"""``python -m tpuserve_torch import-model`` against the reference's TF import
for transformers' ``TFBertForSequenceClassification`` and the
Keras-applications EfficientNetB0 (the SavedModels
``tests/test_tf_parity.py``'s fixtures build from randomized weights); the
helpers and the vision models are ``tests/test_torch_tf_import.py``'s.

- the ``.npz`` that ``import-model`` writes equals the reference's imported
  tree leaf for leaf (EfficientDet: the backbone's subtrees; the BiFPN and
  heads keep each package's own seeded init);
- the port's float32 BERT on that ``.npz`` holds TF's logits within rtol
  1e-4, atol 1e-5 (a padded lane included), with the same argmax;
- BERT's vocabulary refusal holds, with the reference's message;
- the B0 backbone's C3/C4/C5 maps equal Keras' intermediate activations
  (rtol and atol 1e-4).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import torch  # noqa: E402

from tpuserve.models import build as jax_build  # noqa: E402
from tpuserve_torch.cli import main as port_main  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_tf_parity import bert_cfg, bert_savedmodel, effb0_savedmodel  # noqa: E402,F401
from test_torch_tf_import import (CASES, check_npz_equals_reference_tree,  # noqa: E402,F401
                                  imported, port_module)

# EfficientNetB0 first: transformers' TF BERT switches a later first use of
# ``tf.keras`` to the legacy Keras, whose ``Model.export`` the fixture's
# ``verbose=False`` does not fit.
FAMILIES = ("efficientdet", "bert")


@pytest.mark.parametrize("family", FAMILIES)
def test_import_model_npz_equals_reference_tree(imported, family):
    check_npz_equals_reference_tree(imported, family)


def test_bert_logits_hold_tf_parity_bounds(imported):
    tf_model, npz, _ = imported["bert"]
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 10:] = 0  # one padded row: the additive bias path
    y_tf = tf_model(ids, attention_mask=mask, training=False).logits.numpy()
    _, module = port_module("bert", npz)
    with torch.no_grad():
        y = module(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert y.shape == y_tf.shape == (2, 3)
    np.testing.assert_allclose(y, y_tf, rtol=1e-4, atol=1e-5)
    assert (y.argmax(-1) == y_tf.argmax(-1)).all()


def test_bert_rejects_vocab_mismatch(bert_savedmodel, tmp_path):
    """A checkpoint whose vocabulary differs from the serving tokenizer's
    fails at import, with the reference's message."""
    _, path = bert_savedmodel
    opts = [o for o in CASES["bert"][2] if not o.startswith("vocab_size")] + ["vocab_size=8192"]
    argv = ["import-model", "--saved-model", path, "--family", "bert",
            "--out", str(tmp_path / "b.npz")]
    for o in opts:
        argv += ["--opt", o]
    with pytest.raises(ValueError, match="vocab") as port_err:
        port_main(argv)
    cfg = bert_cfg(weights=path)
    cfg.options = {**cfg.options, "vocab_size": 8192}
    with pytest.raises(ValueError, match="vocab") as ref_err:
        jax_build(cfg).load_params()
    assert str(port_err.value) == str(ref_err.value)
    assert not (tmp_path / "b.npz").exists()


def test_efficientdet_backbone_features_match_keras(imported):
    """EfficientNet-B0's weights in the detector's backbone: C3/C4/C5 equal
    Keras' intermediate activations (depthwise transpose, SE mapping)."""
    keras_model, npz, _ = imported["efficientdet"]
    taps = ["block3b_add", "block5c_add", "block7a_project_bn"]  # C3/C4/C5
    sub = tf.keras.Model(keras_model.input, [keras_model.get_layer(n).output for n in taps])
    x = np.random.default_rng(0).uniform(0, 255, (1, 224, 224, 3)).astype(np.float32)
    tf_feats = [np.asarray(t) for t in sub(x, training=False)]
    _, module = port_module("efficientdet", npz)
    # Keras preproc with weights=None: Rescaling(1/255) + identity
    # Normalization (mean 0, var 1) — replicate, then run the backbone alone.
    with torch.no_grad():
        feats = module.backbone(torch.from_numpy(x / 255.0).permute(0, 3, 1, 2).float())
    for lvl, want in zip([3, 4, 5], tf_feats):
        got = feats[lvl].permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape, (lvl, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
