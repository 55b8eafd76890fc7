"""``python -m tpuserve_torch import-model`` against the reference's TF import
(``tpuserve/savedmodel.py``'s extraction and each family's
``import_tf_variables``), on the SavedModels that ``tests/test_tf_parity.py``'s
fixtures build from randomized weights. This file: the Keras-applications
ResNet50 and MobileNetV3Large, and frozen GraphDefs;
``tests/test_torch_tf_import_bert_b0.py`` (which shares this file's
helpers): transformers' ``TFBertForSequenceClassification`` and
EfficientNetB0. Each pays TensorFlow's import and two Keras exports, so the
four models are split over two files that run in parallel.

- the ``.npz`` that ``import-model`` writes (with its manifest) equals the
  reference's imported tree leaf for leaf;
- the port's float32 network on that ``.npz`` holds TF's logits within the
  reference's bounds: ResNet-50 and MobileNetV3 rtol 1e-4, atol 5e-3 with
  the same argmax;
- ``extract_graphdef_constants`` equals the reference's on a tiny frozen
  GraphDef, and ``import-model`` turns MobileNetV3's variables frozen into a
  GraphDef into the same ``.npz`` as its SavedModel;
- serving refuses a SavedModel or GraphDef as ``weights`` by naming
  ``import-model``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import torch  # noqa: E402

from tpuserve import savedmodel as jsm  # noqa: E402
from tpuserve.models import build as jax_build  # noqa: E402
from tpuserve_torch import savedmodel as tsm  # noqa: E402
from tpuserve_torch.cli import main as port_main  # noqa: E402
from tpuserve_torch.config import ModelConfig  # noqa: E402
from tpuserve_torch.models import build  # noqa: E402
from tpuserve_torch.utils.trees import flatten_with_paths  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_tf_parity import (bert_cfg, keras_savedmodel, mnv3_cfg,  # noqa: E402,F401
                            mnv3_savedmodel, serving_cfg)

# family -> (fixture, the reference's config, import-model's --opt flags)
CASES = {
    "resnet50": ("keras_savedmodel", serving_cfg,
                 ["num_classes=1000", "v1_downsample=true", "bn_eps=1.001e-5"]),
    "mobilenetv3": ("mnv3_savedmodel", mnv3_cfg, ["num_classes=1000"]),
    "bert": ("bert_savedmodel", bert_cfg,
             ["num_classes=3", "seq_buckets=[64]", "layers=2", "d_model=32", "heads=2",
              "d_ff=64", "vocab_size=128"]),
    "efficientdet": ("effb0_savedmodel", None, ["image_size=224"]),
}


def port_cfg(family: str, opts: list[str], weights: str) -> ModelConfig:
    """The port's config for what ``--opt`` set: ModelConfig fields as
    fields, the rest as options."""
    import dataclasses

    from tpuserve_torch.cli import _parse_opt_args

    parsed = _parse_opt_args(None, [f"{o}" for o in opts])
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in parsed.items() if k in fields}
    options = {k: v for k, v in parsed.items() if k not in fields}
    return ModelConfig(name=family, family=family, dtype="float32", weights=weights,
                       parallelism="single", options=options, **kw)


def reference_tree(family: str, path: str):
    """The reference's imported tree (``load_params``: its extraction and
    ``import_tf_variables``). EfficientDet's import starts from the model's
    seeded init, which only the BiFPN and heads keep — the leaves no test
    compares — so its init is given as shapes (``jax.eval_shape``): seconds
    instead of a minute of flax init on the CPU."""
    if family == "efficientdet":
        from tpuserve.config import ModelConfig as JaxModelConfig

        model = jax_build(JaxModelConfig(name="d0", family="efficientdet", dtype="float32",
                                         weights=path, image_size=224))
        init = model.init_params
        model.init_params = lambda rng: jax.eval_shape(init, rng)
        return model.load_params()
    return jax_build(CASES[family][1](weights=path)).load_params()


# The families whose SavedModels a test file builds (the other file: BERT
# and EfficientDet).
FAMILIES = ("resnet50", "mobilenetv3")


@pytest.fixture(scope="module")
def imported(request, tmp_path_factory):
    """{family: (keras model, .npz path, the reference's tree)} for the test
    module's ``FAMILIES``; each SavedModel is converted once by the port's
    CLI."""
    out = {}
    d = tmp_path_factory.mktemp("import_model")
    for family in request.module.FAMILIES:
        fixture, _, opts = CASES[family]
        keras_model, sm_path = request.getfixturevalue(fixture)
        npz = str(d / f"{family}.npz")
        argv = ["import-model", "--saved-model", sm_path, "--family", family, "--out", npz]
        for o in opts:
            argv += ["--opt", o]
        assert port_main(argv) == 0
        out[family] = (keras_model, npz, reference_tree(family, sm_path))
    return out


def leaves_jax(tree) -> list:
    return [(jax.tree_util.keystr(p), np.asarray(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def check_npz_equals_reference_tree(imported, family: str) -> None:
    _, npz, ref = imported[family]
    got = tsm.load_npz(npz)
    assert tsm.verify_manifest_if_present(npz, got, require=True)
    if family == "efficientdet":
        got = {k: {"backbone": got[k]["backbone"]} for k in ("params", "batch_stats")}
        ref = {k: {"backbone": ref[k]["backbone"]} for k in ("params", "batch_stats")}
    got_l, want_l = list(flatten_with_paths(got)), leaves_jax(ref)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert np.array_equal(g, w), path


@pytest.mark.parametrize("family", FAMILIES)
def test_import_model_npz_equals_reference_tree(imported, family):
    check_npz_equals_reference_tree(imported, family)


def port_module(family: str, npz: str):
    model = build(port_cfg(family, CASES[family][2], npz))
    module = model.build_module()
    module.load_state_dict(model.load_params())
    return model, module.eval()


@pytest.mark.parametrize("family", ["resnet50", "mobilenetv3"])
def test_vision_logits_hold_tf_parity_bounds(imported, family):
    keras_model, npz, _ = imported[family]
    lo = 0.0 if family == "resnet50" else -1.0
    x = np.random.default_rng(0).uniform(lo, 1, (2, 224, 224, 3)).astype(np.float32)
    y_tf = keras_model(x, training=False).numpy()
    _, module = port_module(family, npz)
    with torch.no_grad():
        y = module(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert y.shape == y_tf.shape == (2, 1000)
    np.testing.assert_allclose(y, y_tf, rtol=1e-4, atol=5e-3)
    assert (y.argmax(-1) == y_tf.argmax(-1)).all()


def write_graphdef(path: str, consts: dict) -> None:
    """A frozen GraphDef holding ``consts`` as Const nodes (named by their
    keys) and one op that is not a Const."""
    graph = tf.Graph()
    with graph.as_default():
        nodes = [tf.constant(v, name=k) for k, v in consts.items()]
        tf.identity(nodes[0], name="out")
    with open(path, "wb") as f:
        f.write(graph.as_graph_def().SerializeToString())


@pytest.fixture(scope="module")
def frozen_pb(tmp_path_factory):
    rng = np.random.default_rng(0)
    consts = {"dense/kernel": rng.standard_normal((4, 3)).astype(np.float32),
              "dense/bias": rng.standard_normal(3).astype(np.float32),
              "steps": np.array([7, 9], np.int64)}
    path = str(tmp_path_factory.mktemp("pb") / "frozen.pb")
    write_graphdef(path, consts)
    return path, consts


def test_graphdef_extraction_equals_reference(frozen_pb):
    path, consts = frozen_pb
    got, want = tsm.extract_graphdef_constants(path), jsm.extract_graphdef_constants(path)
    assert sorted(got) == sorted(want) == sorted(consts)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        assert np.array_equal(got[k], consts[k]), k


def test_import_model_reads_a_graphdef(imported, mnv3_savedmodel, tmp_path):
    """MobileNetV3's variables frozen into a GraphDef's Const nodes convert
    to the same .npz as its SavedModel."""
    flat = tsm.extract_saved_model_variables(mnv3_savedmodel[1])
    pb = str(tmp_path / "mnv3.pb")
    write_graphdef(pb, flat)
    npz = str(tmp_path / "mnv3_pb.npz")
    assert port_main(["import-model", "--saved-model", pb, "--family", "mobilenetv3",
                      "--out", npz]) == 0
    got = list(flatten_with_paths(tsm.load_npz(npz)))
    want = list(flatten_with_paths(tsm.load_npz(imported["mobilenetv3"][1])))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(got, want))


@pytest.mark.parametrize("kind", ["saved_model", "graphdef"])
def test_serving_refuses_tf_weights_naming_import_model(keras_savedmodel, frozen_pb, kind):
    path = keras_savedmodel[1] if kind == "saved_model" else frozen_pb[0]
    with pytest.raises(NotImplementedError, match="import-model"):
        build(port_cfg("resnet50", [], path))
