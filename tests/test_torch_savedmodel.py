"""The port's weights on disk against the JAX package's: the integrity layer
(``tpuserve_torch.savedmodel``, ``tpuserve_torch.utils.trees``), the fault
injector and the ``.npz`` checkpoint, on the same numpy trees.

- ``tree_digests`` and ``nonfinite_paths`` equal ``tpuserve.savedmodel.
  tree_digests`` and ``tpuserve.utils.trees.nonfinite_paths`` exactly (same
  keystr paths, same hex digests), bf16 and integer leaves included.
- A manifest written by either package verifies the other's tree, and the
  port's ``.npz`` of it; a one-bit change fails it.
- ``FaultInjector`` fires the same sequence as the JAX one for a seed and
  rules (exact).
- ``to_jax_params`` inverts ``from_jax_params`` bit for bit for toy, BERT and
  ResNet, and ``save_npz``/``load_npz`` round-trip a tree bit for bit.
- The toy, a 2-layer BERT and a narrow ResNet (stage sizes (1, 1, 1, 1)),
  each served by the port's runtime from a ``.npz`` of the JAX package's
  seed-1 init, match the JAX forward on that tree: toy probabilities atol
  1e-6 (test_torch_vision.py's), BERT logits atol 1e-4 and probabilities
  1e-5 (test_torch_bert.py's), ResNet logits atol 1e-4 x max|logit|
  (test_torch_resnet.py's), all float32 with identical top-k indices.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import savedmodel as jsm
from tpuserve.config import FaultRuleConfig as JaxRule
from tpuserve.config import FaultsConfig as JaxFaults
from tpuserve.config import ModelConfig as JaxModelConfig
from tpuserve.faults import FaultInjector as JaxInjector
from tpuserve.models import build as jax_build
from tpuserve.models.resnet import ResNet as JaxResNet
from tpuserve.utils import trees as jtrees
from tpuserve_torch import savedmodel as sm
from tpuserve_torch.config import FaultRuleConfig, FaultsConfig, ModelConfig
from tpuserve_torch.faults import FaultInjector
from tpuserve_torch.models import build
from tpuserve_torch.models.resnet import ResNet, ResNet50Serving
from tpuserve_torch.runtime import build_runtime
from tpuserve_torch.utils import trees

TINY_BERT = dict(layers=2, d_model=32, heads=2, d_ff=64, vocab_size=512)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cfg_kwargs(family: str, **over) -> dict:
    base = {"toy": dict(name="toy", family="toy", batch_buckets=[1, 4], dtype="float32",
                        num_classes=10, parallelism="single"),
            "bert": dict(name="bert", family="bert", batch_buckets=[1, 4], seq_buckets=[16],
                         dtype="float32", num_classes=4, parallelism="single",
                         options=dict(TINY_BERT)),
            "resnet50": dict(name="r", family="resnet50", batch_buckets=[2], dtype="float32",
                             num_classes=10, parallelism="single", image_size=32,
                             wire_size=32, wire_format="rgb8")}[family]
    base.update(over)
    return base


def jax_model(family: str):
    jm = jax_build(JaxModelConfig(**cfg_kwargs(family)))
    if family == "resnet50":
        jm.module = JaxResNet(stage_sizes=(1, 1, 1, 1), num_classes=10, dtype=jnp.float32)
    return jm


def seed_tree(family: str, key: int = 1):
    """The JAX package's seeded float32 tree as numpy arrays."""
    return jax.device_get(jax_model(family).init_params(jax.random.key(key)))


def mixed_tree():
    """float32, bfloat16 and int32 leaves in nested dicts with unsorted keys."""
    rng = np.random.default_rng(3)
    return {"z": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                  "bias": np.arange(3, dtype=np.int32)},
            "a": {"emb": np.asarray(jnp.asarray(rng.normal(size=(5, 2)), jnp.bfloat16)),
                  "scale": np.ones((7,), np.float32)},
            "pos": rng.normal(size=(2, 2)).astype(np.float32)}


# -- digests and non-finite paths ------------------------------------------------

@pytest.mark.parametrize("family", ["toy", "bert", "mixed"])
def test_tree_digests_equal_the_reference(family):
    tree = mixed_tree() if family == "mixed" else seed_tree(family)
    got = sm.tree_digests(tree)
    assert got == jsm.tree_digests(tree)
    assert list(got) == [jax.tree_util.keystr(p)
                         for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def poisoned(tree, *paths_values):
    out = jax.tree_util.tree_map(lambda x: np.array(x), tree)
    for path, index, value in paths_values:
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]][index] = value
    return out


@pytest.mark.parametrize("poison", [
    (),
    ((("z", "kernel"), (0, 0), np.nan),),
    ((("a", "emb"), (1, 1), np.inf), (("pos",), (0, 1), -np.inf)),
])
def test_nonfinite_paths_equal_the_reference(poison):
    tree = poisoned(mixed_tree(), *poison)
    assert trees.nonfinite_paths(tree) == jtrees.nonfinite_paths(tree)
    assert len(trees.nonfinite_paths(tree)) == len(poison)


def test_nonfinite_paths_reads_state_dicts():
    sd = {"fc.weight": torch.zeros(2, 2, dtype=torch.bfloat16), "fc.bias": torch.zeros(2),
          "steps": torch.zeros(1, dtype=torch.int64)}
    assert trees.nonfinite_paths(sd) == []
    sd["fc.weight"][0, 1] = float("nan")
    assert trees.nonfinite_paths(sd) == ["['fc.weight']"]
    assert trees.tree_summary(sd) == {"leaves": 3, "bytes": 8 + 8 + 8, "params": 7}


# -- manifests across packages, and the .npz -------------------------------------

def flip_one_bit(tree, path):
    out = jax.tree_util.tree_map(lambda x: np.array(x), tree)
    node = out
    for k in path[:-1]:
        node = node[k]
    node[path[-1]].view(np.uint8).reshape(-1)[0] ^= 1
    return out


def test_reference_manifest_verifies_the_ports_npz(tmp_path):
    tree = seed_tree("bert")
    ckpt = str(tmp_path / "bert.npz")
    sm.save_npz(ckpt, tree)
    jsm.write_manifest(ckpt, tree)          # overwrite with the reference's
    loaded = sm.load_npz(ckpt)
    assert sm.verify_manifest_if_present(ckpt, loaded) is True
    bad = flip_one_bit(loaded, ("params", "layer1", "mlp_up", "kernel"))
    with pytest.raises(sm.IntegrityError, match="corrupt"):
        sm.verify_manifest_if_present(ckpt, bad)
    # And the other way: the port's manifest verifies in the JAX package.
    sm.write_manifest(ckpt, loaded)
    assert jsm.verify_manifest_if_present(ckpt, tree) is True
    with pytest.raises(jsm.IntegrityError, match="corrupt"):
        jsm.verify_manifest_if_present(ckpt, bad)
    with open(sm.manifest_path(ckpt)) as f:
        assert json.load(f)["leaves"] == jsm.tree_digests(tree)


def test_manifest_missing_skips_unless_required(tmp_path):
    tree = seed_tree("toy")
    ckpt = str(tmp_path / "toy.npz")
    sm.save_npz(ckpt, tree)
    os.remove(sm.manifest_path(ckpt))
    assert sm.verify_manifest_if_present(ckpt, tree) is False
    with pytest.raises(sm.IntegrityError, match="require_manifest"):
        sm.verify_manifest_if_present(ckpt, tree, require=True)


def test_npz_round_trip_is_bit_identical(tmp_path):
    tree = mixed_tree()
    del tree["a"]["emb"]                    # the port's .npz holds the float32 tree
    ckpt = str(tmp_path / "m.npz")
    sm.save_npz(ckpt, tree)
    back = sm.load_npz(ckpt)
    assert sm.tree_digests(back) == sm.tree_digests(tree)
    with np.load(ckpt) as z:
        assert sorted(z.files) == sorted(sm.tree_digests(tree))
    with pytest.raises(ValueError, match=".npz"):
        sm.save_npz(str(tmp_path / "m.bin"), tree)


def test_detect_format(tmp_path):
    """The port serves its .npz and torch checkpoints; a TF form is refused
    naming import-model, an orbax directory by name; anything else is not
    a weight file."""
    assert sm.detect_format("w.npz") == "npz"
    for suffix in (".safetensors", ".ckpt", ".pt", ".pth", ".bin"):
        assert sm.detect_format("w" + suffix) == "torch"
    (tmp_path / "sm").mkdir()
    (tmp_path / "sm" / "saved_model.pb").write_bytes(b"")
    for path, kind in ((tmp_path, "orbax.*npz"), (tmp_path / "sm", "TF SavedModel.*import-model"),
                       ("frozen.pb", "GraphDef.*import-model")):
        with pytest.raises(NotImplementedError, match=kind):
            sm.detect_format(str(path))
    with pytest.raises(ValueError, match="cannot identify"):
        sm.detect_format("weights.txt")


# -- fault injection ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_fault_injector_fires_the_reference_sequence(seed):
    rules = [dict(kind="device_error", probability=0.3),
             dict(kind="slow_compute", model="m1", probability=0.5, count=4, delay_ms=2.0),
             dict(kind="reload_nan", probability=0.7, seed=11),
             dict(kind="device_error", model="m2", probability=1.0, count=2)]
    port = FaultInjector(FaultsConfig(enabled=True, seed=seed,
                                      rules=[FaultRuleConfig(**r) for r in rules]))
    ref = JaxInjector(JaxFaults(enabled=True, seed=seed, rules=[JaxRule(**r) for r in rules]))
    calls = [(k, m) for _ in range(40) for k, m in (
        ("device_error", "m1"), ("device_error", "m2"), ("slow_compute", "m1"),
        ("reload_nan", "m2"), ("slow_compute", "m2"))]
    fired = [(port.fire(k, m), ref.fire(k, m)) for k, m in calls]
    got = [None if a is None else (a.kind, a.model, a.probability) for a, _ in fired]
    want = [None if b is None else (b.kind, b.model, b.probability) for _, b in fired]
    assert got == want and 0 < sum(g is not None for g in got) < len(got)
    assert [{k: v for k, v in r.items()} for r in port.snapshot()] == ref.snapshot()


# -- weights: the reference's tree <-> the port's state_dict ---------------------------

@pytest.mark.parametrize("family", ["toy", "bert", "resnet50"])
def test_to_jax_params_inverts_from_jax_params(family, monkeypatch):
    monkeypatch.setattr(ResNet50Serving, "build_module", lambda self: ResNet(
        (1, 1, 1, 1), self.cfg.num_classes))
    model = build(ModelConfig(**cfg_kwargs(family)))
    tree = seed_tree(family)
    back = model.to_jax_params(model.from_jax_params(tree))
    assert sm.tree_digests(back) == jsm.tree_digests(tree)
    sd = model.init_params(0)
    again = model.from_jax_params(model.to_jax_params(sd))
    assert set(again) == set(sd)
    for k, v in sd.items():
        assert torch.equal(again[k], v), k


def jax_forward(family, jm, tree, batch):
    """The JAX package's logits and top-k on one assembled batch."""
    if family == "bert":
        logits = jm.module.apply(tree, *batch)
    elif family == "toy":
        logits = None
    else:
        logits = jm.module.apply(tree, jm.device_preprocess(batch[0]))
    out = jm.forward(tree, batch if family == "bert" else batch[0])
    return (None if logits is None else np.asarray(logits)), jax.device_get(out)


@pytest.mark.parametrize("family", ["toy", "bert", "resnet50"])
def test_npz_loaded_forward_matches_jax(family, tmp_path, monkeypatch):
    monkeypatch.setattr(ResNet50Serving, "build_module", lambda self: ResNet(
        (1, 1, 1, 1), self.cfg.num_classes))
    jm = jax_model(family)
    tree = seed_tree(family)
    ckpt = str(tmp_path / f"{family}.npz")
    sm.save_npz(ckpt, tree)
    model = build(ModelConfig(**cfg_kwargs(family, weights=ckpt)))
    rt = build_runtime(model, device="cpu")
    rng = np.random.default_rng(5)
    if family == "bert":
        texts = ["hello world", "serve this text", "a third", "four"]
        items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
                 for t in texts]
        bucket = (4, 16)
    else:
        bucket = (4,) if family == "toy" else (2,)
        items = list(rng.integers(0, 256, (bucket[0],) + model.input_signature(bucket)[0].shape[1:],
                                  dtype=np.uint8))
    batch = model.assemble(items, bucket)
    got = rt.fetch(rt.run(bucket, batch))
    ref_logits, ref = jax_forward(family, jm, tree, batch)
    np.testing.assert_array_equal(got["indices"], np.asarray(ref["indices"]))
    if family == "toy":
        np.testing.assert_allclose(got["probs"], ref["probs"], rtol=0, atol=1e-6)
        return
    with torch.inference_mode():
        logits = model.logits(rt.module, tuple(torch.from_numpy(a) for a in batch)).numpy()
    if family == "bert":
        np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["probs"], ref["probs"], rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(logits, ref_logits, rtol=0,
                                   atol=1e-4 * np.abs(ref_logits).max())
