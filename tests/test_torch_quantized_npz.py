"""The int8-quantized tree in a ``.npz`` (``import-model --quantize int8``)
against the JAX package's ``tpuserve.quantize``, on the CPU.

- ``quantize.quantize_tree`` (the port's copy of the reference's numpy
  function) equals ``tpuserve.quantize.quantize_tree`` of the same float
  tree byte for byte, int8 values and float32 scales, and so does the
  ``.npz`` that ``savedmodel.convert_cli(..., quantize="int8")`` writes;
  both are idempotent over a quantized tree.
- Served under ``quantize = "int8"`` (and ``"int8c"``) the pre-quantized
  ``.npz`` holds the same int8 values and scales in every slot as the float
  ``.npz`` quantized at stage time, and answers with the same bytes: in
  float32, and in bfloat16 for a tree whose floats are bf16 values (the
  reference quantizes the cast weights at stage time and the float32 ones
  at import, so only then do the two agree).
- Served answers equal the JAX package's int8 serving of the same tree
  (float32, probabilities atol 1e-4 for int8 and 1e-3 for int8c, the
  tolerances of ``tests/test_torch_quantize.py``), top-1 exact; under
  tensor parallelism too (``tp = 2``, the JAX runtime over 4 of its fake
  devices, as ``tests/test_quantize.py::test_tp_sharded_quantized_bert_runs``).
- The reference's guidance: a quantized ``.npz`` on a model without
  ``quantize`` raises naming ``quantize = "int8"``; a ``.npz`` quantized at
  ``quantize_min_size = 1024`` serves under the default 4096 (its
  quantized leaves are installed as they are); an unquantized one serves
  under int8; a mismatched one raises ("weights do not fit").
- The lifecycle: ``:reload`` onto the pre-quantized ``.npz`` (staged canary,
  publish) answers the bytes of a reload onto the float ``.npz``, with no
  new compile; rollback restores the float version.
"""

import json

import jax
import numpy as np
import pytest
import torch

from tpuserve import quantize as jqz
from tpuserve.config import ModelConfig as JaxModelConfig
from tpuserve.models import build as jax_build
from tpuserve.parallel import make_mesh as jax_make_mesh
from tpuserve.parallel.mesh import MeshPlan as JaxMeshPlan
from tpuserve.runtime import build_runtime as jax_build_runtime
from tpuserve_torch import quantize as qz
from tpuserve_torch import savedmodel
from tpuserve_torch.config import ModelConfig, ParallelConfig
from tpuserve_torch.models import build
from tpuserve_torch.parallel import mesh as meshlib
from tpuserve_torch.runtime import build_runtime
from tpuserve_torch.utils.trees import flatten_with_paths

BERT = dict(layers=2, d_model=64, heads=4, d_ff=128, vocab_size=512)
TEXTS = ["quantized tensor parallel", "hello world", "a b c", "the int8 tree"]
INT8_ATOL = 1e-4
INT8C_ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def kw(**over) -> dict:
    base = dict(name="bert", family="bert", batch_buckets=[4], seq_buckets=[16],
                dtype="float32", num_classes=4, parallelism="single",
                request_timeout_ms=30_000.0, options=dict(BERT))
    base.update(over)
    return base


@pytest.fixture(scope="module")
def tree():
    jm = jax_build(JaxModelConfig(**kw()))
    return jax.device_get(jm.load_params())


@pytest.fixture(scope="module")
def npzs(tree, tmp_path_factory):
    """The float tree's .npz, and its int8 form written by import-model's
    function (convert_cli reads an .npz as it is) at min_size 256 and 1024."""
    d = tmp_path_factory.mktemp("q8")
    float_npz = str(d / "float.npz")
    savedmodel.save_npz(float_npz, tree)
    out = {"float": float_npz}
    for ms in (256, 1024):
        out[ms] = str(d / f"q8_{ms}.npz")
        savedmodel.convert_cli(float_npz, "bert", out[ms],
                               dict(BERT, quantize_min_size=ms, num_classes=4,
                                    seq_buckets=[16]), quantize="int8")
    return out


def leaves(tree) -> list:
    return list(flatten_with_paths(tree))


def assert_trees_bit_equal(got, want):
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert a.tobytes() == b.tobytes(), p


def batch(model):
    items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
             for t in TEXTS]
    return model.assemble(items, (4, 16))


def serve(weights=None, **over):
    model = build(ModelConfig(**kw(weights=weights, **over)))
    rt = build_runtime(model, device="cpu")
    return rt, rt.fetch(rt.run((4, 16), batch(model)))


# -- the tree ----------------------------------------------------------------------

@pytest.mark.parametrize("min_size", [256, 1024, 4096])
def test_quantize_tree_bit_equal_to_reference(tree, min_size):
    port, ref = qz.quantize_tree(tree, min_size), jqz.quantize_tree(tree, min_size)
    assert_trees_bit_equal(port, ref)
    assert qz.has_quantized_leaves(port) == jqz.has_quantized_leaves(ref)
    # Idempotent: a second pass (which would quantize any leaf) keeps every
    # quantized sub-tree as it is.
    again = dict(leaves(qz.quantize_tree(port, 1)))
    for p, a in leaves(port):
        if p.endswith("['q8']") or p.endswith("['q8_scale']"):
            assert again[p].tobytes() == a.tobytes(), p


def test_import_model_npz_bit_equal_to_reference(tree, npzs):
    for ms in (256, 1024):
        assert_trees_bit_equal(savedmodel.load_npz(npzs[ms]), jqz.quantize_tree(tree, ms))
    savedmodel.verify_manifest_if_present(npzs[256], savedmodel.load_npz(npzs[256]),
                                          require=True)


def test_specs_for_tree_as_reference(tree):
    from jax.sharding import PartitionSpec as JP

    from tpuserve_torch.parallel import P, named_leaves

    rules = [(r"attn/(query|key|value)/kernel", (None, "model", None)),
             (r"mlp_up/kernel", (None, "model")), (r"mlp_down/kernel", ("model", None)),
             (r".*", ())]
    qt = qz.quantize_tree(tree, 256)
    port = qz.specs_for_tree([(r, P(*s)) for r, s in rules], qt)
    ref = jqz.specs_for_tree([(r, JP(*s)) for r, s in rules], jqz.quantize_tree(tree, 256))
    flat_ref = {"/".join(str(k.key) for k in p): s for p, s in
                jax.tree_util.tree_leaves_with_path(ref, is_leaf=lambda x: isinstance(x, JP))}
    flat_port = dict(named_leaves(port, is_leaf=lambda x: isinstance(x, P)))
    assert set(flat_port) == set(flat_ref)
    for k, s in flat_port.items():
        assert tuple(s) == tuple(flat_ref[k]), k


# -- serving ---------------------------------------------------------------------

@pytest.mark.parametrize("quantize", ["int8", "int8c"])
def test_prequantized_serves_stage_time_bytes(npzs, quantize):
    rt_f, out_f = serve(npzs["float"], quantize=quantize, quantize_min_size=256)
    rt_q, out_q = serve(npzs[256], quantize=quantize, quantize_min_size=256)
    held_f, held_q = rt_f.slots[0].tensors, rt_q.slots[0].tensors
    assert list(held_f) == list(held_q)
    assert sum(t.dtype == torch.int8 for t in held_q.values()) >= 8
    for k in held_f:
        assert held_f[k].dtype == held_q[k].dtype, k
        assert torch.equal(held_f[k], held_q[k]), k
    for k in out_f:
        assert out_f[k].tobytes() == out_q[k].tobytes(), k


def test_prequantized_bf16_tree_serves_stage_time_bytes(tree, tmp_path):
    """bfloat16: the import quantizes the float32 leaves and the stage the
    cast ones, so a tree of bf16 values gives the same bytes both ways."""
    bf = qz.cast_tree(tree, torch.bfloat16)
    f, q = str(tmp_path / "bf.npz"), str(tmp_path / "bf_q8.npz")
    savedmodel.save_npz(f, bf)
    savedmodel.save_npz(q, qz.quantize_tree(bf, 256))
    _, out_f = serve(f, quantize="int8", quantize_min_size=256, dtype="bfloat16")
    _, out_q = serve(q, quantize="int8", quantize_min_size=256, dtype="bfloat16")
    for k in out_f:
        assert out_f[k].tobytes() == out_q[k].tobytes(), k


@pytest.mark.parametrize("quantize, atol", [("int8", INT8_ATOL), ("int8c", INT8C_ATOL)])
def test_prequantized_matches_reference_serving(tree, npzs, quantize, atol):
    jm = jax_build(JaxModelConfig(**kw(quantize=quantize, quantize_min_size=256)))
    jm.load_params = lambda: tree  # the same float tree (int8c inits another)
    jrt = jax_build_runtime(jm)
    ref = jrt.fetch(jrt.run((4, 16), batch(jm)))
    _, out = serve(npzs[256], quantize=quantize, quantize_min_size=256)
    np.testing.assert_allclose(out["probs"], np.asarray(ref["probs"]), atol=atol)
    np.testing.assert_array_equal(out["indices"][:, 0], np.asarray(ref["indices"])[:, 0])


@pytest.mark.parametrize("quantize, atol", [("int8", INT8_ATOL), ("int8c", INT8C_ATOL)])
def test_tp_quantized_bert_matches_reference(tree, npzs, monkeypatch, quantize, atol):
    """The reference's test_tp_sharded_quantized_bert_runs modes (tp = 2
    over 4 devices), held to its answers: the port quantizes the tree whole
    and splits q8 and q8_scale by specs_for_tree, from the float .npz and
    from the pre-quantized one alike."""
    monkeypatch.setattr(meshlib, "visible_devices", lambda *a: ["cpu"] * 8)
    over = dict(parallelism="sharded", tp=2, quantize=quantize, quantize_min_size=256)
    jm = jax_build(JaxModelConfig(**kw(**over)))
    jm.load_params = lambda: tree
    jrt = jax_build_runtime(jm, mesh=jax_make_mesh(JaxMeshPlan(tp=2),
                                                   devices=jax.devices()[:4]))
    ref = jrt.fetch(jrt.run((4, 16), batch(jm)))
    outs = []
    for weights in (npzs["float"], npzs[256]):
        model = build(ModelConfig(**kw(weights=weights, **over)))
        rt = build_runtime(model, device="cpu", parallel=ParallelConfig(n_chips=4))
        assert rt.parallel_signature == "sharded@d2" and rt.n_chips == 4
        out = rt.fetch(rt.run((4, 16), batch(model)))
        np.testing.assert_allclose(out["probs"], np.asarray(ref["probs"]), atol=atol)
        np.testing.assert_array_equal(out["indices"][:, 0], np.asarray(ref["indices"])[:, 0])
        outs.append(out)
    assert outs[0]["probs"].tobytes() == outs[1]["probs"].tobytes()


# -- the reference's guidance ------------------------------------------------------

def test_quantized_checkpoint_without_flag_gives_guidance(npzs):
    model = build(ModelConfig(**kw(weights=npzs[256])))
    with pytest.raises(ValueError, match='quantize = "int8"'):
        model.load_params()
    with pytest.raises(ValueError, match='quantize = "int8"'):
        build_runtime(model, device="cpu")


def test_checkpoint_metadata_bridges_min_size_mismatch(npzs):
    """Quantized at 1024, served under the default 4096: the checkpoint's
    own quantized leaves are installed as they are (more than 4096 would
    quantize), so the answers equal the 1024 stage-time ones."""
    rt, out = serve(npzs[1024], quantize="int8")
    _, out_1024 = serve(npzs["float"], quantize="int8", quantize_min_size=1024)
    rt_4096, _ = serve(npzs["float"], quantize="int8")
    n_int8 = sum(t.dtype == torch.int8 for t in rt.slots[0].tensors.values())
    assert n_int8 > sum(t.dtype == torch.int8 for t in rt_4096.slots[0].tensors.values())
    assert out["probs"].tobytes() == out_1024["probs"].tobytes()


def test_unquantized_checkpoint_serves_with_int8_flag(npzs):
    rt, _ = serve(npzs["float"], quantize="int8", quantize_min_size=1024)
    assert any(t.dtype == torch.int8 for t in rt.slots[0].tensors.values())


def test_mismatched_checkpoint_gives_guidance(tmp_path):
    jm = jax_build(JaxModelConfig(**kw(options=dict(BERT, d_ff=64))))
    path = str(tmp_path / "other.npz")
    savedmodel.save_npz(path, qz.quantize_tree(jax.device_get(jm.load_params()), 256))
    model = build(ModelConfig(**kw(weights=path, quantize="int8")))
    with pytest.raises(ValueError, match="do not fit"):
        build_runtime(model, device="cpu")


# -- the lifecycle ----------------------------------------------------------------

def test_reload_onto_prequantized_npz(npzs, tmp_path):
    """A runtime serving the float .npz under int8 stages the pre-quantized
    one (the staged canary runs on it), publishes it and answers the bytes
    of the float tree quantized at stage time; no compile; rollback."""
    model = build(ModelConfig(**kw(weights=npzs["float"], quantize="int8",
                                   quantize_min_size=256)))
    rt = build_runtime(model, device="cpu")
    b = batch(model)
    before = rt.fetch(rt.run((4, 16), b))
    compiles = rt.compiles_total
    model.cfg.weights = npzs[256]
    staged = rt.stage_params()
    canary = rt.fetch(rt.run((4, 16), b, params_override=staged))
    info = rt.publish(staged)
    after = rt.fetch(rt.run((4, 16), b))
    assert info["version"] == 2 and rt.compiles_total == compiles
    for k in before:
        assert after[k].tobytes() == before[k].tobytes() == canary[k].tobytes(), k
    rt.rollback()
    assert rt.version == 1


def test_resnet_prequantized_bf16_reload_answers_float_bytes(tmp_path):
    """The smoke's phase 9 rule on the CPU: int8 ResNet-50 (bf16, a shallow
    stage table) serving a float seed-1 .npz, reloaded onto that tree
    written int8 by import-model's function from its bf16 values, answers
    the same bytes, with no new compile."""
    from tpuserve_torch.models.resnet import ResNet, ResNet50Serving

    model = ResNet50Serving(ModelConfig(
        name="resnet50", family="resnet50", batch_buckets=[2], dtype="bfloat16",
        num_classes=10, image_size=32, wire_size=32, parallelism="single",
        quantize="int8", quantize_min_size=1024))
    model.build_module = lambda: ResNet((1, 1, 1, 1), 10)
    tree = model.to_jax_params(model.init_params(1))
    f, q = str(tmp_path / "r.npz"), str(tmp_path / "r_q8.npz")
    savedmodel.save_npz(f, tree)
    savedmodel.save_npz(q, qz.quantize_tree(qz.cast_tree(tree, torch.bfloat16), 1024))
    model.cfg.weights = f
    rt = build_runtime(model, device="cpu")
    rng = np.random.default_rng(2)
    host = model.assemble([rng.integers(0, 255, (32, 32, 3), np.uint8) for _ in range(2)], (2,))
    before = rt.fetch(rt.run((2,), host))
    compiles = rt.compiles_total
    model.cfg.weights = q
    rt.publish(rt.stage_params())
    after = rt.fetch(rt.run((2,), host))
    assert rt.version == 2 and rt.compiles_total == compiles
    for k in before:
        assert after[k].tobytes() == before[k].tobytes(), k
