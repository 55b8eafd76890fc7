"""Int8 of the port (``tpuserve_torch.quantize``) against the JAX package's
``tpuserve.quantize``, on the CPU, on the same seeded trees.

- Layout: ``q8`` and ``q8_scale`` bit-equal to the reference's
  ``quantize_tree`` of the same cast tree, leaf by leaf, for BERT (q/k/v
  kernels with one scale per head_dim index shared across heads, 2-D q/k/v
  biases once ``quantize_min_size`` lets them in, the out kernel, the
  embedding tables with one scale per column of d), ResNet and
  EfficientDet. The port's int8 values and its broadcast scales are carried
  back to the reference's layout by each family's own ``to_jax_params``, so
  the check is independent of ``reference_layout``; the same leaves are
  quantized on both sides.
- ``int8_matmul``: the int8 activations, their scales and the int32
  product equal the reference's exactly; the output within one unit of the
  output dtype's last place (both multiply the same float32 numbers in the
  same order; measured bit-equal), also under 17 rows (the pad).
- Each int8c module against its flax twin on the same int8 weights:
  ``Int8Linear`` against ``Int8Dense``, BERT's q/k/v/out ``Int8Linear``s
  against ``_Int8QKVProj`` / ``_Int8OutProj``, ``Int8Conv1x1`` (stride 1 and
  2) against ``Int8Conv1x1``. float32: atol 1e-5 x the output's scale (the
  same integers; the float32 epilogue and the bias add in another order).
- Served networks against the reference's forward on its prepared tree
  (cast, ``quantize_tree``, then ``dequantize_tree_except`` for int8c or
  ``dequantize_tree`` for int8), float32: int8c BERT (flash and dense
  attention), int8 BERT (both), int8c ResNet (v1 and v1.5 downsampling, a
  shallow stage table) and int8 EfficientDet. Logits atol 1e-3 x their scale
  for int8c (an activation near a rounding edge of its int8 grid may land on
  the other side when the float32 activations differ in the last place:
  one quantum of one product term; measured bit-equal to 2e-7 x) and 1e-4 x
  for weight-only int8; top-1 equal where the reference's top-2 gap exceeds
  that.
- Refusals: int8c on EfficientDet, MobileNetV3 and toy raises the
  reference's ``ValueError`` guidance; an unknown mode raises as in the
  reference.
- The lifecycle under int8 and int8c: a staged ``.npz`` lands in a free
  slot holding exactly what a fresh runtime on it holds (int8 values,
  scales, int8-native weights), answers as that runtime does, and publish
  and rollback switch between the versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import quantize as jqz
from tpuserve.config import ModelConfig as JaxModelConfig
from tpuserve.models import build as jax_build
from tpuserve.models.resnet import ResNet as JaxResNet
from tpuserve_torch import quantize as qz
from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models import build
from tpuserve_torch.models import bert as tbert
from tpuserve_torch.models.resnet import ResNet, ResNet50Serving
from tpuserve_torch.runtime import build_runtime

BERT = dict(layers=2, d_model=32, heads=2, d_ff=64, vocab_size=512)
DET = dict(det_classes=5, fpn_channels=16, fpn_repeats=1, head_repeats=1, max_level=5,
           pre_nms=32, max_dets=8, backbone_width=0.25, backbone_depth=0.35,
           score_thresh=0.005)
MODULE_REL = 1e-5
INT8C_REL = 1e-3
INT8_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cast_tree(tree, dtype):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x).astype(dtype))
        if np.issubdtype(np.asarray(x).dtype, np.floating) else np.asarray(x), tree)


def model_cfg(family: str, **over) -> dict:
    base = {"bert": dict(name="b", family="bert", batch_buckets=[2], seq_buckets=[16],
                         num_classes=4, options=dict(BERT)),
            "resnet50": dict(name="r", family="resnet50", batch_buckets=[2], num_classes=10,
                             image_size=32, wire_size=32),
            "efficientdet": dict(name="d", family="efficientdet", batch_buckets=[2],
                                 image_size=64, wire_size=64, options=dict(DET)),
            "mobilenetv3": dict(name="m", family="mobilenetv3", batch_buckets=[1],
                                image_size=32, wire_size=32),
            "toy": dict(name="t", family="toy", batch_buckets=[1], num_classes=10)}[family]
    kw = dict(base, dtype="float32", parallelism="single", request_timeout_ms=30_000.0)
    kw.update(over)
    return kw


def pair(family: str, **over):
    kw = model_cfg(family, **over)
    return jax_build(JaxModelConfig(**kw)), build(ModelConfig(**kw))


def held(module: torch.nn.Module, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 values and float32 scale the port holds for parameter ``name``."""
    prefix, _, leaf = name.rpartition(".")
    mod = module.get_submodule(prefix) if prefix else module
    if leaf in getattr(mod, "parametrizations", {}):
        p = mod.parametrizations[leaf]
        return p.original, p[0].scale
    return getattr(mod, leaf), mod.weight_scale


def assert_quantized_like_reference(jm, model, tree, dtype, min_size, native=()) -> int:
    """The port's quantized leaves, carried to the reference's layout by the
    family's own ``to_jax_params``, equal ``quantize_tree``'s bit for bit."""
    ref = jqz.quantize_tree(cast_tree(tree, jnp.dtype(dtype)), min_size)
    sd = model.from_jax_params(tree)
    module = model.build_module()
    module.load_state_dict(sd)
    module.to(getattr(torch, dtype))
    done = qz.quantize_module(module, getattr(torch, dtype), min_size,
                              layout=model.reference_layout, native=native)
    as_q, as_s = dict(sd), dict(sd)
    for name in done:
        q, scale = held(module, name)
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        as_q[name] = q.float()
        as_s[name] = scale.expand(q.shape).contiguous()
    tree_q, tree_s = model.to_jax_params(as_q), model.to_jax_params(as_s)
    flat = jax.tree_util.tree_flatten_with_path(ref, is_leaf=jqz.is_quantized)[0]
    n = 0
    for path, leaf in flat:
        if not jqz.is_quantized(leaf):
            continue
        got_q, got_s = tree_q, tree_s
        for p in path:
            got_q, got_s = got_q[p.key], got_s[p.key]
        np.testing.assert_array_equal(got_q, leaf[jqz.QKEY].astype(np.float32), str(path))
        np.testing.assert_array_equal(got_s, np.broadcast_to(leaf[jqz.SKEY], got_s.shape),
                                      str(path))
        n += 1
    assert n == len(done) > 0
    return n


# -- layout: the reference's channel, leaf by leaf ----------------------------------

@pytest.mark.parametrize("min_size", [16, 4096])
def test_bert_quantizes_like_reference(min_size):
    jm, model = pair("bert", options=dict(BERT, d_model=128, heads=4, d_ff=256))
    tree = jax.device_get(jm.init_params(jax.random.key(0)))
    n = assert_quantized_like_reference(jm, model, tree, "bfloat16", min_size)
    layer = tree["params"]["layer0"]["attn"]
    ref = jqz.quantize_leaf(np.asarray(layer["query"]["kernel"]))
    assert ref[jqz.SKEY].shape == (1, 1, 32)   # one scale per head_dim index
    module = model.build_module()
    module.load_state_dict(model.from_jax_params(tree))
    qz.quantize_module(module, torch.float32, min_size, layout=model.reference_layout)
    _, scale = held(module, "layers.0.attn.query.weight")
    assert scale.shape == (128, 1)
    np.testing.assert_array_equal(scale.reshape(4, 32).numpy(),
                                  np.broadcast_to(ref[jqz.SKEY].reshape(1, 32), (4, 32)))
    _, emb = held(module, "embed.weight")
    assert emb.shape == (1, 128)               # one scale per column of d
    # The 2-D q/k/v biases (H, hd) qualify once min_size lets them in: 3 per
    # layer beside the 6 kernels; the embeddings, pooler and classifier.
    assert n == (2 * 9 + 4 if min_size == 16 else 2 * 6 + 2)


@pytest.mark.parametrize("v1_downsample", [False, True])
def test_resnet_quantizes_like_reference(v1_downsample):
    jm = JaxResNet(stage_sizes=(1, 1, 1, 1), num_classes=10, v1_downsample=v1_downsample,
                   dtype=jnp.float32)
    tree = jax.device_get(jm.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3))))
    _, model = pair("resnet50", options={"v1_downsample": v1_downsample})
    model.build_module = lambda: ResNet((1, 1, 1, 1), 10, v1_downsample)
    native = model.int8c_native_kernel_paths()
    assert assert_quantized_like_reference(jm, model, tree, "bfloat16", 4096, native) > 8


def test_efficientdet_quantizes_like_reference():
    jm, model = pair("efficientdet")
    tree = jax.device_get(jm.init_params(jax.random.key(2)))
    assert assert_quantized_like_reference(jm, model, tree, "bfloat16", 256) > 10


# -- int8_matmul -------------------------------------------------------------------

@pytest.mark.parametrize("rows", [4, 17, 64])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_int32_exact(rows, out_dtype):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 96)).astype(np.float32)
    x[0] = 0.0                                             # an all-zero row: s_x = 1e-8 / 127
    x[1, :3] = [0.5, -0.5, 1.5]                            # ties of round-half-even
    w = rng.standard_normal((96, 128)).astype(np.float32)
    ref_w = jqz.quantize_leaf(w)
    q, scale = qz.quantize_leaf(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(q.numpy().T, ref_w[jqz.QKEY])

    amax = np.abs(x).max(-1, keepdims=True)
    ref_sx = np.maximum(amax, np.float32(1e-8)) / np.float32(127.0)
    ref_xq = np.clip(np.round(x / ref_sx), -127, 127).astype(np.int8)
    xq, s_x = qz.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(), ref_xq)
    np.testing.assert_array_equal(s_x.numpy(), ref_sx)
    y = qz.int_mm(xq, q.t())
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), ref_xq.astype(np.int64) @ ref_w[jqz.QKEY].astype(np.int64))

    dt = jnp.dtype(out_dtype)
    ref = np.asarray(jqz.int8_matmul(jnp.asarray(x), jnp.asarray(ref_w[jqz.QKEY]),
                                     jnp.asarray(ref_w[jqz.SKEY]), dt)).astype(np.float32)
    got = qz.int8_matmul(torch.from_numpy(x), q.t(), scale, getattr(torch, out_dtype)).float()
    ulp = np.spacing(np.abs(ref).astype(dt)).astype(np.float32)
    assert (np.abs(got.numpy() - ref) <= ulp).all()


# -- the int8c modules against their flax twins ------------------------------------

def _close(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=MODULE_REL * np.abs(ref).max())


def test_int8_linear_matches_int8_dense():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    ref_q = jqz.quantize_leaf(w)
    ref = np.asarray(jqz.Int8Dense(40, dtype=jnp.float32).apply(
        {"params": {"kernel": ref_q, "bias": b}}, x))
    lin = qz.Int8Linear(48, 40)
    lin.load_state_dict({"weight": torch.from_numpy(w.T.copy()), "bias": torch.from_numpy(b)})
    assert qz.quantize_module(lin, torch.float32, 16, native=[r"^weight$"]) == ["weight"]
    assert lin.weight.dtype == torch.int8
    with torch.no_grad():
        _close(lin(torch.from_numpy(x)).numpy(), ref)


def test_bert_projections_match_int8_self_attention():
    """q/k/v (scales per head_dim index, broadcast across heads) and out."""
    d, heads = 64, 4
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, d)).astype(np.float32)
    attn = jqz.Int8SelfAttention(heads=heads, dtype=jnp.float32,
                                 attention_fn=lambda q, k, v: q + 2 * k - v)
    tree = jax.device_get(attn.init(jax.random.key(5), x))
    qtree = jax.tree_util.tree_map(lambda a: a, tree)
    for name in ("query", "key", "value", "out"):
        qtree["params"][name]["kernel"] = jqz.quantize_leaf(tree["params"][name]["kernel"])
    ref = np.asarray(attn.apply(qtree, x))

    model = build(ModelConfig(**model_cfg("bert", options=dict(BERT, d_model=d, heads=heads))))
    module = tbert.SelfAttention(d, heads, "dense")
    p = {k: {n: torch.from_numpy(np.array(a)) for n, a in v.items()}
         for k, v in tree["params"].items()}
    sd = {f"{n}.{leaf}": t for n in ("query", "key", "value")
          for leaf, t in (("weight", p[n]["kernel"].reshape(d, d).T), ("bias", p[n]["bias"].reshape(d)))}
    sd.update({"out.weight": p["out"]["kernel"].reshape(d, d).T, "out.bias": p["out"]["bias"]})
    module.load_state_dict(sd)
    done = qz.quantize_module(
        module, torch.float32, 256,
        layout=lambda n, s: model.reference_layout(f"layers.0.attn.{n}", s),
        native=[r"(query|key|value|out)\.weight$"])
    assert sorted(done) == [f"{n}.weight" for n in ("key", "out", "query", "value")]
    assert module.query.weight_scale.shape == (d, 1)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        q = module.query(xt).view(2, 6, heads, -1)
        k = module.key(xt).view(2, 6, heads, -1)
        v = module.value(xt).view(2, 6, heads, -1)
        got = module.out((q + 2 * k - v).reshape(2, 6, d)).numpy()
    _close(got, ref)


@pytest.mark.parametrize("stride", [1, 2])
def test_int8_conv1x1_matches_flax(stride):
    rng = np.random.default_rng(6 + stride)
    x = rng.standard_normal((2, 9, 9, 16)).astype(np.float32)
    w = rng.standard_normal((1, 1, 16, 24)).astype(np.float32)
    ref_q = jqz.quantize_leaf(w)
    ref = np.asarray(jqz.Int8Conv1x1(24, strides=(stride, stride), dtype=jnp.float32).apply(
        {"params": {"kernel": ref_q}}, x))
    conv = qz.Int8Conv1x1(16, 24, stride)
    conv.load_state_dict({"weight": torch.from_numpy(w.transpose(3, 2, 0, 1).copy())})
    qz.quantize_module(conv, torch.float32, 16, native=[r"^weight$"])
    conv.to(memory_format=torch.channels_last)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = conv(xt)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(got.permute(0, 2, 3, 1).numpy(), ref)


# -- served networks against the reference ------------------------------------------

def _separated_top1(got: np.ndarray, ref: np.ndarray, tol: float) -> None:
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > tol
    np.testing.assert_array_equal(got.argmax(-1)[clear], ref.argmax(-1)[clear])


def _reference_params(jm, tree, quantize: str, min_size: int, dtype=jnp.float32):
    params = jqz.quantize_tree(cast_tree(tree, dtype), min_size)
    if quantize == "int8c":
        return jqz.dequantize_tree_except(params, dtype, jm.int8c_native_kernel_paths())
    return jqz.dequantize_tree(params, dtype)


@pytest.mark.parametrize("quantize", ["int8c", "int8"])
@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_bert_logits_match_reference(quantize, attention):
    over = dict(options=dict(BERT, d_model=64, heads=4, attention=attention),
                quantize=quantize, quantize_min_size=256)
    jm, model = pair("bert", **over)
    tree = jax.device_get(jm.init_params(jax.random.key(0)))
    model.load_params = lambda: model.from_jax_params(tree)
    rt = build_runtime(model, device="cpu")
    texts = ["int8 compute on the card", "hello world", "a b c d e f", "x " * 6]
    items = [model.host_decode(('{"text": "%s"}' % t).encode(), "application/json")
             for t in texts]
    batch = model.assemble(items, (4, 16))
    ref = np.asarray(jm.module.apply(_reference_params(jm, tree, quantize, 256), *batch))
    with torch.inference_mode():
        logits = rt.module(*(torch.from_numpy(a) for a in batch)).numpy()
    native = [n for n, t in rt.module.state_dict().items() if t.dtype == torch.int8
              and "parametrizations" not in n]
    assert len(native) == (12 if quantize == "int8c" else 0)
    rel = INT8C_REL if quantize == "int8c" else INT8_REL
    tol = rel * np.abs(ref).max()
    np.testing.assert_allclose(logits, ref, rtol=0, atol=tol)
    _separated_top1(logits, ref, tol)


@pytest.mark.parametrize("v1_downsample", [False, True])
def test_resnet_int8c_logits_match_reference(v1_downsample):
    jm = JaxResNet(stage_sizes=(1, 1, 1, 1), num_classes=10, v1_downsample=v1_downsample,
                   dtype=jnp.float32, quantize_compute=True)
    tree = jax.device_get(jm.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3))))
    model = ResNet50Serving(ModelConfig(**model_cfg(
        "resnet50", quantize="int8c", quantize_min_size=1024,
        options={"v1_downsample": v1_downsample})))
    model.build_module = lambda: ResNet((1, 1, 1, 1), 10, v1_downsample)
    model.load_params = lambda: model.from_jax_params(tree)
    rt = build_runtime(model, device="cpu")
    keep = [r"(conv1|conv3|proj_conv)/kernel$"]
    params = jqz.dequantize_tree_except(jqz.quantize_tree(tree, 1024), jnp.float32, keep)
    x = np.random.default_rng(8).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(params, x))
    with torch.inference_mode():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        logits = rt.module(xt).numpy()
    n_native = sum(1 for m in rt.module.modules()
                   if isinstance(m, qz.Int8Conv1x1) and m.weight_scale is not None)
    assert n_native >= 8
    tol = INT8C_REL * np.abs(ref).max()
    np.testing.assert_allclose(logits, ref, rtol=0, atol=tol)
    _separated_top1(logits, ref, tol)


def test_efficientdet_int8_heads_match_reference():
    jm, model = pair("efficientdet", quantize="int8", quantize_min_size=256)
    tree = jax.device_get(jm.init_params(jax.random.key(4)))
    model.load_params = lambda: model.from_jax_params(tree)
    rt = build_runtime(model, device="cpu")
    params = _reference_params(jm, tree, "int8", 256)
    x = np.random.default_rng(9).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref_cls, ref_box = (np.asarray(a) for a in jm.module.apply(params, x))
    with torch.inference_mode():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        cls, box = (a.numpy() for a in rt.module(xt))
    for got, ref in ((cls, ref_cls), (box, ref_box)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=INT8_REL * np.abs(ref).max())


# -- refusals ------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["efficientdet", "mobilenetv3", "toy"])
def test_int8c_refused_with_reference_guidance(family):
    from tpuserve.runtime import build_runtime as jax_build_runtime

    kw = model_cfg(family, quantize="int8c")
    with pytest.raises(ValueError) as ref:
        jax_build_runtime(jax_build(JaxModelConfig(**kw)))
    with pytest.raises(ValueError) as got:
        build_runtime(build(ModelConfig(**kw)), device="cpu")
    assert str(got.value) == str(ref.value)
    assert "names no int8-native kernel sites; use quantize='int8'" in str(got.value)


def test_int8c_serves_where_the_reference_does():
    for family in ("bert", "resnet50"):
        kw = model_cfg(family, quantize="int8c")
        assert jax_build(JaxModelConfig(**kw)).int8c_native_kernel_paths()
        assert build(ModelConfig(**kw)).int8c_native_kernel_paths()
    with pytest.raises(ValueError, match="unknown quantize mode"):
        build_runtime(build(ModelConfig(**model_cfg("toy", quantize="int4"))), device="cpu")


def test_int8c_keeps_native_weights_int8_and_the_rest_dequantized():
    cfg = ModelConfig(**model_cfg("bert", quantize="int8c", quantize_min_size=256))
    rt = build_runtime(build(cfg), device="cpu")
    m = rt.module
    block = m.layers[0]
    for lin in (block.attn.query, block.attn.key, block.attn.value, block.attn.out,
                block.mlp_up, block.mlp_down):
        assert lin.weight.dtype == torch.int8 and lin.weight_scale.dtype == torch.float32
    assert m.embed.weight.dtype == torch.float32          # weight-only: dequantized on access
    assert "embed.parametrizations.weight.original" in m.state_dict()
    int8 = build_runtime(build(dataclasses.replace(cfg, quantize="int8")), device="cpu")
    assert all(not hasattr(mod, "weight_scale") or mod.weight_scale is None
               for mod in int8.module.modules())


# -- the lifecycle ---------------------------------------------------------------------

@pytest.mark.parametrize("quantize", ["int8", "int8c"])
def test_staged_checkpoint_quantizes_the_same_way(tmp_path, quantize):
    """A staged ``.npz`` lands in a free slot quantized as a fresh runtime
    on the same checkpoint would hold it (int8 values, scales, int8-native
    weights), its answers equal that runtime's; publish and rollback switch
    slots with the slot structure unchanged."""
    from tpuserve_torch import savedmodel as sm

    kw = model_cfg("bert", quantize=quantize, quantize_min_size=256)
    path = str(tmp_path / "w.npz")
    model = build(ModelConfig(**kw, weights=path))
    sm.save_npz(path, model.to_jax_params(model.init_params(1)))
    rt = build_runtime(model, device="cpu")
    items = [model.host_decode(b'{"text": "quantized weights"}', "application/json")] * 2
    batch = model.assemble(items, (2, 16))
    v1 = rt.fetch(rt.run((2, 16), batch))
    sm.save_npz(path, model.to_jax_params(model.init_params(2)))
    staged = rt.stage_params()
    fresh = build_runtime(build(ModelConfig(**kw, weights=path)), device="cpu")
    held, want = rt.slots[staged.slot].tensors, fresh.slots[0].tensors
    assert list(held) == list(want)
    for name, t in held.items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), name
    n_int8 = sum(t.dtype == torch.int8 for t in held.values())
    assert n_int8 == 2 * 6 + 3          # 6 kernels a layer, the two tables, the pooler
    assert sum(name.endswith("weight_scale") for name in held) == (12 if quantize == "int8c" else 0)
    rt.publish(staged)
    v2 = rt.fetch(rt.run((2, 16), batch))
    np.testing.assert_array_equal(v2["probs"], fresh.fetch(fresh.run((2, 16), batch))["probs"])
    assert not np.array_equal(v2["probs"], v1["probs"])
    rt.rollback()
    np.testing.assert_array_equal(rt.fetch(rt.run((2, 16), batch))["probs"], v1["probs"])
