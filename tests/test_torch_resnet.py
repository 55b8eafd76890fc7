"""Port parity for ResNet (``tpuserve_torch.models.resnet``) and weight-only
int8 (``tpuserve_torch.quantize``) against the JAX package's
``tpuserve.models.resnet`` and ``tpuserve.quantize`` on the same weights:
the reference's seeded flax tree, converted by ``from_jax_params``.

- ``quantize_leaf``: bit-identical int8 values and float32 scales on the same
  arrays (the port's in its OIHW / (out, in) layout), zero channels and the
  depthwise rule included, and bit-identical bf16 dequantization (by
  ``dequantize`` and by the served parametrization); the same
  leaves are eligible in both layouts.
- The network at small ``stage_sizes`` on a (2, S, S, 3) input, S = 32 (even
  sizes all the way down) and S = 36 (odd sizes at the stride-2 convs, so the
  SAME padding's parity is exercised), v1.5 and v1 downsampling. float32:
  logits atol 1e-4 x max|logit| (convolutions summed in another order;
  measured up to 1.1e-6 x), identical top-5. bfloat16 (both sides cast every
  float leaf to bf16, as the runtimes do): logits atol 1e-2 x max|logit|
  (measured up to 2.2e-3 x: the frameworks round some activations to bf16
  at different points), identical top-1 wherever the reference's top-2 gap
  exceeds that tolerance.
- The slice: ``ResNet50Serving.forward`` at full depth (3, 4, 6, 3), 1000
  classes, image_size 32, for the two models of ``examples/resnet50.toml``
  (yuv420 + int8 on an upscaling wire, 24 -> 32; rgb8 unquantized on a
  downscaling one, 40 -> 32), bf16, on the same seeded uint8 batch, with
  parameters prepared as each runtime prepares them (the reference: cast,
  ``quantize_tree``, ``dequantize_tree`` in the forward; the port's
  ``build_runtime``). The int8 values are identical. Sixteen bf16 blocks
  grow the per-layer rounding differences: logits atol 3e-2 x max|logit|
  (measured 9.5e-3 and 9.8e-3 x); top-5 probabilities atol 3e-2 x the top
  probability (measured 9.3e-3 and 7.0e-3 x); top-5 indices identical at
  every rank whose reference probability is separated from its neighbours
  by more than that atol.
"""

import dataclasses
import functools

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
from tpuserve_torch.config import load_config
from tpuserve_torch.models import build
from tpuserve_torch.models.resnet import ResNet, from_jax_params
from tpuserve_torch.runtime import build_runtime

F32_REL = 1e-4
BF16_REL = 1e-2
SLICE_REL = 3e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def to_port_layout(a: np.ndarray) -> np.ndarray:
    """A reference leaf in the port's layout: HWIO -> OIHW, (in, out) ->
    (out, in)."""
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


def cast_tree(tree, dtype):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x).astype(dtype)) if np.issubdtype(x.dtype, np.floating)
        else x, tree)


# -- quantize -------------------------------------------------------------------

@pytest.mark.parametrize("shape, zero_channel", [
    ((3, 3, 16, 32), None),        # 3x3 conv, HWIO
    ((1, 1, 64, 256), 7),          # 1x1 conv with an all-zero output channel
    ((7, 7, 3, 64), None),         # the stem
    ((256, 100), 3),               # Dense (in, out) with a zero column
    ((3, 3, 32, 1), None),         # depthwise-shaped: last axis 1
    ((96, 1), None),               # one-output Dense
])
def test_quantize_leaf_bit_identical(shape, zero_channel):
    rng = np.random.default_rng(sum(shape))
    w = rng.normal(0.0, 0.05, shape).astype(np.float32)
    w[..., :2] *= 40.0                                  # uneven channel scales
    if zero_channel is not None:
        w[..., zero_channel] = 0.0
    w = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))  # cast first
    ref = jqz.quantize_leaf(w)
    q, scale = qz.quantize_leaf(torch.from_numpy(to_port_layout(w).copy()))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), to_port_layout(ref[jqz.QKEY]))
    np.testing.assert_array_equal(scale.numpy(), to_port_layout(ref[jqz.SKEY]))
    if zero_channel is not None:
        assert (to_port_layout(ref[jqz.SKEY])[zero_channel] == 1.0).all()
    # Dequantization in bf16, as both forwards do it.
    want = np.asarray(jnp.asarray(ref[jqz.QKEY]).astype(jnp.bfloat16)
                      * jnp.asarray(ref[jqz.SKEY]).astype(jnp.bfloat16)).astype(np.float32)
    got = qz.dequantize(q, scale, torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, to_port_layout(want))
    # The parametrization's scale, cast once at load, gives the same bits.
    served = qz.Dequantize(scale, torch.bfloat16)(q).float().numpy()
    np.testing.assert_array_equal(served, to_port_layout(want))


@pytest.mark.parametrize("min_size", [4096, 1 << 20])
def test_same_leaves_eligible_in_both_layouts(min_size):
    tree = jax_tree((1, 1, 1, 1))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    names = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
    ref = {".".join(p.key for p in path[1:-1]) + "." + names[path[-1].key]
           for path, leaf in flat if jqz.eligible(leaf, min_size)}
    sd = from_jax_params(tree)
    port = {k for k, t in sd.items() if qz.eligible(t, min_size)}
    assert port == ref and "head.weight" in port and len(port) < len(sd)
    module = ResNet((1, 1, 1, 1), 1000)
    module.load_state_dict(sd)
    assert sorted(qz.quantize_module(module, torch.float32, min_size)) == sorted(port)


@functools.lru_cache(maxsize=None)
def jax_tree(stage_sizes: tuple) -> dict:
    """The reference's seeded float32 tree (its shapes depend on neither the
    input size nor the downsampling convention)."""
    module = JaxResNet(stage_sizes=stage_sizes, num_classes=1000, dtype=jnp.float32)
    return jax.device_get(jax.jit(module.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))


# -- the network ------------------------------------------------------------------

def top1_checked(ref: np.ndarray, got: np.ndarray, tol: float) -> int:
    """Top-1 identical wherever the reference's top-2 gap exceeds tol."""
    checked = 0
    for r, g in zip(ref, got):
        s = np.sort(r)[::-1]
        if s[0] - s[1] > tol:
            assert np.argmax(g) == np.argmax(r)
            checked += 1
    return checked


NETWORK_CASES = [((1, 1, 1, 1), size, v1, dtype) for size in (32, 36) for v1 in (False, True)
                 for dtype in ("float32", "bfloat16")]
NETWORK_CASES += [((2, 1, 1, 1), 36, False, dtype) for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("stage_sizes, size, v1_downsample, dtype", NETWORK_CASES,
                         ids=lambda v: "".join(map(str, v)) if isinstance(v, tuple)
                         else {False: "v1.5", True: "v1"}.get(v, v) if isinstance(v, bool)
                         else str(v))
def test_network_matches_reference(stage_sizes, size, v1_downsample, dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jmod = JaxResNet(stage_sizes=stage_sizes, num_classes=1000,
                     v1_downsample=v1_downsample, dtype=jdt)
    x = np.random.default_rng(size).normal(0.0, 1.0, (2, size, size, 3)).astype(np.float32)
    tree = jax_tree(stage_sizes)
    ref = np.asarray(jax.jit(jmod.apply)(cast_tree(tree, jdt), jnp.asarray(x).astype(jdt)))
    module = ResNet(stage_sizes, 1000, v1_downsample)
    module.load_state_dict(from_jax_params(tree))
    module.to(dtype=tdt).eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        got = module.to(memory_format=torch.channels_last)(xt).numpy()
    assert got.dtype == np.float32 and ref.dtype == np.float32 and got.shape == (2, 1000)
    scale = np.abs(ref).max()
    tol = (F32_REL if dtype == "float32" else BF16_REL) * scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    if dtype == "float32":
        np.testing.assert_array_equal(np.argsort(-got)[:, :5], np.argsort(-ref)[:, :5])
    else:
        top1_checked(ref, got, tol)


# -- the slice ----------------------------------------------------------------------

SLICE = {"resnet50": dict(image_size=32, wire_size=24, batch_buckets=[1, 4]),
         "resnet50_rgb": dict(image_size=32, wire_size=40, batch_buckets=[1, 4])}


def _separated_ranks(ref_p: np.ndarray, tol: float):
    """(row, rank) pairs whose reference probability differs from both
    neighbours by more than tol."""
    out = []
    for row, p in enumerate(ref_p):
        for r in range(len(p)):
            above = p[r - 1] - p[r] if r else np.inf
            below = p[r] - p[r + 1] if r + 1 < len(p) else np.inf
            if min(above, below) > tol:
                out.append((row, r))
    return out


@pytest.mark.parametrize("name", sorted(SLICE))
def test_serving_forward_matches_reference(name):
    mcfg = dataclasses.replace(load_config("examples/resnet50.toml").model(name), **SLICE[name])
    jcfg = JaxModelConfig(**{f.name: getattr(mcfg, f.name)
                             for f in dataclasses.fields(mcfg) if f.name != "unported"})
    jmodel, model = jax_build(jcfg), build(mcfg)
    tree = jax.device_get(jax.jit(jmodel.init_params)(jax.random.key(0)))
    params = cast_tree(tree, jnp.bfloat16)
    if mcfg.quantize == "int8":
        params = jqz.quantize_tree(params, mcfg.quantize_min_size)
    model.load_params = lambda: from_jax_params(tree)
    rt = build_runtime(model, device="cpu")

    bucket = (4,)
    rng = np.random.default_rng(4)
    batch = tuple(rng.integers(0, 256, s.shape, dtype=np.uint8)
                  for s in model.input_signature(bucket))
    jbatch = batch if len(batch) > 1 else batch[0]
    jparams = (jqz.dequantize_tree(params, jnp.bfloat16) if mcfg.quantize else params)

    # The int8 values each runtime holds are the same.
    if mcfg.quantize:
        qleaves = {".".join(p.key for p in path[1:-1]): leaf for path, leaf in
                   jax.tree_util.tree_flatten_with_path(params, is_leaf=jqz.is_quantized)[0]
                   if jqz.is_quantized(leaf)}
        held = {k.split(".parametrizations.")[0]: v for k, v in rt.module.state_dict().items()
                if k.endswith(".original")}
        assert set(held) == set(qleaves) and "head" in held
        for k, v in held.items():
            np.testing.assert_array_equal(v.numpy(), to_port_layout(qleaves[k][jqz.QKEY]))
        assert rt.describe()["params"]["bytes"] < 0.3 * 4 * rt.describe()["params"]["params"]

    ref = jax.device_get(jax.jit(jmodel.forward)(jparams, jbatch))
    ref_logits = np.asarray(jax.jit(lambda p, b: jmodel.module.apply(
        p, jmodel.device_preprocess(b)))(jparams, jbatch))
    out = rt.fetch(rt.run(bucket, batch))
    with torch.inference_mode():
        dev = rt.h2d(bucket, batch)
        logits = rt.module(model.device_preprocess(dev)).numpy()

    assert logits.shape == ref_logits.shape == (4, 1000)
    np.testing.assert_allclose(logits, ref_logits, rtol=0,
                               atol=SLICE_REL * np.abs(ref_logits).max())
    assert out["probs"].shape == (4, 5) and out["indices"].shape == (4, 5)
    tol = SLICE_REL * ref["probs"].max()
    np.testing.assert_allclose(out["probs"], ref["probs"], rtol=0, atol=tol)
    for row, r in _separated_ranks(np.asarray(ref["probs"]), tol):
        assert out["indices"][row, r] == ref["indices"][row, r], (row, r)
