"""Port parity for kernel K1's function: ``tpuserve_torch.ops.flash_attention``
(its plain PyTorch path, which CPU tensors take) against the JAX package's
``flash_attention`` run as its own tests run it on the CPU (Pallas interpret
mode). Same numpy inputs on both sides.

Tolerances: float32 atol 1e-5 (two f32 softmax orders); bfloat16 inputs
atol 1.6e-2 (outputs rounded to bf16, whose spacing near 1 is 7.8e-3, on
both sides independently); gradients through the reference's dense-recompute
VJP, float32 atol 1e-4 (sums over up to 192 keys).

Kernel K2's function (``return_stats=True``) is held the same way against
the reference's ``_fa_kernel_stats`` in interpret mode: acc and l, float32
rtol 1e-5 and atol 1e-5 (unnormalized sums over up to 64 keys, two orders);
m, atol 1e-5 (a max of the same f32 scores); the merge of two key blocks
atol 2e-6 as in the reference's own test.

The kernels themselves run only on the card: ``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py`` hold them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.ops.flash_attention import _dense_stats, _flash, flash_attention as jax_flash
from tpuserve_torch.ops import flash_attention as fa


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_inputs(seed, b, s, h, d, padded, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    mask = np.ones((b, sk), np.float32)
    if padded:
        mask[0, sk // 2:] = 0.0       # half the keys of row 0 are padding
        mask[1, max(1, sk - 3):] = 0.0
    bias = (1.0 - mask) * -1e9
    return q, k, v, bias


def torch_out(q, k, v, bias, dtype=torch.float32):
    t = lambda x: torch.from_numpy(x).to(dtype)  # noqa: E731
    return fa.flash_attention(t(q), t(k), t(v), torch.from_numpy(bias))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("s", [8, 64, 192])
@pytest.mark.parametrize("d", [16, 64])
def test_matches_jax_flash_f32(d, s, padded):
    q, k, v, bias = make_inputs(0, 2, s, 2, d, padded)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(bias)))
    out = torch_out(q, k, v, bias)
    assert out.dtype == torch.float32 and out.shape == (2, s, 2, d)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("s", [8, 64])
def test_matches_jax_flash_bf16(s):
    q, k, v, bias = make_inputs(1, 2, s, 2, 64, padded=True)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    ref = np.asarray(jax_flash(bf(q), bf(k), bf(v), jnp.asarray(bias)),
                     np.float32)
    out = torch_out(q, k, v, bias, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1.6e-2)


def test_fully_masked_row_matches_reference():
    """A row whose keys are all padding (a padded batch lane) gets the
    reference's finite answer, not 0/0."""
    q, k, v, bias = make_inputs(2, 2, 8, 2, 16, padded=False)
    bias[1, :] = -1e9
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(bias)))
    out = torch_out(q, k, v, bias).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_ragged_query_and_key_lengths():
    """Sq != Sk (the kernel masks both tails); no bias = zero bias."""
    q, k, v, _ = make_inputs(3, 2, 8, 2, 16, padded=False, sk=24)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("d", [16, 64])
def test_gradients_match_jax_vjp(d):
    """The autograd.Function's backward recomputes through the plain version,
    as the reference's VJP recomputes through _dense_stats."""
    q, k, v, bias = make_inputs(4, 2, 64, 2, d, padded=True)
    ct = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        out = _flash(q_, k_, v_, jnp.asarray(bias), 64, 64, True, False)
        return jnp.sum(out * ct)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, torch.from_numpy(bias))
    (out * torch.from_numpy(ct)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_cpu_tensors_take_plain_version_and_count_no_launch():
    q, k, v, bias = make_inputs(6, 2, 8, 2, 16, padded=True)
    before = fa.launches
    out = torch_out(q, k, v, bias)
    plain = fa.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v, bias)))
    assert fa.launches == before
    torch.testing.assert_close(out, plain, atol=0, rtol=0)


def test_k1_counts_by_shape_through_replays_and_reset():
    saved = (fa.launches, fa.stats_launches, dict(fa.shape_launches))
    lvl0, lvl1 = (2, 4096, 8, 64), (2, 1024, 8, 128)
    try:
        fa.reset_launches()
        fa.count_replay(10, 0, {lvl0: 5, lvl1: 5})
        fa.count_replay(10, 0, {lvl0: 5, lvl1: 5})
        fa.count_replay(0, 12)
        assert (fa.launches, fa.stats_launches) == (20, 12)
        assert fa.shape_launches == {lvl0: 10, lvl1: 10}
        fa.reset_launches()
        assert (fa.launches, fa.stats_launches, fa.shape_launches) == (0, 0, {})
    finally:
        fa.launches, fa.stats_launches = saved[:2]
        fa.shape_launches.clear()
        fa.shape_launches.update(saved[2])


def test_strided_views_from_a_fused_projection():
    """q/k/v sliced out of one (B, S, 3, H, D) projection are strided views;
    the result equals the contiguous inputs' result."""
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.normal(size=(2, 8, 3, 2, 16)).astype(np.float32))
    q, k, v = qkv.unbind(dim=2)
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, ref)


@pytest.mark.parametrize("shapes", [
    ((2, 8, 2, 16), (2, 8, 2, 8), (2, 8, 2, 8)),      # head dims differ
    ((2, 8, 2, 16), (3, 8, 2, 16), (3, 8, 2, 16)),    # batch differs
    ((2, 8, 16), (2, 8, 16), (2, 8, 16)),             # not (B, S, H, D)
])
def test_rejects_mismatched_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)


def test_rejects_bias_of_wrong_shape():
    q = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="bias"):
        fa.flash_attention(q, q, q, torch.zeros(2, 7))


# -- kernel K2: return_stats=True ---------------------------------------------

def jax_stats(q, k, v, bias=None):
    args = [jnp.asarray(x) for x in (q, k, v)]
    if bias is not None:
        args.append(jnp.asarray(bias))
    return [np.asarray(x) for x in jax_flash(*args, return_stats=True)]


def assert_stats_close(got, want):
    acc, m, l = (x.numpy() for x in got)
    assert acc.dtype == m.dtype == l.dtype == np.float32
    np.testing.assert_allclose(acc, want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m, want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(l, want[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("s, sk", [(8, 8), (64, 64), (16, 40)])
def test_stats_match_jax_flash_stats(s, sk, padded):
    q, k, v, bias = make_inputs(8, 2, s, 2, 64, padded, sk=sk)
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, bias)),
                             return_stats=True)
    assert [tuple(t.shape) for t in got] == [(2, s, 2, 64), (2, s, 2), (2, s, 2)]
    assert_stats_close(got, jax_stats(q, k, v, bias))


def test_stats_bf16_inputs_stay_f32():
    q, k, v, bias = make_inputs(9, 2, 16, 2, 64, padded=True)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    want = [np.asarray(x) for x in jax_flash(bf(q), bf(k), bf(v), jnp.asarray(bias),
                                             return_stats=True)]
    t = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    got = fa.flash_attention(t(q), t(k), t(v), torch.from_numpy(bias), return_stats=True)
    assert_stats_close(got, want)


@pytest.mark.parametrize("masked", [-1e9, -np.inf])
def test_stats_fully_masked_row(masked):
    """A row whose keys are all masked keeps the reference kernel's stats:
    under -1e9, m ~ -1e9, l ~ Sk and acc = sum of v; under -inf, m = -1e30
    (the running-max seed), l = 0 and acc = 0 — never NaN, never divided."""
    q, k, v, bias = make_inputs(10, 2, 8, 2, 64, padded=False)
    bias[1, :] = masked
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, bias)),
                             return_stats=True)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    want = jax_stats(q, k, v, bias)
    assert_stats_close(got, want)
    if masked == -1e9:
        np.testing.assert_allclose(got[2][1].numpy(), 8.0)
        np.testing.assert_allclose(got[0][1].numpy(), np.broadcast_to(
            v[1].sum(axis=0), (8, 2, 64)), rtol=1e-5, atol=1e-5)
    else:
        assert (got[1][1] == fa.NEG_INF).all() and (got[2][1] == 0).all()


def test_stats_merge_across_key_blocks():
    """Two key blocks' (acc, m, l) merge to the full answer, as in the
    reference's test_stats_variant_merges_across_key_blocks."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 128, 4, 64)).astype(np.float32))
               for _ in range(3))
    a1, m1, l1 = fa.flash_attention(q, k[:, :64], v[:, :64], return_stats=True)
    a2, m2, l2 = fa.flash_attention(q, k[:, 64:], v[:, 64:], return_stats=True)
    m12 = torch.maximum(m1, m2)
    w1, w2 = torch.exp(m1 - m12), torch.exp(m2 - m12)
    merged = (a1 * w1[..., None] + a2 * w2[..., None]) / (l1 * w1 + l2 * w2)[..., None]
    np.testing.assert_allclose(merged.numpy(), fa.flash_attention(q, k, v).numpy(),
                               atol=2e-6)
    want = np.asarray(jax_flash(*(jnp.asarray(x.numpy()) for x in (q, k, v))))
    np.testing.assert_allclose(merged.numpy(), want, atol=2e-6)


def test_stats_gradients_match_jax_vjp():
    """The stats Function's backward recomputes through the stats' plain
    version, as the reference's VJP does with return_stats=True; the
    cotangent weighs acc, m and l."""
    q, k, v, bias = make_inputs(11, 2, 64, 2, 64, padded=True)
    rng = np.random.default_rng(12)
    cts = [rng.normal(size=s).astype(np.float32)
           for s in ((2, 64, 2, 64), (2, 64, 2), (2, 64, 2))]

    def loss(q_, k_, v_):
        outs = _flash(q_, k_, v_, jnp.asarray(bias), 64, 64, True, True)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    outs = fa.flash_attention(tq, tk, tv, torch.from_numpy(bias), return_stats=True)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts)).backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_stats_on_cpu_take_plain_version_and_count_no_launch():
    q, k, v, bias = (torch.from_numpy(x) for x in make_inputs(13, 2, 8, 2, 16, padded=True))
    before = (fa.launches, fa.stats_launches)
    got = fa.flash_attention(q, k, v, bias, return_stats=True)
    assert (fa.launches, fa.stats_launches) == before
    for a, b in zip(got, fa.flash_attention_stats_reference(q, k, v, bias)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# -- the tensor-core kernels' one rounding ----------------------------------------

# The card's shapes (tests/test_torch_kernels_cuda.py and chip_smoke.py):
# (B, Sq, Sk, H, D), with Sq and Sk off the 64-row and 128-key tiles.
CARD_SHAPES = [
    (2, 64, 64, 12, 64), (2, 128, 128, 12, 64), (1, 77, 77, 3, 64),
    (2, 64, 100, 4, 40), (2, 192, 192, 2, 128), (2, 200, 333, 3, 64),
    (1, 77, 100, 2, 80), (2, 100, 64, 4, 64), (2, 512, 512, 12, 64),
]


def emulate_tensor_core_stats(q, k, v, bias):
    """The plain stats version with the tensor-core kernels' one rounding:
    scores and m in f32, P cast to bf16 before P.V, l summed from the f32 P
    (before any rounding), accumulation in f32."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    s = s + bias[:, None, None, :]
    m = s.amax(dim=-1).clamp_min(fa.NEG_INF)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), v.float())
    return acc, m.transpose(1, 2), l.transpose(1, 2)


@pytest.mark.parametrize("b, sq, sk, h, d", CARD_SHAPES)
def test_p_rounding_stays_within_bf16_tolerance(b, sq, sk, h, d):
    """Rounding P to bf16 before P.V, as the tensor-core K1/K2 do (and as
    the reference's f32 dot_general does on the TPU's MXU), moves acc/l by
    at most max|v| * 2^-8 (each p moves by at most bf16's unit roundoff
    2^-8 of itself, and l is summed from the unrounded p), and stays within
    the bf16 tolerance 1.6e-2 of the plain f32 version and of the JAX
    package's _dense_stats; m and l are untouched."""
    rng = np.random.default_rng(b * 1000 + sq + sk + d)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    q = bf(rng.normal(size=(b, sq, h, d)).astype(np.float32))
    k = bf(rng.normal(size=(b, sk, h, d)).astype(np.float32))
    v = bf(rng.normal(size=(b, sk, h, d)).astype(np.float32))
    bias = torch.zeros(b, sk)
    bias[0, sk // 2:] = -1e9
    acc, m, l = emulate_tensor_core_stats(q, k, v, bias)
    racc, rm, rl = fa.flash_attention_stats_reference(q.float(), k.float(), v.float(), bias)
    torch.testing.assert_close(m, rm, atol=0, rtol=0)
    torch.testing.assert_close(l, rl, atol=0, rtol=0)
    out, ref = acc / l[..., None], racc / rl[..., None]
    bound = float(v.float().abs().max()) * 2.0 ** -8
    assert float((out - ref).abs().max()) <= bound + 1e-6
    torch.testing.assert_close(out, ref, atol=1.6e-2, rtol=1.6e-2)
    jacc, jm, jl = (np.asarray(x) for x in _dense_stats(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        jnp.asarray(bias.numpy()), True))
    np.testing.assert_allclose(out.numpy(), jacc / jl[..., None], atol=1.6e-2, rtol=1.6e-2)
    np.testing.assert_allclose(l.numpy(), jl, rtol=1e-5, atol=1e-5)


def _strided(dtype, shape, offset=0, head_pad=0):
    b, s, h, d = shape
    base = torch.zeros(b * s * h * (d + head_pad) + offset, dtype=dtype)
    return base[offset:].view(b, s, h, d + head_pad)[..., :d]


@pytest.mark.parametrize("case, want", [
    ("bf16 contiguous", None),
    ("bf16 fused projection", None),
    ("f32 odd head stride", None),
    ("bf16 odd head stride", "stride 68 (dim 2) is 136 bytes"),
    ("bf16 unaligned base", "base address is not 16-byte aligned"),
    ("bf16 single head, odd stride", None),
])
def test_tma_layout_problem(case, want):
    """The tensor-core kernels' TMA needs 16-byte aligned bases and strides
    (extent-1 dims excepted); float32 takes the CUDA-core kernel, which
    reads any strides. The wrapper raises this message on a CUDA tensor."""
    x = {
        "bf16 contiguous": lambda: torch.zeros(2, 77, 4, 64, dtype=torch.bfloat16),
        "bf16 fused projection": lambda: torch.zeros(
            2, 77, 3, 4, 40, dtype=torch.bfloat16).unbind(dim=2)[1],
        "f32 odd head stride": lambda: _strided(torch.float32, (2, 8, 4, 64), head_pad=3),
        "bf16 odd head stride": lambda: _strided(torch.bfloat16, (2, 8, 4, 64), head_pad=4),
        "bf16 unaligned base": lambda: _strided(torch.bfloat16, (2, 8, 4, 64), offset=3),
        "bf16 single head, odd stride": lambda: torch.zeros(
            2 * 8 * 64, dtype=torch.bfloat16).as_strided((2, 8, 1, 64), (512, 64, 3, 1)),
    }[case]()
    got = fa.tma_layout_problem(x, x, x)
    if want is None:
        assert got is None
    else:
        assert want in got and got.startswith("q's")
