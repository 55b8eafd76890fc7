"""Fused (flash) attention: the port of ``tpuserve/ops/flash_attention.py``.

``flash_attention(q, k, v, bias)`` computes ``softmax(q.k^T * D^-1/2 + bias).v``
in the reference's (B, S, H, D) layout, with an optional additive per-key
bias (B, Sk) — what BERT's padding mask lowers to (padded keys get -1e9).
``flash_attention(..., return_stats=True)`` returns ``(acc, m, l)`` instead:
the unnormalized f32 accumulator (B, Sq, H, D) and the online softmax's row
max and normalizer (B, Sq, H) f32, which ring attention's local step merges
across key blocks (the merge formula is in ``flash_attention``'s docstring).

Dispatch is by the tensors' device, never by a fallback:

- CUDA tensors launch a hand-written Hopper kernel from
  ``csrc/flash_attention.cu``: K1 (replacing the Pallas ``_fa_kernel``) for
  the normalized output, K2 (replacing ``_fa_kernel_stats``) for the stats.
  bfloat16 and float16 inputs run on the tensor cores (``wgmma`` fed by
  TMA), which need 16-byte aligned bases and strides
  (``tma_layout_problem``); float32 inputs run on the CUDA cores in full
  float32. The library is built with ``nvcc`` at the first launch
  (``tpuserve_torch.ops._build``). A shape, dtype or layout the kernels do
  not take, a failed build or a refused launch raises.
- CPU tensors take the plain PyTorch version of the same function (the twins
  of the reference's ``_dense_stats``): ``flash_attention_reference`` — f32
  scores, f32 softmax, f32 P.V, output cast to q's dtype — and
  ``flash_attention_stats_reference``, which stops before the divide.

``launches`` counts K1's launches and ``stats_launches`` K2's (one per call on
CUDA tensors, none on the CPU), so a run can show that its main path went
through the kernel; ``shape_launches`` splits K1's count by q's (B, Sq, H, D). A call made while a CUDA graph is being captured counts
once at capture, though its launch runs at every replay; whoever replays the
graph adds the launches it recorded (``count_replay``): the serving
runtime's graphs do.

Gradients: a ``torch.autograd.Function`` for each variant whose backward
recomputes through its plain version, as the reference's ``_flash_bwd`` does
through ``_dense_stats`` (training through flash pays the dense O(S^2)
memory on backward only).
"""

from __future__ import annotations

import ctypes
import threading

import torch

# Launches of kernels K1 and K2 since process start (or since a caller reset
# them to 0). Batches dispatch from several pipeline threads, so the
# increments are locked.
launches = 0
stats_launches = 0
shape_launches: dict[tuple[int, int, int, int], int] = {}
_launches_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The online softmax's running-max seed, as in the reference kernel: a row
# whose keys all carry a -inf bias keeps m = NEG_INF and l = 0, not NaN.
NEG_INF = -1e30
_fns: dict = {}  # entry-point name -> ctypes function


def reset_launches() -> None:
    """Set both kernels' launch counts to 0."""
    global launches, stats_launches
    with _launches_lock:
        launches = stats_launches = 0
        shape_launches.clear()


def count_replay(k1: int, k2: int, k1_shapes: dict | None = None) -> None:
    """Add the K1 and K2 launches of one replay of a captured CUDA graph
    (the launches its capture recorded, K1's by shape in ``k1_shapes``) to
    the counts."""
    global launches, stats_launches
    with _launches_lock:
        launches += k1
        stats_launches += k2
        for shape, n in (k1_shapes or {}).items():
            shape_launches[shape] = shape_launches.get(shape, 0) + n


def shape_launches_since(before: dict) -> dict:
    """K1's launches by shape since ``before`` (a copy of ``shape_launches``)."""
    with _launches_lock:
        return {s: n - before.get(s, 0) for s, n in shape_launches.items()
                if n != before.get(s, 0)}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K1 (the reference's ``_dense_stats``
    without stats): O(S^2) scores in f32, output in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if bias is not None:
        s = s + bias[:, None, None, :].float()
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                    # (B, H, Sq)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def flash_attention_stats_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    bias: torch.Tensor | None = None
                                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 (the reference's ``_dense_stats(...,
    return_stats=True)``): the unnormalized f32 accumulator (B, Sq, H, D)
    and the row stats m, l (B, Sq, H) f32. m starts from NEG_INF as the
    kernels' running max does, so an all -inf row gives m = NEG_INF, l = 0."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if bias is not None:
        s = s + bias[:, None, None, :].float()
    m = s.amax(dim=-1).clamp_min(NEG_INF)                # (B, H, Sq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return acc, m.transpose(1, 2), l.transpose(1, 2)


def _kernel_fn(name: str):
    """The library's entry point ``name`` with its C signature set; K1's
    takes one output pointer, K2's three (acc, m, l)."""
    fn = _fns.get(name)
    if fn is None:
        from tpuserve_torch.ops import _build

        n_out = 3 if name == "tpuserve_flash_attention_stats_fwd" else 1
        fn = getattr(_build.load("flash_attention"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (4 + n_out) + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        _fns[name] = fn
    return fn


def tma_layout_problem(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str | None:
    """Why the tensor-core kernels cannot read these 16-bit q/k/v, or None.

    Their tiles arrive by TMA, which needs each base address 16-byte aligned
    and each (batch, seq, head) stride a positive multiple of 16 bytes (a
    dimension of extent 1 has no stride that is ever used). float32 inputs
    take the CUDA-core kernel, which reads any strides."""
    if q.dtype == torch.float32:
        return None
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            return f"{name}'s base address is not 16-byte aligned"
        for dim, (n, stride) in enumerate(zip(t.shape[:3], t.stride()[:3])):
            nbytes = stride * t.element_size()
            if n > 1 and (nbytes <= 0 or nbytes % 16):
                return (f"{name}'s stride {stride} (dim {dim}) is {nbytes} bytes, "
                        "not a positive multiple of 16")
    return None


def dynamic_smem_bytes(dtype: torch.dtype, dim: int) -> int:
    """Dynamic shared memory, in bytes, of the kernel instantiation that a
    call with this dtype and head dim launches (0 for float32, whose kernel
    has static shared memory). Builds the library if needed."""
    from tpuserve_torch.ops import _build

    lib = _build.load("flash_attention")
    return lib.tpuserve_flash_attention_smem_bytes(_DTYPE_CODES[dtype], dim)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: torch.Tensor | None) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, S, H, D) q, k and v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, Sk, H, D) with B, H, D of q {tuple(q.shape)}")
    if bias is not None and tuple(bias.shape) != (b, k.shape[1]):
        raise ValueError(f"bias must be (B, Sk) = {(b, k.shape[1])}, "
                         f"got {tuple(bias.shape)}")
    devices = {t.device for t in (q, k, v) + ((bias,) if bias is not None else ())}
    if len(devices) != 1:
        raise ValueError(f"flash_attention inputs span devices {sorted(map(str, devices))}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor, stats: bool):
    """Run K1 (``stats`` false) or K2 on q's CUDA device and PyTorch's
    current stream."""
    global launches, stats_launches
    kernel = "K2" if stats else "K1"
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{kernel} takes float32, bfloat16 or float16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"{kernel} takes a head dim that is a multiple of 8 up to 128, "
                         f"got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"{kernel}'s grid holds at most 65535 batches and heads, "
                         f"got B={b}, H={h}")
    strides = (q.stride(), k.stride(), v.stride())
    if any(st[3] != 1 for st in strides):
        raise ValueError(f"{kernel} needs the head dim of q, k and v contiguous (stride 1)")
    problem = tma_layout_problem(q, k, v)
    if problem:
        raise ValueError(f"{kernel}: {problem}")
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        bias = bias.to(torch.float32).contiguous()
    dev = q.device
    if stats:
        outs = (torch.empty((b, sq, h, d), dtype=torch.float32, device=dev),
                torch.empty((b, sq, h), dtype=torch.float32, device=dev),
                torch.empty((b, sq, h), dtype=torch.float32, device=dev))
        fn = _kernel_fn("tpuserve_flash_attention_stats_fwd")
    else:
        outs = (torch.empty((b, sq, h, d), dtype=q.dtype, device=dev),)
        fn = _kernel_fn("tpuserve_flash_attention_fwd")
    # The current stream's handle without building a Stream object (about
    # 8 us of host time per call on the serving path otherwise).
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), *(t.data_ptr() for t in outs),
             b, sq, sk, h, d, *strides[0][:3], *strides[1][:3], *strides[2][:3],
             bias.stride(0), d ** -0.5, _DTYPE_CODES[q.dtype], dev.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {kernel} launch failed: cudaError_t {err} "
                           f"(q {tuple(q.shape)} {q.dtype}, Sk {sk})")
    with _launches_lock:
        if stats:
            stats_launches += 1
        else:
            launches += 1
            shape_launches[(b, sq, h, d)] = shape_launches.get((b, sq, h, d), 0) + 1
    return outs if stats else outs[0]


def _forward(q, k, v, bias, stats: bool):
    if q.device.type == "cpu":
        reference = flash_attention_stats_reference if stats else flash_attention_reference
        return reference(q, k, v, bias)
    if q.device.type == "cuda":
        return _launch(q, k, v, bias, stats)
    raise ValueError(f"flash_attention runs on CUDA (kernel) or CPU (plain version), "
                     f"not on {q.device}")


def _recompute_grads(ctx, reference, grad_outs):  # noqa: ANN001
    """The dense-recompute backward: differentiate the plain version."""
    q, k, v, bias = ctx.saved_tensors
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip((q, k, v, bias), ctx.needs_input_grad)]
    with torch.enable_grad():
        outs = reference(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    wanted = [t for t, need in zip(inputs, ctx.needs_input_grad) if need]
    grads = iter(torch.autograd.grad(outs, wanted, grad_outs))
    return tuple(next(grads) if need else None for need in ctx.needs_input_grad)


class _FlashAttention(torch.autograd.Function):
    """K1 forward, dense-recompute backward (the reference's VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):  # noqa: ANN001, ANN205
        ctx.save_for_backward(q, k, v, bias)
        return _forward(q, k, v, bias, stats=False)

    @staticmethod
    def backward(ctx, grad_out):  # noqa: ANN001, ANN205
        return _recompute_grads(ctx, flash_attention_reference, (grad_out,))


class _FlashAttentionStats(torch.autograd.Function):
    """K2 forward, dense-recompute backward through the stats' plain version
    (the reference's VJP with ``return_stats=True``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):  # noqa: ANN001, ANN205
        ctx.save_for_backward(q, k, v, bias)
        return _forward(q, k, v, bias, stats=True)

    @staticmethod
    def backward(ctx, grad_acc, grad_m, grad_l):  # noqa: ANN001, ANN205
        return _recompute_grads(ctx, flash_attention_stats_reference,
                                (grad_acc, grad_m, grad_l))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None, *, return_stats: bool = False):
    """Blockwise fused attention, (B, S, H, D) in and out, output in q's
    dtype. ``bias``: optional additive per-key scores (B, Sk), e.g. a padding
    mask's (1 - mask) * -1e9. Differentiable in q, k, v and bias.

    ``return_stats=True`` returns ``(acc, m, l)``: the unnormalized f32
    accumulator (B, Sq, H, D) and the online softmax's row stats (B, Sq, H)
    f32, never divided, so a caller can merge this key block with others
    without NaN on fully masked blocks and without rounding partial results
    to the input dtype. The merge is::

        m12 = max(m1, m2); a1 = exp(m1-m12); a2 = exp(m2-m12)
        l12 = l1*a1 + l2*a2
        o12 = (acc1*a1 + acc2*a2) / l12
    """
    _check(q, k, v, bias)
    if bias is None:
        bias = torch.zeros((q.shape[0], k.shape[1]), dtype=torch.float32,
                           device=q.device)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias))):
        # No gradient wanted (serving): skip the autograd.Function's
        # per-call bookkeeping on the host.
        return _forward(q, k, v, bias, stats=return_stats)
    if return_stats:
        return _FlashAttentionStats.apply(q, k, v, bias)
    return _FlashAttention.apply(q, k, v, bias)
