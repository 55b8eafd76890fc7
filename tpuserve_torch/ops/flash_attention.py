"""Fused (flash) attention: the port of ``tpuserve/ops/flash_attention.py``.

``flash_attention(q, k, v, bias)`` computes ``softmax(q.k^T * D^-1/2 + bias).v``
in the reference's (B, S, H, D) layout, with an optional additive per-key
bias (B, Sk) — what BERT's padding mask lowers to (padded keys get -1e9).

Dispatch is by the tensors' device, never by a fallback:

- CUDA tensors launch kernel K1, ``csrc/flash_attention.cu`` (the hand-written
  Hopper replacement of the Pallas ``_fa_kernel``). The library is built with
  ``nvcc`` at the first launch (``tpuserve_torch.ops._build``). A shape,
  dtype or layout the kernel does not take, a failed build or a refused
  launch raises.
- CPU tensors take ``flash_attention_reference``, the plain PyTorch version
  of the same function (the twin of the reference's ``_dense_stats``): f32
  scores, f32 softmax, f32 P.V, output cast to q's dtype.

``launches`` counts kernel launches (one per call on CUDA tensors, none on the
CPU), so a run can show that its main path went through the kernel.

Gradients: a ``torch.autograd.Function`` whose backward recomputes through the
plain version, as the reference's ``_flash_bwd`` does through ``_dense_stats``
(training through flash pays the dense O(S^2) memory on backward only).

Not ported yet: ``return_stats=True`` (kernel K2, ``_fa_kernel_stats``, the
local step of ring attention; ROADMAP.md queue 2).
"""

from __future__ import annotations

import ctypes
import threading

import torch

# Launches of kernel K1 since process start (or since a caller reset it to 0).
# Batches dispatch from several pipeline threads, so the increment is locked.
launches = 0
_launches_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fn = None


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


def _kernel_fn():
    global _fn
    if _fn is None:
        from tpuserve_torch.ops import _build

        fn = _build.load("flash_attention").tpuserve_flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        _fn = fn
    return _fn


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
            bias: torch.Tensor) -> torch.Tensor:
    """Run K1 on q's CUDA device and PyTorch's current stream."""
    global launches
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("K1 takes float32, bfloat16 or float16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"K1 takes a head dim that is a multiple of 8 up to 128, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"K1's grid holds at most 65535 batches and heads, got B={b}, H={h}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("K1 needs the head dim of q, k and v contiguous (stride 1)")
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), out.data_ptr(),
        b, sq, sk, h, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        bias.stride(0),
        d ** -0.5, _DTYPE_CODES[q.dtype], q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err} "
                           f"(q {tuple(q.shape)} {q.dtype}, Sk {sk})")
    with _launches_lock:
        launches += 1
    return out


def _forward(q, k, v, bias):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias)
    if q.device.type == "cuda":
        return _launch(q, k, v, bias)
    raise ValueError(f"flash_attention runs on CUDA (kernel) or CPU (plain version), "
                     f"not on {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Kernel forward, dense-recompute backward (the reference's VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):  # noqa: ANN001, ANN205
        ctx.save_for_backward(q, k, v, bias)
        return _forward(q, k, v, bias)

    @staticmethod
    def backward(ctx, grad_out):  # noqa: ANN001, ANN205
        q, k, v, bias = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((q, k, v, bias), ctx.needs_input_grad)]
        with torch.enable_grad():
            out = flash_attention_reference(*inputs)
        wanted = [t for t, need in zip(inputs, ctx.needs_input_grad) if need]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return tuple(next(grads) if need else None for need in ctx.needs_input_grad)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Blockwise fused attention, (B, S, H, D) in and out, output in q's
    dtype. ``bias``: optional additive per-key scores (B, Sk), e.g. a padding
    mask's (1 - mask) * -1e9. Differentiable in q, k, v and bias."""
    _check(q, k, v, bias)
    if bias is None:
        bias = torch.zeros((q.shape[0], k.shape[1]), dtype=torch.float32,
                           device=q.device)
    return _FlashAttention.apply(q, k, v, bias)
