"""Int8 quantization, ported from ``tpuserve/quantize.py``: weight-only
(``quantize = "int8"``: ``eligible``, ``quantize_leaf``, ``dequantize_tree``)
and int8 compute (``quantize = "int8c"``: ``int8_matmul``, ``Int8Dense``,
``Int8SelfAttention``'s projections, ``Int8Conv1x1``,
``dequantize_tree_except``).

Weight-only: every large floating-point weight is stored as int8 plus a
per-channel float32 scale and dequantized in the compute dtype inside the
forward (``q.to(dtype) * scale.to(dtype)``); the convolutions and matmuls
still compute in the compute dtype. Scheme: symmetric absmax per channel,
``scale = absmax / 127`` (1.0 for an all-zero channel), ``q = round(w /
scale)`` clipped to +-127. Small (< ``min_size`` elements), integer and
0/1-D leaves stay unquantized.

The channel is the one the reference picks *on its own leaf*: the last axis,
or the one before it when the last has size 1 (``ref_channel_axis``). The
port's parameters lie in other layouts, so each family says how a
parameter lies in the reference's tree (``ServingModel.reference_layout``):
a ``view`` of the parameter (a reshape that only splits axes) and the
permutation of the view's axes that gives the reference's leaf. By default a
4-D weight is OIHW (the reference's HWIO is ``(2, 3, 1, 0)`` of it) and a
2-D one an ``nn.Linear`` (out, in) (the reference's (in, out) Dense kernel is
its transpose): the output channel. BERT's q/k/v kernels are (D, heads,
head_dim) in the reference, so their channel is the head_dim index, one
scale shared by all heads; its embedding tables are (rows, d) in both, so
their channel is d. Eligibility is judged on the reference's shape too. So
the int8 values and scales equal the reference's ``quantize_tree`` leaf for
leaf; the port holds a scale broadcast to the parameter's layout (for q/k/v,
a (heads * head_dim, 1) column repeating the 64 scales per head).

``quantize_module`` swaps each eligible parameter of a module for its int8
values (a frozen parameter). A parameter named by one of the family's
``int8c_native_kernel_paths`` regexes, under ``int8c``, stays int8 with its
float32 scale as the ``weight_scale`` buffer of its module (an
``Int8Linear`` or ``Int8Conv1x1``, which then multiply int8 x int8 ->
int32 by ``int8_matmul``). Every other one goes under a
``torch.nn.utils.parametrize`` parametrization that holds the scale as a
buffer and dequantizes on every access: the forward reads ``module.weight``
as before, nothing is mutated per call, so concurrent forwards are safe.

``int8_matmul``'s product is ``torch._int_mm`` (cuBLASLt's int8 GEMM on the
card): the reference computes it with XLA's ``dot_general``, outside any
Pallas kernel. On the card ``_int_mm`` needs more than 16 rows and K and N
multiples of 8; rows are padded with zeros up to 17 where a bucket gives
fewer (a zero row quantizes to zeros and its output is dropped).
"""

from __future__ import annotations

import re
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from tpuserve_torch.models.layers import Conv

# Leaves smaller than this stay in the compute dtype.
DEFAULT_MIN_SIZE = 4096

# How a port parameter lies in the reference's tree: (view, perm) with
# ``reference leaf == param.reshape(view).permute(perm)``.
Layout = tuple[tuple[int, ...], tuple[int, ...]]

# ``torch._int_mm`` on CUDA takes only more rows than this.
_INT_MM_MIN_ROWS = 17


def default_layout(shape: tuple) -> Layout:
    """A conv weight (OIHW <- HWIO), an ``nn.Linear`` weight ((out, in) <- (in,
    out)) or a leaf of the same layout in both packages."""
    perm = {4: (2, 3, 1, 0), 2: (1, 0)}.get(len(shape), tuple(range(len(shape))))
    return tuple(shape), perm


def ref_channel_axis(shape: Sequence[int]) -> int:
    """The reference's per-channel axis of one of its leaves: the last axis,
    or the one before it when the last has size 1."""
    return len(shape) - 1 if shape[-1] > 1 else max(len(shape) - 2, 0)


def eligible(t: torch.Tensor, min_size: int = DEFAULT_MIN_SIZE,
             layout: Layout | None = None) -> bool:
    """True when a parameter should be quantized: floating, at least 2-D as
    the reference holds it, and at least ``min_size`` elements."""
    view = (layout or default_layout(tuple(t.shape)))[0]
    return t.is_floating_point() and len(view) >= 2 and t.numel() >= min_size


def _view_to_port_axes(shape: tuple, view: tuple) -> list[int]:
    """For each axis of ``view``, the axis of ``shape`` it splits out of
    (``view`` only splits axes of ``shape``)."""
    out, i, rem = [], 0, shape[0] if shape else 1
    for n in view:
        while rem == 1 and n != 1 and i + 1 < len(shape):
            i += 1
            rem = shape[i]
        if rem % n:
            raise ValueError(f"view {view} does not split shape {shape}")
        out.append(i)
        rem //= n
    return out


def quantize_leaf(w: torch.Tensor, layout: Layout | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 of ``w`` (its values taken as float32), on
    the reference's channel (``layout``; the default layout when None):
    ``(q int8 like w, scale float32 broadcastable to w)``. The scale keeps
    the size of the axis of ``w`` that holds the channel and 1 elsewhere."""
    w = w.detach().to(torch.float32)
    shape = tuple(w.shape)
    view, perm = layout or default_layout(shape)
    axis = perm[ref_channel_axis([view[p] for p in perm])]
    v = w.reshape(view)
    reduce = [i for i in range(len(view)) if i != axis]
    absmax = v.abs().amax(dim=reduce, keepdim=True)
    scale = absmax / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8).reshape(shape)
    if view != shape:
        of = _view_to_port_axes(shape, view)
        keep = of[axis]
        scale = scale.expand([n if of[i] == keep else 1 for i, n in enumerate(view)])
        scale = scale.reshape([n if d == keep else 1 for d, n in enumerate(shape)])
    return q, scale.contiguous()


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 values and their scale -> ``dtype``, multiplied in ``dtype``."""
    return q.to(dtype) * scale.to(dtype)


class Dequantize(nn.Module):
    """The parametrization of a quantized weight: holds the float32 scale
    (in the state_dict) and its cast to the compute dtype, made once so
    that ``dequantize``'s cast of it launches nothing; turns the int8
    original into the compute dtype on each access."""

    def __init__(self, scale: torch.Tensor, dtype: torch.dtype) -> None:
        super().__init__()
        self.register_buffer("scale", scale)
        self.register_buffer("scale_cast", scale.to(dtype), persistent=False)
        self.dtype = dtype

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return dequantize(q, self.scale_cast, self.dtype)


# -- int8 compute (quantize = "int8c") ---------------------------------------

def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row int8 of ``x`` (..., K): ``(xq int8, s_x float32 (..., 1))``
    with ``s_x = max(absmax over K, 1e-8) / 127``, rounding half to even."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1, keepdim=True)
    s_x = torch.clamp_min(amax, 1e-8) / 127.0
    return torch.clamp(torch.round(x32 / s_x), -127, 127).to(torch.int8), s_x


def int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32 (M, N) by ``torch._int_mm``, rows
    padded with zeros to its minimum where M is smaller."""
    m = xq.shape[0]
    if m < _INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    return torch._int_mm(xq, wq)[:m]


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """``x @ dequant(wq)`` computed as int8 x int8 -> int32: the reference's
    ``int8_matmul``. x (..., K) float; wq (K, N) int8 (a transposed view of
    an (N, K) weight is what cuBLASLt's int8 GEMM takes); w_scale: N float32
    scales in any shape. Dynamic per-row activation scale, so padded lanes
    cannot skew other rows; ``y * s_x * w_scale`` in float32, then the cast."""
    k = x.shape[-1]
    xq, s_x = quantize_activations(x)
    y = int_mm(xq.reshape(-1, k), wq).reshape(x.shape[:-1] + (wq.shape[1],))
    return (y.to(torch.float32) * s_x
            * w_scale.reshape(-1).to(torch.float32)).to(out_dtype)


class Int8Linear(nn.Linear):
    """``nn.Linear`` whose weight may arrive int8 (the reference's
    ``Int8Dense``, and the q/k/v/out projections of ``Int8SelfAttention``):
    with a ``weight_scale`` buffer set (``quantize_module`` under int8c) the
    product runs int8 x int8 -> int32 (``int8_matmul``) and the bias is added
    in the compute dtype; otherwise it is ``nn.Linear`` (a float or a
    weight-only dequantized weight)."""

    def __init__(self, cin: int, cout: int, bias: bool = True) -> None:
        super().__init__(cin, cout, bias=bias)
        self.register_buffer("weight_scale", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight_scale is None:
            return super().forward(x)
        y = int8_matmul(x, self.weight.t(), self.weight_scale, x.dtype)
        return y if self.bias is None else y + self.bias


class Int8Conv1x1(Conv):
    """A 1x1 ``Conv`` (no bias) whose weight may arrive int8 (the reference's
    ``Int8Conv1x1``): with ``weight_scale`` set, a strided 1x1 is the spatial
    slice ``x[..., ::s, ::s]`` (output (i, j) reads input (i*s, j*s); flax's
    "SAME" pads nothing for a 1x1), then ``int8_matmul`` over the channel
    axis of the (B*H*W, C) rows, contiguous under channels_last; otherwise
    it is ``Conv``."""

    def __init__(self, cin: int, cout: int, stride: int = 1) -> None:
        super().__init__(cin, cout, 1, stride)
        self.register_buffer("weight_scale", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight_scale is None:
            return super().forward(x)
        if self.stride != 1:
            x = x[:, :, ::self.stride, ::self.stride]
        rows = x.permute(0, 2, 3, 1)                      # (B, H, W, C)
        w = self.weight.reshape(self.weight.shape[0], -1)  # (N, C)
        y = int8_matmul(rows, w.t(), self.weight_scale, x.dtype)
        return y.permute(0, 3, 1, 2)                      # NCHW, channels_last memory


def quantize_module(module: nn.Module, dtype: torch.dtype,
                    min_size: int = DEFAULT_MIN_SIZE,
                    layout: Callable[[str, tuple], Layout] | None = None,
                    native: Sequence[str] = ()) -> list[str]:
    """Quantize every eligible parameter of ``module`` in place (see the
    module docstring); returns their names. ``layout(name, shape)`` says how
    a parameter lies in the reference's tree (default: ``default_layout``).
    A parameter whose name matches one of the ``native`` regexes stays int8
    with its scale as its module's ``weight_scale``; the rest dequantize on
    access. Call it after the cast to the compute dtype, as the reference
    quantizes the cast weights, and move the module to its device afterwards
    without a dtype, so the scales stay float32."""
    pats = [re.compile(p) for p in native]
    done = []
    for mod_name, mod in list(module.named_modules()):
        for name, p in list(mod.named_parameters(recurse=False)):
            full = f"{mod_name}.{name}" if mod_name else name
            lay = layout(full, tuple(p.shape)) if layout else None
            if not eligible(p, min_size, lay):
                continue
            q, scale = quantize_leaf(p, lay)
            setattr(mod, name, nn.Parameter(q, requires_grad=False))
            if any(pat.search(full) for pat in pats):
                if name != "weight" or not isinstance(mod, (Int8Linear, Int8Conv1x1)):
                    raise ValueError(f"{full} is named int8-native but its module "
                                     f"{type(mod).__name__} does not compute in int8")
                mod.weight_scale = scale
            else:
                parametrize.register_parametrization(mod, name, Dequantize(scale, dtype),
                                                     unsafe=True)
            done.append(full)
    return done


def dequantized_state_dict(module: nn.Module) -> dict[str, torch.Tensor]:
    """``module``'s weights as its forward sees them under weight-only int8:
    quantized ones dequantized, under their unquantized names (a state_dict
    that loads into an unquantized twin of the module)."""
    out = {k: t for k, t in module.state_dict().items()
           if "parametrizations." not in k}
    for mod_name, mod in module.named_modules():
        if parametrize.is_parametrized(mod):
            for name in mod.parametrizations:
                key = f"{mod_name}.{name}" if mod_name else name
                out[key] = getattr(mod, name).detach()
    return out
