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

A checkpoint may hold the weights already quantized (``import-model
--quantize int8``): the reference's tree with a ``{"q8", "q8_scale"}``
sub-tree in place of each quantized leaf (``quantize_tree``, the
reference's numpy function, copied). ``prequantized_leaves`` carries such
a tree through the family's ``from_jax_params`` into port parameter names,
int8 values and scales, and ``quantize_module(..., given=...)`` installs
them through the same parametrization (or ``weight_scale`` under int8c) as
stage-time quantization; a float leaf left in the tree is quantized at
stage time when eligible, as the reference's idempotent ``quantize_tree``
does. Quantizing the float tree at stage time and loading its
pre-quantized form give the same int8 bytes and scales wherever both see
the same float values (the reference quantizes the weights cast to the
compute dtype at stage time and the float32 ones at import, so under bf16
the two agree for a tree whose floats are bf16 values). Under tensor
parallelism the tree is quantized whole and then split
(``specs_for_tree``: the int8 values take the weight's spec, the scale the
spec entry of its channel axis), so each rank's scales are the whole
weight's.

``int8_matmul``'s product is ``torch._int_mm`` (cuBLASLt's int8 GEMM on the
card): the reference computes it with XLA's ``dot_general``, outside any
Pallas kernel. On the card ``_int_mm`` needs more than 16 rows and K and N
multiples of 8; rows are padded with zeros up to 17 where a bucket gives
fewer (a zero row quantizes to zeros and its output is dropped).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from tpuserve_torch.models.layers import Conv

# Leaves smaller than this stay in the compute dtype.
DEFAULT_MIN_SIZE = 4096

# Marker keys for a quantized leaf's sub-tree in the reference's tree.
QKEY = "q8"
SKEY = "q8_scale"

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


def scale_shape(shape: tuple, layout: Layout | None = None) -> tuple:
    """The shape of ``quantize_leaf``'s scale for a parameter of ``shape``:
    the size of the axis holding the reference's channel, 1 elsewhere."""
    view, perm = layout or default_layout(tuple(shape))
    axis = perm[ref_channel_axis([view[p] for p in perm])]
    if tuple(view) == tuple(shape):
        return tuple(n if i == axis else 1 for i, n in enumerate(shape))
    keep = _view_to_port_axes(tuple(shape), tuple(view))[axis]
    return tuple(n if d == keep else 1 for d, n in enumerate(shape))


# -- the reference's quantized tree (tpuserve.quantize, numpy) ------------------

def _tree_channel_axis(shape: tuple) -> int:
    return len(shape) - 1 if shape[-1] > 1 else max(len(shape) - 2, 0)


def eligible_leaf(leaf: Any, min_size: int = DEFAULT_MIN_SIZE) -> bool:
    """True when a leaf of the reference's tree should be quantized:
    floating, at least 2-D, at least ``min_size`` elements."""
    a = np.asarray(leaf)
    return (np.issubdtype(a.dtype, np.floating) and a.ndim >= 2
            and a.size >= min_size)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and QKEY in leaf and SKEY in leaf


def quantize_tree_leaf(w: Any) -> dict[str, np.ndarray]:
    """Symmetric per-channel int8 of one reference leaf:
    {"q8": int8 like w, "q8_scale": float32 with w's rank}."""
    w = np.asarray(w, dtype=np.float32)
    axis = _tree_channel_axis(w.shape)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    absmax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = (absmax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, np.float32(1.0), scale)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {QKEY: q, SKEY: scale}


def _map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of a nested-dict tree, a quantized sub-tree
    taken as one leaf."""
    if isinstance(tree, dict) and not is_quantized(tree):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def quantize_tree(params: Any, min_size: int = DEFAULT_MIN_SIZE) -> Any:
    """Replace every eligible leaf of the reference's tree with its
    {"q8", "q8_scale"} sub-tree; already-quantized sub-trees pass through
    (idempotent, so a pre-quantized checkpoint is never re-quantized)."""
    return _map_tree(lambda x: x if is_quantized(x)
                     else (quantize_tree_leaf(x) if eligible_leaf(x, min_size) else x),
                     params)


def has_quantized_leaves(tree: Any) -> bool:
    if is_quantized(tree):
        return True
    return isinstance(tree, dict) and any(has_quantized_leaves(v) for v in tree.values())


def specs_for_tree(rules: list, tree: Any) -> Any:
    """The partition rules' specs over a possibly-quantized tree: a
    quantized sub-tree matches at its weight's path, its int8 values take
    the matched spec and its scale the spec entry of its channel axis."""
    from tpuserve_torch.parallel.partition import P, spec_for_name

    def walk(prefix: str, node: Any) -> Any:
        if isinstance(node, dict) and not is_quantized(node):
            return {k: walk(f"{prefix}/{k}" if prefix else str(k), v) for k, v in node.items()}
        if is_quantized(node):
            w = node[QKEY]
            spec = spec_for_name(rules, prefix, w.shape)
            axis = _tree_channel_axis(w.shape)
            full = tuple(spec) + (None,) * (w.ndim - len(spec))
            return {QKEY: spec,
                    SKEY: P(*[full[i] if i == axis else None for i in range(w.ndim)])}
        return spec_for_name(rules, prefix, tuple(np.shape(node)))

    return walk("", tree)


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """The reference's load-time cast: every float leaf rounded to the
    compute dtype (kept as float32 numpy, exact), quantized sub-trees as
    saved."""
    def cast(x):
        if is_quantized(x):
            return x
        a = np.asarray(x)
        if not np.issubdtype(a.dtype, np.floating):
            return a
        return torch.from_numpy(np.array(a, np.float32)).to(dtype).float().numpy()

    return _map_tree(cast, tree)


def prequantized_leaves(tree: Any, convert: Callable[[Any], dict],
                        layout: Callable[[str, tuple], Layout] | None = None
                        ) -> tuple[dict[str, torch.Tensor], dict]:
    """A tree with quantized sub-trees -> ``(state_dict, given)`` in the
    port's names: ``convert`` (the family's ``from_jax_params``) maps the
    int8 values (as float32, exact) and, separately, each scale broadcast
    to its weight's shape, so both land in the port's layout by the same
    reshapes; ``given`` maps each quantized parameter's name to its int8
    values and its scale in ``quantize_leaf``'s shape. The state_dict holds
    the float leaves as they are and the int8 values as floats (replaced
    by ``quantize_module``)."""
    values = convert(_map_tree(
        lambda x: np.asarray(x[QKEY], np.float32) if is_quantized(x) else x, tree))
    scales = convert(_map_tree(
        lambda x: (np.broadcast_to(np.asarray(x[SKEY], np.float32), x[QKEY].shape)
                   if is_quantized(x) else np.zeros(np.shape(x), np.float32)), tree))
    given = {}
    for name, full in scales.items():
        if full.numel() == 0 or float(full.reshape(-1)[0]) == 0.0:
            continue  # not a quantized leaf (a scale is never 0)
        shape = tuple(full.shape)
        lay = layout(name, shape) if layout else None
        ss = scale_shape(shape, lay)
        index = tuple(slice(None) if n > 1 else slice(0, 1) for n in ss)
        given[name] = (values[name].round().to(torch.int8),
                       full[index].reshape(ss).contiguous())
    return values, given


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

def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    """The per-row activation scale of a row's absmax: max(absmax, 1e-8) / 127."""
    return torch.clamp_min(amax, 1e-8) / 127.0


def quantize_activations(x: torch.Tensor, s_x: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row int8 of ``x`` (..., K): ``(xq int8, s_x float32 (..., 1))``
    with ``s_x = max(absmax over K, 1e-8) / 127``, rounding half to even.
    ``s_x`` given: that scale (a tensor-parallel rank holding a block of K
    quantizes with the whole row's, as the reference's partitioned
    ``int8_matmul`` does)."""
    x32 = x.to(torch.float32)
    if s_x is None:
        s_x = activation_scale(x32.abs().amax(dim=-1, keepdim=True))
    return torch.clamp(torch.round(x32 / s_x), -127, 127).to(torch.int8), s_x


def int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32 (M, N) by ``torch._int_mm``, rows
    padded with zeros to its minimum where M is smaller."""
    m = xq.shape[0]
    if m < _INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    return torch._int_mm(xq, wq)[:m]


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype, s_x: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ dequant(wq)`` computed as int8 x int8 -> int32: the reference's
    ``int8_matmul``. x (..., K) float; wq (K, N) int8 (a transposed view of
    an (N, K) weight is what cuBLASLt's int8 GEMM takes); w_scale: N float32
    scales in any shape. Dynamic per-row activation scale, so padded lanes
    cannot skew other rows; ``y * s_x * w_scale`` in float32, then the cast."""
    k = x.shape[-1]
    xq, s_x = quantize_activations(x, s_x)
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

    def forward(self, x: torch.Tensor, s_x: torch.Tensor | None = None) -> torch.Tensor:
        """``s_x``: the activation scale to quantize ``x`` with under int8c
        (``int8_matmul``); ignored otherwise."""
        if self.weight_scale is None:
            return super().forward(x)
        y = int8_matmul(x, self.weight.t(), self.weight_scale, x.dtype, s_x)
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
                    native: Sequence[str] = (),
                    given: dict | None = None) -> list[str]:
    """Quantize every eligible parameter of ``module`` in place (see the
    module docstring); returns their names. ``layout(name, shape)`` says how
    a parameter lies in the reference's tree (default: ``default_layout``).
    ``given`` maps names to int8 values and scales already made (a
    pre-quantized checkpoint, ``prequantized_leaves``): those are installed
    as they are, whatever ``min_size`` says. A parameter whose name matches
    one of the ``native`` regexes stays int8 with its scale as its module's
    ``weight_scale``; the rest dequantize on access. Call it after the cast
    to the compute dtype, as the reference quantizes the cast weights, and
    move the module to its device afterwards without a dtype, so the scales
    stay float32."""
    pats = [re.compile(p) for p in native]
    given = given or {}
    done = []
    for mod_name, mod in list(module.named_modules()):
        for name, p in list(mod.named_parameters(recurse=False)):
            full = f"{mod_name}.{name}" if mod_name else name
            lay = layout(full, tuple(p.shape)) if layout else None
            if full in given:
                q, scale = given[full]
            elif eligible(p, min_size, lay):
                q, scale = quantize_leaf(p, lay)
            else:
                continue
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
