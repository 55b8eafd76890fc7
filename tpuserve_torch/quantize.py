"""Weight-only int8 quantization (``quantize = "int8"``), ported from
``tpuserve/quantize.py`` (its ``eligible``, ``quantize_leaf`` and
``dequantize_tree``).

Every large floating-point weight is stored as int8 plus a per-output-channel
float32 scale and dequantized in the compute dtype inside the forward
(``q.to(dtype) * scale.to(dtype)``); the convolutions and matmuls still
compute in the compute dtype. Scheme: symmetric absmax per output channel,
``scale = absmax / 127`` (1.0 for an all-zero channel), ``q = round(w /
scale)`` clipped to +-127. Small (< ``min_size`` elements), integer and 0/1-D
leaves stay unquantized.

The channel axis is the output channel. The reference's leaves are HWIO conv
kernels and (in, out) Dense kernels, whose output channel is the last axis;
the port's are OIHW conv weights and (out, in) ``Linear`` weights, whose
output channel is the first — and where that axis has size 1 both take the
next one (the reference's depthwise rule). So the same leaves quantize to the
same values in both layouts.

``quantize_module`` swaps each eligible parameter of a module for its int8
values (a frozen parameter) under a ``torch.nn.utils.parametrize``
parametrization that holds the scale as a buffer and dequantizes on every
access: the forward reads ``module.weight`` as before, nothing is mutated
per call, so concurrent forwards are safe. The reference's int8-compute
path (``quantize = "int8c"``: ``Int8Dense``, ``Int8Conv1x1``) is not ported
yet.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize

# Leaves smaller than this stay in the compute dtype.
DEFAULT_MIN_SIZE = 4096


def channel_axis(shape: tuple) -> int:
    """The per-channel axis of a port-layout weight: the output channel
    (axis 0), or axis 1 when the output channel has size 1."""
    return 0 if shape[0] > 1 or len(shape) < 2 else 1


def eligible(t: torch.Tensor, min_size: int = DEFAULT_MIN_SIZE) -> bool:
    """True when a parameter should be quantized."""
    return t.is_floating_point() and t.dim() >= 2 and t.numel() >= min_size


def quantize_leaf(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 of ``w`` (its values taken as float32):
    ``(q int8 like w, scale float32 with w's rank, 1 off the channel axis)``."""
    w = w.detach().to(torch.float32)
    axis = channel_axis(tuple(w.shape))
    reduce = [i for i in range(w.dim()) if i != axis]
    absmax = w.abs().amax(dim=reduce, keepdim=True)
    scale = absmax / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


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


def quantize_module(module: nn.Module, dtype: torch.dtype,
                    min_size: int = DEFAULT_MIN_SIZE) -> list[str]:
    """Quantize every eligible parameter of ``module`` in place (see the
    module docstring); returns their names. Call it after the cast to the
    compute dtype, as the reference quantizes the cast weights, and move the
    module to its device afterwards without a dtype, so the scales stay
    float32."""
    done = []
    for mod_name, mod in list(module.named_modules()):
        for name, p in list(mod.named_parameters(recurse=False)):
            if not eligible(p, min_size):
                continue
            q, scale = quantize_leaf(p)
            setattr(mod, name, nn.Parameter(q, requires_grad=False))
            parametrize.register_parametrization(mod, name, Dequantize(scale, dtype),
                                                 unsafe=True)
            done.append(f"{mod_name}.{name}" if mod_name else name)
    return done


def dequantized_state_dict(module: nn.Module) -> dict[str, torch.Tensor]:
    """``module``'s weights as its forward sees them: quantized ones
    dequantized, under their unquantized names (a state_dict that loads into
    an unquantized twin of the module)."""
    out = {k: t for k, t in module.state_dict().items()
           if "parametrizations." not in k}
    for mod_name, mod in module.named_modules():
        if parametrize.is_parametrized(mod):
            for name in mod.parametrizations:
                key = f"{mod_name}.{name}" if mod_name else name
                out[key] = getattr(mod, name).detach()
    return out
