"""Layers and weight conversion shared by the port's convolutional families
(``resnet.py``, ``mobilenet.py``, ``efficientdet.py``).

- ``Conv``: a 2-D convolution with flax's ``"SAME"`` padding computed from
  the input size at run time (``_same_padding``: ``total = max((ceil(in /
  s) - 1) * s + k - in, 0)``, ``lo = total // 2``, ``hi = total - lo``), so
  a stride-2 3x3 on an even input pads (0, 1) and a stride-2 5x5 pads
  (1, 2), not PyTorch's symmetric ``k // 2``; or an explicit symmetric
  padding. ``groups = C`` is flax's ``feature_group_count = C`` (a
  depthwise convolution); ``bias`` adds flax's ``use_bias``.
- ``BatchNorm``: the inference affine in flax's order, ``y = (x - mean) *
  (rsqrt(var + eps) * scale) + bias`` in the compute dtype, not folded into
  the conv weights (under int8 a fold would quantize another tensor).
- ``from_jax_params`` / ``to_jax_params``: the reference's ``{"params",
  "batch_stats"}`` tree <-> a module's float32 state_dict, for any module
  whose submodules carry the reference's flax names. Conv kernels HWIO <->
  OIHW (a depthwise kernel (kh, kw, 1, C) <-> (C, 1, kh, kw), the same
  permutation), Dense kernels (in, out) <-> ``Linear.weight`` (out, in),
  BatchNorm ``scale``/``bias`` <-> ``weight``/``bias`` and ``batch_stats``
  ``mean``/``var`` <-> ``running_mean``/``running_var``; any other leaf
  (EfficientDet's fusion weights ``w_td{l}``) keeps its name and values.
- ``seeded_state_dict``: a seeded init with the reference's initializer
  families (it cannot reproduce jax.random's bits): LeCun-normal kernels,
  zero biases, BatchNorm at identity.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _same_padding(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding (lo, hi) of one spatial dim."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2-D convolution with flax's padding: "SAME" when ``padding`` is None,
    else the given symmetric padding; ``groups`` input groups (``cin`` for
    a depthwise convolution) and an optional bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int | None = None, groups: int = 1,
                 bias: bool = False) -> None:
        super().__init__()
        self.k, self.stride, self.padding, self.groups = k, stride, padding, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.padding
        if pad is None:
            (ht, hb), (wl, wr) = (_same_padding(n, self.k, self.stride) for n in x.shape[-2:])
            if ht == hb and wl == wr:
                pad = (ht, wl)
            else:
                x = F.pad(x, (wl, wr, ht, hb))
                pad = 0
        return F.conv2d(x, self.weight, self.bias, stride=self.stride, padding=pad,
                        groups=self.groups)


class BatchNorm(nn.Module):
    """Inference BatchNorm over the channel dim in flax's order of ops."""

    def __init__(self, c: int, eps: float) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x - self.running_mean.view(shape)) * mul.view(shape)
        return y + self.bias.view(shape)


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """The reference's ``{"params", "batch_stats"}`` tree (numpy or jax
    leaves) -> the float32 state_dict of the module with the same names."""
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    sd: dict[str, torch.Tensor] = {}

    def walk(node, prefix: str) -> None:
        for key, val in node.items():
            if hasattr(val, "items"):          # a sub-tree
                walk(val, f"{prefix}{key}.")
                continue
            t = torch.from_numpy(np.array(val, dtype=np.float32))
            if key == "kernel":
                t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.T
            sd[prefix + names.get(key, key)] = t.contiguous()

    walk(tree["params"], "")
    walk(tree.get("batch_stats", {}), "")
    return sd


def to_jax_params(state_dict: dict[str, torch.Tensor]) -> dict:
    """A float32 state_dict -> the reference's ``{"params", "batch_stats"}``
    tree of numpy arrays: ``from_jax_params`` inverted, bit for bit (OIHW ->
    HWIO, ``Linear.weight`` -> (in, out), 1-D weights -> BatchNorm
    ``scale``, running statistics -> ``batch_stats``)."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for name, v in state_dict.items():
        t = v.detach().to(torch.float32).cpu()
        *mods, leaf = name.split(".")
        root = tree["params"]
        if leaf in ("running_mean", "running_var"):
            root, key = tree["batch_stats"], leaf[len("running_"):]
        elif leaf == "weight" and t.dim() >= 2:
            key = "kernel"
            t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.T
        else:
            key = "scale" if leaf == "weight" else leaf
        node = root
        for m in mods:
            node = node.setdefault(m, {})
        node[key] = t.contiguous().numpy()
    return tree


def seeded_state_dict(build_module: Callable[[], nn.Module],
                      seed: int) -> dict[str, torch.Tensor]:
    """A float32 state_dict for ``build_module()`` from a numpy seed:
    LeCun-normal kernels (fan-in = every dim but the output one), zero
    biases, BatchNorm at identity (scale 1, bias 0, mean 0, var 1)."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in build_module().state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        if len(shape) >= 2:                    # conv OIHW or dense (out, in)
            fan_in = int(np.prod(shape[1:]))
            x = rng.normal(0.0, fan_in ** -0.5, shape)
        elif name.endswith(("weight", "running_var")):
            x = np.ones(shape)
        else:
            x = np.zeros(shape)
        sd[name] = torch.from_numpy(x.astype(np.float32))
    return sd
