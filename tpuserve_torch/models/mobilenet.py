"""MobileNetV3-Large classifier, ported from ``tpuserve/models/mobilenet.py``
(BASELINE.json config 2, "batch=1 latency-optimized").

Architecture: MobileNetV3-Large (Howard et al. 2019): hard-swish/ReLU
inverted-residual blocks with optional squeeze-excite, 5x5 depthwise
convolutions in the later stages, a 960 -> 1280 head. The serving plumbing
(wire formats, preprocessing in front of the network and softmax + top-k
behind it on the device) is ``models/vision.py``'s, as for ResNet-50.

The reference is NHWC flax; the port is NCHW-logical with
``torch.channels_last`` memory, so cuDNN's convolutions (the depthwise ones
included) read the same NHWC bytes. Kept from the reference, exactly:

- flax's ``"SAME"`` padding for every convolution (``layers.Conv``): the
  stem and the stride-2 3x3 depthwise convolutions pad (0, 1), the stride-2
  5x5 ones (1, 2);
- BatchNorm's epsilon 1e-3 (not ResNet's 1e-5), in flax's order of ops;
- biases on the squeeze-excite 1x1 convolutions and the two dense layers
  only;
- the float32 classifier: the pooled, hard-swished 1280 features and its
  (compute-dtype) weights are promoted to float32 for the matmul, as
  ``nn.Dense(dtype=jnp.float32)`` does.

``hard_sigmoid`` and ``hard_swish`` are ``F.hardsigmoid`` and
``F.hardswish``: the reference's ``relu6(x + 3) / 6`` (times x), computed
in one kernel each; in bf16 the port rounds once where the reference rounds
after each op.

Submodules carry the reference's flax names (``stem``, ``bn_stem``,
``block{i}.expand`` / ``bn_expand`` / ``depthwise`` / ``bn_dw`` /
``se.reduce`` / ``se.expand`` / ``project`` / ``bn_project``,
``head_conv``, ``bn_head``, ``pre_logits``, ``classifier``), so
``layers.from_jax_params`` and ``layers.to_jax_params`` carry the
reference's ``{"params", "batch_stats"}`` tree across; a depthwise kernel
(kh, kw, 1, C) becomes (C, 1, kh, kw) under the same HWIO -> OIHW
permutation as every other kernel. The reference's Keras import
(``import_tf_variables``) is not ported: it needs Keras weights the repo
does not hold.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models.layers import (BatchNorm, Conv, from_jax_params,
                                          seeded_state_dict, to_jax_params)
from tpuserve_torch.models.vision import ImageClassifierServing


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.hardsigmoid(x)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return F.hardswish(x)


def _divisible(v: float, d: int = 8) -> int:
    out = max(d, int(v + d / 2) // d * d)
    if out < 0.9 * v:
        out += d
    return out


# (kernel, expanded, out, use_se, use_hs, stride) — MobileNetV3-Large table.
V3_LARGE: tuple = (
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        mid = _divisible(channels / 4)
        self.reduce = Conv(channels, mid, 1, bias=True)
        self.expand = Conv(mid, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.relu(self.reduce(s))
        return x * hard_sigmoid(self.expand(s))


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, kernel: int, expanded: int, out: int,
                 use_se: bool, use_hs: bool, stride: int, bn_eps: float = 1e-3) -> None:
        super().__init__()
        self.act = hard_swish if use_hs else F.relu
        self.has_expand = expanded != inp
        if self.has_expand:
            self.expand = Conv(inp, expanded, 1)
            self.bn_expand = BatchNorm(expanded, bn_eps)
        self.depthwise = Conv(expanded, expanded, kernel, stride, groups=expanded)
        self.bn_dw = BatchNorm(expanded, bn_eps)
        self.se = SqueezeExcite(expanded) if use_se else None
        self.project = Conv(expanded, out, 1)
        self.bn_project = BatchNorm(out, bn_eps)
        self.residual = stride == 1 and inp == out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.has_expand:
            h = self.act(self.bn_expand(self.expand(h)))
        h = self.act(self.bn_dw(self.depthwise(h)))
        if self.se is not None:
            h = self.se(h)
        h = self.bn_project(self.project(h))
        return h + x if self.residual else h


class MobileNetV3Large(nn.Module):
    def __init__(self, num_classes: int = 1000, blocks: Sequence = V3_LARGE,
                 bn_eps: float = 1e-3) -> None:
        super().__init__()
        self.stem = Conv(3, 16, 3, 2)
        self.bn_stem = BatchNorm(16, bn_eps)
        self.blocks = []
        inp = 16
        for i, spec in enumerate(blocks):
            self.add_module(f"block{i}", InvertedResidual(inp, *spec, bn_eps=bn_eps))
            self.blocks.append(f"block{i}")
            inp = spec[2]
        last = blocks[-1][1]  # 960
        self.head_conv = Conv(inp, last, 1)
        self.bn_head = BatchNorm(last, bn_eps)
        self.pre_logits = nn.Linear(last, 1280)
        self.classifier = nn.Linear(1280, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = hard_swish(self.bn_stem(self.stem(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = hard_swish(self.bn_head(self.head_conv(x)))
        x = x.mean(dim=(2, 3))
        x = hard_swish(self.pre_logits(x))
        return F.linear(x.float(), self.classifier.weight.float(),
                        self.classifier.bias.float())


class MobileNetV3Serving(ImageClassifierServing):
    def build_module(self) -> MobileNetV3Large:
        return MobileNetV3Large(num_classes=self.cfg.num_classes)

    def from_jax_params(self, tree) -> dict[str, torch.Tensor]:
        return from_jax_params(tree)

    def to_jax_params(self, state_dict: dict[str, torch.Tensor]) -> dict:
        return to_jax_params(state_dict)

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        return seeded_state_dict(self.build_module, seed)


def create(cfg: ModelConfig) -> MobileNetV3Serving:
    return MobileNetV3Serving(cfg)
