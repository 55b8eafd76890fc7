"""ResNet-50 ImageNet classifier, ported from ``tpuserve/models/resnet.py``.

The reference is NHWC flax; the port is NCHW-logical with
``torch.channels_last`` memory, so cuDNN's convolutions read the same NHWC
bytes. Preprocessing runs in front of the network and softmax + top-k behind
it, on the device (``models/vision.py``).

Architecture: the standard bottleneck ResNet, ``stage_sizes`` (3, 4, 6, 3),
with ``options.v1_downsample`` choosing the stride-2 conv of a stage's first
block — False (default): v1.5 / torchvision, stride 2 on the 3x3 (conv2);
True: original v1 / Keras, stride 2 on the first 1x1 (conv1) — and
``options.bn_eps`` (Keras uses 1.001e-5). ``ResNet`` takes other
``stage_sizes``; the served model, like the reference, always builds
(3, 4, 6, 3).

Kept from the reference, exactly:

- flax's ``"SAME"`` padding, computed from the input size at run time:
  ``total = max((ceil(in / s) - 1) * s + k - in, 0)`` split ``lo = total //
  2``, ``hi = total - lo``, so a 3x3 stride-2 conv on an even input pads
  (0, 1), not (1, 1) (``_same_padding``); the stem and the max pool keep
  their explicit symmetric padding (3 and 1; the pool pads with -inf);
- BatchNorm as the inference affine in flax's order, ``y = (x - mean) *
  (rsqrt(var + eps) * scale) + bias`` in the compute dtype, not folded into
  the conv weights (under int8 a fold would quantize another tensor);
- a float32 head: the pooled features and the (possibly dequantized) head
  weights are promoted to float32 for the matmul, as ``nn.Dense(dtype=
  jnp.float32)`` does.

Under ``quantize = "int8c"`` the bottleneck 1x1 convolutions (``conv1``,
``conv3``, ``proj_conv``: ``quantize.Int8Conv1x1``) multiply int8 x int8 ->
int32, a strided one as a spatial slice first, as the reference's
``Int8Conv1x1``; the 3x3 and 7x7 convolutions and the head stay on the
weight-only path.

``from_jax_params`` converts the reference's ``{"params", "batch_stats"}``
tree (numpy leaves) into this module's float32 state_dict; that is how the
tests hold the port to the JAX package on the same weights.
``to_jax_params`` converts back, so a ``.npz`` checkpoint of that tree can
be written from the port's own seeded init.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models.layers import (BatchNorm, Conv, from_jax_params,
                                          seeded_state_dict, to_jax_params)
from tpuserve_torch.models.vision import ImageClassifierServing
from tpuserve_torch.quantize import Int8Conv1x1


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, projection: bool = False,
                 v1_downsample: bool = False, bn_eps: float = 1e-5) -> None:
        super().__init__()
        s1, s2 = (stride, 1) if v1_downsample else (1, stride)
        cout = features * 4
        self.conv1 = Int8Conv1x1(cin, features, s1)
        self.bn1 = BatchNorm(features, bn_eps)
        self.conv2 = Conv(features, features, 3, s2)
        self.bn2 = BatchNorm(features, bn_eps)
        self.conv3 = Int8Conv1x1(features, cout)
        self.bn3 = BatchNorm(cout, bn_eps)
        if projection:
            self.proj_conv = Int8Conv1x1(cin, cout, stride)
            self.proj_bn = BatchNorm(cout, bn_eps)
        self.projection = projection

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.proj_bn(self.proj_conv(x)) if self.projection else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Submodules are named as the reference's flax modules (``stem_conv``,
    ``stage1_block1.conv1``, ``head``, ...)."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), num_classes: int = 1000,
                 v1_downsample: bool = False, bn_eps: float = 1e-5) -> None:
        super().__init__()
        self.stem_conv = Conv(3, 64, 7, 2, padding=3)
        self.stem_bn = BatchNorm(64, bn_eps)
        self.blocks = []
        cin = 64
        for i, n_blocks in enumerate(stage_sizes):
            features = 64 * 2**i
            for j in range(n_blocks):
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, Bottleneck(
                    cin, features, stride=2 if i > 0 and j == 0 else 1,
                    projection=j == 0, v1_downsample=v1_downsample, bn_eps=bn_eps))
                self.blocks.append(name)
                cin = features * 4
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.head.weight.float(), self.head.bias.float())


class ResNet50Serving(ImageClassifierServing):
    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__(cfg)
        opt = cfg.options
        self.v1_downsample = bool(opt.get("v1_downsample", False))
        self.bn_eps = float(opt.get("bn_eps", 1e-5))

    def build_module(self) -> ResNet:
        return ResNet((3, 4, 6, 3), self.cfg.num_classes, self.v1_downsample, self.bn_eps)

    def int8c_native_kernel_paths(self) -> list[str]:
        """The bottleneck 1x1 convolutions (``Int8Conv1x1``) consume their
        weights int8 under int8c; the 3x3 and 7x7 convolutions and the head
        stay on the weight-only dequantization path (the reference's
        ``(conv1|conv3|proj_conv)/kernel$``)."""
        return [r"(conv1|conv3|proj_conv)\.weight$"]

    def from_jax_params(self, tree) -> dict[str, torch.Tensor]:
        return from_jax_params(tree)

    def to_jax_params(self, state_dict: dict[str, torch.Tensor]) -> dict:
        return to_jax_params(state_dict)

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        return seeded_state_dict(self.build_module, seed)


def create(cfg: ModelConfig) -> ResNet50Serving:
    return ResNet50Serving(cfg)
