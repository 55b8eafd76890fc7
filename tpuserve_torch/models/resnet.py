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

``from_jax_params`` converts the reference's ``{"params", "batch_stats"}``
tree (numpy leaves) into this module's float32 state_dict; that is how the
tests hold the port to the JAX package on the same weights.
``to_jax_params`` converts back, so a ``.npz`` checkpoint of that tree can
be written from the port's own seeded init.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models.vision import ImageClassifierServing


def _same_padding(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding (lo, hi) of one spatial dim."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Bias-free 2-D convolution with flax's padding: "SAME" when
    ``padding`` is None, else the given symmetric padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int | None = None) -> None:
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.padding
        if pad is None:
            (ht, hb), (wl, wr) = (_same_padding(n, self.k, self.stride) for n in x.shape[-2:])
            if ht == hb and wl == wr:
                pad = (ht, wl)
            else:
                x = F.pad(x, (wl, wr, ht, hb))
                pad = 0
        return F.conv2d(x, self.weight, stride=self.stride, padding=pad)


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


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, projection: bool = False,
                 v1_downsample: bool = False, bn_eps: float = 1e-5) -> None:
        super().__init__()
        s1, s2 = (stride, 1) if v1_downsample else (1, stride)
        cout = features * 4
        self.conv1 = Conv(cin, features, 1, s1)
        self.bn1 = BatchNorm(features, bn_eps)
        self.conv2 = Conv(features, features, 3, s2)
        self.bn2 = BatchNorm(features, bn_eps)
        self.conv3 = Conv(features, cout, 1)
        self.bn3 = BatchNorm(cout, bn_eps)
        if projection:
            self.proj_conv = Conv(cin, cout, 1, stride)
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


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """The reference's ``{"params", "batch_stats"}`` tree (numpy or jax
    leaves) -> this port's float32 state_dict.

    Layouts: conv kernels HWIO -> OIHW (``permute(3, 2, 0, 1)``); the Dense
    head's (in, out) kernel -> ``Linear.weight`` (out, in); BatchNorm
    ``scale``/``bias`` -> ``weight``/``bias``; ``batch_stats`` ``mean``/``var``
    -> ``running_mean``/``running_var``."""
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
            sd[prefix + names[key]] = t.contiguous()

    walk(tree["params"], "")
    walk(tree.get("batch_stats", {}), "")
    return sd


def to_jax_params(state_dict: dict[str, torch.Tensor]) -> dict:
    """This port's float32 state_dict -> the reference's ``{"params",
    "batch_stats"}`` tree of numpy arrays: ``from_jax_params`` inverted, bit
    for bit (OIHW -> HWIO, ``Linear.weight`` -> (in, out), 1-D weights ->
    BatchNorm ``scale``, running statistics -> ``batch_stats``)."""
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


class ResNet50Serving(ImageClassifierServing):
    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__(cfg)
        opt = cfg.options
        self.v1_downsample = bool(opt.get("v1_downsample", False))
        self.bn_eps = float(opt.get("bn_eps", 1e-5))

    def build_module(self) -> ResNet:
        return ResNet((3, 4, 6, 3), self.cfg.num_classes, self.v1_downsample, self.bn_eps)

    def from_jax_params(self, tree) -> dict[str, torch.Tensor]:
        return from_jax_params(tree)

    def to_jax_params(self, state_dict: dict[str, torch.Tensor]) -> dict:
        return to_jax_params(state_dict)

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Seeded init with the reference's initializer families (it cannot
        reproduce jax.random's bits): LeCun-normal conv and head weights,
        zero head bias, BatchNorm at identity (scale 1, bias 0, mean 0,
        var 1)."""
        rng = np.random.default_rng(seed)
        with torch.device("meta"):
            shapes = {k: tuple(v.shape) for k, v in self.build_module().state_dict().items()}
        sd = {}
        for name, shape in shapes.items():
            if len(shape) >= 2:                    # conv OIHW or head (out, in)
                fan_in = int(np.prod(shape[1:]))
                x = rng.normal(0.0, fan_in ** -0.5, shape)
            elif name.endswith(("weight", "running_var")):
                x = np.ones(shape)
            else:
                x = np.zeros(shape)
            sd[name] = torch.from_numpy(x.astype(np.float32))
        return sd


def create(cfg: ModelConfig) -> ResNet50Serving:
    return ResNet50Serving(cfg)
