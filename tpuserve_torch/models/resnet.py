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

Under ``tp > 1`` (``parallelism = "sharded"``) the reference's partition
rules split the output channels of every convolution (``conv\\d?/kernel``
matches ``stem_conv``, ``conv1``-``conv3`` and ``proj_conv``) and the head's
classes over "model". Each model rank's module (``ResNet(tp=...)``) holds
its block of every kernel and its slice of the per-channel leaves the tree
keeps replicated (BatchNorm's scale, bias, mean and variance, the head's
bias; ``_tp_channels``); the forward runs each convolution, BatchNorm and
ReLU on every rank and gathers the ranks' channel blocks before the next
convolution, which reads them all (on one card the gather is a
concatenation; ``tp_logits``). Under ``quantize`` the whole tree is cast
and quantized first and then split (``quantize.specs_for_tree``), so each
rank's scales are its channels' own.

``from_jax_params`` converts the reference's ``{"params", "batch_stats"}``
tree (numpy leaves) into this module's float32 state_dict; that is how the
tests hold the port to the JAX package on the same weights.
``to_jax_params`` converts back, so a ``.npz`` checkpoint of that tree can
be written from the port's own seeded init. ``import_tf_variables`` maps a
Keras-applications ResNet50 SavedModel onto the tree (``import-model``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuserve_torch import quantize
from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models.base import MeshModule, rows_gather, rows_split, to_device
from tpuserve_torch.models.layers import (BatchNorm, Conv, from_jax_params,
                                          seeded_state_dict, to_jax_params)
from tpuserve_torch.models.vision import ImageClassifierServing
from tpuserve_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, batch_sharding
from tpuserve_torch.parallel.partition import P, PartitionSpec
from tpuserve_torch.quantize import Int8Conv1x1


class Bottleneck(nn.Module):
    """The bottleneck block; ``tp`` > 1 builds one model rank's block of it:
    every convolution's output channels (and its BatchNorm) divided by
    ``tp``, each reading all of its input's channels."""

    def __init__(self, cin: int, features: int, stride: int = 1, projection: bool = False,
                 v1_downsample: bool = False, bn_eps: float = 1e-5, tp: int = 1) -> None:
        super().__init__()
        s1, s2 = (stride, 1) if v1_downsample else (1, stride)
        cout = features * 4
        self.conv1 = Int8Conv1x1(cin, features // tp, s1)
        self.bn1 = BatchNorm(features // tp, bn_eps)
        self.conv2 = Conv(features, features // tp, 3, s2)
        self.bn2 = BatchNorm(features // tp, bn_eps)
        self.conv3 = Int8Conv1x1(features, cout // tp)
        self.bn3 = BatchNorm(cout // tp, bn_eps)
        if projection:
            self.proj_conv = Int8Conv1x1(cin, cout // tp, stride)
            self.proj_bn = BatchNorm(cout // tp, bn_eps)
        self.projection = projection

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.proj_bn(self.proj_conv(x)) if self.projection else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Submodules are named as the reference's flax modules (``stem_conv``,
    ``stage1_block1.conv1``, ``head``, ...). ``tp`` > 1 builds one model
    rank's module: its block of every convolution's output channels and of
    the head's classes (``tp_logits`` runs the ranks together)."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), num_classes: int = 1000,
                 v1_downsample: bool = False, bn_eps: float = 1e-5, tp: int = 1) -> None:
        super().__init__()
        self.stem_conv = Conv(3, 64 // tp, 7, 2, padding=3)
        self.stem_bn = BatchNorm(64 // tp, bn_eps)
        self.blocks = []
        cin = 64
        for i, n_blocks in enumerate(stage_sizes):
            features = 64 * 2**i
            for j in range(n_blocks):
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, Bottleneck(
                    cin, features, stride=2 if i > 0 and j == 0 else 1,
                    projection=j == 0, v1_downsample=v1_downsample, bn_eps=bn_eps, tp=tp))
                self.blocks.append(name)
                cin = features * 4
        self.head = nn.Linear(cin, num_classes // tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.head.weight.float(), self.head.bias.float())


def tp_logits(ranks: list[ResNet], devices: list[torch.device],
              x: torch.Tensor) -> torch.Tensor:
    """``ResNet.forward`` over the model ranks of one data rank: each
    convolution, its BatchNorm and ReLU run on every rank's block of the
    output channels, and the blocks are gathered on the first rank's
    device (a concatenation along the channels) before the next
    convolution, which reads every channel; the head's class blocks are
    gathered the same way."""
    def split(mods: list, inp: torch.Tensor, conv: str, bn: str, relu: bool) -> torch.Tensor:
        outs = []
        for mod, dev in zip(mods, devices):
            y = getattr(mod, bn)(getattr(mod, conv)(inp.to(dev)))
            outs.append((F.relu(y) if relu else y).to(devices[0]))
        return torch.cat(outs, dim=1)

    x = split(ranks, x, "stem_conv", "stem_bn", True)
    x = F.max_pool2d(x, 3, 2, padding=1)
    for name in ranks[0].blocks:
        blocks = [getattr(r, name) for r in ranks]
        y = split(blocks, x, "conv1", "bn1", True)
        y = split(blocks, y, "conv2", "bn2", True)
        y = split(blocks, y, "conv3", "bn3", False)
        residual = split(blocks, x, "proj_conv", "proj_bn", False) if blocks[0].projection else x
        x = F.relu(y + residual)
    x = x.mean(dim=(2, 3)).float()
    return torch.cat([F.linear(x.to(dev), r.head.weight.float(), r.head.bias.float())
                      .to(devices[0]) for r, dev in zip(ranks, devices)], dim=-1)


class ResNet50Serving(ImageClassifierServing):
    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__(cfg)
        opt = cfg.options
        self.v1_downsample = bool(opt.get("v1_downsample", False))
        self.bn_eps = float(opt.get("bn_eps", 1e-5))
        # The model ranks a module's output channels split over: 1, or a
        # tensor-parallel rank's view (mesh_module).
        self.tp_split = 1

    def build_module(self) -> ResNet:
        return ResNet((3, 4, 6, 3), self.cfg.num_classes, self.v1_downsample, self.bn_eps,
                      self.tp_split)

    # -- the model axis (the reference's rules) --------------------------------
    def partition_rules(self) -> list[tuple[str, PartitionSpec]]:
        """The reference's TP rules (off unless tp > 1): every convolution's
        output channels (``conv\\d?/kernel``: the stem, ``conv1``-``conv3``
        and ``proj_conv``) and the head's classes on "model"."""
        if self.cfg.tp <= 1:
            return [(".*", P())]
        return [(r"head/kernel", P(None, MODEL_AXIS)),
                (r"conv\d?/kernel", P(None, None, None, MODEL_AXIS)),
                (r".*", P())]

    def mesh_module(self, tree, mesh: Mesh, prepare) -> MeshModule:
        """tp = 1: one copy per data rank. tp > 1: one module per (data,
        model) rank holding its blocks by ``partition_rules`` and its slice
        of the replicated per-channel leaves (``_tp_channels``); a rank's
        seq ranks share its parameters and are not built."""
        dp, tp = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
        if tp == 1:
            return super().mesh_module(tree, mesh, prepare)
        if 64 % tp or self.cfg.num_classes % tp:
            raise ValueError(f"tp={tp} must divide ResNet-50's channels (64, ...) and "
                             f"num_classes={self.cfg.num_classes}")
        view = self._with(tp_split=tp)
        ranks = [prepare(view, self._tp_channels(rank_tree, coord[MODEL_AXIS], tp), dev)
                 for coord, rank_tree, dev in self.model_rank_trees(tree, mesh)]
        return MeshModule(ranks, mesh, (dp, tp))

    @staticmethod
    def _tp_channels(tree: dict, m: int, tp: int) -> dict:
        """A model rank's slice of every per-channel leaf the reference
        keeps replicated and XLA slices with its channel-split products:
        each BatchNorm's scale, bias, mean and variance and the head's bias
        (every 1-D leaf of the tree; quantized kernels stay as split)."""
        def walk(node):
            if quantize.is_quantized(node):
                return node
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if np.ndim(node) == 1:
                n = np.shape(node)[0] // tp
                return node[m * n:(m + 1) * n]
            return node

        return walk(tree)

    def mesh_logits(self, module: MeshModule, batch: tuple) -> torch.Tensor:
        """The logits per data rank: its copy's (tp = 1), or its model
        ranks' (``tp_logits``); rows gathered on the first data rank's
        device."""
        if module.mesh.shape[MODEL_AXIS] == 1:
            return super().mesh_logits(module, batch)
        dp, tp = module.grid
        parts = []
        for d, rows in enumerate(rows_split(batch, dp)):
            ranks = [module.rank(d, m) for m in range(tp)]
            devs = [r.head.weight.device for r in ranks]
            parts.append(tp_logits(ranks, devs, self.device_preprocess(to_device(rows, devs[0]))))
        return rows_gather(parts, batch_sharding(module.mesh)[0])

    def mesh_forward(self, module: MeshModule, batch: tuple) -> dict:
        if module.mesh.shape[MODEL_AXIS] == 1:
            return super().mesh_forward(module, batch)
        return self.top_k_outputs(self.mesh_logits(module, batch))

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

    def import_tf_variables(self, flat: dict) -> dict:
        """Keras-applications ResNet50 names/layouts -> the reference's tree.

        Source scheme (``tf.keras.applications.ResNet50``): stem
        ``conv1_conv``/``conv1_bn``; blocks
        ``conv{s}_block{j}_{1,2,3}_conv|bn`` with the projection shortcut at
        ``_0``; head ``predictions``. That architecture puts stride 2 on the
        block's first 1x1 and uses eps 1.001e-5, so serve imported weights
        with ``options={"v1_downsample": true, "bn_eps": 1.001e-5}``.

        Layouts transfer directly (both are NHWC with HWIO conv kernels and
        (in, out) dense kernels). The one real translation: Keras convs carry
        biases that immediately feed BatchNorm, while the tree's are
        bias-free — a conv bias shifts the BN input, so it folds exactly into
        the BN moving mean (``mean' = mean - bias``)."""
        f = {k.split(":")[0]: np.asarray(v) for k, v in flat.items()}

        def unit(conv_tf: str, bn_tf: str):
            """-> (conv params, bn params, bn stats) with the bias fold."""
            mean = f[f"{bn_tf}/moving_mean"].astype(np.float32)
            bias = f.get(f"{conv_tf}/bias")
            if bias is not None:
                mean = mean - bias.astype(np.float32)
            return (
                {"kernel": f[f"{conv_tf}/kernel"]},
                {"scale": f[f"{bn_tf}/gamma"], "bias": f[f"{bn_tf}/beta"]},
                {"mean": mean, "var": f[f"{bn_tf}/moving_variance"]},
            )

        params: dict = {}
        stats: dict = {}
        params["stem_conv"], params["stem_bn"], stats["stem_bn"] = unit(
            "conv1_conv", "conv1_bn")
        for i, n_blocks in enumerate((3, 4, 6, 3)):
            s = i + 2  # Keras stages are conv2..conv5
            for j in range(1, n_blocks + 1):
                name = f"stage{i + 1}_block{j}"
                tf_pre = f"conv{s}_block{j}"
                p: dict = {}
                st: dict = {}
                for k in (1, 2, 3):
                    p[f"conv{k}"], p[f"bn{k}"], st[f"bn{k}"] = unit(
                        f"{tf_pre}_{k}_conv", f"{tf_pre}_{k}_bn")
                if f"{tf_pre}_0_conv/kernel" in f:
                    p["proj_conv"], p["proj_bn"], st["proj_bn"] = unit(
                        f"{tf_pre}_0_conv", f"{tf_pre}_0_bn")
                params[name] = p
                stats[name] = st
        params["head"] = {"kernel": f["predictions/kernel"],
                          "bias": f["predictions/bias"]}
        return {"params": params, "batch_stats": stats}


def create(cfg: ModelConfig) -> ResNet50Serving:
    return ResNet50Serving(cfg)
