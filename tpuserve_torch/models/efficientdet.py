"""EfficientDet-D0 object detection, ported from
``tpuserve/models/efficientdet.py`` (BASELINE.json config 4, "multi-output +
NMS postproc").

The network: an EfficientNet-B0 backbone (MBConv blocks with squeeze-excite
and swish) giving levels 3-5, lateral 1x1 convolutions to ``fpn_channels``
with P6 and P7 by max pool, ``fpn_repeats`` BiFPN layers with fast
normalized fusion, and class and box heads of separable convolutions shared
across levels with a BatchNorm per level; 9 anchors per cell; the heads'
outputs in float32. Sizes come from ``cfg.options`` with the reference's
D0 defaults (``det_classes`` 90, ``fpn_channels`` 64, ``fpn_repeats`` 3,
``head_repeats`` 3, levels 3-7, ``pre_nms`` 1024, ``max_dets`` 100,
``iou_thresh`` 0.5, ``score_thresh`` 0.05, ``anchor_scale`` 4.0,
``backbone_width`` / ``backbone_depth`` 1.0), so the tests run the
reference's tiny variant too.

The detection tail runs on the device with fixed shapes, inside the
bucket's CUDA graph with the network: sigmoid, best class per anchor, the
top ``pre_nms`` anchors, box decoding, and greedy per-class NMS (classes
offset by 2.0 so that boxes of two classes never overlap) as ``max_dets``
steps batched over the images. Every index stays a tensor: no ``.item()``,
no host sync. The outputs are ``boxes`` (B, max_dets, 4) float32,
``scores`` (B, max_dets) float32, ``classes`` (B, max_dets) int32 (-1 for
an empty slot) and ``n`` (B,) int32; ``host_postprocess`` formats them into
the reference's JSON.

Kept from the reference where PyTorch's default differs:

- flax's ``"SAME"`` padding of every convolution (``layers.Conv``) and of
  the 3x3 / stride-2 max pools (P6, P7 and the BiFPN's downsampling):
  padded with -inf by ``layers._same_padding`` ((0, 1) on an even input),
  then pooled unpadded — ``F.max_pool2d(padding=1)`` would pool shifted
  windows;
- ``jax.image.resize(..., "nearest")`` samples half-pixel centres,
  ``floor((i + 0.5) * in / out)``: ``F.interpolate(mode="nearest-exact")``,
  not ``"nearest"`` (they agree on exact 2x upsampling only);
- the fusion weights ``w_td{l}`` / ``w_out{l}`` are 1-D parameters of the
  BiFPN layer itself, initialised to ones; ``relu``, a divide by ``sum +
  1e-4``, a cast per node to the node's dtype and a left-to-right sum. They
  take the compute dtype as every other float leaf does: the reference's
  runtime casts every float leaf of the tree to the compute dtype before
  the forward (``tpuserve/runtime.py:379-384``), so under bf16 its
  normalization runs in bf16 too;
- the class head's final bias starts at ``-log((1 - 0.01) / 0.01)`` (the
  focal-loss prior), the seeded init's other families as in
  ``layers.seeded_state_dict``;
- ties: ``lax.top_k`` puts the lower index first, so the top ``pre_nms`` is
  a stable descending sort; ``jnp.argmax`` and ``torch.argmax`` both take
  the first maximum.

``from_jax_params`` / ``to_jax_params`` are ``layers``' (the submodules carry
the reference's flax names; the fusion weights keep theirs).
``import_tf_variables`` maps a Keras-applications EfficientNetB0 SavedModel
onto the backbone (``import-model``); the BiFPN and heads keep the seeded
init.
"""

from __future__ import annotations

import logging
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models.layers import (BatchNorm, Conv, _same_padding, from_jax_params,
                                          seeded_state_dict, to_jax_params)
from tpuserve_torch.models.vision import ImageClassifierServing
from tpuserve_torch.utils.trees import flatten_with_paths

# (expand_ratio, channels, repeats, stride, kernel) — EfficientNet-B0 table.
B0_BLOCKS: tuple = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

BN_EPS = 1e-3
# The class head's prior: sigmoid(bias) = 0.01 before training.
CLASS_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def _round_filters(ch: int, width: float) -> int:
    if width == 1.0:
        return ch
    ch *= width
    new = max(8, int(ch + 4) // 8 * 8)
    if new < 0.9 * ch:
        new += 8
    return int(new)


def _round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(r * depth))


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")``:
    -inf padding split as XLA splits it, then an unpadded pool."""
    (ht, hb), (wl, wr) = (_same_padding(n, 3, 2) for n in x.shape[-2:])
    return F.max_pool2d(F.pad(x, (wl, wr, ht, hb), value=float("-inf")), 3, 2)


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excite (EfficientNet block)."""

    def __init__(self, inp: int, expand: int, out: int, stride: int, kernel: int) -> None:
        super().__init__()
        mid = inp * expand
        self.has_expand = expand != 1
        if self.has_expand:
            self.expand = Conv(inp, mid, 1)
            self.bn_expand = BatchNorm(mid, BN_EPS)
        self.depthwise = Conv(mid, mid, kernel, stride, groups=mid)
        self.bn_dw = BatchNorm(mid, BN_EPS)
        # Squeeze-excite at ratio 0.25 of the *input* channels (B0 spec).
        se_mid = max(1, inp // 4)
        self.se_reduce = Conv(mid, se_mid, 1, bias=True)
        self.se_expand = Conv(se_mid, mid, 1, bias=True)
        self.project = Conv(mid, out, 1)
        self.bn_project = BatchNorm(out, BN_EPS)
        self.residual = stride == 1 and inp == out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.has_expand:
            h = F.silu(self.bn_expand(self.expand(h)))
        h = F.silu(self.bn_dw(self.depthwise(h)))
        s = h.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self.se_expand(F.silu(self.se_reduce(s))))
        h = self.bn_project(self.project(h * s))
        return h + x if self.residual else h


class EfficientNetFeatures(nn.Module):
    """EfficientNet backbone returning {level: feature} for levels 3..5
    (strides 8/16/32). Width/depth multipliers give the tiny test variant."""

    def __init__(self, width: float = 1.0, depth: float = 1.0,
                 blocks: Sequence = B0_BLOCKS) -> None:
        super().__init__()
        stem = _round_filters(32, width)
        self.stem = Conv(3, stem, 3, 2)
        self.bn_stem = BatchNorm(stem, BN_EPS)
        self.blocks: list[str] = []
        self.taps: dict[int, int] = {}      # index into self.blocks -> level
        self.channels: dict[int, int] = {}  # level -> its feature's channels
        level, inp = 1, stem  # the stem is stride 2 = level 1
        for gi, (e, c, r, s, k) in enumerate(blocks):
            c = _round_filters(c, width)
            if s == 2:
                level += 1
            for j in range(_round_repeats(r, depth)):
                name = f"block{len(self.blocks)}"
                self.add_module(name, MBConv(inp, e, c, s if j == 0 else 1, k))
                self.blocks.append(name)
                inp = c
            # A level's feature is the last block at that stride before the
            # next downsampling group.
            nxt = blocks[gi + 1][3] if gi + 1 < len(blocks) else 2
            if nxt == 2 and level >= 3:
                self.taps[len(self.blocks) - 1] = level
                self.channels[level] = c

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        x = F.silu(self.bn_stem(self.stem(x)))
        feats = {}
        for i, name in enumerate(self.blocks):
            x = getattr(self, name)(x)
            if i in self.taps:
                feats[self.taps[i]] = x
        return feats


class SeparableConv(nn.Module):
    """Depthwise 3x3 without bias, then pointwise 1x1 with bias."""

    def __init__(self, cin: int, out: int) -> None:
        super().__init__()
        self.dw = Conv(cin, cin, 3, groups=cin)
        self.pw = Conv(cin, out, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


def _fuse(nodes: list[torch.Tensor], w: torch.Tensor) -> torch.Tensor:
    """Fast normalized fusion (EfficientDet eq. 2): a relu-weighted mean, in
    the weights' dtype, each weight cast to its node's dtype, summed left to
    right."""
    w = F.relu(w)
    w = w / (w.sum() + 1e-4)
    out = w[0].to(nodes[0].dtype) * nodes[0]
    for i in range(1, len(nodes)):
        out = out + w[i].to(nodes[i].dtype) * nodes[i]
    return out


def _resize_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if x.shape[-2:] == like.shape[-2:]:
        return x
    if x.shape[-2] > like.shape[-2]:  # downsample: stride-2 max pool
        return max_pool_same(x)
    return F.interpolate(x, size=like.shape[-2:], mode="nearest-exact")


class BiFPNLayer(nn.Module):
    def __init__(self, channels: int, levels: Sequence[int]) -> None:
        super().__init__()
        self.levels = list(levels)
        lv = self.levels
        for l in reversed(lv[:-1]):
            self.register_parameter(f"w_td{l}", nn.Parameter(torch.ones(2)))
            self.add_module(f"td{l}", SeparableConv(channels, channels))
            self.add_module(f"bn_td{l}", BatchNorm(channels, BN_EPS))
        for l in lv[1:]:
            n = 2 if l == lv[-1] else 3
            self.register_parameter(f"w_out{l}", nn.Parameter(torch.ones(n)))
            self.add_module(f"out{l}", SeparableConv(channels, channels))
            self.add_module(f"bn_out{l}", BatchNorm(channels, BN_EPS))

    def _node(self, kind: str, l: int, nodes: list) -> torch.Tensor:
        fused = _fuse(nodes, getattr(self, f"w_{kind}{l}"))
        return F.silu(getattr(self, f"bn_{kind}{l}")(getattr(self, f"{kind}{l}")(fused)))

    def forward(self, feats: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        lv = self.levels
        # Top-down pass: td[l] = fuse(in[l], up(td[l+1]))
        td = {lv[-1]: feats[lv[-1]]}
        for l in reversed(lv[:-1]):
            td[l] = self._node("td", l, [feats[l], _resize_to(td[l + 1], feats[l])])
        # Bottom-up pass: out[l] = fuse(in[l], td[l], down(out[l-1]))
        out = {lv[0]: td[lv[0]]}
        for l in lv[1:]:
            down = _resize_to(out[l - 1], feats[l])
            nodes = [feats[l], down] if l == lv[-1] else [feats[l], td[l], down]
            out[l] = self._node("out", l, nodes)
        return out


class PredictionHead(nn.Module):
    """Class or box net: ``repeats`` separable convs shared across levels with
    a BatchNorm per level, plus a shared final projection."""

    def __init__(self, channels: int, out_per_anchor: int, anchors: int, repeats: int,
                 levels: Sequence[int]) -> None:
        super().__init__()
        self.out_per_anchor = out_per_anchor
        self.levels = list(levels)
        self.repeats = repeats
        for i in range(repeats):
            self.add_module(f"conv{i}", SeparableConv(channels, channels))
            for l in self.levels:
                self.add_module(f"bn{i}_l{l}", BatchNorm(channels, BN_EPS))
        self.final = SeparableConv(channels, out_per_anchor * anchors)

    def forward(self, feats: dict[int, torch.Tensor]) -> torch.Tensor:
        outs = []
        for l in self.levels:
            h = feats[l]
            for i in range(self.repeats):
                h = F.silu(getattr(self, f"bn{i}_l{l}")(getattr(self, f"conv{i}")(h)))
            h = self.final(h)
            # NHWC order, as the reference reshapes: (B, H*W*anchors, out).
            outs.append(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1, self.out_per_anchor))
        return torch.cat(outs, dim=1)


class EfficientDet(nn.Module):
    def __init__(self, num_classes: int, fpn_channels: int = 64, fpn_repeats: int = 3,
                 head_repeats: int = 3, min_level: int = 3, max_level: int = 7,
                 num_anchors: int = 9, width: float = 1.0, depth: float = 1.0) -> None:
        super().__init__()
        self.levels = list(range(min_level, max_level + 1))
        self.max_level = max_level
        self.backbone = EfficientNetFeatures(width, depth)
        feats = self.backbone.channels
        self.lateral = [l for l in self.levels if l in feats]
        for l in self.lateral:
            self.add_module(f"lat{l}", Conv(feats[l], fpn_channels, 1, bias=True))
            self.add_module(f"bn_lat{l}", BatchNorm(fpn_channels, BN_EPS))
        self.top = max(feats)
        if self.top + 1 <= max_level:
            cin = fpn_channels if self.top in self.lateral else feats[self.top]
            self.add_module(f"lat{self.top + 1}", Conv(cin, fpn_channels, 1, bias=True))
            self.add_module(f"bn_lat{self.top + 1}", BatchNorm(fpn_channels, BN_EPS))
        self.fpn_repeats = fpn_repeats
        for i in range(fpn_repeats):
            self.add_module(f"bifpn{i}", BiFPNLayer(fpn_channels, self.levels))
        self.class_net = PredictionHead(fpn_channels, num_classes, num_anchors, head_repeats,
                                        self.levels)
        self.box_net = PredictionHead(fpn_channels, 4, num_anchors, head_repeats, self.levels)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        feats = self.backbone(x)
        # Lateral 1x1 to fpn_channels; extra levels (P6, P7) from P5.
        p = {l: getattr(self, f"bn_lat{l}")(getattr(self, f"lat{l}")(feats[l]))
             for l in self.lateral}
        prev = p.get(self.top, feats[self.top])
        for l in range(self.top + 1, self.max_level + 1):
            if l == self.top + 1:
                prev = getattr(self, f"bn_lat{l}")(getattr(self, f"lat{l}")(prev))
            p[l] = max_pool_same(prev)
            prev = p[l]
        for i in range(self.fpn_repeats):
            p = getattr(self, f"bifpn{i}")(p)
        return self.class_net(p).float(), self.box_net(p).float()


# -- anchors & the fixed-shape detection tail --------------------------------

def make_anchors(image_size: int, min_level: int, max_level: int,
                 anchor_scale: float = 4.0) -> np.ndarray:
    """(A, 4) [yc, xc, h, w] in pixels: 3 octave scales x 3 aspect ratios per
    cell per level — the EfficientDet anchor grid."""
    out = []
    for level in range(min_level, max_level + 1):
        stride = 2 ** level
        # SAME-padded stride-2 convs/pools produce ceil-sized feature maps
        # (repeated ceil-halving == ceil(size / stride)).
        n = max(1, -(-image_size // stride))
        yc, xc = np.meshgrid(
            (np.arange(n) + 0.5) * stride, (np.arange(n) + 0.5) * stride,
            indexing="ij")
        cells = np.stack([yc.ravel(), xc.ravel()], axis=-1)  # (n*n, 2)
        sizes = []
        for octave in (0.0, 1.0 / 3.0, 2.0 / 3.0):
            base = anchor_scale * stride * (2.0 ** octave)
            for ratio in (0.5, 1.0, 2.0):
                sizes.append((base / math.sqrt(ratio), base * math.sqrt(ratio)))
        sizes = np.asarray(sizes)  # (9, 2) h, w
        a = np.concatenate([
            np.repeat(cells, len(sizes), axis=0),
            np.tile(sizes, (len(cells), 1)),
        ], axis=-1)
        out.append(a)
    return np.concatenate(out, axis=0).astype(np.float32)


def decode_boxes(reg: torch.Tensor, anchors: torch.Tensor, image_size: int) -> torch.Tensor:
    """(..., 4) regression [ty, tx, th, tw] + anchors -> normalized corners."""
    yc = reg[..., 0] * anchors[..., 2] + anchors[..., 0]
    xc = reg[..., 1] * anchors[..., 3] + anchors[..., 1]
    h = torch.exp(torch.clamp(reg[..., 2], -8.0, 8.0)) * anchors[..., 2]
    w = torch.exp(torch.clamp(reg[..., 3], -8.0, 8.0)) * anchors[..., 3]
    boxes = torch.stack([yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2], dim=-1)
    return torch.clamp(boxes / image_size, 0.0, 1.0)


def pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) corner boxes -> (..., K, K) IoU, all static shapes."""
    area = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0) * torch.clamp_min(
        boxes[..., 3] - boxes[..., 1], 0)
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-9)


def fixed_nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
              max_dets: int, iou_thresh: float, score_thresh: float) -> dict:
    """Greedy NMS with static shapes over a batch: (B, K, 4) boxes, (B, K)
    float32 scores and int classes; ``max_dets`` steps, each picking every
    image's best live candidate (the first on ties) and suppressing by a
    precomputed IoU matrix. Per-class via the class-offset trick (boxes
    normalized to [0, 1], offset 2.0 * class)."""
    shifted = boxes + (classes.to(torch.float32) * 2.0)[..., None]
    iou = pairwise_iou(shifted)  # (B, K, K)
    k = scores.shape[-1]
    alive = scores
    idxs, kept, valids = [], [], []
    for _ in range(max_dets):
        idx = torch.argmax(alive, dim=-1, keepdim=True)           # (B, 1)
        s = alive.gather(1, idx)
        valid = s > score_thresh
        # Includes idx itself (IoU 1).
        suppress = iou.gather(1, idx[..., None].expand(-1, 1, k)).squeeze(1) > iou_thresh
        alive = torch.where(suppress, 0.0, alive).scatter(1, idx, 0.0)
        idxs.append(idx)
        kept.append(torch.where(valid, s, 0.0))
        valids.append(valid)
    idx = torch.cat(idxs, dim=1)                                   # (B, max_dets)
    valid = torch.cat(valids, dim=1)
    return {
        "boxes": boxes.gather(1, idx[..., None].expand(-1, -1, 4)),
        "scores": torch.cat(kept, dim=1),
        "classes": torch.where(valid, classes.gather(1, idx), -1).to(torch.int32),
        "n": valid.sum(dim=1, dtype=torch.int32),
    }


class EfficientDetServing(ImageClassifierServing):
    """Detection serving: the shared vision wire and decode plumbing, the
    detection tail behind the network."""

    def __init__(self, cfg: ModelConfig) -> None:
        o = cfg.options
        self.det_classes = int(o.get("det_classes", 90))
        self.pre_nms = int(o.get("pre_nms", 1024))
        self.max_dets = int(o.get("max_dets", 100))
        self.iou_thresh = float(o.get("iou_thresh", 0.5))
        self.score_thresh = float(o.get("score_thresh", 0.05))
        self.min_level = int(o.get("min_level", 3))
        self.max_level = int(o.get("max_level", 7))
        super().__init__(cfg)
        self.anchors = make_anchors(cfg.image_size, self.min_level, self.max_level,
                                    float(o.get("anchor_scale", 4.0)))
        # The anchor table per device, made at the first forward there (the
        # eager warm-up, before any capture).
        self._anchors_on: dict[torch.device, torch.Tensor] = {}

    def build_module(self) -> EfficientDet:
        o = self.cfg.options
        return EfficientDet(
            num_classes=self.det_classes,
            fpn_channels=int(o.get("fpn_channels", 64)),
            fpn_repeats=int(o.get("fpn_repeats", 3)),
            head_repeats=int(o.get("head_repeats", 3)),
            min_level=self.min_level,
            max_level=self.max_level,
            width=float(o.get("backbone_width", 1.0)),
            depth=float(o.get("backbone_depth", 1.0)),
        )

    def from_jax_params(self, tree) -> dict[str, torch.Tensor]:
        return from_jax_params(tree)

    def to_jax_params(self, state_dict: dict[str, torch.Tensor]) -> dict:
        return to_jax_params(state_dict)

    def import_tf_variables(self, flat: dict) -> dict:
        """Keras-applications EfficientNetB0 -> the backbone subtree.

        The detector's backbone IS EfficientNet-B0, so a classification
        checkpoint transfers it exactly — the standard detection transfer-
        learning setup. BiFPN and heads keep the port's seeded init (logged).

        Source scheme (``tf.keras.applications.EfficientNetB0``): stem
        ``stem_conv``/``stem_bn``; block ``block{stage}{a,b,...}_{expand_conv,
        expand_bn, dwconv, bn, se_reduce, se_expand, project_conv,
        project_bn}`` (stage-1 blocks have no expand: ratio 1). Depthwise
        kernels transpose (H, W, C, 1) -> (H, W, 1, C); SE convs keep biases;
        the classifier-only ``top_conv``/``top_bn``/``predictions`` and the
        input ``normalization`` stats have no detector counterpart and are
        skipped."""
        o = self.cfg.options
        if (float(o.get("backbone_width", 1.0)), float(o.get("backbone_depth", 1.0))) != (1.0, 1.0):
            raise ValueError(
                "EfficientNetB0 import requires backbone_width/depth == 1.0")
        f = {k.split(":")[0]: np.asarray(v) for k, v in flat.items()}

        def conv(name):
            return {"kernel": f[f"{name}/kernel"]}

        def bn(name):
            return (
                {"scale": f[f"{name}/gamma"], "bias": f[f"{name}/beta"]},
                {"mean": f[f"{name}/moving_mean"],
                 "var": f[f"{name}/moving_variance"]},
            )

        bp: dict = {"stem": conv("stem_conv")}
        bs: dict = {}
        bp["bn_stem"], bs["bn_stem"] = bn("stem_bn")
        bi = 0
        for stage, (e, _c, r, _s, _k) in enumerate(B0_BLOCKS, start=1):
            for j in range(r):
                pre = f"block{stage}{'abcdefghij'[j]}"
                p: dict = {}
                st: dict = {}
                if e != 1:
                    p["expand"] = conv(f"{pre}_expand_conv")
                    p["bn_expand"], st["bn_expand"] = bn(f"{pre}_expand_bn")
                dw = f[f"{pre}_dwconv/kernel"]  # (H, W, C, 1)
                p["depthwise"] = {"kernel": dw.transpose(0, 1, 3, 2)}
                p["bn_dw"], st["bn_dw"] = bn(f"{pre}_bn")
                p["se_reduce"] = {"kernel": f[f"{pre}_se_reduce/kernel"],
                                  "bias": f[f"{pre}_se_reduce/bias"]}
                p["se_expand"] = {"kernel": f[f"{pre}_se_expand/kernel"],
                                  "bias": f[f"{pre}_se_expand/bias"]}
                p["project"] = conv(f"{pre}_project_conv")
                p["bn_project"], st["bn_project"] = bn(f"{pre}_project_bn")
                bp[f"block{bi}"] = p
                bs[f"block{bi}"] = st
                bi += 1

        full = self.to_jax_params(self.init_params(0))
        got = list(flatten_with_paths(bp))
        want = list(flatten_with_paths(full["params"]["backbone"]))
        if [p for p, _ in got] != [p for p, _ in want]:
            raise ValueError("imported backbone tree does not match the module")
        for (_, g), (_, w) in zip(got, want):
            if g.shape != w.shape:
                raise ValueError(
                    f"backbone shape mismatch: imported {g.shape} vs "
                    f"module {w.shape}")
        full["params"]["backbone"] = bp
        full["batch_stats"]["backbone"] = bs
        logging.getLogger("tpuserve_torch.models").info(
            "%s: EfficientNetB0 backbone imported; BiFPN/heads keep the seeded "
            "init (serve a full-detector .npz for end-to-end weights)", self.name)
        return full

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """``layers.seeded_state_dict`` with the reference's two other
        initializers: fusion weights at ones, the class head's final bias at
        the focal-loss prior."""
        sd = seeded_state_dict(self.build_module, seed)
        for name, t in sd.items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith(("w_td", "w_out")):
                t.fill_(1.0)
        sd["class_net.final.pw.bias"].fill_(CLASS_PRIOR_BIAS)
        return sd

    def logits(self, module: torch.nn.Module, batch: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """Device preprocess + network: the float32 class logits (B, A,
        det_classes) and box regression (B, A, 4) — two outputs, not a
        classifier's (B, classes)."""
        return module(self.device_preprocess(batch))

    def forward(self, module: torch.nn.Module, batch: tuple) -> dict:
        return self.detect(*self.logits(module, batch))

    def detect(self, cls_logits: torch.Tensor, box_reg: torch.Tensor) -> dict:
        """The detection tail on the heads' outputs: sigmoid, best class per
        anchor, the top ``pre_nms`` anchors (a stable descending sort, so
        ties keep the lower index first as ``lax.top_k`` does), decode, NMS."""
        probs = torch.sigmoid(cls_logits)
        best = probs.amax(dim=-1)                                  # (B, A)
        best_cls = torch.argmax(probs, dim=-1).to(torch.int32)
        k = min(self.pre_nms, best.shape[1])
        top_i = torch.sort(best, dim=-1, descending=True, stable=True).indices[:, :k]
        anchors = self._anchors_on.get(best.device)
        if anchors is None:
            anchors = self._anchors_on[best.device] = torch.from_numpy(self.anchors).to(best.device)
        boxes = decode_boxes(box_reg.gather(1, top_i[..., None].expand(-1, -1, 4)),
                             anchors[top_i], self.cfg.image_size)
        return fixed_nms(boxes, best.gather(1, top_i), best_cls.gather(1, top_i),
                         self.max_dets, self.iou_thresh, self.score_thresh)

    def host_postprocess(self, outputs: dict, n_valid: int) -> list[dict]:
        res = []
        for r in range(n_valid):
            n = int(outputs["n"][r])
            dets = []
            for j in range(self.max_dets):
                if outputs["classes"][r][j] < 0:
                    continue
                det = {
                    "box": [round(float(c), 5) for c in outputs["boxes"][r][j]],
                    "score": round(float(outputs["scores"][r][j]), 5),
                    "class": int(outputs["classes"][r][j]),
                }
                label = self.label_for(det["class"])
                if label is not None:
                    det["label"] = label
                dets.append(det)
                if len(dets) == n:
                    break
            res.append({"detections": dets, "num_detections": n})
        return res


def create(cfg: ModelConfig) -> EfficientDetServing:
    return EfficientDetServing(cfg)
