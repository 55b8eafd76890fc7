"""Shared serving plumbing for image classifiers, ported from
``tpuserve/models/vision.py``.

Every vision classifier serves the same way: the host decodes to the
configured wire format (rgb8, or yuv420 planes), the forward runs resize and
normalisation in front of the network (``device_preprocess``) and softmax +
top-k behind it on the device, and the host formats the small (B, k)
results. Families subclass and provide ``build_module`` and
``init_params``.

Bodies: ``application/x-tpuserve-frame`` (parsed zero-copy at the model's
exact wire contract), ``application/x-npy`` ((N, H, W, 3) is a client batch,
(H, W, 3) a single image; on the yuv420 wire each is converted on the host)
and any other type as one encoded image (PIL, or the native shim for
exact-size 4:2:0 JPEGs on the yuv420 wire).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpuserve_torch import frame, preproc
from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models.base import DTYPES, ServingModel, TensorSpec, not_ported


class ImageClassifierServing(ServingModel):
    """ServingModel base for uint8 images -> class-probability models."""

    TOP_K = 5
    channels_last = True

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__(cfg)
        if cfg.parallelism != "single" or cfg.tp > 1 or cfg.sp > 1:
            raise not_ported(
                f"parallelism={cfg.parallelism!r} (tp={cfg.tp}, sp={cfg.sp}); "
                "set parallelism = \"single\"", "mesh modes")
        self.dtype = DTYPES[cfg.dtype]
        self.top_k = min(self.TOP_K, cfg.num_classes)
        # Normalisation the network was trained with, as (mean, std) applied
        # after the /255 scale; torchvision-style ImageNet stats by default.
        self.norm_mean = tuple(cfg.options.get("preproc_mean", preproc.IMAGENET_MEAN))
        self.norm_std = tuple(cfg.options.get("preproc_std", preproc.IMAGENET_STD))

    def input_signature(self, bucket: tuple) -> tuple[TensorSpec, ...]:
        (b,) = bucket
        w = self.cfg.wire_size
        u8 = np.dtype(np.uint8)
        if self.cfg.wire_format == "yuv420":
            h = w // 2
            return (TensorSpec((b, w, w), u8), TensorSpec((b, h, h), u8),
                    TensorSpec((b, h, h), u8))
        return (TensorSpec((b, w, w, 3), u8),)

    # -- device side ---------------------------------------------------------
    def device_preprocess(self, batch: tuple) -> torch.Tensor:
        """Wire tensors -> normalised (B, 3, S, S) compute-dtype input in
        channels_last memory: the three YUV planes, or the one RGB batch."""
        if self.cfg.wire_format == "yuv420":
            y, u, v = batch
            return preproc.device_prepare_images_yuv420(
                y, u, v, self.cfg.image_size, dtype=self.dtype,
                mean=self.norm_mean, std=self.norm_std)
        (rgb,) = batch
        return preproc.device_prepare_images(rgb, self.cfg.image_size, dtype=self.dtype,
                                             mean=self.norm_mean, std=self.norm_std)

    def logits(self, module: torch.nn.Module, batch: tuple) -> torch.Tensor:
        return module(self.device_preprocess(batch))

    # -- host side -----------------------------------------------------------
    def host_decode(self, payload: bytes, content_type: str) -> Any:
        if self.cfg.wire_format == "yuv420":
            return preproc.decode_image_yuv420(
                payload, content_type, self.cfg.wire_size, model=self.name)
        return preproc.decode_image(payload, content_type, edge=self.cfg.wire_size)

    def host_decode_items(self, payload: bytes, content_type: str) -> tuple[list, bool]:
        """Framed bodies parse zero-copy; npy bodies parse once ((N, H, W, 3)
        is a client batch, (H, W, 3) a single item); other content types
        take the single-image path."""
        if content_type == frame.CONTENT_TYPE:
            items = frame.parse_frame(
                payload, kind=frame.KIND_BY_WIRE_FORMAT[self.cfg.wire_format],
                edge=self.cfg.wire_size, max_items=self.MAX_ITEMS_PER_REQUEST)
            return items, True
        if content_type != "application/x-npy":
            return [self.host_decode(payload, content_type)], False
        items, batched = preproc.decode_npy_items(
            payload, self.cfg.wire_size, self.MAX_ITEMS_PER_REQUEST)
        if self.cfg.wire_format == "yuv420":
            items = [preproc.rgb_to_yuv420(a) for a in items]
        return items, batched

    def canary_item(self) -> Any:
        if self.cfg.wire_format == "yuv420":
            w, h = self.cfg.wire_size, self.cfg.wire_size // 2
            return (np.zeros((w, w), np.uint8), np.full((h, h), 128, np.uint8),
                    np.full((h, h), 128, np.uint8))
        return super().canary_item()

    def host_postprocess(self, outputs: dict, n_valid: int) -> list[dict]:
        return self.format_top_k(outputs, n_valid)
