"""Model zoo of the port, mirroring ``tpuserve/models``.

Each family implements the ``ServingModel`` contract in ``base.py``. Ported:

- bert — BERT-base text classification, bucketed seq lens, dense, flash
  (kernel K1), ring (local step dense or kernel K2) or Ulysses (local step
  dense or K1) attention.
- resnet50 — ResNet-50 image classification (``vision.py`` serving: framed,
  npy and encoded-image bodies, rgb8 or yuv420 wire, preprocessing and
  softmax + top-k on the device; bf16, channels_last, cuDNN convolutions;
  weight-only int8, or int8 compute in the bottleneck 1x1 convolutions).
- mobilenetv3 — MobileNetV3-Large image classification (the same
  ``vision.py`` serving; depthwise and squeeze-excite blocks, cuDNN
  convolutions, batch-1 latency through the CUDA graphs).
- efficientdet — EfficientDet-D0 object detection (the same ``vision.py``
  ingest; EfficientNet-B0, BiFPN, shared heads, and the fixed-shape
  detection tail — top-k, decode, greedy NMS — on the device, inside the
  bucket's CUDA graph).
- sd15 — Stable Diffusion 1.5 txt2img (CLIP text tower, UNet, VAE
  decoder; spatial self-attention on kernel K1 with ``unet_attention =
  "flash"``), served as one captured graph per locked batch or step by step
  by the generation engine, previews streamed as binary frames.
- textgen — autoregressive text generation (a prefix-LM decoder whose
  prompt prefill runs kernel K1 with ``attention = "flash"``), served as
  locked batches by the batcher or iteration by iteration by the
  generation engine (``tpuserve_torch.genserve``) with dense or paged KV.
- toy — a tiny MLP image classifier, the fast model of the CPU tests.

The shared convolution, BatchNorm and weight-conversion code of the
convolutional families is ``layers.py``.

Every family of the JAX package is ported; ``_NOT_PORTED`` stays the place
where a family that is registered by name but not served yet raises "not
yet ported", naming its ROADMAP.md item.
"""

from __future__ import annotations

import importlib
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from tpuserve_torch.config import ModelConfig
    from tpuserve_torch.models.base import ServingModel

_REGISTRY: dict[str, str] = {
    "bert": "tpuserve_torch.models.bert",
    "efficientdet": "tpuserve_torch.models.efficientdet",
    "mobilenetv3": "tpuserve_torch.models.mobilenet",
    "resnet50": "tpuserve_torch.models.resnet",
    "sd15": "tpuserve_torch.models.sd15",
    "textgen": "tpuserve_torch.models.textgen",
    "toy": "tpuserve_torch.models.toy",
}

# Families of the JAX package not ported yet -> their ROADMAP.md queue-1 item.
_NOT_PORTED: dict[str, str] = {}


def build(cfg: "ModelConfig") -> "ServingModel":
    """Instantiate the ServingModel for cfg.family."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not yet ported to tpuserve_torch "
            f"(ROADMAP.md queue 1: {_NOT_PORTED[cfg.family]})")
    if cfg.family not in _REGISTRY:
        raise KeyError(f"unknown model family {cfg.family!r}; known: "
                       f"{sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[cfg.family]).create(cfg)
