"""Model zoo of the port, mirroring ``tpuserve/models``.

Each family implements the ``ServingModel`` contract in ``base.py``. Ported:

- bert — BERT-base text classification, bucketed seq lens, dense, flash
  (kernel K1), ring (local step dense or kernel K2) or Ulysses (local step
  dense or K1) attention.
- resnet50 — ResNet-50 image classification (``vision.py`` serving: framed,
  npy and encoded-image bodies, rgb8 or yuv420 wire, preprocessing and
  softmax + top-k on the device; bf16, channels_last, cuDNN convolutions;
  weight-only int8).
- mobilenetv3 — MobileNetV3-Large image classification (the same
  ``vision.py`` serving; depthwise and squeeze-excite blocks, cuDNN
  convolutions, batch-1 latency through the CUDA graphs).
- toy — a tiny MLP image classifier, the fast model of the CPU tests.

The shared convolution, BatchNorm and weight-conversion code of the
convolutional families is ``layers.py``.

The JAX package's other families (efficientdet, sd15, textgen)
are registered by name and raise "not yet ported", naming their ROADMAP.md
item.
"""

from __future__ import annotations

import importlib
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from tpuserve_torch.config import ModelConfig
    from tpuserve_torch.models.base import ServingModel

_REGISTRY: dict[str, str] = {
    "bert": "tpuserve_torch.models.bert",
    "mobilenetv3": "tpuserve_torch.models.mobilenet",
    "resnet50": "tpuserve_torch.models.resnet",
    "toy": "tpuserve_torch.models.toy",
}

# Families of the JAX package not ported yet -> their ROADMAP.md queue-1 item.
_NOT_PORTED: dict[str, str] = {
    "efficientdet": "EfficientDet",
    "sd15": "SD 1.5",
    "textgen": "textgen",
}


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
