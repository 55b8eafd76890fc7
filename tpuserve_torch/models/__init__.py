"""Model zoo of the port, mirroring ``tpuserve/models``.

Each family implements the ``ServingModel`` contract in ``base.py``. Ported:

- bert — BERT-base text classification, bucketed seq lens, dense, flash
  (kernel K1), ring (local step dense or kernel K2) or Ulysses (local step
  dense or K1) attention.

The JAX package's other families (resnet50, mobilenetv3, efficientdet, sd15,
textgen, toy) are registered by name and raise "not yet ported", naming
their ROADMAP.md item.
"""

from __future__ import annotations

import importlib
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from tpuserve_torch.config import ModelConfig
    from tpuserve_torch.models.base import ServingModel

_REGISTRY: dict[str, str] = {
    "bert": "tpuserve_torch.models.bert",
}

# Families of the JAX package not ported yet -> their ROADMAP.md queue-1 item.
_NOT_PORTED: dict[str, str] = {
    "resnet50": "ResNet-50 (the next path)",
    "mobilenetv3": "MobileNetV3",
    "efficientdet": "EfficientDet",
    "sd15": "SD 1.5",
    "textgen": "textgen",
    "toy": "ResNet-50 (the next path)",
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
