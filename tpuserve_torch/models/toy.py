"""Toy model family: a tiny MLP classifier, ported from
``tpuserve/models/toy.py``.

The fast model of the CPU tests and of the serve recipe: it exercises the
whole ServingModel contract (device preprocessing, top-k behind the network,
padding, framed and npy client batches) without a real network's cost. The
weights are ``nn.Linear``s, (out, in), so the weight-only int8 path treats
them as the reference treats its (in, out) kernels; ``from_jax_params``
and ``to_jax_params`` transpose them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpuserve_torch import frame, preproc
from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models.base import DTYPES, ServingModel, TensorSpec

EDGE = 8  # toy wire shape: (8, 8, 3) uint8


class ToyMLP(nn.Module):
    def __init__(self, hidden: int, num_classes: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(EDGE * EDGE * 3, hidden)
        self.fc2 = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.tanh(self.fc1(x)))


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """The reference's {"w1", "b1", "w2", "b2"} -> this port's state_dict."""
    t = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in tree.items()}
    return {"fc1.weight": t["w1"].T.contiguous(), "fc1.bias": t["b1"],
            "fc2.weight": t["w2"].T.contiguous(), "fc2.bias": t["b2"]}


def to_jax_params(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """This port's state_dict -> the reference's {"w1", "b1", "w2", "b2"}."""
    sd = {k: v.detach().to(torch.float32).cpu() for k, v in state_dict.items()}
    return {"w1": sd["fc1.weight"].T.contiguous().numpy(), "b1": sd["fc1.bias"].numpy(),
            "w2": sd["fc2.weight"].T.contiguous().numpy(), "b2": sd["fc2.bias"].numpy()}


class ToyServing(ServingModel):
    TOP_K = 3

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__(cfg)
        self.dtype = DTYPES[cfg.dtype]
        self.hidden = int(cfg.options.get("hidden", 32))
        self.top_k = min(self.TOP_K, cfg.num_classes)

    def build_module(self) -> ToyMLP:
        return ToyMLP(self.hidden, self.cfg.num_classes)

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Seeded N(0, 0.02) weights and zero biases, as the reference draws
        them (not its bits)."""
        rng = np.random.default_rng(seed)
        d_in = EDGE * EDGE * 3
        return from_jax_params({
            "w1": rng.normal(0.0, 0.02, (d_in, self.hidden)),
            "b1": np.zeros(self.hidden),
            "w2": rng.normal(0.0, 0.02, (self.hidden, self.cfg.num_classes)),
            "b2": np.zeros(self.cfg.num_classes)})

    def input_signature(self, bucket: tuple) -> tuple[TensorSpec, ...]:
        (b,) = bucket
        return (TensorSpec((b, EDGE, EDGE, 3), np.dtype(np.uint8)),)

    def device_preprocess(self, batch: tuple) -> torch.Tensor:
        """uint8 wire -> flattened [0, 1] compute dtype."""
        (x,) = batch
        return x.to(self.dtype).reshape(x.shape[0], -1) / 255.0

    def logits(self, module: ToyMLP, batch: tuple) -> torch.Tensor:
        return module(self.device_preprocess(batch))

    def from_jax_params(self, tree) -> dict[str, torch.Tensor]:
        return from_jax_params(tree)

    def to_jax_params(self, state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        return to_jax_params(state_dict)

    def host_decode(self, payload: bytes, content_type: str) -> np.ndarray:
        return preproc.decode_image(payload, content_type, edge=EDGE)

    def host_decode_items(self, payload: bytes, content_type: str) -> tuple[list, bool]:
        """Framed (zero-copy) and npy client batches, sharing the vision
        wire contracts (one parse either way)."""
        if content_type == frame.CONTENT_TYPE:
            return frame.parse_frame(
                payload, kind=frame.KIND_RGB8, edge=EDGE,
                max_items=self.MAX_ITEMS_PER_REQUEST), True
        if content_type != "application/x-npy":
            return [self.host_decode(payload, content_type)], False
        return preproc.decode_npy_items(payload, EDGE, self.MAX_ITEMS_PER_REQUEST)

    def host_postprocess(self, outputs: dict, n_valid: int) -> list[dict]:
        return self.format_top_k(outputs, n_valid)

    def canary_item(self) -> np.ndarray:
        return np.zeros((EDGE, EDGE, 3), dtype=np.uint8)


def create(cfg: ModelConfig) -> ToyServing:
    return ToyServing(cfg)
