"""ServingModel: the contract between the model zoo and the runtime/batcher,
ported from ``tpuserve/models/base.py``.

The runtime warms ``forward`` up once per (batch-bucket, input-shape) pair
at startup and, on CUDA, captures it as a graph per parameter slot, which it
replays per batch; the batcher assembles padded host batches, and
``forward`` does everything device-side — preprocessing in front of the
network (``device_preprocess``, inside ``logits``) and postprocessing
(softmax, top-k) behind it — so one H2D copy of the inputs and one D2H copy
of small outputs happen per batch.

Weights: ``load_tree`` reads the reference's float32 parameter tree — the
``.npz`` that ``cfg.weights`` names, held to its checksum manifest, or the
seeded init — and each family's ``from_jax_params`` / ``to_jax_params``
convert between that tree and its module's state_dict.

``input_signature`` gives a tuple of (shape, dtype) specs (numpy dtypes, the
host batch layout) where the JAX package gives ``jax.ShapeDtypeStruct``s; a
host batch is always the matching tuple of arrays, one component for an rgb8
image batch, three for YUV 4:2:0 planes, two for BERT's ids and mask.
Dynamic request counts are handled by padding: ``host_postprocess`` reads
the first ``n_valid`` rows, and padded lanes must not influence real lanes.
The host side (decode, assemble, postprocess) is numpy and copied as it is.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tpuserve_torch import quantize, savedmodel
from tpuserve_torch.config import ModelConfig

# A host batch: a tuple of np.ndarrays with leading batch dim.
HostBatch = Any
# Device outputs: a dict of tensors with leading batch dim.
Outputs = Any


# Compute dtypes by their config name.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a family raises for a setting the port does not serve yet,
    naming its ROADMAP.md item."""
    return NotImplementedError(
        f"{what} is not yet ported to tpuserve_torch (ROADMAP.md queue 1: {item})")


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one host-batch input (the port's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: np.dtype


def _stack_pad(arrs: list[np.ndarray], b: int) -> np.ndarray:
    out = np.stack(arrs, axis=0)
    if out.shape[0] < b:
        pad = np.zeros((b - out.shape[0],) + out.shape[1:], dtype=out.dtype)
        out = np.concatenate([out, pad], axis=0)
    return out


class ServingModel(abc.ABC):
    """One deployable model family instance."""

    # True: the runtime keeps the module's 4-D weights in channels_last
    # memory (convolutional families, whose inputs come channels_last).
    channels_last = False

    def __init__(self, cfg: ModelConfig) -> None:
        self.cfg = cfg
        self.name = cfg.name
        if cfg.weights:
            savedmodel.detect_format(cfg.weights)  # refuse a form the port cannot read
        self.class_labels: list[str] | None = None
        if cfg.labels:
            with open(cfg.labels, encoding="utf-8") as f:
                lines = [line.rstrip("\r\n") for line in f]
            while lines and not lines[-1]:  # trailing blank lines
                lines.pop()
            self.class_labels = lines

    # -- parameters ---------------------------------------------------------
    @abc.abstractmethod
    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Seeded random float32 parameters as a CPU state_dict."""

    @abc.abstractmethod
    def from_jax_params(self, tree: Any) -> dict[str, torch.Tensor]:
        """The reference's parameter tree (numpy leaves) -> this port's
        float32 state_dict."""

    @abc.abstractmethod
    def to_jax_params(self, state_dict: dict[str, torch.Tensor]) -> dict:
        """The inverse of ``from_jax_params``, bit for bit: a float32
        state_dict -> the reference's tree of numpy arrays."""

    def load_tree(self, verify_integrity: bool = True,
                  require_manifest: bool = False) -> dict:
        """The reference's float32 parameter tree: ``cfg.weights``' .npz,
        held to its sidecar checksum manifest before anything else reads it
        (IntegrityError; a missing manifest is one only with
        ``require_manifest``), or the seeded init (seed 0) when no weights
        are configured."""
        if not self.cfg.weights:
            return self.to_jax_params(self.init_params(0))
        tree = savedmodel.load_npz(self.cfg.weights)
        if verify_integrity:
            savedmodel.verify_manifest_if_present(self.cfg.weights, tree,
                                                  require=require_manifest)
        return tree

    def load_params(self) -> dict[str, torch.Tensor]:
        """``load_tree`` (integrity gate included), as a float32 state_dict."""
        return self.from_jax_params(self.load_tree())

    @abc.abstractmethod
    def build_module(self) -> torch.nn.Module:
        """The network as an ``nn.Module`` whose state_dict matches
        ``init_params``; the runtime loads params into it."""

    def reference_layout(self, name: str, shape: tuple) -> tuple[tuple, tuple]:
        """How parameter ``name`` of the module lies in the reference's tree:
        ``(view, perm)`` with ``reference leaf == param.reshape(view)
        .permute(perm)``. Quantization picks the reference's channel through
        it (``tpuserve_torch.quantize``). Default: conv weights OIHW (the
        reference's HWIO), ``nn.Linear`` weights (out, in) (its (in, out)
        Dense kernels), other leaves as they are."""
        return quantize.default_layout(shape)

    def int8c_native_kernel_paths(self) -> list[str]:
        """Regexes over parameter names of the weights an int8c module
        (``quantize.Int8Linear``, ``quantize.Int8Conv1x1``) consumes int8
        natively under ``quantize = "int8c"``. Empty by default: the runtime
        then refuses int8c for the family, as the reference's does."""
        return []

    def bind_mesh(self, mesh) -> None:
        """Hook for mesh-aware models (BERT's ring/Ulysses attention): the
        runtime passes its serving mesh before it builds the module and
        warms up. A no-op by default."""

    # -- shapes -------------------------------------------------------------
    @abc.abstractmethod
    def input_signature(self, bucket: tuple) -> tuple[TensorSpec, ...]:
        """Specs of the host batch for a bucket key: ``(batch,)`` for vision,
        ``(batch, seq)`` for text."""

    def buckets(self) -> list[tuple]:
        """All bucket keys warmed up at startup."""
        return [(b,) for b in self.cfg.batch_buckets]

    def bucket_for(self, n: int, **kw) -> tuple:
        """Smallest bucket that fits n requests (used by the batcher)."""
        for b in self.cfg.batch_buckets:
            if b >= n:
                return (b,)
        return (self.cfg.batch_buckets[-1],)

    # -- device-side --------------------------------------------------------
    def device_preprocess(self, batch: Any) -> Any:
        """Device-side preprocessing seam: wire arrays -> network input.
        Identity by default (token ids go to the network as they are)."""
        return batch

    @abc.abstractmethod
    def logits(self, module: torch.nn.Module, batch: Any) -> torch.Tensor:
        """Device preprocess + network on a batch of device tensors: the
        (B, classes) logits."""

    # Entries of each answer's top-k (families set it from num_classes).
    top_k = 5

    def forward(self, module: torch.nn.Module, batch: Any) -> Outputs:
        """``logits`` + device postprocess: float32 softmax and top-k."""
        probs = torch.softmax(self.logits(module, batch).float(), dim=-1)
        top_p, top_i = torch.topk(probs, self.top_k, dim=-1)
        return {"probs": top_p, "indices": top_i}

    # -- host-side ----------------------------------------------------------
    @abc.abstractmethod
    def host_decode(self, payload: bytes, content_type: str) -> Any:
        """Decode one request body into per-item input arrays (threadpool)."""

    def host_decode_items(self, payload: bytes, content_type: str) -> tuple[list, bool]:
        """Decode one request body into (items, is_batch) with a single
        parse; ``is_batch`` requests answer in the {"results": [...]} shape."""
        return [self.host_decode(payload, content_type)], False

    # A single POST may not carry more items than this.
    MAX_ITEMS_PER_REQUEST = 1024

    def canary_item(self) -> Any:
        """A trivial decoded item used by health canaries; default zero
        image at the wire edge."""
        w = self.cfg.wire_size
        return np.zeros((w, w, 3), dtype=np.uint8)

    def group_key(self, item: Any) -> Any:
        """Batching group for a decoded item (e.g. seq bucket); None = one group."""
        return None

    @abc.abstractmethod
    def host_postprocess(self, outputs: Outputs, n_valid: int) -> list[Any]:
        """Convert device outputs (already np) to n_valid JSON-able results."""

    def format_top_k(self, outputs: dict, n_valid: int) -> list[dict]:
        """Shared classifier response shape: {"top_k": [{class, prob}, ...]},
        plus a "label" per entry when cfg.labels names the classes."""
        probs = outputs["probs"][:n_valid]
        idx = outputs["indices"][:n_valid]
        return [
            {"top_k": [self._class_entry(i, p) for i, p in zip(idx[r], probs[r])]}
            for r in range(n_valid)
        ]

    def _class_entry(self, i, p) -> dict:
        entry = {"class": int(i), "prob": float(p)}
        label = self.label_for(int(i))
        if label is not None:
            entry["label"] = label
        return entry

    def label_for(self, i: int) -> str | None:
        if self.class_labels is not None and 0 <= i < len(self.class_labels):
            return self.class_labels[i]
        return None

    def assemble(self, items: list[Any], bucket: tuple) -> HostBatch:
        """Stack decoded items into one padded host batch (a tuple) for
        `bucket`: each component stacked along axis 0 and zero-padded up to
        bucket[0]. An item that is one array is a one-component batch."""
        b = bucket[0]
        items = [it if isinstance(it, tuple) else (it,) for it in items]
        return tuple(_stack_pad([it[k] for it in items], b) for k in range(len(items[0])))

    def assemble_into(self, items: list[Any], bucket: tuple, out: HostBatch) -> HostBatch:
        """Assemble into a preallocated host-batch buffer (the tuple shaped
        like ``input_signature(bucket)``); must produce exactly what
        ``assemble`` would, writing in place (real rows copied — read-only
        frame views included —, padded rows zeroed)."""
        n = len(items)
        items = [it if isinstance(it, tuple) else (it,) for it in items]
        for k, comp in enumerate(out):
            for i, it in enumerate(items):
                comp[i] = it[k]
            if n < comp.shape[0]:
                comp[n:] = 0
        return out
