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
``.npz`` that ``cfg.weights`` names, held to its checksum manifest, a torch
checkpoint through the family's ``import_torch_variables``, or the seeded
init — and each family's ``from_jax_params`` / ``to_jax_params`` convert
between that tree and its module's state_dict. ``import_tf_variables``
maps a TF checkpoint's variables onto the tree for ``import-model``.

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
import copy
import logging
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tpuserve_torch import quantize, savedmodel
from tpuserve_torch.config import ModelConfig
from tpuserve_torch.parallel.mesh import SEQ_AXIS, Mesh, batch_sharding
from tpuserve_torch.parallel.partition import (REPLICATED_RULES, PartitionSpec,
                                               match_partition_rules, rank_coords, split_tree)

log = logging.getLogger("tpuserve_torch.models")

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


class MeshModule(torch.nn.Module):
    """One parameter slot of a mesh that splits the forward: a module per
    rank (``ranks``, in the layout the family's ``mesh_module`` chose —
    one per data rank, one per (data, model) rank, or one per stage), each
    on its rank's device. The runtime treats it as one module: its
    parameters and buffers are the slot's tensors, copied in place by a
    reload, and ``ServingModel.mesh_forward`` runs it."""

    def __init__(self, ranks: list[torch.nn.Module], mesh: Mesh,
                 grid: tuple[int, ...]) -> None:
        super().__init__()
        self.ranks = torch.nn.ModuleList(ranks)
        self.mesh = mesh
        self.grid = grid  # the ranks' layout, e.g. (dp, tp) or (stages,)

    def rank(self, *index: int) -> torch.nn.Module:
        return self.ranks[int(np.ravel_multi_index(index, self.grid))]


def rows_split(batch: tuple, n: int) -> list[tuple]:
    """A batch's tensors cut into ``n`` equal row blocks."""
    rows = batch[0].shape[0] // n
    return [tuple(t[i * rows:(i + 1) * rows] for t in batch) for i in range(n)]


def rows_gather(outs: list, device: torch.device) -> Any:
    """Per-rank outputs (dicts of batch-leading tensors, or tensors) joined
    along the rows on ``device``."""
    if isinstance(outs[0], dict):
        return {k: torch.cat([o[k].to(device) for o in outs]) for k in outs[0]}
    return torch.cat([o.to(device) for o in outs])


def partial_sum(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum over the model axis, single-controller: each model rank's
    partial output of a product whose input dim is split over the ranks,
    added on ``device`` (the first rank's) in rank order, in the partials'
    own dtype."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def tp_bias_share(tree: dict, m: int, tp: int, cols: tuple[str, ...],
                  rows: tuple[str, ...]) -> dict:
    """Model rank ``m`` of ``tp``'s share of the biases the reference keeps
    replicated and XLA slices with their split products, found by module
    name anywhere in ``tree``: a product split by columns (named in
    ``cols``) keeps its bias' block ``m`` along the first dim; a product
    split by rows (``rows``) keeps its bias on rank 0 alone, zeros on the
    others, so ``partial_sum`` adds it once. A new tree; every other leaf
    is shared."""
    def walk(node: dict) -> dict:
        out = {}
        for k, v in node.items():
            if k in cols:
                n = np.shape(v["bias"])[0] // tp
                v = dict(v, bias=v["bias"][m * n:(m + 1) * n])
            elif k in rows:
                v = dict(v, bias=v["bias"] if m == 0 else np.zeros_like(v["bias"]))
            elif isinstance(v, dict) and not quantize.is_quantized(v):
                v = walk(v)
            out[k] = v
        return out

    return walk(tree)


def to_device(batch: tuple, device: torch.device) -> tuple:
    return tuple(t.to(device) for t in batch)


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
        ``require_manifest``), whose quantized ``{"q8", "q8_scale"}``
        sub-trees need ``quantize = "int8"``/``"int8c"`` (ValueError with
        the reference's guidance otherwise); a torch checkpoint, imported through
        ``import_torch_variables`` and, as in the reference, held to no
        manifest; or the seeded init (seed 0) when no weights are
        configured."""
        if not self.cfg.weights:
            return self.to_jax_params(self.init_params(0))
        path = self.cfg.weights
        if savedmodel.detect_format(path) == "torch":
            t0 = time.perf_counter()
            flat = savedmodel.read_torch_checkpoint(path)
            t1 = time.perf_counter()
            tree = self.import_torch_variables(flat)
            log.info("%s: imported torch checkpoint %s (%d tensors): read %.3f s, "
                     "mapping %.3f s", self.name, path, len(flat), t1 - t0,
                     time.perf_counter() - t1)
            return tree
        tree = savedmodel.load_npz(path)
        if verify_integrity:
            savedmodel.verify_manifest_if_present(path, tree, require=require_manifest)
        if quantize.has_quantized_leaves(tree) and self.cfg.quantize not in ("int8", "int8c"):
            # Never served as float: the int8 values would read as weights.
            raise ValueError(
                f"checkpoint at {path!r} holds int8-quantized weights; set "
                "quantize = \"int8\" (weight-only) or \"int8c\" (int8 compute) "
                "on the model to serve it")
        return tree

    def load_params(self) -> Any:
        """``load_tree`` (integrity gate included), as a float32 state_dict;
        a tree holding pre-quantized leaves comes back as it is (the
        runtime installs its int8 values and scales as they are)."""
        tree = self.load_tree()
        if quantize.has_quantized_leaves(tree):
            return tree
        return self.from_jax_params(tree)

    def import_tf_variables(self, flat: dict[str, np.ndarray]) -> Any:
        """Translate a flat TF {name: array} dict into the reference's tree
        (``import-model``). Family-specific (name schemes and layouts differ
        per source repo)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no TF variable mapping; convert the "
            "weights to the port's .npz or implement import_tf_variables")

    def import_torch_variables(self, flat: dict[str, np.ndarray]) -> Any:
        """Translate a flat torch {name: array} state_dict into the
        reference's tree. Family-specific; implemented for families whose
        published artifacts ship as torch/safetensors (SD 1.5)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no torch state_dict mapping; convert "
            "the weights to the port's .npz or implement import_torch_variables")

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

    # True for a family with a homogeneous block stack that pipelines its
    # own depth (parallelism = "pipeline"); BERT does.
    pipeline_capable = False

    def partition_rules(self) -> list[tuple[str, PartitionSpec]]:
        """Ordered (regex, PartitionSpec) rules over the reference tree's
        '/'-joined leaf paths; default replicate."""
        return list(REPLICATED_RULES)

    def _with(self, **attrs) -> "ServingModel":
        """A view of this model with other sizes (a tensor-parallel rank's
        widths, a pipeline stage's layers, a rank's seq mesh): its
        ``build_module``, ``from_jax_params`` and ``reference_layout`` read
        them."""
        view = copy.copy(self)
        view.__dict__.update(attrs)
        return view

    def model_rank_trees(self, tree: Any, mesh: Mesh) -> list[tuple[dict, Any, torch.device]]:
        """``(coordinate, block of tree, device)`` of every (data, model)
        rank, the tree split by ``partition_rules`` (a rank's seq ranks hold
        the same block: seq rank 0's stands for them). Under ``quantize``
        the whole tree is cast and quantized first and then split
        (``quantize.specs_for_tree``), so each rank's scales are the whole
        weight's, as the reference quantizes before it shards."""
        if self.cfg.quantize is not None:
            tree = quantize.quantize_tree(
                quantize.cast_tree(tree, DTYPES[self.cfg.dtype]), self.cfg.quantize_min_size)
            specs = quantize.specs_for_tree(self.partition_rules(), tree)
        else:
            specs = match_partition_rules(self.partition_rules(), tree)
        return [(coord, rank_tree, dev) for coord, rank_tree, dev in
                zip(rank_coords(mesh), split_tree(tree, specs, mesh), mesh.devices.flat)
                if not coord[SEQ_AXIS]]

    def mesh_module(self, tree: Any, mesh: Mesh, prepare) -> MeshModule:
        """One parameter slot on a mesh that splits the forward (a data or
        model axis larger than 1, or pipeline stages), from the reference's
        tree. ``prepare(model, tree, device)`` builds one rank's module the
        way the runtime builds a one-device slot (conversion, cast,
        quantization). Default, the reference's default rule
        (``REPLICATED_RULES``): the parameters replicate over every axis,
        so the ranks of one data rank (its model and seq ranks) would
        compute the same rows: one full copy per data rank is built, on
        that rank's device. A family that splits its weights over the model
        axis or pipelines overrides it."""
        devs = batch_sharding(mesh)
        return MeshModule([prepare(self, tree, d) for d in devs], mesh, (len(devs),))

    def data_ranks(self, module: MeshModule) -> list:
        """What each data rank of a ``MeshModule`` runs its rows on, in data
        rank order: default, its copy. A family that splits a data rank
        over model ranks returns a view of them."""
        return list(module.ranks)

    def mesh_forward(self, module: MeshModule, batch: tuple) -> Outputs:
        """``forward`` over a ``MeshModule``: default, each data rank runs
        its rows on its ``data_ranks`` module, on its device, and the rows
        come back to the first rank's device (the batch is split and
        gathered, as the reference's sharded executable takes and returns
        it)."""
        devs = batch_sharding(module.mesh)
        outs = [self.forward(rank, to_device(rows, d)) for rank, rows, d in
                zip(self.data_ranks(module), rows_split(batch, len(devs)), devs)]
        return rows_gather(outs, devs[0])

    def mesh_logits(self, module: MeshModule, batch: tuple) -> torch.Tensor:
        """``logits`` over a ``MeshModule`` (default: per data rank, rows
        gathered on the first rank's device)."""
        devs = batch_sharding(module.mesh)
        return rows_gather([self.logits(rank, to_device(rows, d)) for rank, rows, d in
                            zip(self.data_ranks(module), rows_split(batch, len(devs)), devs)],
                           devs[0])

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
        return self.top_k_outputs(self.logits(module, batch))

    def top_k_outputs(self, logits: torch.Tensor) -> Outputs:
        """The device postprocess of (B, classes) logits: float32 softmax
        and top-k."""
        probs = torch.softmax(logits.float(), dim=-1)
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
