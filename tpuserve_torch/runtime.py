"""Runtime: parameter slots on one device, a captured CUDA graph per (bucket,
slot), the variant registry and the versioned weight lifecycle, ported from
``tpuserve/runtime.py``.

The JAX runtime AOT-compiles one XLA executable per (bucket, device set) and
passes the weight tree to it as an argument, so publishing a new tree never
recompiles. A CUDA graph instead bakes in the addresses of every tensor it
reads. So the port keeps ``N_SLOTS`` = 3 *parameter slots* — live,
last-known-good and staged — each one copy of the module's parameters and
buffers (int8 values, float32 scales and BatchNorm statistics included) at
fixed addresses, and captures one graph per (bucket, slot):

- startup: each bucket is warmed up eagerly, once per slot (this sets K1/K2's
  shared-memory opt-in, cuBLAS' workspace and cuDNN's plans before any
  capture), then captured per slot into one memory pool per runtime and
  replayed once (a graph's first launch uploads it to the card), and its
  inputs are allocated once on the copy stream the served h2d uses
  (``prewarm_executables = false``: no replay at startup, the captures
  stay; on the CPU no warm run). A
  variant is the bucket's graph set: ``runtime_compiles_total`` counts one
  per bucket, as the JAX runtime counts one per (bucket, replica), and the
  variant summary reports its ``captures`` and ``compile_ms``. A capture that
  fails raises at startup; no bucket is ever served eagerly on CUDA.
- ``dispatch`` copies the device batch into the graph's static inputs,
  replays it and clones its (small) outputs, all on the calling thread's
  current stream and under one lock, so batches in flight never share a
  static buffer. The launches of K1/K2 each graph recorded at capture are
  added to the kernels' counts on every replay.
- ``stage_params`` loads a candidate, runs the gates (integrity, NaN/Inf
  scan, structure) and only then copies it in place into a free slot, after
  that slot's last replay has finished on the card; ``publish`` and
  ``rollback`` switch which slot is live. Zero new captures, ever.
- Weight paging (the fleet scheduler's ``cold_start``): a cold runtime
  (``build_runtime(..., cold=True)``) holds no slot and has captured
  nothing (``compiles_total`` 0). Its first ``stage_params`` fills all
  ``N_SLOTS`` slots with the candidate and ``ensure_compiled`` warms up and
  captures every (bucket, slot), so a later reload still needs no capture;
  ``publish`` makes it resident (``params_resident``). ``release_params``
  (demote) waits for each slot's last replay, then drops the graphs, the
  slots' tensors and the graphs' memory pool and empties PyTorch's cache,
  so the memory is back on the card. A graph binds its slot's storage by
  address, so the graphs go with the storage: a re-warm captures every
  (bucket, slot) again. The variant registry stays, so the port's form of
  the reference's "a re-warm recompiles nothing" is that
  ``runtime_compiles_total`` does not move across demote and re-warm while
  ``captures_total`` rises by slots x buckets. A dispatch on a released (or
  not yet published) runtime raises; it never replays a graph over freed
  storage.

The iteration-level generation engine (``tpuserve_torch.genserve``) adds
*programs* (``register_program`` / ``run_program``): insert or prefill, step
and extract, each a function of a parameter slot's module, the engine's state
block and a few small arguments. The state block (KV caches, token buffers,
per-slot counters) is one set of device tensors the programs update in place,
standing in for the JAX engine's donated state; the runtime keeps
``N_BLOCKS`` = 2 of them — the live block the engine serves from and a
scratch block the lifecycle's staged canary generates on — and captures one
graph per (program, parameter slot, block), so slot roles rotating on
publish and rollback never need a new capture. A program's small arguments
(slot index, request item, chunk start, block-table row) are copied into its
static input tensors before each replay and never baked into a graph, so
slot, page and chunk churn replay the same graphs.

``debug_nans`` makes every fetch check its outputs and fail the batch with
FloatingPointError on NaN/Inf (bound at construction: with it off the fetch
is the plain one); ``configure_runtime`` points the kernel build at
``compilation_cache_dir``.

On the CPU the slots and the version machine are the same and each slot's
module runs eagerly (the tests do this); only capture and replay are
CUDA-only. The graphs of one runtime share a memory pool and are replayed on
one stream, one at a time in stream order, so they never run concurrently.
Captures use ``capture_error_mode="thread_local"``, so a capture (a re-warm
under live load) tolerates other threads' allocations and syncs, and take
the K1/K2 launches a graph records from ``fa.capture_launches``, which sees
the capturing thread's launches only.

The device is explicit: ``build_runtime(model)`` serves on the current CUDA
device, ``device="cpu"`` on the CPU; CUDA absent without ``device="cpu"``
raises instead of falling back.

Parallelism (the model's ``parallelism``, bounded by ``[parallel]``), as
the reference's runtime builds it, single-controller: one process owns
every rank, and the ranks may share one device (``mesh.visible_devices``
lists the devices; the tests and ``chip_smoke.py`` patch it):

- ``"single"``: the given device alone;
- ``"sharded"``: a (data, model, seq) mesh over ``select_devices`` (the
  buckets round up to multiples of the data axis); with a data or model
  axis larger than 1 each parameter slot is a ``MeshModule`` of rank
  modules (the family's ``mesh_module``: a copy per data rank, BERT's,
  ResNet-50's and textgen's weights split over the model axis, the other
  families' replicated over it) and the family's ``mesh_forward`` runs
  them; a seq axis runs BERT's ring/Ulysses attention and textgen's KV
  context (each rank module over its own seq ranks) and replicates the
  other families' work;
- ``"pipeline"``: a ("stage",) mesh of ``pp`` stages, for a family that
  pipelines its own depth (BERT), without ``quantize``;
- ``"replica"``: ``ReplicaRuntime``, one one-device runtime per device.

A split forward is captured as one CUDA graph per (bucket, slot), its
collectives (the all-reduce after a row-split product, the pipeline's
hand-offs) being tensor operations inside it; a graph cannot span cards,
so on CUDA every rank of a split mesh must share one card, and a mesh
over several is refused (ROADMAP item 10). ``runtime_compiles_total``
counts one per bucket per mesh (replicas x buckets for a ReplicaRuntime),
as the reference's counts one per (bucket, mesh).

A deferred-mode worker (``tpuserve_torch.deferred``) runs no lifecycle, so
it asks for one parameter slot (``build_runtime(..., n_slots=1)``) and one
graph per bucket; every other runtime keeps ``N_SLOTS``.

Hot path, one batch: ``h2d`` copies the pinned host batch with
``non_blocking=True`` on a copy stream of its own, ``dispatch`` replays the
bucket's graph on the current stream (which waits for that copy on the
card) and returns device tensors at once, ``fetch`` blocks for the small
outputs' copy back (called off the event loop by the batcher's fetch stage).
"""

from __future__ import annotations

import gc
import logging
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from tpuserve_torch import quantize
from tpuserve_torch.analysis import witness
from tpuserve_torch.config import ModelConfig, ParallelConfig, ServerConfig
from tpuserve_torch.faults import FaultInjected
from tpuserve_torch.models.base import DTYPES, MeshModule, ServingModel
from tpuserve_torch.obs import Metrics
from tpuserve_torch.ops import _build
from tpuserve_torch.ops import flash_attention as fa
from tpuserve_torch.parallel.distributed import check_local_mesh
from tpuserve_torch.parallel import mesh as meshlib
from tpuserve_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, MeshPlan, make_mesh,
                                          pad_batch_to_mesh, plan_for, select_devices)
from tpuserve_torch.parallel.pipeline import STAGE_AXIS, make_stage_mesh
from tpuserve_torch.savedmodel import IntegrityError
from tpuserve_torch.utils.locks import new_lock
from tpuserve_torch.utils.retrace import allow_transfers, host_fetch
from tpuserve_torch.utils.trees import map_leaves, nonfinite_paths, tree_summary

log = logging.getLogger("tpuserve_torch.runtime")

# Parameter slots: live, last-known-good and staged. Rollback stays a switch
# of the live slot, so no fewer will do.
N_SLOTS = 3
# Generation state blocks: the live block the engine serves from, and the
# scratch block the staged canary runs on (it must never touch the live one).
N_BLOCKS = 2
LIVE_BLOCK, SCRATCH_BLOCK = 0, 1


class NaNDetected(ValueError):
    """A candidate weight tree holds NaN/Inf float leaves; the reload gate
    (tpuserve_torch.lifecycle) rejects it and the old version keeps serving."""


def configure_runtime(cfg: ServerConfig) -> None:
    """Process-wide runtime settings (call once, before any kernel builds):
    ``compilation_cache_dir`` becomes the directory the hand-written
    kernels build into and load from."""
    if cfg.compilation_cache_dir:
        _build.set_build_dir(cfg.compilation_cache_dir)


def resolve_device(device: "str | torch.device | None" = None,
                   init: bool = True) -> torch.device:
    """The device a runtime serves on: the current CUDA device unless the
    caller names another. Raises when CUDA is asked for (or defaulted to)
    and absent — the port never falls back to the CPU on its own.
    ``init=False`` leaves CUDA uninitialized in this process: an unindexed
    ``"cuda"`` stays unindexed (a process that only hands the device to
    workers, as a deferred pool's server does)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"tpuserve_torch serves on 'cuda' or 'cpu', not {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: tpuserve_torch runs on the GPU by "
                "default; pass device='cpu' (serve --device cpu) to run on "
                "the CPU")
        if dev.index is None and init:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def backend_info(device: torch.device) -> dict:
    """What the server runs on, for /stats: the card, torch and CUDA,
    whether this process initialized CUDA, and then the card and this
    process's ``memory_reserved`` and ``memory_allocated`` (never asked of
    a process that did not: the question would initialize it)."""
    info = {"device": str(device), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "cuda_initialized": torch.cuda.is_initialized()}
    if device.type == "cuda" and info["cuda_initialized"]:
        info["device_name"] = torch.cuda.get_device_name(device)
        info["device_count"] = torch.cuda.device_count()
        info["memory_reserved_bytes"] = torch.cuda.memory_reserved(device)
        info["memory_allocated_bytes"] = torch.cuda.memory_allocated(device)
    return info


@dataclass(frozen=True)
class VariantKey:
    """Identity of one specialized variant: the static batch/seq bucket,
    the compute dtype, the quantization mode and the parallelism layout
    (the JAX registry's key, unchanged; weight versions are not part of it,
    so publish and rollback reuse the variant set)."""

    bucket: tuple
    dtype: str
    quantize: str | None
    parallelism: str

    @property
    def label(self) -> str:
        """Compact metric-label form: "<bucket>/<dtype>/<quantize>/<mode>"."""
        b = "x".join(str(d) for d in self.bucket)
        return f"{b}/{self.dtype}/{self.quantize or 'fp'}/{self.parallelism}"


@dataclass
class Variant:
    """Registry entry: one VariantKey, warmed up and (on CUDA) captured on
    every parameter slot."""

    key: VariantKey
    compile_ms: float = 0.0
    captures: int = 0
    replicas: int = 1

    def summary(self) -> dict:
        return {
            "bucket": list(self.key.bucket),
            "dtype": self.key.dtype,
            "quantize": self.key.quantize,
            "parallelism": self.key.parallelism,
            "replicas": self.replicas,
            "captures": self.captures,
            "compile_ms": round(self.compile_ms, 1),
        }


@dataclass
class Graph:
    """One bucket's forward captured on one parameter slot: its static
    input and output tensors, and the K1/K2 launches one replay makes
    (each kernel's by q shape in ``k1_shapes`` and ``k2_shapes``)."""

    graph: Any  # torch.cuda.CUDAGraph
    inputs: tuple
    outputs: dict
    launches: tuple[int, int]
    k1_shapes: dict
    k2_shapes: dict


@dataclass
class Program:
    """One registered generative program: ``fn(module, state, *args)``, the
    specs of its arguments after the state block, the static input tensors
    its graphs read (shared by all of them: replays are serialized), and on
    CUDA its graph per (parameter slot, state block)."""

    tag: str
    fn: Callable
    arg_specs: tuple
    inputs: tuple = ()
    graphs: dict[tuple[int, int], Graph] = field(default_factory=dict)
    counter: Any = None
    # Whatever the registering engine needs to read the outputs back (the
    # step's packed out-block layout).
    out_layout: dict = field(default_factory=dict)


@dataclass
class Slot:
    """One parameter slot: a module whose parameters and buffers (every
    tensor the forward reads) stay at fixed addresses for the runtime's
    life, its graphs, and the event recorded after its last replay."""

    module: torch.nn.Module
    tensors: dict[str, torch.Tensor]
    graphs: dict[tuple, Graph] = field(default_factory=dict)
    last_replay: Any = None  # torch.cuda.Event
    # Bumped by each stage into this slot (a staged handle stays valid only
    # while its generation is the slot's).
    generation: int = 0


@dataclass(frozen=True)
class StagedParams:
    """What ``stage_params`` returns: the slot holding the candidate. Pass
    it to ``dispatch``/``run`` as ``params_override`` (the staged canary)
    and then to ``publish``."""

    slot: int
    generation: int


def slot_tensors(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Every parameter and buffer of ``module`` by name, non-persistent
    buffers included (a quantized weight's ``scale_cast``): all the storage
    a forward reads."""
    out = dict(module.named_parameters())
    out.update(module.named_buffers())
    return out


class ModelRuntime:
    """Owns the model's parameter slots on one device, their graphs, the
    variant registry and the weight version machine."""

    def __init__(self, model: ServingModel,
                 device: "str | torch.device | None" = None,
                 metrics: Metrics | None = None, prewarm: bool = True,
                 debug_nans: bool = False, n_slots: int = N_SLOTS,
                 parallel: ParallelConfig | None = None,
                 mode: str | None = None, replica: int = 0,
                 signature: str | None = None) -> None:
        self.model = model
        # Parameter slots this runtime fills: N_SLOTS, or 1 for a runtime
        # that never stages a candidate (a deferred-mode worker).
        self.n_slots = n_slots
        self.cfg: ModelConfig = model.cfg
        self.metrics = metrics if metrics is not None else Metrics()
        # Server-wide device plan ([parallel]): bounds the device set and
        # sizes the sharded data axis. The mode override happens at the
        # config level (ServerState.build), so cfg.parallelism is the truth
        # here; a replica of a ReplicaRuntime passes mode="single".
        self.pcfg = parallel if parallel is not None else ParallelConfig()
        self.mode = mode or self.cfg.parallelism
        if self.mode not in ("sharded", "replica", "single", "pipeline"):
            raise ValueError(f"unknown parallelism mode {self.mode!r}")
        if self.mode == "replica":
            raise ValueError("parallelism='replica' runtimes are ReplicaRuntimes: "
                             "build them with build_runtime")
        # This runtime's index among a ReplicaRuntime's replicas (0 alone),
        # and the parallelism label of its variant keys.
        self.replica = replica
        self._signature = signature
        if self.cfg.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, "
                             f"got {self.cfg.dtype!r}")
        if self.cfg.quantize not in (None, "int8", "int8c"):
            raise ValueError(f"unknown quantize mode {self.cfg.quantize!r}")
        if self.cfg.quantize == "int8c" and not model.int8c_native_kernel_paths():
            raise ValueError(
                f"{model.name}: quantize='int8c' (int8 COMPUTE) is not "
                f"supported by family {self.cfg.family!r} — it names no "
                "int8-native kernel sites; use quantize='int8' "
                "(weight-only) instead")
        self.dtype = DTYPES[self.cfg.dtype]
        self.mesh = self._plan_mesh(resolve_device(device))
        # Every rank of the mesh on one device: the runtime's device. On
        # the card a graph cannot span devices, so a mesh over several
        # cards is refused (_plan_mesh).
        self.device = self.mesh.devices.flat[0]
        # True when a slot is a MeshModule: a data or model axis larger
        # than 1, or pipeline stages. A seq axis alone keeps one module: BERT's
        # ring/Ulysses attention and textgen's KV context run over the mesh's
        # seq ranks inside it, and every other family's work replicates over
        # them. Beside a data or model axis each rank module takes its own
        # seq ranks (the family's mesh_module).
        self.split = (self.mode == "pipeline" or self.mesh.shape.get(DATA_AXIS, 1) > 1
                      or self.mesh.shape.get(MODEL_AXIS, 1) > 1)
        # Mesh-aware models (BERT's ring/Ulysses attention, its pipeline
        # stages) close over it; this precedes building the modules.
        model.bind_mesh(self.mesh)
        if self.mode == "sharded":
            # The batch splits evenly over the data axis: buckets round up
            # to its multiples, as the reference's do.
            aligned = sorted({pad_batch_to_mesh(b, self.mesh) for b in self.cfg.batch_buckets})
            if aligned != self.cfg.batch_buckets:
                log.info("%s: batch buckets %s -> %s (data axis %d)", model.name,
                         self.cfg.batch_buckets, aligned, self.mesh.shape[DATA_AXIS])
                self.cfg.batch_buckets = aligned
        self.slots: list[Slot] = []
        self.variants: dict[VariantKey, Variant] = {}
        # Raw forward ms per bucket from the startup probes (probe_raw_ms),
        # the /stats roofline block's device-time term.
        self.raw_ms_per_batch: dict[tuple, float] = {}
        # memory_reserved() before the first capture and after the last.
        self.capture_memory: dict[str, int] = {}
        # When True, h2d() waits for its own copy so the "h2d" phase owns
        # the transfer and "compute" measures dispatch-to-ready only (set
        # from [pipeline] h2d_sync by the batcher).
        self.h2d_sync = False
        cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._capture_stream = torch.cuda.Stream(self.device) if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        # Versioned lifecycle: the live slot carries a monotonically
        # numbered version; publish() retains the previous slot as
        # last-known-good so rollback() is a switch, not a reload.
        self.version = 1
        self._version_seq = 1  # never reused, even across rollbacks
        self._live = 0
        self._prev: int | None = None
        self._prev_version: int | None = None
        # True while a published parameter set serves (False for a cold
        # runtime until its first publish, and after release_params).
        self._resident = True
        # Demotes so far (release_params): each re-warm captures every
        # (bucket, slot) again and compiles nothing.
        self.releases_total = 0
        # Serializes replays (static buffers) and the choice of their slot;
        # the reload lock serializes stage-into-slot, publish and rollback.
        self._replay_lock = new_lock("runtime.replay")
        self._reload_lock = new_lock("runtime.reload")
        # Deterministic chaos (tpuserve_torch.faults.FaultInjector); None in
        # production. device_error/slow_compute fire in dispatch().
        self.injector = None
        name = model.name
        self._c_compiles = self.metrics.counter(
            f"runtime_compiles_total{{model={name}}}")
        self._g_variants = self.metrics.gauge(f"runtime_variants{{model={name}}}")
        self._c_variant_batches: dict[tuple, Any] = {}
        # Batches dispatched on this replica (replica_batches_total{model=,
        # replica=}); a sharded or pipelined mesh is one entry.
        self._c_replica_batches = self.metrics.counter(
            f"replica_batches_total{{model={name},replica={replica}}}")
        # False for a runtime serving through the generation engine: its
        # programs replace the forward buckets (build_runtime).
        self.compile_forward = True
        # [server] prewarm_executables: replay each bucket's graph once at
        # startup (on the CPU: one eager run per bucket); False skips those
        # runs, never a capture.
        self.prewarm = prewarm
        if debug_nans:
            # [server] debug_nans: every fetch checks its outputs. Bound
            # here, so with it off the hot path's fetch is the plain one.
            self.fetch = self._fetch_finite
            self.fetch_program = self._fetch_program_finite
        # The generation engine's programs and state blocks (register_state).
        self.gen_programs: dict[str, Program] = {}
        self.gen_meta: dict | None = None
        self.state_blocks: list[dict[str, torch.Tensor]] = []

    # -- startup ------------------------------------------------------------
    def _plan_mesh(self, device: torch.device):
        """The serving mesh: the one device for "single"; for "sharded" a
        (data, model, seq) mesh over ``select_devices`` of the visible
        devices of ``device``'s platform ([parallel] n_chips bounds it;
        ``data`` alone sizes it to data * tp * sp); for "pipeline" a
        ("stage",) mesh of ``pp`` stages (every device when 0), for a
        family that pipelines its own depth and without ``quantize``."""
        if self.mode == "single":
            return make_mesh(MeshPlan(), devices=[device])
        n_chips = self.pcfg.n_chips
        if not n_chips and self.pcfg.data and self.mode == "sharded":
            n_chips = self.pcfg.data * self.cfg.tp * self.cfg.sp
        devs = select_devices(n_chips, meshlib.visible_devices(device.type))
        if self.mode == "pipeline":
            if not self.model.pipeline_capable:
                raise ValueError(
                    f"{self.model.name}: parallelism='pipeline' needs a family "
                    f"with a homogeneous block stack; {self.cfg.family!r} "
                    "does not support it (BERT does) — use 'sharded', "
                    "'replica', or 'single'")
            if self.cfg.quantize:
                raise ValueError(
                    "parallelism='pipeline' does not compose with quantize "
                    "modes yet; drop one of the two")
            mesh = make_stage_mesh(self.cfg.pp or len(devs), devs)
        else:
            mesh = make_mesh(plan_for(self.pcfg, tp=self.cfg.tp, sp=self.cfg.sp), devs)
        check_local_mesh(list(mesh.devices.flat))
        distinct = mesh.distinct_devices()
        if distinct[0].type == "cuda" and len(distinct) > 1:
            # One process replays one CUDA graph per bucket, and a graph
            # cannot span cards: the mesh's ranks must share one card.
            raise NotImplementedError(
                f"a {self.mode} mesh over {len(distinct)} CUDA devices needs "
                "collectives between cards, which is not yet ported to "
                "tpuserve_torch (ROADMAP.md queue 1: item 10, several GPUs); "
                "its ranks may share one card, and parallelism = \"replica\" "
                "serves one replica per card")
        return mesh

    def _prepare(self, weights: Any) -> torch.nn.Module:
        """A fresh parameter slot's module holding ``weights`` (the
        reference's tree, or the port's float32 state_dict): one module
        (``prepare_module``), or a ``MeshModule`` of rank modules when the
        mesh splits the forward (the family's ``mesh_module``, which reads
        the tree)."""
        if self.split:
            tree = self.model.to_jax_params(weights) if _is_state_dict(weights) else weights
            return self.model.mesh_module(tree, self.mesh, self.prepare_module)
        return self.prepare_module(self.model, weights, self.device)

    def prepare_module(self, model: ServingModel, tree: Any,
                       device: torch.device) -> torch.nn.Module:
        """``model``'s module holding ``tree`` (or a float32 state_dict of
        it) as the forward reads it, on
        ``device``: every floating tensor cast to the compute dtype; under
        ``quantize = "int8"`` or ``"int8c"`` each eligible cast weight
        quantized on the reference's channel (the reference's order: cast,
        then quantize) and each leaf the tree holds pre-quantized installed
        as it is, under int8c the family's int8-native weights kept int8
        for their int8 modules and the rest dequantized on access as under
        int8; 4-D weights channels_last for convolutional families.
        ValueError when the tree does not fit the module (its quantized
        leaves taken at their int8 values' shapes)."""
        try:
            if _is_state_dict(tree):
                state_dict, given = tree, {}
            elif quantize.has_quantized_leaves(tree):
                state_dict, given = quantize.prequantized_leaves(
                    tree, model.from_jax_params, model.reference_layout)
            else:
                state_dict, given = model.from_jax_params(tree), {}
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"weights do not match {model.name}'s param structure: "
                             f"{e!r}") from e
        # Quantization runs on the host: CUDA divides by a scalar through
        # its reciprocal, which moves an int8 scale (absmax / 127) by an ulp
        # from the host's (tests/test_torch_runtime_cuda.py holds the card's
        # held weights equal to the CPU's).
        with torch.device("cpu" if self.cfg.quantize is not None else device):
            module = model.build_module()
        try:
            module.load_state_dict(state_dict)
        except (RuntimeError, KeyError) as e:
            raise ValueError(f"weights do not fit {model.name}'s module: {e}") from e
        module.to(dtype=self.dtype)
        module.eval().requires_grad_(False)
        if self.cfg.quantize is not None:
            native = (model.int8c_native_kernel_paths()
                      if self.cfg.quantize == "int8c" else ())
            quantize.quantize_module(module, self.dtype, self.cfg.quantize_min_size,
                                     layout=model.reference_layout, native=native,
                                     given=given)
        if model.channels_last:
            module.to(memory_format=torch.channels_last)
        # Without a dtype: int8 values and float32 scales arrive as they are.
        return module.to(device=device)

    def _forward(self, module: torch.nn.Module, batch: Any) -> Any:
        """The model's forward on one slot's module, or on a mesh's."""
        if isinstance(module, MeshModule):
            return self.model.mesh_forward(module, batch)
        return self.model.forward(module, batch)

    def load_params(self) -> None:
        """Load the model's parameters (``cfg.weights`` under its integrity
        gate, or the seeded init) into every slot: one module per slot.
        Slot 0 is live."""
        self._fill_slots(self.model.load_params())

    def _fill_slots(self, tree: Any) -> None:
        """``n_slots`` slots, each a module holding ``tree``."""
        slots = []
        for _ in range(self.n_slots):
            module = self._prepare(tree)
            slots.append(Slot(module, slot_tensors(module)))
        with self._replay_lock:
            self.slots = slots
        if self.device.type == "cuda":
            # Hand the float32 build and cast copies back, so memory_reserved
            # before capture counts the slots, not those transients.
            del tree, module, slots
            torch.cuda.empty_cache()

    @property
    def module(self) -> torch.nn.Module:
        """The live slot's module."""
        return self.slots[self._live].module

    @property
    def parallel_signature(self) -> str:
        """The parallelism dimension of every VariantKey: the mode and the
        layout it was specialized on ("sharded@d2", "replica@2",
        "pipeline@2"); "single" stays bare."""
        if self._signature is not None:
            return self._signature
        if self.mode == "sharded":
            return f"sharded@d{self.mesh.shape[DATA_AXIS]}"
        if self.mode == "pipeline":
            return f"pipeline@{self.mesh.shape[STAGE_AXIS]}"
        return self.mode

    @property
    def n_replicas(self) -> int:
        """Independent graph sets (the batcher keeps a staging-slot pool
        per replica): 1, a sharded or pipelined mesh included."""
        return 1

    @property
    def n_chips(self) -> int:
        """Ranks the serving path occupies: the mesh's size (they may share
        one card)."""
        return self.mesh.size

    def replica_batches(self) -> list[float]:
        """Per-replica dispatch counts (replica_batches_total)."""
        return [self._c_replica_batches.value]

    def pick_replica(self, loads: "list[int] | None" = None) -> int:
        return 0

    def variant_key(self, bucket: tuple) -> VariantKey:
        return VariantKey(bucket=tuple(bucket), dtype=self.cfg.dtype,
                          quantize=self.cfg.quantize,
                          parallelism=self.parallel_signature)

    def compile_all(self) -> None:
        """Warm up (and on CUDA capture) every bucket on every slot: the
        port's counterpart of the JAX runtime's AOT compile."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            self.capture_memory["reserved_before_bytes"] = torch.cuda.memory_reserved(self.device)
        for bucket in self.model.buckets():
            self._compile_bucket(tuple(bucket))
        if self.device.type == "cuda":
            self.capture_memory["reserved_after_bytes"] = torch.cuda.memory_reserved(self.device)
        log.info("%s: %d bucket(s) warmed, %d graph(s) captured on %s in %.1fs",
                 self.model.name, len(self.variants), self.captures_total,
                 self.device, time.perf_counter() - t0)

    def ensure_compiled(self) -> int:
        """Warm up and capture any configured bucket missing from the
        variant registry, on every slot; returns how many were added. The
        lifecycle calls it at stage time, so the staged canary and the
        first post-publish request never meet an uncaptured bucket; a
        candidate lands in a slot whose graphs exist, so steady state this
        returns 0. After ``release_params`` the registry keeps its variants
        and the new slots have no graph: each (bucket, slot) is captured
        again, counted in the variant's ``captures`` and not in
        ``runtime_compiles_total``."""
        new = 0
        if not self.compile_forward:
            # Engine-served: the programs were registered at engine start and
            # shapes never change across versions, so nothing is missing.
            return new
        for b in self.model.buckets():
            bucket = tuple(b)
            key = self.variant_key(bucket)
            if key not in self.variants:
                self._compile_bucket(bucket)
                new += 1
            elif self.device.type == "cuda":
                # The variant stays; its captures grow.
                self.variants[key].captures += self._capture_missing(bucket)
        return new

    def _zeros(self, bucket: tuple) -> tuple:
        return tuple(np.zeros(s.shape, s.dtype) for s in self.model.input_signature(bucket))

    def _compile_bucket(self, bucket: tuple) -> None:
        t0 = time.perf_counter()
        captures = 0
        if self.device.type == "cuda":
            captures = self._capture_missing(bucket)
        elif self.prewarm:
            # One eager run on the live slot (a cold runtime's first warm
            # runs this before its publish).
            with torch.inference_mode():
                self._forward(self.slots[self._live].module,
                              self.h2d(bucket, self._zeros(bucket)))
        key = self.variant_key(bucket)
        self.variants[key] = Variant(key, (time.perf_counter() - t0) * 1e3, captures)
        self._c_variant_batches[bucket] = self.metrics.counter(
            f"runtime_variant_batches_total{{model={self.model.name},variant={key.label}}}")
        self._c_compiles.inc()
        # Retrace witness: a compile after the warmup barrier raises here,
        # with the variant registered and the counter ticked, as the
        # reference's runtime does.
        witness.note_compile(self.model.name, key.label)
        self._g_variants.set(len(self.variants))

    def _capture_missing(self, bucket: tuple) -> int:
        """Capture ``bucket`` on every slot that lacks its graph (all of them
        at a first compile, the slots a re-warm filled after a demote);
        returns how many were captured (0, touching nothing, when every
        slot has it: a reload's steady state)."""
        missing = [slot for slot in self.slots if bucket not in slot.graphs]
        if not missing:
            return 0
        for slot in missing:
            slot.graphs[bucket] = self._capture(slot, bucket)
        # The served h2d allocates the bucket's inputs on the copy stream,
        # whose pool the captures never touched: allocate them there once
        # now, so that no request grows the allocator (a first request's
        # cudaMalloc took 17-124 ms on the H100 machine; chip_smoke.py
        # phase 14's first requests).
        with allow_transfers():
            self.h2d(bucket, self._zeros(bucket))
            self._copy_stream.synchronize()
        return len(missing)

    def _capture(self, slot: Slot, bucket: tuple) -> Graph:
        """One eager warm-up of ``bucket`` on ``slot`` and then its capture,
        both on the runtime's capture stream; a failed capture raises. The
        retrace witness hears of it first (a capture after the warmup
        barrier, outside a sanctioned window, raises before it starts);
        capturing syncs the host, so it runs in an ``allow_transfers``
        window."""
        witness.note_capture(self.model.name, self.variant_key(bucket).label)
        with allow_transfers():
            return self._warm_and_capture(slot, bucket)

    def _warm_and_capture(self, slot: Slot, bucket: tuple) -> Graph:
        inputs = tuple(torch.from_numpy(a).to(self.device) for a in self._zeros(bucket))
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.inference_mode():
            with torch.cuda.stream(stream):
                self._forward(slot.module, inputs)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            # This thread's K1/K2 launches while capturing are the graph's;
            # other threads' launches and replays stay out of its count.
            graph = torch.cuda.CUDAGraph()
            with fa.capture_launches() as rec, torch.cuda.graph(
                    graph, pool=self._pool, stream=stream,
                    capture_error_mode="thread_local"):
                outputs = self._forward(slot.module, inputs)
            launches, shapes = (rec["k1"], rec["k2"]), (rec["shapes"], rec["k2_shapes"])
            if self.prewarm:
                # A graph's first launch uploads it to the card: pay that
                # here, at startup, not in the first request of the bucket.
                with torch.cuda.stream(stream):
                    graph.replay()
                fa.count_replay(*launches, *shapes)
            stream.synchronize()
        return Graph(graph, inputs, outputs, launches, *shapes)

    @property
    def compiles_total(self) -> float:
        return self._c_compiles.value

    @property
    def captures_total(self) -> int:
        return sum(v.captures for v in self.variants.values())

    @staticmethod
    def _bucket_order(key: VariantKey) -> tuple:
        # Forward buckets (numbers) first, then programs ("step", width).
        return (isinstance(key.bucket[0], str), key.bucket)

    def variants_summary(self) -> list[dict]:
        return [v.summary() for _, v in sorted(
            self.variants.items(), key=lambda kv: self._bucket_order(kv[0]))]

    # -- hot path -----------------------------------------------------------
    def h2d(self, bucket: tuple, host_batch: tuple, replica: int = 0) -> tuple:
        """Copy the host batch to the device: from pinned memory (the
        assembly arena pins its buffers on CUDA) with ``non_blocking=True``,
        on the runtime's own copy stream, so the copy overlaps the forward
        of the batch before it. The calling thread's current stream, which
        replays the forward, waits for the copy on the card; with
        ``h2d_sync`` the host waits for this copy too, and for nothing
        queued before it."""
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in host_batch]
        if self.device.type != "cuda":
            return tuple(tensors)
        compute = torch.cuda.current_stream(self.device)
        out = []
        with torch.cuda.stream(self._copy_stream):
            for t in tensors:
                d = (t if t.is_pinned() else t.pin_memory()).to(self.device, non_blocking=True)
                # Allocated on the copy stream, read on the compute stream.
                d.record_stream(compute)
                out.append(d)
            copied = torch.cuda.Event()
            copied.record()
        compute.wait_event(copied)
        if self.h2d_sync:
            copied.synchronize()
        return tuple(out)

    def dispatch(self, bucket: tuple, dev_batch: tuple, replica: int = 0,
                 params_override: StagedParams | None = None) -> dict:
        """Enqueue the forward on the device batch against the live slot —
        or, with ``params_override``, against a staged candidate's slot
        (the lifecycle's staged canary runs the candidate through the real
        graphs without it ever serving) — and return device outputs without
        waiting for them. On CUDA: copy into the graph's static inputs,
        replay, clone the outputs, record the slot's last-replay event, all
        on the current stream under the replay lock. The chaos kinds
        device_error/slow_compute fire here, below the batcher."""
        if self.injector is not None:
            delay = self.injector.delay_s("slow_compute", self.model.name)
            if delay > 0:
                time.sleep(delay)  # runs on a stage executor thread
            self.injector.check("device_error", self.model.name)
        with self._replay_lock, torch.inference_mode():
            slot = self._serving_slot(params_override)
            if self.device.type != "cuda":
                out = self._forward(slot.module, dev_batch)
            else:
                g = slot.graphs[bucket]
                for dst, src in zip(g.inputs, dev_batch):
                    dst.copy_(src)
                g.graph.replay()
                fa.count_replay(*g.launches, g.k1_shapes, g.k2_shapes)
                out = {k: v.clone() for k, v in g.outputs.items()}
                slot.last_replay = torch.cuda.Event()
                slot.last_replay.record()
        c = self._c_variant_batches.get(bucket)
        if c is not None:
            c.inc()
        self._c_replica_batches.inc()
        return out

    def _serving_slot(self, params_override: StagedParams | None) -> Slot:
        """The slot a replay reads (call under the replay lock): the live
        one, or a staged candidate's. Raises on a runtime whose parameters
        are released or not yet published: a graph must never replay over
        storage the allocator may have handed to another model."""
        if not self.slots or (params_override is None and not self._resident):
            raise RuntimeError(
                f"{self.model.name}: parameters are not resident (cold "
                "runtime or demoted); warm it before dispatching")
        return self.slots[self._live if params_override is None
                          else params_override.slot]

    def run(self, bucket: tuple, host_batch: tuple, replica: int | None = None,
            params_override: StagedParams | None = None) -> dict:
        """h2d + dispatch in one call; returns device outputs immediately
        (``replica`` is for a ReplicaRuntime's signature: one replica here)."""
        return self.dispatch(bucket, self.h2d(bucket, host_batch),
                             params_override=params_override)

    @staticmethod
    def fetch(outputs: dict) -> dict:
        """Block for the D2H copy of the outputs; call off the event loop.
        Goes through the retrace witness's blessed readback (``host_fetch``:
        pinned copies and one event wait), which an armed sync guard never
        flags."""
        return host_fetch(outputs)

    def _fetch_finite(self, outputs: dict) -> dict:
        """``fetch`` under debug_nans: FloatingPointError when a floating
        output holds NaN/Inf, which fails the batch."""
        out = ModelRuntime.fetch(outputs)
        _raise_nonfinite(self.model.name, out)
        return out

    # -- generative programs (tpuserve_torch.genserve) ------------------------
    def register_state(self, struct: dict) -> None:
        """Allocate the engine's ``N_BLOCKS`` state blocks, zeros of
        ``struct`` (``{name: TensorSpec}``; numpy or torch dtypes), at
        addresses fixed for the runtime's life. Call before
        ``register_program``: the programs' graphs bind them."""
        if self.state_blocks:
            raise ValueError(f"{self.model.name}: state blocks already allocated")
        if self.device.type == "cuda":
            self.capture_memory["reserved_before_bytes"] = torch.cuda.memory_reserved(self.device)
        self.state_blocks = [
            {k: torch.zeros(spec.shape, dtype=torch_dtype(spec.dtype), device=self.device)
             for k, spec in struct.items()} for _ in range(N_BLOCKS)]

    def zero_state(self, block: int) -> None:
        """Zero every tensor of one state block in place (after the work
        queued on the calling thread's stream, as every replay is)."""
        with self._replay_lock, torch.inference_mode():
            for t in self.state_blocks[block].values():
                t.zero_()

    def register_program(self, tag: str, fn: Callable, arg_specs: tuple,
                         width: int = 0) -> Program:
        """Register ``fn(module, state, *args)`` — a generative program that
        updates the state block in place and returns a tensor, a dict of
        tensors or None — in the variant registry under the bucket
        ``(tag, width)``, as the JAX runtime AOT-compiles it: one
        ``runtime_compiles_total`` tick, a per-variant serving counter that
        ``run_program`` ticks, weight versions out of the key.

        ``arg_specs`` gives each argument after the state block as a
        TensorSpec, or a tuple of them for a tuple argument (a request
        item). On CUDA each argument gets a static input tensor, shared by
        the program's graphs, and the program is warmed up and captured on
        every (parameter slot, state block) pair; the slot index, item,
        chunk start and block-table row are copied into those inputs before
        each replay and are never baked into a graph, so slot, page and
        chunk churn and publish/rollback all replay the same graphs. Both
        state blocks are zeroed afterwards. On the CPU the program runs
        eagerly."""
        if not self.state_blocks:
            raise ValueError(f"{self.model.name}: register_state before register_program")
        t0 = time.perf_counter()
        prog = Program(tag, fn, tuple(arg_specs))
        captures = 0
        if self.device.type == "cuda":
            with torch.inference_mode():
                prog.inputs = tuple(
                    torch.zeros(spec.shape, dtype=torch_dtype(spec.dtype), device=self.device)
                    for spec in _flatten(prog.arg_specs))
            for i, slot in enumerate(self.slots):
                for block in range(N_BLOCKS):
                    prog.graphs[(i, block)] = self._capture_program(prog, slot, block, width)
                    captures += 1
            for block in range(N_BLOCKS):
                self.zero_state(block)
            torch.cuda.current_stream(self.device).synchronize()
            # The state blocks and every program's captures so far.
            self.capture_memory["reserved_after_bytes"] = torch.cuda.memory_reserved(self.device)
        key = self.variant_key((tag, width))
        self.variants[key] = Variant(key, (time.perf_counter() - t0) * 1e3, captures)
        prog.counter = self._c_variant_batches[(tag, width)] = self.metrics.counter(
            f"runtime_variant_batches_total{{model={self.model.name},variant={key.label}}}")
        self.gen_programs[tag] = prog
        self._c_compiles.inc()
        witness.note_compile(tag, key.label)  # the retrace witness (as above)
        self._g_variants.set(len(self.variants))
        return prog

    def _capture_program(self, prog: Program, slot: Slot, block: int, width: int) -> Graph:
        """One eager warm-up of ``prog`` on (``slot``, ``block``) and then
        its capture, both on the runtime's capture stream, heard by the
        retrace witness first, as ``_capture``. Programs register at
        engine start, before the warmup barrier: the sync guard is off."""
        witness.note_capture(prog.tag, self.variant_key((prog.tag, width)).label)
        state = self.state_blocks[block]
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.inference_mode():
            with torch.cuda.stream(stream):
                prog.fn(slot.module, state, *_unflatten(prog.arg_specs, prog.inputs))
            torch.cuda.current_stream(self.device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with fa.capture_launches() as rec, torch.cuda.graph(
                    graph, pool=self._pool, stream=stream,
                    capture_error_mode="thread_local"):
                outputs = prog.fn(slot.module, state, *_unflatten(prog.arg_specs, prog.inputs))
            launches, shapes = (rec["k1"], rec["k2"]), (rec["shapes"], rec["k2_shapes"])
            # The first launch uploads the graph: pay it at startup.
            with torch.cuda.stream(stream):
                graph.replay()
            fa.count_replay(*launches, *shapes)
            stream.synchronize()
        return Graph(graph, prog.inputs, outputs, launches, *shapes)

    def run_program(self, tag: str, *args, params_override: StagedParams | None = None,
                    block: int = LIVE_BLOCK) -> Any:
        """Enqueue a registered program on state block ``block`` against the
        live parameter slot — or a staged candidate's (``params_override``:
        the lifecycle's staged canary generates through the real graphs on
        the scratch block without the candidate ever serving) — and return
        its outputs as device tensors without waiting for them. ``args``
        are numpy arrays or scalars, shaped as the program's specs. On CUDA:
        copy them into the static inputs, replay the (slot, block) graph,
        clone the outputs, all under the replay lock on the current stream.
        The chaos kinds device_error/slow_compute fire here, as in
        ``dispatch``."""
        if self.injector is not None:
            delay = self.injector.delay_s("slow_compute", self.model.name)
            if delay > 0:
                time.sleep(delay)  # runs on a stage executor thread
            self.injector.check("device_error", self.model.name)
        prog = self.gen_programs[tag]
        # np.asarray, not ascontiguousarray, which turns 0-d arrays into 1-d.
        arrays = [np.asarray(a, dtype=spec.dtype, order="C")
                  for a, spec in zip(_flatten(args), _flatten(prog.arg_specs))]
        with self._replay_lock, torch.inference_mode():
            slot = self._serving_slot(params_override)
            i = self._live if params_override is None else params_override.slot
            state = self.state_blocks[block]
            if self.device.type != "cuda":
                tensors = tuple(torch.from_numpy(a) for a in arrays)
                out = prog.fn(slot.module, state, *_unflatten(prog.arg_specs, tensors))
            else:
                g = prog.graphs[(i, block)]
                for dst, a in zip(prog.inputs, arrays):
                    dst.copy_(torch.from_numpy(a).pin_memory(), non_blocking=True)
                g.graph.replay()
                fa.count_replay(*g.launches, g.k1_shapes, g.k2_shapes)
                out = _map_out(g.outputs, torch.Tensor.clone)
                slot.last_replay = torch.cuda.Event()
                slot.last_replay.record()
        prog.counter.inc()
        return out

    def _fetch_program_finite(self, out: Any) -> Any:
        """``fetch_program`` under debug_nans (as ``_fetch_finite``)."""
        host = ModelRuntime.fetch_program(self, out)
        _raise_nonfinite(self.model.name, host if isinstance(host, dict) else {"out": host})
        return host

    def fetch_program(self, out: Any) -> Any:
        """Block for a program's outputs on the host (numpy) through
        ``host_fetch`` (one pinned copy per output and one event wait on
        CUDA); call off the event loop."""
        return host_fetch(out)

    # -- raw-forward probes ---------------------------------------------------
    def probe_raw_ms(self, bucket: tuple, iters: int = 8) -> float:
        """The forward's time for one bucket (ms/batch), inputs resident:
        ``iters`` back-to-back dispatches against one device batch, closed
        by one dependent read, so the host-device copy never enters the
        window; recorded (rounded to 3 places) in ``raw_ms_per_batch``.
        Call at startup, before the injector is armed."""
        dev = self.h2d(bucket, self._zeros(bucket))
        self.fetch(self.dispatch(bucket, dev))  # warm the window
        t0 = time.perf_counter()
        out = None
        for _ in range(max(1, iters)):
            out = self.dispatch(bucket, dev)
        self.fetch(out)
        ms = (time.perf_counter() - t0) / max(1, iters) * 1e3
        self.raw_ms_per_batch[bucket] = round(ms, 3)
        return ms

    def probe_all_raw(self, iters: int = 8) -> dict[tuple, float]:
        """probe_raw_ms over every bucket, logged; returns the map (also
        kept on the runtime for /stats roofline attribution)."""
        t0 = time.perf_counter()
        for b in sorted(v.bucket for v in self.variants if not isinstance(v.bucket[0], str)):
            self.probe_raw_ms(b, iters=iters)
        log.info("%s: raw-forward probes %s in %.1fs", self.model.name,
                 {str(b): ms for b, ms in sorted(self.raw_ms_per_batch.items())},
                 time.perf_counter() - t0)
        return dict(self.raw_ms_per_batch)

    # -- versioned weight lifecycle ------------------------------------------
    #
    # stage_params -> (staged canary, lifecycle.py) -> publish | rollback.
    # Staging loads and validates the candidate off the serving path and
    # copies it in place into a free slot (neither live nor last-known-good);
    # publish and rollback switch the live slot under the reload lock. A
    # batch reads the live slot under the replay lock, so it runs wholly on
    # one version.

    def stage_params(self, verify_integrity: bool = True, nan_scan: bool = True,
                     require_manifest: bool = False) -> StagedParams:
        """Load + validate a candidate weight tree and write it into a free
        slot without publishing it.

        Gates, in the JAX order: the sidecar checksum manifest
        (IntegrityError), a NaN/Inf scan of the float leaves cast to the
        compute dtype (NaNDetected), and structure, shape and dtype against
        the slots (ValueError). Injected ``reload_corrupt`` / ``reload_nan``
        faults fire at their gates. Only then is the candidate copied into
        the slot — in place, so its graphs stay valid — once the slot's last
        replay has finished on the card."""
        tree = self.load_candidate(verify_integrity, nan_scan, require_manifest)
        # The candidate lands on the card through blocking copies and a
        # stream sync: a deliberate transfer under an armed sync guard.
        with allow_transfers():
            return self._stage_slot(tree)

    def load_candidate(self, verify_integrity: bool = True, nan_scan: bool = True,
                       require_manifest: bool = False) -> Any:
        """``stage_params``' host half: the candidate tree, through the
        integrity and NaN/Inf gates."""
        name = self.model.name
        if self.injector is not None:
            try:
                self.injector.check("reload_corrupt", name)
            except FaultInjected as e:
                raise IntegrityError(f"checksum mismatch (injected): {e}") from e
        tree = self.model.load_tree(verify_integrity=verify_integrity,
                                    require_manifest=require_manifest)
        if nan_scan:
            if self.injector is not None:
                try:
                    self.injector.check("reload_nan", name)
                except FaultInjected as e:
                    raise NaNDetected(f"NaN leaves (injected): {e}") from e
            bad = nonfinite_paths(map_leaves(self._cast_leaf, tree))
            if bad:
                raise NaNDetected(
                    f"candidate weights for {name} hold NaN/Inf in {bad}; "
                    "candidate rejected")
        return tree

    def _stage_slot(self, tree: Any) -> StagedParams:
        """``stage_params``' device half: the candidate into a free slot."""
        if not self.slots:
            return self._stage_cold(tree)
        try:
            candidate = slot_tensors(self._prepare(tree))
        except ValueError as e:
            raise ValueError(f"reloaded weights do not match the module: {e}; "
                             "old params kept") from e
        live = self.slots[self._live].tensors
        if list(candidate) != list(live) or any(
                a.shape != b.shape or a.dtype != b.dtype
                for a, b in zip(candidate.values(), live.values())):
            raise ValueError("reloaded weights do not match the captured "
                             "shapes/dtypes; old params kept")
        with self._reload_lock:
            free = next(i for i in range(self.n_slots) if i not in (self._live, self._prev))
            slot = self.slots[free]
            slot.generation += 1
            # A batch that read this slot while it was live has enqueued
            # its replay by the time the replay lock is free.
            with self._replay_lock:
                last = slot.last_replay
            if last is not None:
                last.synchronize()
            for key, t in slot.tensors.items():
                t.copy_(candidate[key])
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            return StagedParams(free, slot.generation)

    def _stage_cold(self, tree: Any) -> StagedParams:
        """Stage into a runtime with no slot (cold boot or demoted): the
        candidate fills all ``N_SLOTS`` slots, as ``load_params`` does at a
        warm boot, and a free one is handed out as the staged candidate;
        ``ensure_compiled`` then captures every (bucket, slot)."""
        with self._reload_lock:
            self._fill_slots(tree)
            free = next(i for i in range(self.n_slots) if i not in (self._live, self._prev))
            slot = self.slots[free]
            slot.generation += 1
            return StagedParams(free, slot.generation)

    def _cast_leaf(self, leaf: Any) -> Any:
        """A tree leaf as the forward would hold it, for the NaN/Inf scan
        (a float32 value beyond the compute dtype's range casts to inf)."""
        a = np.asarray(leaf)
        if a.dtype.kind != "f":
            return a
        with warnings.catch_warnings():
            # A torch checkpoint's leaves are read-only views of the mapped
            # file; the scan only reads them.
            warnings.filterwarnings("ignore", "The given NumPy array is not writable")
            return torch.from_numpy(a).to(self.dtype)

    def publish(self, staged: StagedParams) -> dict:
        """Make a staged slot live as version N+1; the previous live slot is
        retained as last-known-good for rollback(). In-flight batches finish
        on the slot they read."""
        with self._reload_lock:
            if self.slots[staged.slot].generation != staged.generation:
                raise ValueError("the staged candidate was overwritten by a later "
                                 "stage; stage it again")
            self._prev = self._live
            self._prev_version = self.version
            self._version_seq += 1
            self.version = self._version_seq
            self._live = staged.slot
            self._resident = True
            return {"model": self.model.name, "version": self.version,
                    "previous_version": self._prev_version}

    def rollback(self) -> dict:
        """Make the retained last-known-good slot live again (version N-1).
        Version numbers are never reused: a later publish continues the
        monotonic sequence. Raises ValueError when nothing is retained
        (startup state, or already rolled back)."""
        with self._reload_lock:
            if self._prev is None:
                raise ValueError(
                    f"no retained previous version for {self.model.name} "
                    "to roll back to")
            rolled_from = self.version
            self._live, self.version = self._prev, self._prev_version
            self._prev = self._prev_version = None
            return {"model": self.model.name, "version": self.version,
                    "rolled_back_from": rolled_from}

    def release_params(self) -> None:
        """Demote to cold (the fleet scheduler's weight paging): free every
        parameter slot — the live one and the last-known-good one included —
        and the graphs that bind them. In-flight batches finish on their own
        storage first: each slot's last-replay event is waited for. Then the
        graphs, the slots' tensors and the graphs' memory pool are dropped
        and PyTorch's cache emptied, so the memory is back on the card. The
        variant registry stays: a re-warm (``stage_params``,
        ``ensure_compiled``, ``publish``) captures the graphs again and
        compiles nothing."""
        if self.gen_programs:
            raise ValueError(f"{self.model.name}: the generation engine's programs "
                             "bind the slots; an engine-served model is never demoted")
        with self._reload_lock:
            with self._replay_lock:
                slots, self.slots = self.slots, []
                self._resident = False
                self._prev = self._prev_version = None
            self.releases_total += 1
            # A batch that read a slot has enqueued its replay by the time
            # the replay lock is free.
            for event in [s.last_replay for s in slots if s.last_replay is not None]:
                event.synchronize()
            del slots
            if self.device.type == "cuda":
                # A graph's pool returns its memory only once every graph
                # holding it is gone; the next warm captures into a new one.
                self._pool = torch.cuda.graph_pool_handle()
                gc.collect()
                torch.cuda.empty_cache()

    @property
    def params_resident(self) -> bool:
        """True while a published parameter set serves (False = cold: the
        model holds no parameter slot on the device)."""
        return self._resident and bool(self.slots)

    @property
    def previous_version(self) -> int | None:
        """The retained last-known-good version, or None."""
        return self._prev_version

    def reload_params(self) -> dict:
        """Hot-swap weights from cfg.weights with no new capture: stage +
        publish in one call, no canary (the HTTP reload goes through
        tpuserve_torch.lifecycle, which canaries the staged slot first and
        owns rollback). A failed stage raises and the old version keeps
        serving."""
        t0 = time.perf_counter()
        info = self.publish(self.stage_params())
        info["reload_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        info["params"] = self.describe()["params"]
        return info

    # -- info ---------------------------------------------------------------
    def describe(self) -> dict:
        # Every tensor the forward reads: weights (int8 where quantized),
        # scales and BatchNorm statistics, of one slot.
        params = self.slots[self._live].tensors if self.slots else {}
        return {
            "model": self.model.name,
            "family": self.cfg.family,
            "version": self.version,
            "mode": self.mode,
            "dtype": self.cfg.dtype,
            "quantize": self.cfg.quantize,
            "weights": self.cfg.weights,
            "labels": self.cfg.labels,
            "options": dict(self.cfg.options),
            "replicas": self.n_replicas,
            "n_chips": self.n_chips,
            "parallel": self.parallel_signature,
            "mesh_shape": dict(self.mesh.shape),
            "device": str(self.device),
            "buckets": [list(k.bucket) for k in sorted(self.variants, key=self._bucket_order)],
            "variants": self.variants_summary(),
            "compiles_total": self.compiles_total,
            "slots": {"count": len(self.slots), "live": self._live, "previous": self._prev},
            "params_resident": self.params_resident,
            # Counted per (bucket, slot) capture: each demote and re-warm
            # (releases_total) adds slots x buckets here on the card and
            # nothing to compiles_total.
            "captures_total": self.captures_total,
            "releases_total": self.releases_total,
            "capture_memory": dict(self.capture_memory),
            "raw_ms_per_batch": {str(list(b)): v
                                 for b, v in sorted(self.raw_ms_per_batch.items())},
            "params": tree_summary(params),
        }


def _is_state_dict(weights: Any) -> bool:
    """True for the port's flat state_dict (tensor values), False for the
    reference's nested tree (numpy leaves)."""
    return bool(weights) and all(isinstance(v, torch.Tensor) for v in weights.values())


def _raise_nonfinite(name: str, outputs: dict) -> None:
    bad = [k for k, v in outputs.items() if v is not None
           and np.asarray(v).dtype.kind == "f" and not np.isfinite(v).all()]
    if bad:
        raise FloatingPointError(f"debug_nans: {name} produced NaN/Inf in {sorted(bad)}")


def torch_dtype(dtype: Any) -> torch.dtype:
    """A TensorSpec's dtype (numpy, or torch for dtypes numpy lacks such as
    bfloat16) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), dtype)).dtype


def _flatten(args: tuple) -> list:
    """A program's arguments (or specs), tuple arguments spliced in."""
    out = []
    for a in args:
        out.extend(a if isinstance(a, tuple) else (a,))
    return out


def _unflatten(specs: tuple, flat: tuple) -> tuple:
    """``flat`` regrouped into ``specs``' structure."""
    it = iter(flat)
    return tuple(tuple(next(it) for _ in s) if isinstance(s, tuple) else next(it)
                 for s in specs)


def _map_out(out: Any, fn: Callable) -> Any:
    """``fn`` over a program's output: None, a tensor or a dict of them."""
    if out is None:
        return None
    if isinstance(out, dict):
        return {k: fn(v) for k, v in out.items()}
    return fn(out)


class ReplicaRuntime:
    """``parallelism = "replica"``: one independent runtime replica per
    device of the [parallel] plan (``select_devices``; the devices may
    repeat, as ranks on one card do), each a one-device ``ModelRuntime``
    with its own parameter slots, graphs, streams and memory pool — the
    reference's one single-device executable set per device, with the
    parameters copied per device. It serves the runtime surface: ``h2d``,
    ``dispatch`` and ``run`` take the replica, ``pick_replica`` chooses
    the least-loaded one (ties rotating), and the weight lifecycle fans
    out: a candidate is loaded and gated once and staged into the same
    free slot of every replica, publish and rollback switch every
    replica's live slot together, so one version number serves on all.
    ``runtime_compiles_total`` counts replicas x buckets at startup, as the
    reference's; the generation engine runs one engine per replica on its
    runtime (``GenEngineGroup``)."""

    def __init__(self, model: ServingModel, device: "str | torch.device | None" = None,
                 metrics: Metrics | None = None, prewarm: bool = True,
                 debug_nans: bool = False, n_slots: int = N_SLOTS,
                 parallel: ParallelConfig | None = None) -> None:
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.metrics = metrics if metrics is not None else Metrics()
        self.pcfg = parallel if parallel is not None else ParallelConfig()
        self.mode = "replica"
        devs = select_devices(self.pcfg.n_chips,
                              meshlib.visible_devices(resolve_device(device).type))
        check_local_mesh(devs)
        signature = f"replica@{len(devs)}"
        self.replicas = [
            ModelRuntime(model, device=d, metrics=self.metrics, prewarm=prewarm,
                         debug_nans=debug_nans, n_slots=n_slots, parallel=self.pcfg,
                         mode="single", replica=i, signature=signature)
            for i, d in enumerate(devs)]
        self.device = self.replicas[0].device
        self.mesh = self.replicas[0].mesh
        self.n_slots = n_slots
        self._rr = 0  # round-robin cursor
        self._rr_lock = new_lock("runtime.replica_rr")
        self._reload_lock = new_lock("runtime.replica_reload")

    # -- settings the server and batcher write, fanned out ------------------
    def _fan(name: str):  # noqa: N805 — a property factory
        def get(self):
            return getattr(self.replicas[0], name)

        def set_(self, value):
            for r in self.replicas:
                setattr(r, name, value)
        return property(get, set_)

    injector = _fan("injector")
    h2d_sync = _fan("h2d_sync")
    compile_forward = _fan("compile_forward")
    prewarm = _fan("prewarm")
    del _fan

    # -- the replica set ------------------------------------------------------
    @property
    def parallel_signature(self) -> str:
        return f"replica@{len(self.replicas)}"

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def n_chips(self) -> int:
        return len(self.replicas)

    def replica_batches(self) -> list[float]:
        """Per-replica dispatch counts (replica_batches_total), in replica
        order: every replica nonzero under load is the proof that the
        batcher keeps every device busy."""
        return [r._c_replica_batches.value for r in self.replicas]

    def pick_replica(self, loads: "list[int] | None" = None) -> int:
        """First-choice replica for the next batch: with ``loads`` (each
        replica's staging-slot occupancy, from the batcher) the least
        loaded, ties broken on a rotating cursor so equal replicas
        alternate; without it plain round-robin."""
        n = len(self.replicas)
        if n == 1:
            return 0
        with self._rr_lock:
            self._rr = (self._rr + 1) % n
            start = self._rr
        if not loads:
            return start
        return min(range(n), key=lambda i: (loads[i], (i - start) % n))

    # -- startup --------------------------------------------------------------
    def load_params(self) -> None:
        """Load the weights once; fill every replica's slots from them."""
        tree = self.model.load_params()
        for r in self.replicas:
            r._fill_slots(tree)

    def compile_all(self) -> None:
        for r in self.replicas:
            r.compile_all()

    def ensure_compiled(self) -> int:
        return sum(r.ensure_compiled() for r in self.replicas)

    def probe_all_raw(self, iters: int = 8) -> dict[tuple, float]:
        return self.replicas[0].probe_all_raw(iters)

    # -- hot path -------------------------------------------------------------
    def h2d(self, bucket: tuple, host_batch: tuple, replica: int = 0) -> tuple:
        return self.replicas[replica].h2d(bucket, host_batch)

    def dispatch(self, bucket: tuple, dev_batch: tuple, replica: int = 0,
                 params_override: StagedParams | None = None) -> dict:
        return self.replicas[replica].dispatch(bucket, dev_batch,
                                               params_override=params_override)

    def run(self, bucket: tuple, host_batch: tuple, replica: int | None = None,
            params_override: StagedParams | None = None) -> dict:
        """h2d + dispatch on ``replica`` (round-robin when None)."""
        i = replica if replica is not None else self.pick_replica()
        return self.replicas[i].run(bucket, host_batch, params_override=params_override)

    fetch = staticmethod(ModelRuntime.fetch)

    # -- lifecycle ------------------------------------------------------------
    def stage_params(self, verify_integrity: bool = True, nan_scan: bool = True,
                     require_manifest: bool = False) -> StagedParams:
        """Replica 0 loads and gates the candidate (integrity, NaN/Inf,
        structure) as a one-device runtime does; every other replica then
        takes the same tree into the same free slot."""
        with self._reload_lock:
            tree = self.replicas[0].load_candidate(verify_integrity, nan_scan,
                                                   require_manifest)
            with allow_transfers():
                staged = [r._stage_slot(tree) for r in self.replicas]
            if any(st != staged[0] for st in staged):
                raise RuntimeError(f"the replicas staged into different slots: {staged}")
            return staged[0]

    def publish(self, staged: StagedParams) -> dict:
        with self._reload_lock:
            infos = [r.publish(staged) for r in self.replicas]
        return infos[0]

    def rollback(self) -> dict:
        with self._reload_lock:
            infos = [r.rollback() for r in self.replicas]
        return infos[0]

    def release_params(self) -> None:
        for r in self.replicas:
            r.release_params()

    def reload_params(self) -> dict:
        t0 = time.perf_counter()
        info = self.publish(self.stage_params())
        info["reload_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        info["params"] = self.describe()["params"]
        return info

    # -- info -----------------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        # The version machine, the registry's read side and the rest of a
        # runtime's state read as replica 0's (the replicas move together).
        if name in ("version", "previous_version", "params_resident", "module",
                    "compiles_total", "raw_ms_per_batch", "capture_memory",
                    "releases_total", "variants", "slots", "gen_programs",
                    "gen_meta", "dtype", "variant_key", "_live", "_prev", "_zeros"):
            return getattr(self.replicas[0], name)
        raise AttributeError(name)

    @property
    def captures_total(self) -> int:
        return sum(r.captures_total for r in self.replicas)

    def variants_summary(self) -> list[dict]:
        out = self.replicas[0].variants_summary()
        for v in out:
            v["replicas"] = len(self.replicas)
            v["captures"] = sum(r.variants[r.variant_key(tuple(v["bucket"]))].captures
                                for r in self.replicas
                                if r.variant_key(tuple(v["bucket"])) in r.variants)
        return out

    def describe(self) -> dict:
        d = self.replicas[0].describe()
        d.update(mode=self.mode, replicas=self.n_replicas, n_chips=self.n_chips,
                 parallel=self.parallel_signature, variants=self.variants_summary(),
                 captures_total=self.captures_total,
                 devices=[str(r.device) for r in self.replicas])
        return d


def build_runtime(model: ServingModel,
                  device: "str | torch.device | None" = None,
                  metrics: Metrics | None = None,
                  compile_forward: bool = True, prewarm: bool = True,
                  debug_nans: bool = False, cold: bool = False,
                  n_slots: int = N_SLOTS,
                  parallel: ParallelConfig | None = None) -> "ModelRuntime | ReplicaRuntime":
    """Parameter slots on ``device`` (default: the current CUDA device) and
    every bucket warmed up and, on CUDA, captured per slot.
    ``compile_forward=False`` skips the buckets: a runtime for the
    generation engine, whose programs replace them (``register_program``).
    ``prewarm=False`` skips each bucket's startup replay (the capture stays);
    ``debug_nans`` makes every fetch fail on a NaN/Inf output. ``cold=True``
    builds neither slots nor graphs (weight paging's cold boot: the first
    stage fills them). ``n_slots=1``: one parameter slot and one graph per
    bucket, for a runtime that never stages (a deferred-mode worker)."""
    cls = ReplicaRuntime if model.cfg.parallelism == "replica" else ModelRuntime
    rt = cls(model, device=device, metrics=metrics, prewarm=prewarm,
             debug_nans=debug_nans, n_slots=n_slots, parallel=parallel)
    rt.compile_forward = compile_forward
    if cold:
        for r in getattr(rt, "replicas", [rt]):
            r._resident = False
        return rt
    rt.load_params()
    if compile_forward:
        rt.compile_all()
    return rt
