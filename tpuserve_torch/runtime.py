"""Runtime: parameters on one device and the per-bucket variant registry,
ported from ``tpuserve/runtime.py``.

The JAX runtime AOT-compiles one XLA executable per (bucket, device set).
PyTorch runs eagerly, so here a *variant* is one bucket's warmed-up forward:
every bucket runs once on zeros at startup, that warm-up is what
``runtime_compiles_total`` counts, and a steady-state delta of 0 shows that
serving never meets an unwarmed shape. (Capturing each variant as a CUDA
graph is a later step, ROADMAP.md queue 1.)

The device is explicit: ``build_runtime(model)`` serves on the current CUDA
device, ``device="cpu"`` on the CPU (what the tests do); CUDA absent without
``device="cpu"`` raises instead of falling back.

Hot path, one batch: ``h2d`` copies the pinned host batch with
``non_blocking=True`` on a copy stream of its own, ``dispatch`` enqueues
the forward on the current stream (which waits for that copy on the card)
and returns device tensors at once, ``fetch`` blocks for the small outputs'
copy back (called off the event loop by the batcher's fetch stage).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from tpuserve_torch import quantize
from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models.base import DTYPES, ServingModel
from tpuserve_torch.obs import Metrics
from tpuserve_torch.parallel.mesh import MeshPlan, make_mesh

log = logging.getLogger("tpuserve_torch.runtime")


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device a runtime serves on: the current CUDA device unless the
    caller names another. Raises when CUDA is asked for (or defaulted to)
    and absent — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"tpuserve_torch serves on 'cuda' or 'cpu', not {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: tpuserve_torch runs on the GPU by "
                "default; pass device='cpu' (serve --device cpu) to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def backend_info(device: torch.device) -> dict:
    """What the server runs on, for /stats: the card, torch and CUDA."""
    info = {"device": str(device), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if device.type == "cuda":
        info["device_name"] = torch.cuda.get_device_name(device)
        info["device_count"] = torch.cuda.device_count()
    return info


@dataclass(frozen=True)
class VariantKey:
    """Identity of one specialized variant: the static batch/seq bucket,
    the compute dtype, the quantization mode and the parallelism layout
    (the JAX registry's key, unchanged)."""

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
    """Registry entry: one VariantKey, warmed up on this runtime's device."""

    key: VariantKey
    compile_ms: float = 0.0

    def summary(self) -> dict:
        return {
            "bucket": list(self.key.bucket),
            "dtype": self.key.dtype,
            "quantize": self.key.quantize,
            "parallelism": self.key.parallelism,
            "replicas": 1,
            "compile_ms": round(self.compile_ms, 1),
        }


class ModelRuntime:
    """Owns the model's parameters on one device and its variant registry."""

    def __init__(self, model: ServingModel,
                 device: "str | torch.device | None" = None,
                 metrics: Metrics | None = None) -> None:
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else Metrics()
        self.mode = self.cfg.parallelism
        if self.mode != "single":
            raise NotImplementedError(
                f"parallelism={self.mode!r} is not yet ported to "
                "tpuserve_torch (ROADMAP.md queue 1: mesh modes)")
        if self.cfg.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, "
                             f"got {self.cfg.dtype!r}")
        if self.cfg.quantize == "int8c":
            raise NotImplementedError(
                "quantize='int8c' (int8 compute) is not yet ported to "
                "tpuserve_torch (ROADMAP.md queue 1: quantized variants)")
        if self.cfg.quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {self.cfg.quantize!r}")
        self.dtype = DTYPES[self.cfg.dtype]
        # Single mode serves on a 1-device mesh (every axis of size 1).
        # Mesh-aware models (BERT's ring/Ulysses attention) close over it;
        # this precedes building the module and warming up.
        self.mesh = make_mesh(MeshPlan(), devices=[self.device])
        model.bind_mesh(self.mesh)
        self.module: torch.nn.Module | None = None
        self.variants: dict[VariantKey, Variant] = {}
        self.version = 1
        # When True, h2d() waits for its own copy so the "h2d" phase owns
        # the transfer and "compute" measures dispatch-to-ready only (set
        # from [pipeline] h2d_sync by the batcher).
        self.h2d_sync = False
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        name = model.name
        self._c_compiles = self.metrics.counter(
            f"runtime_compiles_total{{model={name}}}")
        self._g_variants = self.metrics.gauge(f"runtime_variants{{model={name}}}")

    # -- startup ------------------------------------------------------------
    def load_params(self) -> None:
        """Build the module and load the float32 params (seeded init) on the
        host; cast every floating one to the compute dtype; under
        ``quantize = "int8"`` quantize each eligible cast weight (the
        reference's order: cast, then quantize); then move the module to the
        device without a dtype, so int8 values and float32 scales arrive as
        they are. Convolutional families keep 4-D weights channels_last."""
        module = self.model.build_module()
        module.load_state_dict(self.model.load_params())
        module.to(dtype=self.dtype)
        module.eval().requires_grad_(False)
        if self.cfg.quantize == "int8":
            quantize.quantize_module(module, self.dtype, self.cfg.quantize_min_size)
        if self.model.channels_last:
            module.to(memory_format=torch.channels_last)
        module.to(device=self.device)
        self.module = module

    def variant_key(self, bucket: tuple) -> VariantKey:
        return VariantKey(bucket=tuple(bucket), dtype=self.cfg.dtype,
                          quantize=self.cfg.quantize, parallelism=self.mode)

    def compile_all(self) -> None:
        """Warm up every bucket once: the port's counterpart of the JAX
        runtime's AOT compile (each counts in runtime_compiles_total)."""
        t0 = time.perf_counter()
        for bucket in self.model.buckets():
            self._compile_bucket(tuple(bucket))
        log.info("%s: warmed %d bucket(s) on %s in %.1fs", self.model.name,
                 len(self.variants), self.device, time.perf_counter() - t0)

    def _zeros(self, bucket: tuple) -> tuple:
        return tuple(np.zeros(s.shape, s.dtype) for s in self.model.input_signature(bucket))

    def _compile_bucket(self, bucket: tuple) -> None:
        t0 = time.perf_counter()
        self.fetch(self.run(bucket, self._zeros(bucket)))
        key = self.variant_key(bucket)
        self.variants[key] = Variant(key, (time.perf_counter() - t0) * 1e3)
        self._c_compiles.inc()
        self._g_variants.set(len(self.variants))

    def warm_thread(self) -> None:
        """Run every bucket's forward once on the calling thread, uncounted
        (each bucket counted its compile at startup): cuDNN builds and
        caches its convolution plans per thread, so a thread that serves
        without this builds them on its first batch of each bucket, inside
        a request. The batcher calls it on each of its h2d threads before
        it serves."""
        for bucket in self.model.buckets():
            self.fetch(self.run(tuple(bucket), self._zeros(tuple(bucket))))

    @property
    def compiles_total(self) -> float:
        return self._c_compiles.value

    def variants_summary(self) -> list[dict]:
        return [v.summary() for _, v in sorted(
            self.variants.items(), key=lambda kv: kv[0].bucket)]

    # -- hot path -----------------------------------------------------------
    def h2d(self, bucket: tuple, host_batch: tuple) -> tuple:
        """Copy the host batch to the device: from pinned memory (the
        assembly arena pins its buffers on CUDA) with ``non_blocking=True``,
        on the runtime's own copy stream, so the copy overlaps the forward
        of the batch before it. The calling thread's current stream, which
        runs the forward, waits for the copy on the card; with ``h2d_sync``
        the host waits for this copy too, and for nothing queued before it.
        """
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

    def dispatch(self, bucket: tuple, dev_batch: tuple) -> dict:
        """Enqueue the forward on the device batch; returns device outputs
        without waiting for them."""
        with torch.inference_mode():
            return self.model.forward(self.module, dev_batch)

    def run(self, bucket: tuple, host_batch: tuple) -> dict:
        """h2d + dispatch in one call; returns device outputs immediately."""
        return self.dispatch(bucket, self.h2d(bucket, host_batch))

    @staticmethod
    def fetch(outputs: dict) -> dict:
        """Block for the D2H copy of the outputs; call off the event loop."""
        return {k: v.cpu().numpy() for k, v in outputs.items()}

    # -- info ---------------------------------------------------------------
    def describe(self) -> dict:
        # Every tensor the forward reads: weights (int8 where quantized),
        # scales and BatchNorm statistics.
        params = list(self.module.state_dict().values()) if self.module is not None else []
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
            "replicas": 1,
            "n_chips": 1,
            "parallel": self.mode,
            "device": str(self.device),
            "buckets": [list(k.bucket) for k in sorted(self.variants, key=lambda k: k.bucket)],
            "variants": self.variants_summary(),
            "compiles_total": self.compiles_total,
            "params": {"count": sum(p.numel() for p in params),
                       "bytes": sum(p.numel() * p.element_size() for p in params)},
        }


def build_runtime(model: ServingModel,
                  device: "str | torch.device | None" = None,
                  metrics: Metrics | None = None) -> ModelRuntime:
    """Parameters on ``device`` (default: the current CUDA device) and every
    bucket warmed up."""
    rt = ModelRuntime(model, device=device, metrics=metrics)
    rt.load_params()
    rt.compile_all()
    return rt
