"""Pipelined host execution primitives, ported from ``tpuserve/hostpipe.py``.

- :class:`StageExecutors` — one dedicated thread pool per pipeline stage
  (``assemble`` / ``h2d`` / ``fetch`` / ``postproc``), so consecutive batches
  occupy different stages at once instead of queueing behind each other.
- :class:`AssemblyArena` — preallocated per-bucket host-batch buffers
  recycled through a free-list instead of allocating per batch. On a CUDA
  runtime the buffers are pinned, so the runtime's ``h2d`` copies them with
  ``non_blocking=True``; ``prefill`` makes every bucket's buffers when the
  batcher starts, so no request pins memory. A buffer goes back to the
  free-list only after its batch's fetch completed, which proves the device
  finished reading it.
- :class:`SlotPool` — a bounded pool of integer slots with async acquire
  (optionally bounded by a timeout) and ``close`` (every waiter wakes with
  :class:`SlotsClosed`): the batcher's depth-k staging slots for the device
  section, and a deferred-mode worker's shared-memory batch slots.
"""

from __future__ import annotations

import asyncio
import concurrent.futures as cf
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from tpuserve_torch.config import PipelineConfig
from tpuserve_torch.obs import PIPELINE_STAGES, Metrics
from tpuserve_torch.utils.locks import new_lock


class SlotsClosed(Exception):
    """The pool was closed while (or before) a waiter held on for a slot."""


class SlotPool:
    """Fixed set of integer slots [0, n) with async acquire (event loop only);
    ``acquire`` waits until a slot frees, bounded by ``timeout_s`` (raises
    ``asyncio.TimeoutError``); ``close`` wakes every waiter with
    :class:`SlotsClosed`. Construction touches no event loop, so a pool can
    be built on an executor thread (the deferred pool spawns workers off
    the loop)."""

    def __init__(self, n: int) -> None:
        self.capacity = max(1, n)
        self._free: list[int] = list(range(self.capacity))
        self._waiters: deque[asyncio.Future] = deque()
        self._closed = False

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    def _wake_one(self) -> None:
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                return

    def try_acquire(self) -> int | None:
        if self._closed or not self._free:
            return None
        return self._free.pop()

    async def acquire(self, timeout_s: float | None = None) -> int:
        while True:
            if self._closed:
                raise SlotsClosed("slot pool closed")
            if self._free:
                return self._free.pop()
            fut = asyncio.get_running_loop().create_future()
            self._waiters.append(fut)
            try:
                await asyncio.wait_for(fut, timeout_s)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                if fut in self._waiters:
                    self._waiters.remove(fut)
                # A release that raced the timeout or cancellation must not
                # strand its slot: pass it to the next waiter.
                if self._free:
                    self._wake_one()
                raise

    def release(self, slot: int) -> None:
        self._free.append(slot)
        self._wake_one()

    def close(self) -> None:
        """Wake every waiter with SlotsClosed; held slots may still be
        released afterwards (bookkeeping only)."""
        self._closed = True
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_exception(SlotsClosed("slot pool closed"))


class StageExecutors:
    """Dedicated thread pool per pipeline stage (PIPELINE_STAGES), shared by
    every batcher of a server; keeps per-(model, stage) submitted-but-
    unfinished counts as ``pipeline_stage_depth{model=,stage=}`` gauges."""

    def __init__(self, cfg: PipelineConfig | None = None,
                 metrics: Metrics | None = None) -> None:
        cfg = cfg or PipelineConfig()
        sizes = {
            "assemble": cfg.assemble_workers,
            "h2d": cfg.h2d_workers,
            "fetch": cfg.fetch_workers,
            "postproc": cfg.postproc_workers,
        }
        self.metrics = metrics
        self._pools = {
            stage: cf.ThreadPoolExecutor(max_workers=max(1, sizes[stage]),
                                         thread_name_prefix=f"pipe-{stage}")
            for stage in PIPELINE_STAGES
        }
        self.workers = {s: max(1, n) for s, n in sizes.items()}
        self._depth: dict[tuple[str, str], int] = {}
        self._submitted: dict[str, int] = {s: 0 for s in PIPELINE_STAGES}
        self._shut = False

    def _set_depth(self, model: str, stage: str, depth: int) -> None:
        self._depth[(model, stage)] = depth
        if self.metrics is not None:
            self.metrics.gauge(
                f"pipeline_stage_depth{{model={model},stage={stage}}}").set(depth)

    async def run(self, model: str, stage: str, fn: Callable, *args) -> Any:
        """Run ``fn(*args)`` on the stage's pool; returns its result."""
        loop = asyncio.get_running_loop()
        self._set_depth(model, stage, self._depth.get((model, stage), 0) + 1)
        self._submitted[stage] += 1
        try:
            return await loop.run_in_executor(self._pools[stage], fn, *args)
        finally:
            self._set_depth(model, stage, self._depth[(model, stage)] - 1)

    def stats(self) -> dict:
        per_stage_depth = {s: 0 for s in PIPELINE_STAGES}
        for (_, stage), d in self._depth.items():
            per_stage_depth[stage] += d
        return {"workers": dict(self.workers), "depth": per_stage_depth,
                "submitted_total": dict(self._submitted)}

    def shutdown(self) -> None:
        if self._shut:
            return
        self._shut = True
        for p in self._pools.values():
            p.shutdown(wait=False, cancel_futures=True)


class _ArenaLease:
    """One acquired assembly buffer; hand back via AssemblyArena.release."""

    __slots__ = ("bucket", "buf", "pooled")

    def __init__(self, bucket: tuple, buf: Any, pooled: bool) -> None:
        self.bucket = bucket
        self.buf = buf
        self.pooled = pooled


class AssemblyArena:
    """Preallocated host-batch buffers per bucket, recycled via a free-list.

    A buffer is a tuple of np arrays shaped like ``model.input_signature``
    (pinned memory when ``pin``). ``acquire`` never blocks: past ``slots``
    buffers per bucket it hands out a one-shot allocation that is dropped
    instead of pooled, counted in ``arena_overflow_total{model=}``."""

    def __init__(self, model: Any, slots: int, metrics: Metrics | None = None,
                 pin: bool = False) -> None:
        self.model = model
        self.slots = max(1, slots)
        self.metrics = metrics
        self.pin = pin
        self._lock = new_lock("hostpipe.AssemblyArena")
        self._free: dict[tuple, list] = {}
        self._made: dict[tuple, int] = {}
        self.overflow_total = 0
        self.leased = 0

    def _alloc(self, bucket: tuple) -> tuple:
        return tuple(
            torch.zeros(s.shape, dtype=torch.from_numpy(np.zeros((), s.dtype)).dtype,
                        pin_memory=self.pin).numpy()
            for s in self.model.input_signature(bucket))

    def prefill(self, buckets) -> None:
        """Make every pooled buffer of ``buckets`` now (pinned on CUDA), so
        the first batch of a bucket allocates nothing on the request path."""
        for bucket in buckets:
            bufs = []
            with self._lock:
                n = self.slots - self._made.get(bucket, 0)
                self._made[bucket] = self.slots
            for _ in range(max(0, n)):
                bufs.append(self._alloc(bucket))
            with self._lock:
                self._free.setdefault(bucket, []).extend(bufs)

    def acquire(self, bucket: tuple) -> _ArenaLease:
        with self._lock:
            self.leased += 1
            free = self._free.setdefault(bucket, [])
            if free:
                return _ArenaLease(bucket, free.pop(), True)
            pooled = self._made.get(bucket, 0) < self.slots
            if pooled:
                self._made[bucket] = self._made.get(bucket, 0) + 1
            else:
                self.overflow_total += 1
        if not pooled and self.metrics is not None:
            self.metrics.counter(
                f"arena_overflow_total{{model={self.model.name}}}").inc()
        # Allocated outside the lock: pinning a buffer must not serialize
        # acquires for other buckets.
        return _ArenaLease(bucket, self._alloc(bucket), pooled)

    def release(self, lease: _ArenaLease) -> None:
        """Return a lease, only once the batch's fetch has completed."""
        with self._lock:
            self.leased -= 1
            if lease.pooled:
                self._free[lease.bucket].append(lease.buf)

    def stats(self) -> dict:
        with self._lock:
            return {
                "slots_per_bucket": self.slots,
                "pinned": self.pin,
                "leased": self.leased,
                "overflow_total": self.overflow_total,
                "buckets": {
                    str(list(b)): {"pooled": self._made.get(b, 0), "free": len(free)}
                    for b, free in self._free.items()
                },
            }
