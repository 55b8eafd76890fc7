"""Static-shape request batching engine, ported from ``tpuserve/batcher.py``.

- Requests are routed to a *group* (model-defined: the seq bucket for text).
  Each group has its own accumulation task and queue.
- A group flushes when the largest batch bucket fills, or when its oldest
  request has waited ``deadline_ms``, whichever is first. The flush picks the
  smallest batch bucket >= the ready count and pads up to it.
- Dispatch is a staged pipeline on dedicated executors (``hostpipe``):
  assemble into a recycled arena buffer ("preproc" phase), h2d + dispatch of
  the forward ("h2d"), fetch of the outputs ("compute"), then postprocess
  ("postproc"). A depth-k staging-slot pool bounds batches inside
  [h2d..fetch]; admission (depth + assemble_ahead batches) bounds the rest.
- ``QueueFull`` (-> 429) when ``max_queue`` requests are pending, and
  ``DeadlineExceeded`` (-> fast 504) for a request whose deadline passed
  while it was still queued.

Not ported yet (ROADMAP.md queue 1, "Batcher robustness"): the adaptive AIMD
flush, batch retry and poison bisection, the circuit breaker, deferred
(recycle) mode, the fault injector and request trace spans.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Hashable

from tpuserve_torch.config import PipelineConfig
from tpuserve_torch.hostpipe import AssemblyArena, SlotPool, StageExecutors
from tpuserve_torch.models.base import ServingModel
from tpuserve_torch.obs import PHASES, Metrics
from tpuserve_torch.runtime import ModelRuntime

log = logging.getLogger("tpuserve_torch.batcher")


class QueueFull(Exception):
    """Raised by submit() when the model queue is at capacity (-> HTTP 429)."""


class DeadlineExceeded(Exception):
    """A request's absolute deadline expired while it was still queued
    (-> fast HTTP 504): work nobody waits for is rejected before dispatch."""


@dataclass
class _Request:
    item: Any  # decoded input (np arrays), model-specific
    group: Hashable
    future: asyncio.Future = field(repr=False)
    enqueued_at: float = 0.0  # time.perf_counter()
    # Absolute deadline (perf_counter clock); None = no per-request deadline.
    deadline_at: float | None = None


class ModelBatcher:
    """One batching engine per served model."""

    def __init__(self, model: ServingModel, runtime: ModelRuntime,
                 metrics: Metrics, stages: StageExecutors | None = None,
                 pipeline_cfg: PipelineConfig | None = None) -> None:
        self.model = model
        self.runtime = runtime
        self.metrics = metrics
        self.cfg = model.cfg
        self.pipeline_cfg = pipeline_cfg or PipelineConfig()
        name = model.cfg.name
        self._g_queue_depth = metrics.gauge(f"queue_depth{{model={name}}}")
        self._g_fill = metrics.gauge(f"batch_fill_ratio{{model={name}}}")
        self._g_inflight = metrics.gauge(f"pipeline_inflight{{model={name}}}")
        self._c_shed = metrics.counter(f"shed_total{{model={name}}}")
        self._c_deadline = metrics.counter(f"deadline_exceeded_total{{model={name}}}")
        self._c_batches = metrics.counter(f"batches_total{{model={name}}}")
        self._c_items = metrics.counter(f"items_total{{model={name}}}")
        self._c_batch_errors = metrics.counter(f"batch_errors_total{{model={name}}}")
        self._h_phase = {p: metrics.histogram(f"latency_ms{{model={name},phase={p}}}")
                         for p in PHASES}
        # Stage executors are normally server-owned and shared across models;
        # a batcher built without one (tests) owns and later shuts down its own.
        self._own_stages = stages is None
        self.stages = stages if stages is not None \
            else StageExecutors(self.pipeline_cfg, metrics)
        self._queues: dict[Hashable, asyncio.Queue[_Request]] = {}
        self._tasks: dict[Hashable, asyncio.Task] = {}
        self._dispatch_tasks: set[asyncio.Task] = set()
        self._inflight: asyncio.Semaphore | None = None
        self._staging: SlotPool | None = None
        self.arena: AssemblyArena | None = None
        self.depth = 0
        self._admission_cap = 0
        self._inflight_now = 0
        self._inflight_peak = 0
        self._pending = 0
        self._running = False

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        pcfg = self.pipeline_cfg
        self.runtime.h2d_sync = pcfg.h2d_sync
        self.depth = max(1, pcfg.depth or self.cfg.max_inflight)
        if self.runtime.device.type == "cpu":
            # On the CPU a second forward in flight only competes for the
            # same cores; a CUDA device keeps the configured depth (its
            # stream orders the batches).
            self.depth = 1
        self._staging = SlotPool(self.depth)
        self._admission_cap = self.depth + pcfg.assemble_ahead
        self.arena = AssemblyArena(
            self.model, pcfg.arena_slots or (self.depth + pcfg.assemble_ahead),
            self.metrics, pin=self.runtime.device.type == "cuda")
        self._inflight = asyncio.Semaphore(self._admission_cap)
        self._running = True

    async def stop(self) -> None:
        """Cancel accumulation, fail queued requests, drain in-flight batches."""
        self._running = False
        for t in self._tasks.values():
            t.cancel()
        for group, t in self._tasks.items():
            try:
                await t
            except asyncio.CancelledError:
                pass  # the cancellation requested just above
            except Exception:
                log.exception("group loop %r for %s failed during stop",
                              group, self.model.name)
        self._tasks.clear()
        err = RuntimeError(f"server shutting down; {self.model.name} not served")
        for q in self._queues.values():
            while not q.empty():
                req = q.get_nowait()
                self._pending -= 1
                if not req.future.done():
                    req.future.set_exception(err)
        self._queues.clear()
        if self._dispatch_tasks:
            await asyncio.gather(*self._dispatch_tasks, return_exceptions=True)
        if self._own_stages:
            self.stages.shutdown()

    # -- submission (event loop) --------------------------------------------
    def submit(self, item: Any, group: Hashable = None,
               deadline_at: float | None = None) -> asyncio.Future:
        """Enqueue one decoded request; returns a Future of its result.
        ``deadline_at`` (perf_counter clock): past it, a still-queued request
        fails with DeadlineExceeded instead of dispatching."""
        if not self._running:
            raise RuntimeError(f"batcher for {self.model.name} not started")
        if self._pending >= self.cfg.max_queue:
            self._c_shed.inc()
            raise QueueFull(self.model.name)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        req = _Request(item=item, group=group, future=fut,
                       enqueued_at=time.perf_counter(), deadline_at=deadline_at)
        q = self._queues.get(group)
        if q is None:
            q = self._queues[group] = asyncio.Queue()
            self._tasks[group] = loop.create_task(self._group_loop(group, q))
        q.put_nowait(req)
        self._pending += 1
        self._g_queue_depth.set(self._pending)
        return fut

    def _expire_dead(self, reqs: list[_Request]) -> list[_Request]:
        """Fail requests whose deadline has passed and drop done futures
        (cancelled by a client that went away); returns the live rest."""
        now = time.perf_counter()
        live: list[_Request] = []
        n_expired = 0
        for r in reqs:
            if r.future.done():
                continue
            if r.deadline_at is not None and now >= r.deadline_at:
                r.future.set_exception(DeadlineExceeded(
                    f"deadline expired after {(now - r.enqueued_at) * 1e3:.0f} ms in queue"))
                n_expired += 1
                continue
            live.append(r)
        if n_expired:
            self._c_deadline.inc(n_expired)
        return live

    # -- accumulation (event loop) ------------------------------------------
    async def _group_loop(self, group: Hashable, q: asyncio.Queue) -> None:
        max_bucket = max(self.cfg.batch_buckets)
        deadline_s = self.cfg.deadline_ms / 1e3
        while True:
            req = await q.get()
            batch = [req]
            try:
                flush_at = req.enqueued_at + deadline_s
                while len(batch) < max_bucket:
                    timeout = flush_at - time.perf_counter()
                    if timeout <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(q.get(), timeout))
                    except asyncio.TimeoutError:
                        break
                # Admission bounds batches inside the pipeline; the group
                # task waits here (backpressure).
                await self._inflight.acquire()
            except asyncio.CancelledError:
                # stop() cancelled us mid-accumulation: requests already
                # pulled off the queue must fail, not hang their clients.
                err = RuntimeError(f"server shutting down; {self.model.name} not served")
                self._pending -= len(batch)
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(err)
                raise
            # Anything that queued while we waited for admission folds into
            # this batch, up to the largest bucket.
            while len(batch) < max_bucket and not q.empty():
                batch.append(q.get_nowait())
            self._pending -= len(batch)
            self._g_queue_depth.set(self._pending)
            live = self._expire_dead(batch)
            if not live:
                self._inflight.release()
                continue
            now = time.perf_counter()
            for r in live:
                self._h_phase["queue"].observe((now - r.enqueued_at) * 1e3)
            task = asyncio.get_running_loop().create_task(self._dispatch(live, group))
            self._dispatch_tasks.add(task)
            task.add_done_callback(self._dispatch_tasks.discard)

    # -- dispatch (stage executors do the blocking work) ---------------------
    async def _dispatch(self, reqs: list[_Request], group: Hashable) -> None:
        """Run one batch; a failure fails this batch's futures only."""
        self._inflight_now += 1
        self._inflight_peak = max(self._inflight_peak, self._inflight_now)
        self._g_inflight.set(self._inflight_now)
        try:
            await self._execute(reqs, group)
        except Exception as e:
            log.exception("batch dispatch failed for %s", self.model.name)
            self._c_batch_errors.inc()
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            self._inflight_now -= 1
            self._g_inflight.set(self._inflight_now)
            self._inflight.release()

    async def _execute(self, reqs: list[_Request], group: Hashable) -> None:
        name = self.model.name
        bucket = self.model.bucket_for(len(reqs), group=group)
        self._g_fill.set(len(reqs) / bucket[0])
        self._c_batches.inc()
        items = [r.item for r in reqs]
        t0 = time.perf_counter()
        lease = self.arena.acquire(bucket)
        try:
            host_batch = await self.stages.run(
                name, "assemble", self.model.assemble_into, items, bucket, lease.buf)
            t1 = time.perf_counter()
            self._h_phase["preproc"].observe((t1 - t0) * 1e3)
            slot = await self._staging.acquire()
            try:
                outputs = await self.stages.run(
                    name, "h2d", self.runtime.run, bucket, host_batch)
                t2 = time.perf_counter()
                self._h_phase["h2d"].observe((t2 - t1) * 1e3)
                np_out = await self.stages.run(name, "fetch", self.runtime.fetch, outputs)
                t3 = time.perf_counter()
                self._h_phase["compute"].observe((t3 - t2) * 1e3)
            finally:
                self._staging.release(slot)
        finally:
            # Safe only now: the completed fetch proves the device is done
            # reading the (pinned) buffer.
            self.arena.release(lease)
        results = await self.stages.run(
            name, "postproc", self.model.host_postprocess, np_out, len(reqs))
        self._h_phase["postproc"].observe((time.perf_counter() - t3) * 1e3)
        self._c_items.inc(len(reqs))
        for r, res in zip(reqs, results):
            if not r.future.done():
                r.future.set_result(res)

    def pipeline_stats(self) -> dict:
        return {
            "depth": self.depth,
            "admission_cap": self._admission_cap,
            "inflight": self._inflight_now,
            "inflight_peak": self._inflight_peak,
            "staging_in_use": self._staging.in_use if self._staging else 0,
            "pending": self._pending,
            "arena": self.arena.stats() if self.arena is not None else None,
        }
