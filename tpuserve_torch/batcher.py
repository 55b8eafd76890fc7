"""Static-shape request batching engine, ported from ``tpuserve/batcher.py``.

- Requests are routed to a *group* (model-defined: the seq bucket for text).
  Each group has its own accumulation task and queue.
- Flush scheduling is adaptive (``[adaptive]``, on by default as in the
  reference): each group keeps an AIMD target batch size — a batch that
  fills to target with work still queued grows it additively, a
  timer-driven partial flush shrinks it multiplicatively — so light load
  converges to target 1 (flush at once, no ``deadline_ms`` wait) and
  sustained load to the largest bucket. A per-bucket EWMA of the batch
  duration bounds the wait further: a batch whose earliest member deadline
  leaves less than EWMA + slack of headroom flushes now. ``deadline_ms``
  stays the max-wait backstop, and ``[adaptive] enabled = false`` restores
  the fixed timer: flush when the largest bucket fills or the oldest
  request has waited ``deadline_ms``. The flush picks the smallest batch
  bucket >= the ready count and pads up to it.
- Dispatch is a staged pipeline on dedicated executors (``hostpipe``):
  assemble into a recycled, pinned arena buffer ("preproc" phase), h2d +
  dispatch of the forward ("h2d"), fetch of the outputs ("compute"), then
  postprocess ("postproc"). A depth-k staging-slot pool bounds batches
  inside [h2d..fetch]; admission (depth + assemble_ahead batches) bounds the
  rest. Both waits are bounded by the earliest per-request deadline.
- Failure containment: a failed dispatch re-assembles and re-runs the batch
  once (``batch_retry``); if that fails too the batch bisects recursively
  (``retry_split``), so a single poison item fails only its own future.
  Dispatch outcomes feed the model's circuit breaker; an optional
  FaultInjector supplies ``batch_error``/``slow_dispatch`` at dispatch and
  ``kill_group_loop`` at the top of a group loop, and the server's watchdog
  revives dead group loops (``revive_group_loops``). ``drain`` waits for
  every accepted request on an idle event.
- ``QueueFull`` (-> 429) when ``max_queue`` requests are pending, and
  ``DeadlineExceeded`` (-> fast 504) for a request whose deadline passed
  while it was still queued.
- Tracing: a request submitted with its ``TraceContext`` gets a ``queue``
  span at flush and, per batch it rode in, ``preproc``, ``h2d``,
  ``compute`` and ``postproc`` spans tagged with the batch id (a retried or
  bisected request's tree holds every attempt); the phase histograms carry
  a member's trace id as their exemplar, and the span ring gets one
  ``batch[bucket]`` span per batch. ``device_seconds_total{model=,
  replica=}`` counts each replica's compute phase wall time (the telemetry
  sampler's device utilization).
- Replicas (a ``runtime.ReplicaRuntime``): one depth-k staging-slot pool
  per replica; a batch takes the runtime's least-loaded pick and, when that
  pool is full, the least-loaded of the others (ties rotating), so no
  replica starves; admission is depth x replicas + assemble_ahead, and
  ``replica_inflight{model=,replica=}`` and ``pipeline_stats``'
  ``per_replica`` rows show each one's occupancy.
- Fleet scheduler seams (``tpuserve_torch.scheduler``): a request submitted
  with its ``priority`` class lands in ``queue_wait_ms{model=,priority=}``
  (the model's default class without one), and ``device_time_cb``, when the
  scheduler set it, receives each batch's compute-phase seconds on the
  event loop. ``pending``, ``estimate_clear_s`` and ``predicted_service_s``
  are what its admission reads.
- Deferred (recycle) mode: over a ``tpuserve_torch.deferred.DeferredPool``
  (a runtime with ``run_deferred``) the model has no staging slots and no
  arena, and admission is ``max(1, max_inflight)`` batches between assembly
  and their enqueue on a worker, released as soon as ``enqueue`` returns
  (once per batch, retries included), before the epoch's readback. There
  ``h2d`` is the enqueue and ``compute`` the wait for the epoch; its seconds
  go to ``device_seconds_total{replica=0}`` and ``device_time_cb``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures as cf
import logging
import math
import time
from dataclasses import dataclass, field
from typing import Any, Hashable

from tpuserve_torch.config import AdaptiveConfig, PipelineConfig
from tpuserve_torch.hostpipe import AssemblyArena, SlotPool, StageExecutors
from tpuserve_torch.models.base import ServingModel
from tpuserve_torch.obs import PHASES, PRIORITIES, Metrics
from tpuserve_torch.runtime import ModelRuntime

log = logging.getLogger("tpuserve_torch.batcher")


class QueueFull(Exception):
    """Raised by submit() when the model queue is at capacity (-> HTTP 429)."""


def clamp_retry_after_s(est: "float | None") -> "int | None":
    """The [1, 30] s Retry-After hint derived from a raw queue-clear
    estimate (``ModelBatcher.estimate_clear_s`` stays unclamped)."""
    if est is None:
        return None
    return max(1, min(30, math.ceil(est)))


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
    # Priority class (obs.PRIORITIES) labelling the queue-wait histogram;
    # None = the model's default class.
    priority: str | None = None
    # The request's obs.TraceContext (queue and phase spans are appended to
    # it); None when the caller does not trace.
    ctx: Any = None


class ModelBatcher:
    """One batching engine per served model."""

    def __init__(self, model: ServingModel, runtime: ModelRuntime,
                 metrics: Metrics, stages: StageExecutors | None = None,
                 pipeline_cfg: PipelineConfig | None = None,
                 adaptive_cfg: AdaptiveConfig | None = None,
                 breaker: Any | None = None, injector: Any | None = None) -> None:
        self.model = model
        self.runtime = runtime
        # A deferred-readback pool (tpuserve_torch.deferred.DeferredPool)
        # instead of an in-process runtime: dispatch awaits the epoch's
        # readback, and this process never touches the device.
        self.deferred = hasattr(runtime, "run_deferred")
        self.metrics = metrics
        self.cfg = model.cfg
        self.pipeline_cfg = pipeline_cfg or PipelineConfig()
        self.adaptive_cfg = adaptive_cfg or AdaptiveConfig()
        # Adaptive scheduler state (event loop only): AIMD target batch size
        # per group, batch-duration EWMA per bucket.
        self._targets: dict[Hashable, float] = {}
        self._ewma_ms: dict[tuple, float] = {}
        name = model.cfg.name
        self._g_queue_depth = metrics.gauge(f"queue_depth{{model={name}}}")
        self._g_fill = metrics.gauge(f"batch_fill_ratio{{model={name}}}")
        self._g_inflight = metrics.gauge(f"pipeline_inflight{{model={name}}}")
        self._g_target = metrics.gauge(f"adaptive_target_batch{{model={name}}}")
        self._g_ewma = metrics.gauge(f"batch_duration_ewma_ms{{model={name}}}")
        self._c_shed = metrics.counter(f"shed_total{{model={name}}}")
        self._c_deadline = metrics.counter(f"deadline_exceeded_total{{model={name}}}")
        self._c_batches = metrics.counter(f"batches_total{{model={name}}}")
        self._c_items = metrics.counter(f"items_total{{model={name}}}")
        self._c_batch_errors = metrics.counter(f"batch_errors_total{{model={name}}}")
        self._c_retries = metrics.counter(f"batch_retries_total{{model={name}}}")
        self._c_retry_failures = metrics.counter(
            f"batch_retry_failures_total{{model={name}}}")
        self._c_poison = metrics.counter(f"poison_items_total{{model={name}}}")
        self._h_phase = {p: metrics.histogram(f"latency_ms{{model={name},phase={p}}}")
                         for p in PHASES}
        # Device seconds per runtime replica (replica 0 alone, and for a
        # deferred pool); sized to the replica count at start().
        self._c_device_seconds = [metrics.device_seconds_counter(name, 0)]
        self._g_replica_inflight: list[Any] = []
        # Per-priority queue-wait split: requests without a resolved priority
        # land under the model's default class.
        self._default_priority = getattr(model.cfg, "priority", "interactive")
        self._h_qwait = {p: metrics.queue_wait_histogram(name, p) for p in PRIORITIES}
        # The fleet scheduler's device-seconds ledger feed (set at its
        # registration): called with each batch's compute-phase seconds.
        self.device_time_cb = None
        # Stage executors are normally server-owned and shared across models;
        # a batcher built without one (tests) owns and later shuts down its own.
        self._own_stages = stages is None
        self.stages = stages if stages is not None \
            else StageExecutors(self.pipeline_cfg, metrics)
        self._queues: dict[Hashable, asyncio.Queue[_Request]] = {}
        self._tasks: dict[Hashable, asyncio.Task] = {}
        self._dispatch_tasks: set[asyncio.Task] = set()
        self._inflight: asyncio.Semaphore | None = None
        # One depth-k staging-slot pool per runtime replica.
        self._staging: list[SlotPool] = []
        self.arena: AssemblyArena | None = None
        self.depth = 0
        self._admission_cap = 0
        self._inflight_now = 0
        self._inflight_peak = 0
        self._idle_event: asyncio.Event | None = None
        self._pending = 0
        self._running = False
        self._loop: asyncio.AbstractEventLoop | None = None
        # Arena assembly requires assemble_into to produce exactly what
        # assemble would: provable only when assemble is the base
        # implementation, or the family overrode assemble_into alongside its
        # own assemble. A wrapper that overrides assemble (the poison tests)
        # takes the allocating path.
        t = type(model)
        a = getattr(t, "assemble", None)
        ai = getattr(t, "assemble_into", None)
        self._use_arena = (a is ServingModel.assemble
                           or (ai is not None and ai is not ServingModel.assemble_into))
        # Per-model circuit breaker (faults.CircuitBreaker): fed dispatch
        # outcomes here, consulted by the HTTP layer.
        self.breaker = breaker
        # Deterministic chaos (faults.FaultInjector); None in production.
        self.injector = injector

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        pcfg = self.pipeline_cfg
        self._loop = asyncio.get_running_loop()
        if self.deferred:
            # The pool's shm-slot wait is the device backpressure; admission
            # bounds the batches between assembly and enqueue.
            self._admission_cap = max(1, self.cfg.max_inflight)
            self._inflight = asyncio.Semaphore(self._admission_cap)
            self._idle_event = asyncio.Event()
            self._idle_event.set()
            self._running = True
            return
        self.runtime.h2d_sync = pcfg.h2d_sync
        self.depth = max(1, pcfg.depth or self.cfg.max_inflight)
        if self.runtime.device.type == "cpu":
            # On the CPU a second forward in flight only competes for the
            # same cores; a CUDA device keeps the configured depth (its
            # stream orders the batches).
            self.depth = 1
        n_rep = max(1, int(getattr(self.runtime, "n_replicas", 1)))
        self._staging = [SlotPool(self.depth) for _ in range(n_rep)]
        # Replica-aware admission: depth-k batches per replica's device
        # section plus the assembly ramp, so every replica's staging slots
        # stay full.
        self._admission_cap = self.depth * n_rep + pcfg.assemble_ahead
        name = self.cfg.name
        self._g_replica_inflight = [self.metrics.gauge(
            f"replica_inflight{{model={name},replica={i}}}") for i in range(n_rep)]
        self._c_device_seconds = [self.metrics.device_seconds_counter(name, i)
                                  for i in range(n_rep)]
        if self._use_arena:
            self.arena = AssemblyArena(
                self.model, pcfg.arena_slots or (self.depth + pcfg.assemble_ahead),
                self.metrics, pin=self.runtime.device.type == "cuda")
            # Every bucket's buffers now: pinning on the request path cost
            # the first batch of each bucket its allocation.
            self.arena.prefill(self.model.buckets())
        self._inflight = asyncio.Semaphore(self._admission_cap)
        self._idle_event = asyncio.Event()
        self._idle_event.set()
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
        self._maybe_idle()
        if self._own_stages:
            self.stages.shutdown()

    # -- submission (event loop) --------------------------------------------
    def submit(self, item: Any, group: Hashable = None,
               deadline_at: float | None = None, priority: str | None = None,
               ctx: Any = None) -> asyncio.Future:
        """Enqueue one decoded request; returns a Future of its result.
        ``deadline_at`` (perf_counter clock): past it, a still-queued request
        fails with DeadlineExceeded instead of dispatching. ``priority``
        labels the request's queue-wait histogram. ``ctx``
        (obs.TraceContext) collects the request's queue and phase spans."""
        if not self._running or self._inflight is None:
            raise RuntimeError(f"batcher for {self.model.name} not started")
        if self._pending >= self.cfg.max_queue:
            self._c_shed.inc()
            raise QueueFull(self.model.name)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        req = _Request(item=item, group=group, future=fut,
                       enqueued_at=time.perf_counter(), deadline_at=deadline_at,
                       priority=priority, ctx=ctx)
        q = self._queues.get(group)
        if q is None:
            q = self._queues[group] = asyncio.Queue()
            self._tasks[group] = loop.create_task(self._group_loop(group, q))
        q.put_nowait(req)
        self._pending += 1
        self._idle_event.clear()
        self._g_queue_depth.set(self._pending)
        return fut

    def submit_threadsafe(self, item: Any, group: Hashable = None,
                          deadline_at: float | None = None,
                          priority: str | None = None,
                          ctx: Any = None) -> cf.Future:
        """Submit from a thread that is not the batcher's event loop (an
        ingest loop, an embedding thread): schedules ``submit`` on the loop
        captured at ``start`` and returns a ``concurrent.futures.Future`` of
        the result; submit-time errors (QueueFull, RuntimeError) arrive
        through it. Cancelling it does not cancel the queued request (the
        request's own deadline bounds it). On the owning loop call
        ``submit``: blocking on this future there would deadlock."""
        loop = self._loop
        if not self._running or loop is None:
            raise RuntimeError(f"batcher for {self.model.name} not started")
        out: cf.Future = cf.Future()

        def _do() -> None:
            try:
                fut = self.submit(item, group=group, deadline_at=deadline_at,
                                  priority=priority, ctx=ctx)
            except Exception as e:  # QueueFull / stopped: through the future
                out.set_exception(e)
                return

            def _done(f: asyncio.Future) -> None:
                if out.cancelled():
                    return
                if f.cancelled():
                    out.cancel()
                elif f.exception() is not None:
                    out.set_exception(f.exception())
                else:
                    out.set_result(f.result())

            fut.add_done_callback(_done)

        loop.call_soon_threadsafe(_do)
        return out

    def revive_group_loops(self) -> int:
        """Watchdog hook: restart group-accumulation tasks that died.

        A group loop only ends on stop(); any other completion (an escaped
        exception, an injected kill) orphans its queue. Requests the dead
        loop had already pulled into its batch are lost (they resolve at
        the server's request timeout); everything still queued is served by
        the revived task."""
        if not self._running:
            return 0
        revived = 0
        loop = asyncio.get_running_loop()
        for group, q in self._queues.items():
            t = self._tasks.get(group)
            if t is not None and not t.done():
                continue
            if t is not None and not t.cancelled() and t.exception() is not None:
                log.error("group loop %r for %s died: %r — restarting",
                          group, self.model.name, t.exception())
            self._tasks[group] = loop.create_task(self._group_loop(group, q))
            revived += 1
        return revived

    def _maybe_idle(self) -> None:
        """Signal drain() waiters when no accepted work remains."""
        if self._idle_event is not None and self._pending == 0 \
                and not self._dispatch_tasks:
            self._idle_event.set()

    async def drain(self, deadline: float) -> bool:
        """Graceful drain: wait until every accepted request (queued or in
        flight) has resolved, bounded by ``deadline`` (event-loop time).
        The caller stops admitting new work first (server.draining)."""
        loop = asyncio.get_running_loop()
        while self._pending > 0 or self._dispatch_tasks:
            timeout = deadline - loop.time()
            if timeout <= 0:
                break
            # clear-then-recheck: the loop is single-threaded, so no
            # completion can slip between the recheck and the wait.
            self._idle_event.clear()
            if self._pending == 0 and not self._dispatch_tasks:
                break
            try:
                await asyncio.wait_for(self._idle_event.wait(), timeout)
            except asyncio.TimeoutError:
                break
        self._maybe_idle()
        return self._pending == 0 and not self._dispatch_tasks

    def _expire_dead(self, reqs: list[_Request],
                     adjust_pending: bool) -> list[_Request]:
        """Fail requests whose deadline has passed (-> fast 504) and drop
        done futures (cancelled by a client that went away); returns the
        live rest. ``adjust_pending`` settles the queue-depth accounting for
        dropped requests when the batch-wide decrement has not run yet."""
        now = time.perf_counter()
        live: list[_Request] = []
        n_expired = 0
        for r in reqs:
            if r.future.done():
                if adjust_pending:
                    self._pending -= 1
                continue
            if r.deadline_at is not None and now >= r.deadline_at:
                r.future.set_exception(DeadlineExceeded(
                    f"deadline expired after {(now - r.enqueued_at) * 1e3:.0f} ms in queue"))
                n_expired += 1
                if adjust_pending:
                    self._pending -= 1
                continue
            live.append(r)
        if n_expired:
            self._c_deadline.inc(n_expired)
        if adjust_pending and len(live) != len(reqs):
            self._g_queue_depth.set(self._pending)
            self._maybe_idle()
        return live

    # -- adaptive flush scheduling (event loop) ------------------------------
    def _flush_headroom(self, batch: list[_Request]) -> float:
        """Earliest-deadline flush bound (perf_counter clock): the batch must
        dispatch while EWMA(batch duration) + slack still fits before the
        earliest member deadline. +inf when no member carries a deadline."""
        earliest = min((r.deadline_at for r in batch
                        if r.deadline_at is not None), default=None)
        if earliest is None:
            return float("inf")
        bucket = self.model.bucket_for(len(batch), group=batch[0].group)
        est_ms = self._ewma_ms.get(bucket, 0.0)
        return earliest - (est_ms + self.adaptive_cfg.slack_ms) / 1e3

    def _aimd_update(self, group: Hashable, tgt: float, n: int,
                     target_n: int, timer_flush: bool,
                     pressure: bool) -> None:
        """AIMD: a batch that filled to target with more work still queued
        (``pressure``) grows the target additively; a timer-driven partial
        flush shrinks it multiplicatively toward min_target. A fill with an
        empty queue is equilibrium (lone sequential requests at target 1
        must not flap between immediate and full-timer flushes)."""
        acfg = self.adaptive_cfg
        if n >= target_n and pressure:
            tgt = min(float(max(self.cfg.batch_buckets)), tgt + acfg.increase)
        elif timer_flush and n < target_n:
            tgt = max(float(acfg.min_target), tgt * acfg.decrease)
        self._targets[group] = tgt
        self._g_target.set(tgt)

    def _observe_batch_duration(self, bucket: tuple, dur_ms: float) -> None:
        prev = self._ewma_ms.get(bucket)
        alpha = self.adaptive_cfg.ewma_alpha
        ewma = dur_ms if prev is None else prev + alpha * (dur_ms - prev)
        self._ewma_ms[bucket] = ewma
        self._g_ewma.set(ewma)

    # -- accumulation (event loop) ------------------------------------------
    async def _group_loop(self, group: Hashable, q: asyncio.Queue) -> None:
        max_bucket = max(self.cfg.batch_buckets)
        deadline_s = self.cfg.deadline_ms / 1e3
        acfg = self.adaptive_cfg
        adaptive = acfg.enabled
        init_target = float(acfg.initial_target or max_bucket)
        while True:
            if self.injector is not None:
                # Chaos: an escaped exception ends this task, the failure
                # revive_group_loops exists to repair.
                self.injector.check("kill_group_loop", self.model.name)
            req = await q.get()
            batch = [req]
            tgt = self._targets.get(group, init_target)
            target_n = (min(max_bucket, max(acfg.min_target, math.ceil(tgt)))
                        if adaptive else max_bucket)
            timer_flush = False
            try:
                # Max-wait backstop; adaptive mode also bounds the wait by
                # the deadline headroom and stops at the AIMD target.
                flush_at = req.enqueued_at + deadline_s
                while len(batch) < target_n:
                    limit = flush_at
                    if adaptive:
                        limit = min(limit, self._flush_headroom(batch))
                    timeout = limit - time.perf_counter()
                    if timeout <= 0:
                        timer_flush = True
                        break
                    try:
                        batch.append(await asyncio.wait_for(q.get(), timeout))
                    except asyncio.TimeoutError:
                        timer_flush = True
                        break
                if adaptive:
                    self._aimd_update(group, tgt, len(batch), target_n,
                                      timer_flush, pressure=not q.empty())
                # Admission bounds batches inside the pipeline; the wait is
                # bounded by the earliest member deadline, so a request that
                # dies behind slow in-flight work fails AT its deadline.
                batch = self._expire_dead(batch, adjust_pending=True)
                while batch:
                    earliest = min((r.deadline_at for r in batch
                                    if r.deadline_at is not None), default=None)
                    if earliest is None:
                        await self._inflight.acquire()
                        break
                    slot_wait = earliest - time.perf_counter()
                    if slot_wait > 0:
                        try:
                            await asyncio.wait_for(self._inflight.acquire(), slot_wait)
                            break
                        except asyncio.TimeoutError:
                            pass
                    batch = self._expire_dead(batch, adjust_pending=True)
                if not batch:
                    continue  # everything expired; no admission was taken
            except asyncio.CancelledError:
                # stop() cancelled us mid-accumulation: requests already
                # pulled off the queue must fail, not hang their clients.
                err = RuntimeError(f"server shutting down; {self.model.name} not served")
                self._pending -= len(batch)
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(err)
                self._maybe_idle()
                raise
            # Anything that queued while we waited folds into this batch, up
            # to the largest bucket.
            while len(batch) < max_bucket and not q.empty():
                batch.append(q.get_nowait())
            self._pending -= len(batch)
            self._g_queue_depth.set(self._pending)
            live = self._expire_dead(batch, adjust_pending=False)
            if not live:
                self._inflight.release()
                self._maybe_idle()
                continue
            now = time.perf_counter()
            now_wall = time.time()
            for r in live:
                wait_ms = (now - r.enqueued_at) * 1e3
                tid = r.ctx.trace_id if r.ctx is not None else None
                self._h_phase["queue"].observe(wait_ms, trace_id=tid)
                self._h_qwait[r.priority or self._default_priority].observe(
                    wait_ms, trace_id=tid)
                if r.ctx is not None:
                    r.ctx.span("queue", now_wall - wait_ms / 1e3, now_wall,
                               tid=self.model.name)
            task = asyncio.get_running_loop().create_task(self._dispatch(live, group))
            self._dispatch_tasks.add(task)
            task.add_done_callback(self._dispatch_tasks.discard)
            task.add_done_callback(lambda _t: self._maybe_idle())

    # -- dispatch (stage executors do the blocking work) ---------------------
    async def _dispatch(self, reqs: list[_Request], group: Hashable) -> None:
        """Run one batch; on failure retry/split per config before failing
        futures. Failure stays inside this batch: the group task and the
        server keep serving. Retries hold this batch's admission slot (in
        deferred mode until its first enqueue returned: it is released once)."""
        name = self.model.name
        released = [False]  # deferred mode releases admission mid-flight
        self._inflight_now += 1
        self._inflight_peak = max(self._inflight_peak, self._inflight_now)
        self._g_inflight.set(self._inflight_now)
        try:
            try:
                await self._execute(reqs, group, released)
            except Exception as e:
                log.exception("batch dispatch failed for %s", name)
                self._c_batch_errors.inc()
                if self.breaker is not None:
                    self.breaker.record_failure()
                live = [r for r in reqs if not r.future.done()]
                if self.cfg.batch_retry and live:
                    try:
                        await self._retry(live, group, released)
                    except Exception as retry_err:
                        # The retry machinery must never leave futures
                        # unresolved (clients would hang to 504).
                        log.exception("batch retry machinery failed for %s", name)
                        for r in live:
                            if not r.future.done():
                                r.future.set_exception(retry_err)
                else:
                    for r in live:
                        r.future.set_exception(e)
        finally:
            self._inflight_now -= 1
            self._g_inflight.set(self._inflight_now)
            if not released[0]:
                self._inflight.release()

    async def _acquire_staging(self, reqs: list[_Request]) -> tuple[int | None, int | None]:
        """Pick a replica and take one of its depth-k staging slots, bounded
        by the earliest per-request deadline. The first choice is the
        runtime's least-loaded pick (fed each pool's occupancy); when its
        pool is full the other pools are tried in ascending occupancy (ties
        rotating from the first choice), so no replica starves under bursty
        load. Returns (replica, slot), or (None, None) when every request
        expired while waiting (their futures already carry
        DeadlineExceeded)."""
        live = [r for r in reqs if not r.future.done()]
        n = len(self._staging)
        while True:
            loads = [p.in_use for p in self._staging]
            first = self.runtime.pick_replica(loads) if n > 1 else 0
            slot = self._staging[first].try_acquire()
            if slot is not None:
                return self._staged(first), slot
            for i in sorted((j for j in range(n) if j != first),
                            key=lambda j: (loads[j], (j - first) % n)):
                slot = self._staging[i].try_acquire()
                if slot is not None:
                    return self._staged(i), slot
            live = self._expire_dead(live, adjust_pending=False)
            if not live:
                return None, None
            earliest = min((r.deadline_at for r in live
                            if r.deadline_at is not None), default=None)
            timeout = (None if earliest is None
                       else max(0.0, earliest - time.perf_counter()))
            try:
                slot = await self._staging[first].acquire(timeout)
                return self._staged(first), slot
            except asyncio.TimeoutError:
                continue

    def _staged(self, replica: int) -> int:
        """Record a staging acquire on the replica's occupancy gauge."""
        self._g_replica_inflight[replica].set(self._staging[replica].in_use)
        return replica

    def _release_staging(self, replica: int, slot: int) -> None:
        self._staging[replica].release(slot)
        self._g_replica_inflight[replica].set(self._staging[replica].in_use)

    async def _execute(self, reqs: list[_Request], group: Hashable,
                       released: list[bool]) -> None:
        """Assemble + run + postprocess one batch, resolving futures on
        success. Raises on failure WITHOUT failing futures: the caller owns
        the retry policy. ``released[0]`` turns True once deferred mode has
        given the batch's admission back."""
        name = self.model.name
        bucket = self.model.bucket_for(len(reqs), group=group)
        fill = len(reqs) / bucket[0]
        self._g_fill.set(fill)
        self._c_batches.inc()
        # Batch identity for trace correlation: the lifetime batch count
        # right after its tick (unique per model: every increment happens on
        # the owning loop). A retry or a bisected half re-enters here and
        # gets its own id.
        bid = int(self._c_batches.value)
        ctxs = [r.ctx for r in reqs if r.ctx is not None]
        ex_tid = ctxs[0].trace_id if ctxs else None
        items = [r.item for r in reqs]
        wall0 = time.time()
        t0 = time.perf_counter()

        def mark(phase: str, t_a: float, t_b: float) -> None:
            """Observe one batch phase (exemplar = a member's trace id) and
            append its span, batch-tagged, to every traced member."""
            self._h_phase[phase].observe((t_b - t_a) * 1e3, trace_id=ex_tid)
            for c in ctxs:
                c.span(phase, wall0 + (t_a - t0), wall0 + (t_b - t0),
                       tid=name, batch=bid)

        lease = self.arena.acquire(bucket) if self.arena is not None else None
        try:
            if lease is not None:
                host_batch = await self.stages.run(
                    name, "assemble", self.model.assemble_into, items, bucket, lease.buf)
            else:
                host_batch = await self.stages.run(
                    name, "assemble", self.model.assemble, items, bucket)
            t1 = time.perf_counter()
            mark("preproc", t0, t1)
            if self.deferred:
                # The enqueue is cheap (a shm write; the slot wait is the
                # backpressure), so admission is released as soon as the
                # batch is on its worker; the await then spans the rest of
                # that worker's epoch and its bulk readback, which is what
                # "compute" measures in this mode.
                await self._inject(name)
                out_fut = await self.runtime.enqueue(bucket, host_batch)
                t2 = time.perf_counter()
                mark("h2d", t1, t2)
                if not released[0]:
                    self._inflight.release()
                    released[0] = True
                np_out = await out_fut
                t3 = time.perf_counter()
                mark("compute", t2, t3)
                self._c_device_seconds[0].inc(t3 - t2)
                if self.device_time_cb is not None:
                    self.device_time_cb(t3 - t2)
            else:
                replica, slot = await self._acquire_staging(reqs)
                if replica is None:
                    return  # every request expired; nothing to run
                try:
                    await self._inject(name)
                    outputs = await self.stages.run(
                        name, "h2d", self.runtime.run, bucket, host_batch, replica)
                    t2 = time.perf_counter()
                    mark("h2d", t1, t2)
                    np_out = await self.stages.run(name, "fetch", self.runtime.fetch, outputs)
                    t3 = time.perf_counter()
                    mark("compute", t2, t3)
                    self._c_device_seconds[replica].inc(t3 - t2)
                    if self.device_time_cb is not None:
                        # The device section (dispatch to ready) is what the
                        # fleet's models compete for.
                        self.device_time_cb(t3 - t2)
                finally:
                    self._release_staging(replica, slot)
        finally:
            if lease is not None:
                # Safe only now: the completed fetch proves the device is
                # done reading the (pinned) buffer.
                self.arena.release(lease)
        results = await self.stages.run(
            name, "postproc", self.model.host_postprocess, np_out, len(reqs))
        t4 = time.perf_counter()
        mark("postproc", t3, t4)
        self._c_items.inc(len(reqs))
        # Feed the adaptive scheduler's per-bucket duration model (tracked
        # with adaptive off too: the gauge is useful on its own).
        self._observe_batch_duration(bucket, (t4 - t0) * 1e3)
        # Start and duration from the same wall-clock capture; member trace
        # ids capped, so a wide bucket does not bloat every ring event.
        self.metrics.tracer.add(
            f"batch[{bucket}]", wall0, wall0 + (t4 - t0), tid=name,
            trace_id=ex_tid, n=len(reqs), fill=fill, batch=bid,
            trace_ids=[c.trace_id for c in ctxs[:8]])
        if self.breaker is not None:
            self.breaker.record_success()
        for r, res in zip(reqs, results):
            if not r.future.done():
                r.future.set_result(res)

    async def _inject(self, name: str) -> None:
        """The dispatch's fault seams: ``slow_dispatch``, then ``batch_error``."""
        if self.injector is not None:
            delay = self.injector.delay_s("slow_dispatch", name)
            if delay > 0:
                await asyncio.sleep(delay)
            self.injector.check("batch_error", name)

    async def _retry(self, reqs: list[_Request], group: Hashable,
                     released: list[bool]) -> None:
        """One-shot batch retry with poison isolation: the whole batch
        re-assembles and re-runs once; if that fails and ``retry_split`` is
        on, it bisects recursively (each half runs once), so a single poison
        item fails only its own future. Every path ends with all futures
        resolved."""
        self._c_retries.inc()

        async def run_split(rs: list[_Request]) -> None:
            live = [r for r in rs if not r.future.done()]
            if not live:
                return
            try:
                await self._execute(live, group, released)
            except Exception as e:
                self._c_retry_failures.inc()
                if len(live) == 1 or not self.cfg.retry_split:
                    if len(live) == 1 and self.cfg.retry_split:
                        self._c_poison.inc()
                    for r in live:
                        if not r.future.done():
                            r.future.set_exception(e)
                else:
                    mid = (len(live) + 1) // 2
                    await run_split(live[:mid])
                    await run_split(live[mid:])

        await run_split(reqs)

    # -- introspection -------------------------------------------------------
    @property
    def pending(self) -> int:
        """Requests accepted but not yet flushed into a batch."""
        return self._pending

    def predicted_service_s(self, n_items: int = 1) -> float | None:
        """Predicted seconds of service for a request of ``n_items`` once at
        the front of the queue: the batch-duration EWMA of the smallest
        bucket that covers it (the largest observed bucket when nothing that
        small has run); None before any batch has completed."""
        if not self._ewma_ms:
            return None
        covering = [(b, ms) for b, ms in self._ewma_ms.items()
                    if ms > 0 and b[0] >= n_items]
        if covering:
            _, ms = min(covering, key=lambda kv: kv[0][0])
        else:
            _, ms = max(self._ewma_ms.items(), key=lambda kv: kv[0][0])
            if ms <= 0:
                return None
        return ms / 1e3

    def estimate_clear_s(self) -> float | None:
        """Estimated seconds for the current queue to clear at the best
        items/s any bucket has shown (its size over its duration EWMA).
        Unclamped; ``clamp_retry_after_s`` derives the 429 hint from it.
        None before any batch has completed or with an empty queue."""
        if self._pending <= 0:
            return None
        rate = max((b[0] / (ms / 1e3) for b, ms in self._ewma_ms.items() if ms > 0),
                   default=0.0)
        if rate <= 0:
            return None
        return self._pending / rate

    def pipeline_stats(self) -> dict:
        adaptive = {
            "enabled": self.adaptive_cfg.enabled,
            "targets": {repr(g): round(t, 2) for g, t in self._targets.items()},
            "batch_ewma_ms": {repr(b): round(v, 2) for b, v in self._ewma_ms.items()},
        }
        if self.deferred:
            # The reference's keys in this mode: no depth, staging or arena.
            return {"mode": "deferred", "admission": self._admission_cap,
                    "inflight": self._inflight_now, "inflight_peak": self._inflight_peak,
                    "pending": self._pending, "adaptive": adaptive}
        return {
            "mode": "direct",
            "depth": self.depth,
            "admission_cap": self._admission_cap,
            "inflight": self._inflight_now,
            "inflight_peak": self._inflight_peak,
            "staging_in_use": sum(p.in_use for p in self._staging),
            "pending": self._pending,
            "arena": self.arena.stats() if self.arena is not None else None,
            "adaptive": adaptive,
            "replicas": len(self._staging),
            # Per-replica dispatch count and device-section occupancy: a
            # starved replica shows as a row of zeros.
            "per_replica": [
                {"replica": i, "batches_total": batches,
                 "staging_in_use": p.in_use,
                 "occupancy": round(p.in_use / self.depth, 3) if self.depth else 0.0}
                for i, (p, batches) in enumerate(zip(
                    self._staging, self.runtime.replica_batches()))],
        }
