"""Iteration-level continuous batching engine, ported from
``tpuserve/genserve/engine.py`` (Orca).

The static-bucket batcher (``tpuserve_torch.batcher``) locks a batch for its
whole run: correct for one-shot classifiers, wrong for multi-step generative
work where a 2-token completion admitted behind a 200-token one waits for
both. This engine is the second dispatch path, scheduling at
MODEL-ITERATION granularity over a fixed block of generative slots:

- every iteration the active batch RE-FORMS: finished sequences retire
  immediately (``gen_early_exits_total``), queued requests fold into free
  slots mid-flight (``gen_fold_ins_total``), and past-deadline sequences
  evict with the fast-504 contract (``gen_evictions_total`` +
  ``deadline_exceeded_total``);
- the per-model state block (KV caches, token buffers, per-slot counters)
  is ONE set of device tensors with leading dim = slots, allocated by the
  runtime at engine compile (``ModelRuntime.register_state``) and updated
  in place by the programs — steady-state serving allocates nothing, and
  the host-side :class:`~tpuserve_torch.genserve.arena.SlotArena` ledger
  guarantees no slot is ever double-handed;
- the device programs (insert or paged prefill, step, extract) register in
  the runtime's variant registry (``ModelRuntime.register_program``), each
  captured as a CUDA graph per (parameter slot, state block) on the card,
  so ``runtime_compiles_total`` covers them and its delta — with
  ``captures_total``'s — stays 0 across admit/retire churn and
  ``:reload``/``:rollback``. Slot indices, items, chunk starts and
  block-table rows are copied into the graphs' static inputs per replay.

The engine exposes the ModelBatcher surface (submit/start/stop/drain/
revive_group_loops/pipeline_stats/estimate_clear_s), so the front door —
deadlines, breakers, result cache and coalescing, canaries, watchdog
revival, graceful drain — holds for multi-step requests unchanged. Blocking
device work hops through the server's StageExecutors ("h2d" for inserts,
"fetch" for step/extract readback, "postproc" for finalize). The step's
small out-block (done, n_new and the token buffer) comes back through one
pinned copy per step.

Streamed generation: ``submit_stream`` returns a :class:`GenStream` the
HTTP layer drains; each step's units (``model.stream_units``, read from the
same host copy of the out-block, so streaming adds no device work) flush
per iteration, and every stream ends in exactly one terminal unit — "done"
at retire, or an "error" naming the machinery that cut it
(``obs.GEN_STREAM_REASONS``).

Not ported: the replica group (``GenEngineGroup``).

All engine state is event-loop-only (the step loop owns every mutation);
there is deliberately no lock to witness.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from tpuserve_torch.batcher import DeadlineExceeded, QueueFull
from tpuserve_torch.config import GenserveConfig, PipelineConfig
from tpuserve_torch.genserve.arena import SlotArena, SlotInfo
from tpuserve_torch.genserve.model import GenerativeModel
from tpuserve_torch.genserve.pages import PageLedger
from tpuserve_torch.hostpipe import StageExecutors
from tpuserve_torch.models.base import TensorSpec
from tpuserve_torch.obs import GEN_STREAM_REASONS, PRIORITIES, Metrics
from tpuserve_torch.runtime import LIVE_BLOCK, SCRATCH_BLOCK, torch_dtype

log = logging.getLogger("tpuserve_torch.genserve")

# A program's slot index: a one-element int64 tensor on the device.
SLOT_SPEC = TensorSpec((1,), np.dtype(np.int64))


class KVPressure(QueueFull):
    """Paged-KV admission shed: the free-page ledger cannot cover this
    request's prompt + decode reservation on top of demand already queued.
    Subclasses QueueFull so every shed path (result-cache passthrough,
    submit re-raise) carries it unchanged; the HTTP layer maps it to 503
    with a clear-time Retry-After and reason "kv_pressure"."""

    def __init__(self, message: str,
                 retry_after_s: float | None = None) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclass
class _GenRequest:
    item: Any
    future: asyncio.Future = field(repr=False)
    enqueued_at: float = 0.0
    deadline_at: float | None = None
    # Paged mode: pages this request will reserve at fold-in (prompt +
    # decode budget); 0 when paging is off. Summed over the queue it is the
    # committed-demand term of the admission pressure check.
    pages_needed: int = 0
    # Priority class (obs.PRIORITIES) labelling the queue-wait histogram.
    priority: str | None = None
    # Request trace context (obs.TraceContext); None untraced.
    ctx: Any = None
    # Emission channel of a streamed request; None for unary.
    stream: "GenStream | None" = None


def _retrieve_exception(fut: asyncio.Future) -> None:
    """Streamed requests surface failures as error terminal units on the
    stream; the future stays for cancellation and bookkeeping. Retrieve the
    exception so asyncio never logs 'exception was never retrieved'."""
    if not fut.cancelled():
        fut.exception()


class GenStream:
    """Consumer handle for one streamed generation: a bounded queue of unit
    dicts the engine produces and the HTTP layer drains. Exactly one
    terminal unit ("done" or "error") always arrives — every engine failure
    path enqueues one — so a client can always tell a complete stream from
    a torn transport. ``close()`` is the consumer's abandon signal (client
    disconnect): it stops further emission and unblocks a producer waiting
    on the full queue. Event-loop-only: touch it from the engine's loop."""

    __slots__ = ("queue", "policy", "state", "first_unit_at", "terminated",
                 "dropped")

    def __init__(self, maxsize: int, policy: str) -> None:
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=max(1, maxsize))
        self.policy = policy  # ModelConfig.stream_policy: "drop" | "block"
        self.state: dict = {}  # the model's incremental emission state
        self.first_unit_at: float | None = None
        # Terminal enqueued (or consumer gone): emission is over.
        self.terminated = False
        self.dropped = 0

    async def get(self) -> dict:
        return await self.queue.get()

    def close(self) -> None:
        """Consumer gone: stop emission and free any blocked producer."""
        self.terminated = True
        while True:
            try:
                self.queue.get_nowait()
            except asyncio.QueueEmpty:
                return


def _packed_step(model: GenerativeModel, layout: dict):
    """The registered step program: the model's step, its out dict packed
    into one (slots, columns) int32 tensor — one device-to-host copy per
    step. ``layout`` records each entry's name, trailing shape and dtype
    for ``_unpack`` (the out leaves are integer or bool)."""
    def step(module, state):
        out = model.step(module, state)
        layout.clear()
        layout.update({k: (tuple(v.shape[1:]), v.dtype) for k, v in out.items()})
        return torch.cat([v.reshape(v.shape[0], -1).to(torch.int32)
                          for v in out.values()], dim=1)
    return step


def _unpack(packed: np.ndarray, layout: dict) -> dict:
    out, col = {}, 0
    for k, (shape, dtype) in layout.items():
        width = int(np.prod(shape)) if shape else 1
        a = packed[:, col:col + width].reshape((packed.shape[0],) + shape)
        out[k] = a.astype(np.bool_) if dtype == torch.bool else a
        col += width
    return out


class GenEngine:
    """One iteration-level generation engine per served generative model."""

    def __init__(self, model: GenerativeModel, runtime: Any,
                 metrics: Metrics, gcfg: "GenserveConfig | None" = None,
                 breaker: "Any | None" = None,
                 injector: "Any | None" = None,
                 stages: "StageExecutors | None" = None,
                 pipeline_cfg: "PipelineConfig | None" = None) -> None:
        self.model = model
        self.runtime = runtime
        self.metrics = metrics
        self.cfg = model.cfg
        self.gcfg = gcfg or GenserveConfig()
        self.breaker = breaker
        self.injector = injector
        # The port runs one engine per model on one card: replica 0.
        self.replica = 0
        self.slots = self.gcfg.slots or max(self.cfg.batch_buckets)
        self.arena = SlotArena(self.slots)
        # Paged KV cache: only families that ship the paged programs opt in.
        self.paging = bool(self.gcfg.kv_paging) \
            and bool(getattr(model, "supports_kv_paging", False))
        if self.gcfg.kv_paging and not self.paging:
            log.info("%s: [genserve] kv_paging is on but the family has no "
                     "paged programs — dense state slab kept",
                     model.cfg.name)
        self.pages: PageLedger | None = None
        self._pps = 0            # block-table width (pages per max-ctx slot)
        self._prefill_chunk = 0  # static chunk width of the prefill program
        if self.paging:
            pt = self.gcfg.kv_page_tokens
            self._pps = int(model.kv_pages_per_slot(pt))
            n_pages = self.gcfg.kv_pages or (self.slots * self._pps + 1)
            if n_pages < self._pps + 1:
                raise ValueError(
                    f"{model.cfg.name}: [genserve] kv_pages={n_pages} cannot "
                    f"cover one max-context request ({self._pps} pages + the "
                    "sentinel)")
            self.pages = PageLedger(n_pages, pt)
            self._prefill_chunk = int(
                model.kv_prefill_chunk(self.gcfg.prefill_chunk))
        # High-water active-slot mark.
        self.peak_active = 0
        self._own_stages = stages is None
        self.stages = stages if stages is not None \
            else StageExecutors(pipeline_cfg or PipelineConfig(), metrics)
        name = model.cfg.name
        self.name = name
        # Hot-path metric handles, prebound once (the batcher discipline).
        self._c_iterations = metrics.counter(
            f"gen_iterations_total{{model={name}}}")
        self._c_admitted = metrics.counter(
            f"gen_admitted_total{{model={name}}}")
        self._c_fold_ins = metrics.counter(
            f"gen_fold_ins_total{{model={name}}}")
        self._c_early_exits = metrics.counter(
            f"gen_early_exits_total{{model={name}}}")
        self._c_evictions = metrics.counter(
            f"gen_evictions_total{{model={name}}}")
        self._c_deadline = metrics.counter(
            f"deadline_exceeded_total{{model={name}}}")
        self._c_items = metrics.counter(f"items_total{{model={name}}}")
        self._c_units = metrics.counter(f"gen_units_total{{model={name}}}")
        self._c_batch_errors = metrics.counter(
            f"batch_errors_total{{model={name}}}")
        self._c_shed = metrics.counter(f"shed_total{{model={name}}}")
        self._g_queue_depth = metrics.gauge(f"queue_depth{{model={name}}}")
        self._g_active = metrics.gauge(f"gen_active_slots{{model={name}}}")
        self._h_step = metrics.histogram(f"gen_step_ms{{model={name}}}")
        self._h_insert = metrics.histogram(f"gen_insert_ms{{model={name}}}")
        self._h_extract = metrics.histogram(f"gen_extract_ms{{model={name}}}")
        self._h_queue = metrics.histogram(
            f"latency_ms{{model={name},phase=queue}}")
        # Streaming: first-unit latency feeds the first-unit SLO subject;
        # the terminated counter is per reason (created on demand).
        self._h_first_unit = metrics.histogram(
            f"gen_first_unit_ms{{model={name}}}")
        self._c_streams = metrics.counter(f"gen_streams_total{{model={name}}}")
        self._c_disconnects = metrics.counter(
            f"gen_client_disconnects_total{{model={name}}}")
        self._c_stream_dropped = metrics.counter(
            f"gen_stream_dropped_total{{model={name}}}")
        # Paged-KV observability, prebound so the telemetry sampler sees the
        # rows from the first scrape.
        self._g_kv_pages_total = metrics.gauge(
            f"gen_kv_pages_total{{model={name}}}")
        self._g_kv_pages_free = metrics.gauge(
            f"gen_kv_pages_free{{model={name}}}")
        self._g_kv_util = metrics.gauge(
            f"gen_kv_page_utilization{{model={name}}}")
        self._c_prefill_chunks = metrics.counter(
            f"gen_prefill_chunks_total{{model={name}}}")
        self._c_kv_shed = metrics.sched_shed_counter(name, "kv_pressure")
        self._default_priority = "interactive"
        self._h_qwait = {p: metrics.queue_wait_histogram(name, p)
                         for p in PRIORITIES}
        # Device-seconds ledger: step time feeds device_utilization.
        self._c_device_seconds = metrics.device_seconds_counter(
            name, self.replica)
        self._c_replica_steps = metrics.gen_replica_steps_counter(
            name, self.replica)
        self._c_replica_units = metrics.gen_replica_units_counter(
            name, self.replica)
        self._g_replica_active = metrics.gen_replica_active_gauge(
            name, self.replica)
        self._g_replica_kv_free = metrics.gen_replica_kv_free_gauge(
            name, self.replica)
        self._pending: collections.deque[_GenRequest] = collections.deque()
        self._state_struct: Any = None
        self._loop_task: asyncio.Task | None = None
        self._work_event: asyncio.Event | None = None
        self._idle_event: asyncio.Event | None = None
        self._running = False
        # Serving-rate model for estimate_clear_s (429 Retry-After).
        self._ewma_step_ms: float | None = None
        self._ewma_iters: float | None = None
        # Pages-per-request EWMA (paged mode): the "typical admission" the
        # kv_clear_s pressure signal prices.
        self._ewma_pages: float | None = None
        # Runaway guard: a slot that somehow never reports done is failed
        # (and freed) past this bound instead of pinning its slot forever.
        self._max_steps_guard = 2 * max(1, model.gen_max_steps())
        # Drain's bounded stream budget: once set (perf_counter clock),
        # still-open streams past it terminate with the "drain" error event
        # instead of holding the drain hostage.
        self._stream_kill_at: float | None = None

    # -- compilation ----------------------------------------------------------
    def compile(self) -> None:
        """Allocate the state blocks, register the insert (or paged prefill),
        step and extract programs in the runtime's variant registry
        (captured per parameter slot and state block on the card), and run
        each once on the scratch block (prewarm). Blocking; call from
        ServerState.build. A second engine over the same runtime reuses the
        registered programs when its geometry matches."""
        model, rt = self.model, self.runtime
        t0 = time.perf_counter()
        if self.paging:
            self._state_struct = model.kv_page_signature(
                self.slots, self.pages.pages, self.pages.page_tokens)
        else:
            self._state_struct = model.state_signature(self.slots)
        geometry = {"kv_paging": self.paging, "slots": self.slots,
                    "pages": self.pages.pages if self.paging else 0,
                    "page_tokens": self.pages.page_tokens
                    if self.paging else 0,
                    "prefill_chunk": self._prefill_chunk}
        if "step" in rt.gen_programs:
            # The state block and the captures are shape-frozen: reuse needs
            # the same slot width AND the same paging geometry.
            prior = rt.gen_meta
            if prior["slots"] != self.slots:
                raise ValueError(
                    f"{self.name}: runtime programs were compiled for "
                    f"{prior['slots']} slots, engine wants {self.slots}")
            if prior != geometry:
                raise ValueError(
                    f"{self.name}: runtime programs were compiled for "
                    f"geometry {prior}, engine wants {geometry}")
            return
        item_spec = tuple(model.gen_item_signature())
        rt.register_state(self._state_struct)
        rt.gen_meta = geometry
        if self.paging:
            chunk = self._prefill_chunk

            def prefill_fn(module, state, slot, item, start, pages):
                model.prefill_chunk(module, state, slot, item, start, pages,
                                    chunk=chunk)

            rt.register_program(
                "prefill", prefill_fn,
                (SLOT_SPEC, item_spec, TensorSpec((), np.dtype(np.int32)),
                 TensorSpec((self._pps,), np.dtype(np.int32))),
                width=self.slots)
        else:
            def insert_fn(module, state, slot, item):
                fresh = model.init_state(module, item)
                for k, s in state.items():
                    s.index_copy_(0, slot, fresh[k].to(s.dtype)[None])

            rt.register_program("insert", insert_fn, (SLOT_SPEC, item_spec),
                                width=self.slots)
        layout: dict = {}
        rt.register_program("step", _packed_step(model, layout), (),
                            width=self.slots).out_layout = layout
        rt.register_program("extract", model.extract, (SLOT_SPEC,),
                            width=self.slots)
        # Prewarm: one full fold-in + step + extract on the scratch block,
        # read back (the only honest completion signal), then zeroed.
        self._generate(model.canary_item(), SCRATCH_BLOCK, None, max_steps=1)
        log.info("%s: generation engine registered+prewarmed %d slots in %.1fs",
                 self.name, self.slots, time.perf_counter() - t0)

    @staticmethod
    def _slot(slot: int) -> np.ndarray:
        return np.array([slot], np.int64)

    def _fold_in_sync(self, item: Any, block: int, staged: Any) -> None:
        """One request into slot 0 of ``block``, every prefill chunk at
        once (prewarm and staged canary)."""
        rt = self.runtime
        if self.paging:
            row = np.arange(1, self._pps + 1, dtype=np.int32)
            start = 0
            while True:
                rt.run_program("prefill", self._slot(0), item, np.int32(start), row,
                               params_override=staged, block=block)
                start += self._prefill_chunk
                if start >= self.model.prompt_tokens(item):
                    break
        else:
            rt.run_program("insert", self._slot(0), item,
                           params_override=staged, block=block)

    def _generate(self, item: Any, block: int, staged: Any,
                  max_steps: int) -> tuple[dict, bool]:
        """A generation in slot 0 of a zeroed ``block`` — fold-in, up to
        ``max_steps`` steps until slot 0 is done, extract — then the block
        zeroed again. Returns (extracted, finished)."""
        rt = self.runtime
        rt.zero_state(block)
        try:
            self._fold_in_sync(item, block, staged)
            done = False
            for _ in range(max_steps):
                out = self._fetch_step(rt.run_program(
                    "step", params_override=staged, block=block))
                done = bool(out["done"][0])
                if done:
                    break
            extracted = rt.fetch_program(rt.run_program(
                "extract", self._slot(0), params_override=staged, block=block))
        finally:
            rt.zero_state(block)
        return extracted, done

    def _fetch_step(self, packed: Any) -> dict:
        return _unpack(self.runtime.fetch_program(packed),
                       self.runtime.gen_programs["step"].out_layout)

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> None:
        self.runtime.zero_state(LIVE_BLOCK)
        if self.pages is not None:
            self._g_kv_pages_total.set(float(self.pages.usable))
            self._update_kv_gauges()
        self._work_event = asyncio.Event()
        self._idle_event = asyncio.Event()
        self._idle_event.set()
        self._running = True
        self._loop_task = asyncio.get_running_loop().create_task(
            self._step_loop())

    async def stop(self) -> None:
        """Cancel the step loop, fail queued and mid-flight requests."""
        self._running = False
        t = self._loop_task
        if t is not None:
            t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass
            except Exception:
                log.exception("step loop for %s failed during stop", self.name)
            self._loop_task = None
        err = RuntimeError(f"server shutting down; {self.name} not served")
        while self._pending:
            req = self._pending.popleft()
            self._terminate_stream(req.stream, "shutdown", str(err))
            if not req.future.done():
                req.future.set_exception(err)
        for info in self.arena.release_all():
            self._terminate_stream(info.stream, "shutdown", str(err))
            if not info.future.done():
                info.future.set_exception(err)
        if self.pages is not None:
            self.pages.release_all()
            self._update_kv_gauges()
        self._publish_queue_depth()
        self._publish_active()
        self._maybe_idle()
        if self._own_stages:
            self.stages.shutdown()

    def revive_group_loops(self) -> int:
        """Watchdog hook (the batcher's name, so server registration is
        uniform): restart the step loop if it died. Mid-flight slots are
        still in the arena, so a revived loop resumes stepping them."""
        if not self._running:
            return 0
        t = self._loop_task
        if t is not None and not t.done():
            return 0
        if t is not None and not t.cancelled() and t.exception() is not None:
            log.error("step loop for %s died: %r — restarting", self.name,
                      t.exception())
        self._loop_task = asyncio.get_running_loop().create_task(
            self._step_loop())
        return 1

    async def drain(self, deadline: float) -> bool:
        """Graceful drain: wait until every accepted request (queued or
        mid-generation) resolved, bounded by ``deadline`` (event-loop
        clock). Same idle-event discipline as the batcher. Streams get their
        own bounded budget inside the window (``stream_drain_s``): past it
        the scheduling passes terminate stragglers with the "drain" error
        event — a well-formed torn-stream signal, never a silent truncation
        or an unbounded drain."""
        loop = asyncio.get_running_loop()
        self._stream_kill_at = time.perf_counter() + self.gcfg.stream_drain_s
        try:
            while self._pending or self.arena.n_active:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                self._idle_event.clear()
                if not self._pending and not self.arena.n_active:
                    break
                try:
                    await asyncio.wait_for(self._idle_event.wait(), timeout)
                except asyncio.TimeoutError:
                    break
        finally:
            self._stream_kill_at = None
        self._maybe_idle()
        return not self._pending and not self.arena.n_active

    # -- submission (event loop) ----------------------------------------------
    def submit(self, item: Any, group: Any = None,
               deadline_at: float | None = None,
               priority: str | None = None,
               ctx: Any = None) -> asyncio.Future:
        """Enqueue one decoded request; returns a Future of its result.
        ``group`` is accepted for batcher-API parity and ignored — the
        engine has one slot block, not per-group queues. ``priority``
        labels the queue-wait histogram. ``ctx`` (obs.TraceContext)
        collects the request's queue/fold-in/step/evict/retire spans,
        tagged with its slot."""
        return self._enqueue(item, deadline_at, priority, ctx, None)

    def submit_stream(self, item: Any, deadline_at: float | None = None,
                      priority: str | None = None,
                      ctx: Any = None) -> "tuple[asyncio.Future, GenStream]":
        """Enqueue one streamed generation -> (future, stream). The HTTP
        layer consumes ONLY the stream (units ending in one terminal —
        every failure path pushes an error terminal, so the queue is the
        single channel); the future exists for disconnect cancellation.
        Raises QueueFull exactly like submit (a shed stream was never
        started: a plain 429)."""
        stream = GenStream(self.gcfg.stream_queue, self.cfg.stream_policy)
        fut = self._enqueue(item, deadline_at, priority, ctx, stream)
        fut.add_done_callback(_retrieve_exception)
        self._c_streams.inc()
        return fut, stream

    def _enqueue(self, item: Any, deadline_at: float | None,
                 priority: str | None, ctx: Any,
                 stream: "GenStream | None") -> asyncio.Future:
        if not self._running or self._work_event is None:
            raise RuntimeError(f"engine for {self.name} not started")
        if len(self._pending) >= self.cfg.max_queue:
            self._c_shed.inc()
            raise QueueFull(self.name)
        need = 0
        if self.pages is not None:
            # Page-pressure admission (budgeted admission, Clockwork). An
            # admitted request never hits mid-decode page exhaustion (its
            # FULL reservation is taken at fold-in), so queued demand only
            # costs latency. One pool turnover of backlog is allowed; past
            # that the page pool, not compute, is the bottleneck: shed with
            # a clear-time hint.
            need = self.model.pages_needed(item, self.pages.page_tokens)
            projected = self.pages.n_reserved + self._queued_pages() + need
            if projected > 2 * self.pages.usable:
                self._c_shed.inc()
                self._c_kv_shed.inc()
                raise KVPressure(
                    f"{self.name}: kv page pool exhausted (need {need} "
                    f"pages, {self.pages.n_free} free, "
                    f"{self._queued_pages()} queued demand)",
                    retry_after_s=self.kv_clear_s())
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending.append(_GenRequest(
            item=item, future=fut, enqueued_at=time.perf_counter(),
            deadline_at=deadline_at, priority=priority, ctx=ctx,
            stream=stream, pages_needed=need))
        self._publish_queue_depth()
        self._idle_event.clear()
        self._work_event.set()
        return fut

    # -- stream emission (event loop) -----------------------------------------
    def _count_termination(self, reason: str) -> None:
        if reason not in GEN_STREAM_REASONS:
            # An off-vocabulary label would fragment the metric: fail loudly.
            raise ValueError(f"unknown stream-termination reason {reason!r} "
                             f"(add it to obs.GEN_STREAM_REASONS)")
        self.metrics.counter(
            f"gen_stream_terminated_total{{model={self.name},"
            f"reason={reason}}}").inc()

    def _terminate_stream(self, stream: "GenStream | None", reason: str,
                          message: str | None = None,
                          unit: dict | None = None) -> None:
        """Enqueue the terminal unit (sync: callable from the scheduling
        passes and stop()). The terminal is never dropped — on a full queue
        the oldest buffered unit makes room; the terminal outranks any
        backlog because the stream is ending either way."""
        if stream is None or stream.terminated:
            return
        stream.terminated = True
        if unit is None:
            unit = {"type": "error", "error": reason,
                    "message": message or reason}
        q = stream.queue
        while True:
            try:
                q.put_nowait(unit)
                break
            except asyncio.QueueFull:
                try:
                    q.get_nowait()
                except asyncio.QueueEmpty:
                    break
        self._count_termination(reason)

    async def _emit_unit(self, stream: "GenStream", unit: dict) -> None:
        """Policy-aware in-flight emission. A droppable unit under policy
        "drop" is discarded when the consumer lags (gen_stream_dropped_
        total); everything else blocks the step loop until the consumer
        drains — re-checking the terminated flag every 50 ms so an
        abandoned stream can never wedge the engine."""
        if stream.terminated:
            return
        if unit.get("droppable") and stream.policy == "drop":
            if stream.queue.full():
                stream.dropped += 1
                self._c_stream_dropped.inc()
                return
            stream.queue.put_nowait(unit)
            return
        while not stream.terminated:
            if not self._running:
                # stop() is tearing the engine down; it sends the
                # "shutdown" terminal itself once the loop exits.
                return
            kill_at = self._stream_kill_at
            if kill_at is not None and time.perf_counter() >= kill_at:
                # Draining and the stream budget is spent: a wedged
                # consumer must not hold the step loop (and the drain) open.
                self._terminate_stream(stream, "drain",
                                       "server draining; stream budget spent")
                return
            try:
                await asyncio.wait_for(stream.queue.put(unit), 0.05)
                return
            except asyncio.TimeoutError:
                continue

    async def _emit_step_units(self, out: dict) -> None:
        """Flush each streaming slot's newly produced units for this
        iteration, read from the step's host out-block (no device work),
        plus the family's optional preview extract — which reuses the
        captured extract program, so previews never add a capture."""
        model = self.model
        for slot in self.arena.active_slots():
            info = self.arena.peek(slot)
            stream = info.stream
            if stream is None or stream.terminated or info.future.done():
                continue
            try:
                units = model.stream_units(out, slot, stream.state)
            except Exception:  # noqa: BLE001 — emission must not kill a slot
                log.exception("stream_units failed for %s slot %d",
                              self.name, slot)
                continue
            if units and stream.first_unit_at is None:
                now = time.perf_counter()
                stream.first_unit_at = now
                ms = (now - info.enqueued_at) * 1e3
                tid = info.ctx.trace_id if info.ctx is not None else None
                self._h_first_unit.observe(ms, trace_id=tid)
                if info.ctx is not None:
                    wall = time.time()
                    info.ctx.span("first_unit", wall - ms / 1e3, wall,
                                  tid=self.name, slot=slot)
            for u in units:
                await self._emit_unit(stream, u)
            if model.stream_wants_preview(out, slot, stream.state):
                try:
                    extracted = await self.stages.run(
                        self.name, "fetch", self._extract_sync, slot)
                    u = model.stream_preview_unit(extracted, stream.state)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — a preview is best-effort
                    log.exception("preview extract failed for %s slot %d",
                                  self.name, slot)
                else:
                    await self._emit_unit(stream, u)

    def _maybe_idle(self) -> None:
        if self._idle_event is not None and not self._pending \
                and not self.arena.n_active:
            self._idle_event.set()

    # -- gauge publication (event loop) ---------------------------------------
    def _publish_active(self) -> None:
        n = float(self.arena.n_active)
        self._g_replica_active.set(n)
        self._g_active.set(n)

    def _publish_queue_depth(self) -> None:
        self._g_queue_depth.set(float(len(self._pending)))

    # -- page ledger plumbing (event loop) ------------------------------------
    def _release_slot(self, slot: int) -> SlotInfo:
        """EVERY slot-release path funnels through here so the slot's KV
        pages return to the free list the same instant the slot frees —
        retire, evict, disconnect, runaway guard, insert failure alike.
        ``holds`` guards the page half: a slot can fail admission before
        its page-acquire lands."""
        if self.pages is not None and self.pages.holds(slot):
            self.pages.release(slot)
            self._update_kv_gauges()
        return self.arena.release(slot)

    def _update_kv_gauges(self) -> None:
        pages = self.pages
        self._g_replica_kv_free.set(float(pages.n_free))
        self._g_kv_pages_free.set(float(pages.n_free))
        self._g_kv_util.set(pages.utilization())

    def _queued_pages(self) -> int:
        """Pages the already-accepted queue will reserve once admitted."""
        return sum(r.pages_needed for r in self._pending)

    def _pages_row(self, page_list: "list[int]") -> np.ndarray:
        """One slot's block-table row: its pages in position order, padded
        with the sentinel (page 0) past its reservation."""
        row = np.zeros((self._pps,), np.int32)
        row[:len(page_list)] = page_list
        return row

    def _observe_pages(self, need: int) -> None:
        prev = self._ewma_pages
        self._ewma_pages = (float(need) if prev is None
                            else prev + 0.2 * (need - prev))

    # -- step loop (event loop) -----------------------------------------------
    async def _step_loop(self) -> None:
        name = self.name
        # The loop condition (not just task cancellation) gates each
        # iteration, so a cancel swallowed by wait_for cannot keep a
        # stopping engine's loop alive.
        while self._running:
            if self.injector is not None:
                # Chaos: an escaped exception kills this task — exactly the
                # failure revive_group_loops exists to repair.
                self.injector.check("kill_group_loop", name)
            self._expire_pending()
            self._evict_expired()
            if not self.arena.n_active and not self._pending:
                self._maybe_idle()
                self._work_event.clear()
                if not self._pending and not self.arena.n_active:
                    await self._work_event.wait()
                continue
            await self._admit()
            await self._advance_prefills()
            if not self.arena.n_active:
                continue
            try:
                if self.injector is not None:
                    delay = self.injector.delay_s("slow_dispatch", name)
                    if delay > 0:
                        await asyncio.sleep(delay)
                    self.injector.check("batch_error", name)
                t0 = time.perf_counter()
                out = await self.stages.run(name, "fetch", self._step_sync)
                step_ms = (time.perf_counter() - t0) * 1e3
                # One step span per traced rider, tagged with its slot.
                wall = time.time()
                ex_tid = None
                for s in self.arena.active_slots():
                    info = self.arena.peek(s)
                    if info.ctx is not None:
                        if ex_tid is None:
                            ex_tid = info.ctx.trace_id
                        info.ctx.span("gen_step", wall - step_ms / 1e3,
                                      wall, tid=name, slot=s,
                                      iteration=info.iterations)
                self._h_step.observe(step_ms, trace_id=ex_tid)
                self._observe_step(step_ms)
                self._c_device_seconds.inc(step_ms / 1e3)
                self._c_iterations.inc()
                self._c_replica_steps.inc()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — contained per step
                await self._fail_active(e)
                continue
            await self._emit_step_units(out)
            await self._retire(out)

    def _step_sync(self) -> dict:
        """One iteration over the live slot block + the small host fetch of
        its out-block (one pinned copy). Runs on the fetch stage."""
        return self._fetch_step(self.runtime.run_program("step", block=LIVE_BLOCK))

    def _insert_sync(self, slot: int, item: Any) -> None:
        self.runtime.run_program("insert", self._slot(slot), item, block=LIVE_BLOCK)

    def _prefill_sync(self, slot: int, item: Any, start: int,
                      pages_row: np.ndarray) -> None:
        self.runtime.run_program("prefill", self._slot(slot), item, np.int32(start),
                                 pages_row, block=LIVE_BLOCK)

    def _extract_sync(self, slot: int) -> Any:
        rt = self.runtime
        return rt.fetch_program(rt.run_program("extract", self._slot(slot),
                                               block=LIVE_BLOCK))

    async def _prefill_advance(self, slot: int, info: SlotInfo) -> None:
        """Fold ONE more prompt chunk for a prefilling slot (on the h2d
        stage, like a dense insert). The program arms the lane for decode
        on the final chunk; the host cursor here tells retire/step
        scheduling the slot is still mid-prefill."""
        start = info.meta["prefill_next"]
        await self.stages.run(self.name, "h2d", self._prefill_sync, slot,
                              info.item, start, info.meta["pages_row"])
        self._c_prefill_chunks.inc()
        nxt = start + self._prefill_chunk
        if nxt >= info.meta["prefill_n"]:
            del info.meta["prefill_next"]  # prefill complete: decode owns it
        else:
            info.meta["prefill_next"] = nxt

    async def _advance_prefills(self) -> None:
        """One chunk per prefilling slot per engine iteration, interleaved
        with decode steps — in-flight decoders see a bounded per-iteration
        stall instead of a whole-prompt one."""
        if self.pages is None:
            return
        for slot in self.arena.active_slots():
            info = self.arena.peek(slot)
            if "prefill_next" not in info.meta or info.future.done():
                continue
            try:
                await self._prefill_advance(slot, info)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — same blast radius as
                # an insert failure: the block may be half-written.
                self._release_slot(slot)
                self._terminate_stream(info.stream, "engine_error", str(e))
                if not info.future.done():
                    info.future.set_exception(e)
                await self._fail_active(e)
                return

    # -- scheduling passes ----------------------------------------------------
    def _expire_pending(self) -> None:
        """Fail queued requests whose deadline passed and drop cancelled
        ones — rejected in microseconds, never admitted (fast-504)."""
        if not self._pending:
            return
        now = time.perf_counter()
        kill_at = self._stream_kill_at
        live: collections.deque[_GenRequest] = collections.deque()
        n_expired = 0
        for req in self._pending:
            if req.future.done():
                if req.stream is not None:
                    req.stream.close()  # consumer already gone
                continue
            if req.deadline_at is not None and now >= req.deadline_at:
                msg = ("deadline expired after "
                       f"{(now - req.enqueued_at) * 1e3:.0f} ms in queue")
                self._terminate_stream(req.stream, "deadline_exceeded", msg)
                req.future.set_exception(DeadlineExceeded(msg))
                n_expired += 1
                continue
            if req.stream is not None and kill_at is not None \
                    and now >= kill_at:
                # Drain's stream budget spent before this one ever started.
                self._terminate_stream(req.stream, "drain",
                                       "server draining; stream budget spent")
                req.future.set_exception(RuntimeError(
                    f"{self.name}: draining; stream budget spent"))
                continue
            live.append(req)
        if n_expired:
            self._c_deadline.inc(n_expired)
        if len(live) != len(self._pending):
            self._pending = live
            self._publish_queue_depth()

    def _evict_expired(self) -> None:
        """Mid-generation deadline eviction: a slot whose request deadline
        passed (or whose client went away) frees NOW — its remaining
        iterations are never computed for nobody. The freed slot's device
        lanes hold stale state until the next insert overwrites them; their
        own done flag freezes them within the model's step bound."""
        now = time.perf_counter()
        kill_at = self._stream_kill_at
        for slot in self.arena.active_slots():
            info = self.arena.peek(slot)
            if info.future.done():  # client gone mid-generation
                self._note_disconnect(info)
                self._release_slot(slot)
                continue
            if info.deadline_at is not None and now >= info.deadline_at:
                msg = (f"deadline expired after {info.iterations} "
                       "iteration(s) "
                       f"({(now - info.enqueued_at) * 1e3:.0f} ms total)")
                # The deadline contract splits at the first unit: before it
                # the HTTP layer answers a plain 504; after it this terminal
                # becomes the in-stream error event — never a silent cut.
                self._terminate_stream(info.stream, "deadline_exceeded", msg)
                info.future.set_exception(DeadlineExceeded(msg))
                self._c_deadline.inc()
                self._c_evictions.inc()
                if info.ctx is not None:
                    wall = time.time()
                    info.ctx.span("evict", wall, wall, tid=self.name,
                                  slot=slot, iterations=info.iterations)
                self._release_slot(slot)
                continue
            if info.stream is not None and kill_at is not None \
                    and now >= kill_at:
                self._terminate_stream(info.stream, "drain",
                                       "server draining; stream budget spent")
                info.future.set_exception(RuntimeError(
                    f"{self.name}: draining; stream terminated after "
                    f"{info.iterations} iteration(s)"))
                self._c_evictions.inc()
                if info.ctx is not None:
                    wall = time.time()
                    info.ctx.span("evict", wall, wall, tid=self.name,
                                  slot=slot, iterations=info.iterations,
                                  reason="drain")
                self._release_slot(slot)
        self._publish_active()

    def _note_disconnect(self, info: SlotInfo) -> None:
        """A slot whose future is done before retire: for a stream, its
        consumer cancelled it (client gone)."""
        if info.stream is not None:
            self._c_disconnects.inc()
            self._count_termination("disconnect")
            info.stream.close()

    async def _admit(self) -> None:
        """Fold queued requests into free slots — mid-flight when the block
        is already generating (the continuous-batching property)."""
        cap = self.gcfg.admit_per_step or self.slots
        admitted = 0
        while self.arena.n_free and self._pending and admitted < cap:
            req = self._pending.popleft()
            self._publish_queue_depth()
            if req.future.done():
                continue
            now = time.perf_counter()
            if req.deadline_at is not None and now >= req.deadline_at:
                msg = ("deadline expired after "
                       f"{(now - req.enqueued_at) * 1e3:.0f} ms in queue")
                self._terminate_stream(req.stream, "deadline_exceeded", msg)
                req.future.set_exception(DeadlineExceeded(msg))
                self._c_deadline.inc()
                continue
            if self.pages is not None \
                    and self.pages.n_free < req.pages_needed:
                # Head-of-line waits for pages to free (strict FIFO —
                # skipping ahead would starve long-context requests); the
                # admission-time pressure check bounds how long.
                self._pending.appendleft(req)
                self._publish_queue_depth()
                break
            fold = any(self.arena.peek(s).iterations > 0
                       for s in self.arena.active_slots())
            info = SlotInfo(item=req.item, future=req.future,
                            deadline_at=req.deadline_at,
                            enqueued_at=req.enqueued_at, admitted_at=now,
                            ctx=req.ctx, stream=req.stream)
            slot = self.arena.acquire(info)
            trace_id = req.ctx.trace_id if req.ctx is not None else None
            try:
                # One protecting try covers the whole held window — page
                # acquire, host bookkeeping and the insert — so no
                # exception path can leak the slot or its pages.
                if self.pages is not None:
                    page_list = self.pages.acquire(slot, req.pages_needed)
                    self._update_kv_gauges()
                    self._observe_pages(req.pages_needed)
                    n_prompt = self.model.prompt_tokens(req.item)
                    info.meta["pages_row"] = self._pages_row(page_list)
                    info.meta["prefill_n"] = n_prompt
                    info.meta["prefill_next"] = 0
                    info.meta["prefill_chunks"] = \
                        -(-n_prompt // self._prefill_chunk)
                if self.arena.n_active > self.peak_active:
                    self.peak_active = self.arena.n_active
                wait_ms = (now - req.enqueued_at) * 1e3
                self._h_queue.observe(wait_ms, trace_id=trace_id)
                self._h_qwait[req.priority or self._default_priority].observe(
                    wait_ms, trace_id=trace_id)
                if req.ctx is not None:
                    wall = time.time()
                    req.ctx.span("queue", wall - wait_ms / 1e3, wall,
                                 tid=self.name)
                t0 = time.perf_counter()
                if self.pages is not None:
                    # Paged fold-in is incremental: the FIRST prompt chunk
                    # lands now, later chunks interleave with decode steps.
                    await self._prefill_advance(slot, info)
                else:
                    await self.stages.run(self.name, "h2d",
                                          self._insert_sync, slot, req.item)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                # The state block may be half-written: hard-reset like a
                # step failure. The admitting request fails with the cause.
                self._release_slot(slot)
                self._terminate_stream(req.stream, "engine_error", str(e))
                if not req.future.done():
                    req.future.set_exception(e)
                await self._fail_active(e)
                return
            insert_s = time.perf_counter() - t0
            self._h_insert.observe(insert_s * 1e3, trace_id=trace_id)
            if req.ctx is not None:
                # "fold_in" = admitted into an ALREADY-generating block;
                # "admit" = joined a fresh one.
                wall = time.time()
                req.ctx.span("fold_in" if fold else "admit",
                             wall - insert_s, wall, tid=self.name,
                             slot=slot)
            self._c_admitted.inc()
            admitted += 1
            if fold:
                self._c_fold_ins.inc()
        self._publish_active()

    async def _retire(self, out: dict) -> None:
        """Account the iteration and retire every finished slot
        immediately — a short sequence exits the instant its own work is
        done, regardless of what the rest of the block still owes."""
        for slot in self.arena.active_slots():
            self.arena.peek(slot).iterations += 1
        for slot in self.arena.active_slots():
            info = self.arena.peek(slot)
            if info.future.done():
                self._note_disconnect(info)
                self._release_slot(slot)
                continue
            # Prefill chunks ride the same iteration counter, so a paged
            # slot's guard stretches by its chunk count.
            guard = self._max_steps_guard + info.meta.get("prefill_chunks", 0)
            if info.iterations > guard:
                msg = (f"{self.name}: slot {slot} exceeded the "
                       f"{guard}-iteration guard without "
                       "reporting done")
                self._terminate_stream(info.stream, "engine_error", msg)
                info.future.set_exception(RuntimeError(msg))
                self._c_batch_errors.inc()
                self._release_slot(slot)
                continue
            if "prefill_next" in info.meta:
                # Mid-prefill: the lane's device done flag is its FREEZE
                # (interleaved decode steps skip it), not completion.
                continue
            if not self.model.is_finished(out, slot):
                continue
            early = self.arena.n_active > 1 or bool(self._pending)
            trace_id = info.ctx.trace_id if info.ctx is not None else None
            t0 = time.perf_counter()
            try:
                extracted = await self.stages.run(
                    self.name, "fetch", self._extract_sync, slot)
                self._h_extract.observe((time.perf_counter() - t0) * 1e3,
                                        trace_id=trace_id)
                result = await self.stages.run(
                    self.name, "postproc", self.model.finalize, extracted,
                    info.item)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — contained to this slot
                log.exception("retire failed for %s slot %d", self.name, slot)
                self._c_batch_errors.inc()
                if self.breaker is not None:
                    self.breaker.record_failure()
                self._terminate_stream(info.stream, "engine_error", str(e))
                if not info.future.done():
                    info.future.set_exception(e)
            else:
                if info.stream is not None and not info.stream.terminated:
                    # Terminal burst: the family's final units, then done
                    # (finish reason + usage) through _terminate_stream, so
                    # its delivery is unconditional and the per-reason
                    # counter sees a "done".
                    finals = self.model.stream_final_units(extracted, result)
                    for u in finals[:-1]:
                        await self._emit_unit(info.stream, u)
                    self._terminate_stream(
                        info.stream, "done",
                        unit=finals[-1] if finals else {"type": "done"})
                if not info.future.done():
                    info.future.set_result(result)
                self._c_items.inc()
                units = self.model.result_units(result)
                self._c_units.inc(units)
                self._c_replica_units.inc(units)
                self._observe_retire(info.iterations)
                if early:
                    self._c_early_exits.inc()
                if self.breaker is not None:
                    self.breaker.record_success()
                wall1 = time.time()
                if info.ctx is not None:
                    # Retire: extract + finalize for this slot.
                    info.ctx.span("retire", wall1 - (time.perf_counter() - t0),
                                  wall1, tid=self.name, slot=slot,
                                  iterations=info.iterations)
                self.metrics.tracer.add(
                    f"gen[{info.iterations}it]",
                    wall1 - (time.perf_counter() - info.enqueued_at), wall1,
                    tid=self.name, trace_id=trace_id, slot=slot,
                    iterations=info.iterations)
            self._release_slot(slot)
        self._publish_active()
        self._maybe_idle()

    async def _fail_active(self, e: Exception) -> None:
        """A step/insert failure poisons the whole state block: fail every
        mid-flight request with the cause, free all slots, and zero the
        block in place. The step loop and queued requests survive —
        failure is contained to the in-flight generation set."""
        log.exception("generation step failed for %s", self.name, exc_info=e)
        self._c_batch_errors.inc()
        if self.breaker is not None:
            self.breaker.record_failure()
        wall = time.time()
        for info in self.arena.release_all():
            self._terminate_stream(info.stream, "engine_error", str(e))
            if not info.future.done():
                info.future.set_exception(e)
            if info.ctx is not None:
                info.ctx.span("engine_failure", wall, wall, tid=self.name,
                              iterations=info.iterations,
                              error=type(e).__name__)
        if self.pages is not None:
            self.pages.release_all()
            self._update_kv_gauges()
        self.runtime.zero_state(LIVE_BLOCK)
        self._publish_active()
        self._maybe_idle()

    # -- staged canary (lifecycle hook; runs in an executor thread) -----------
    def staged_canary_sync(self, staged: Any) -> None:
        """Run a SHORT generation end to end against a staged candidate
        (``params_override``) through the real programs, on the SCRATCH
        state block — the live block and the serving loop are untouched.
        Any non-finite output, empty result, or failure to finish within
        the model's step bound rejects the candidate (tpuserve_torch.
        lifecycle wires this in place of the one-shot staged canary for
        engine-served models)."""
        item = self.model.canary_item()
        extracted, done = self._generate(item, SCRATCH_BLOCK, staged,
                                         self._max_steps_guard)
        if not done:
            raise ValueError(
                f"staged canary did not finish a generation within "
                f"{self._max_steps_guard} iterations")
        for key, arr in sorted(extracted.items()):
            if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                raise ValueError(
                    f"staged canary produced non-finite outputs in {key}")
        if self.model.finalize(extracted, item) is None:
            raise ValueError("staged canary produced no result")

    # -- introspection --------------------------------------------------------
    def _observe_step(self, ms: float) -> None:
        prev = self._ewma_step_ms
        self._ewma_step_ms = ms if prev is None else prev + 0.2 * (ms - prev)

    def _observe_retire(self, iters: int) -> None:
        prev = self._ewma_iters
        self._ewma_iters = (float(iters) if prev is None
                            else prev + 0.2 * (iters - prev))

    @property
    def pending(self) -> int:
        """Requests accepted but not yet admitted into a slot."""
        return len(self._pending)

    def predicted_service_s(self, n_items: int = 1) -> float | None:
        """Predicted seconds for one full generation once admitted:
        iterations-per-request EWMA priced at the step EWMA. None before
        any retirement."""
        if not self._ewma_step_ms or not self._ewma_iters:
            return None
        return max(1, n_items) * self._ewma_iters * self._ewma_step_ms / 1e3

    def kv_clear_s(self) -> float | None:
        """Page-pressure term (paged mode only): estimated seconds until
        enough pages free for a typical admission — the Retry-After hint on
        a kv_pressure shed. None when paging is off or the ledger already
        covers a typical request with nothing queued ahead. The soonest
        page return is the most-advanced active request finishing: one
        request's EWMA span over the active count."""
        if self.pages is None:
            return None
        need = self._ewma_pages or 1.0
        if self.pages.n_free >= need and not self._pending:
            return None
        if not self._ewma_step_ms or not self._ewma_iters:
            return None
        per_req_s = self._ewma_iters * self._ewma_step_ms / 1e3
        return per_req_s / max(1, self.arena.n_active)

    def estimate_clear_s(self) -> float | None:
        """Queue-clear estimate (raw, unclamped; ``clamp_retry_after_s``
        owns the 429 Retry-After hint): pending requests times the observed
        iterations-per-request, priced at the step EWMA, amortized over the
        slot width, plus the page-pressure term when paging is on. None
        before any retirement."""
        if not self._pending:
            return None
        if not self._ewma_step_ms or not self._ewma_iters:
            return None
        per_req_s = self._ewma_iters * self._ewma_step_ms / 1e3
        base = len(self._pending) * per_req_s / max(1, self.slots)
        return base + (self.kv_clear_s() or 0.0)

    def pipeline_stats(self) -> dict:
        """The /stats "pipeline" block entry for this model (mode
        "genserve" tells it from the batcher's)."""
        per_slot = [
            {"slot": s, "iterations": self.arena.peek(s).iterations}
            for s in self.arena.active_slots()]
        stats = {
            "mode": "genserve",
            "slots": self.slots,
            "active": self.arena.n_active,
            "free": self.arena.n_free,
            "peak_active": self.peak_active,
            "pending": len(self._pending),
            "admitted_total": self.arena.acquires_total,
            "iterations_total": self._c_iterations.value,
            "fold_ins_total": self._c_fold_ins.value,
            "early_exits_total": self._c_early_exits.value,
            "evictions_total": self._c_evictions.value,
            "step_ewma_ms": round(self._ewma_step_ms, 3)
            if self._ewma_step_ms else None,
            "iters_per_request_ewma": round(self._ewma_iters, 2)
            if self._ewma_iters else None,
            "per_slot": per_slot,
        }
        if self.pages is not None:
            stats["kv"] = {
                **self.pages.stats(),
                "prefill_chunk": self._prefill_chunk,
                "prefill_chunks_total": self._c_prefill_chunks.value,
                "queued_pages": self._queued_pages(),
                "kv_bytes": self.kv_cache_bytes(),
            }
        stats["per_replica"] = [self.replica_row()]
        return stats

    def replica_row(self) -> dict:
        """The engine's row of the /stats genserve ``per_replica`` block."""
        row = {
            "replica": self.replica,
            "slots": self.slots,
            "active": self.arena.n_active,
            "free": self.arena.n_free,
            "pending": len(self._pending),
            "steps_total": self._c_replica_steps.value,
            "units_total": self._c_replica_units.value,
        }
        if self.pages is not None:
            row["kv"] = self.pages.snapshot()
        return row

    def kv_cache_bytes(self) -> int:
        """Device bytes the live block's KV storage occupies (dense slab k/v
        or the paged pool kp/vp)."""
        total = 0
        for key in ("k", "v", "kp", "vp"):
            spec = (self._state_struct or {}).get(key)
            if spec is not None:
                total += int(np.prod(spec.shape)) * torch.empty(
                    (), dtype=torch_dtype(spec.dtype)).element_size()
        return total
