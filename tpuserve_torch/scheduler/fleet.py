"""FleetScheduler: cross-model SLO admission, priority arbitration and
warm/cold weight paging, ported from ``tpuserve/scheduler/fleet.py``.

The scheduler owns three decisions, all made at admission time, in
microseconds, before a request occupies a queue slot:

1. **Predictive admission.** Each batcher and engine keeps per-bucket
   batch-duration EWMAs; ``predict_completion_s(model)`` = raw queue-clear
   estimate + service-time EWMA. A request whose stamped deadline leaves
   less than that (plus ``headroom_ms`` of grace) sheds with a fast 504
   ``deadline_unmeetable`` + Retry-After.

2. **Priority classes and device-time accounting.** Dispatch timings feed a
   sliding-window per-model device-seconds ledger (``device_time_cb``).
   When the summed predicted queue-clear of the warm models exceeds
   ``overload_clear_s`` the fleet is saturated: batch-class work sheds
   first (503 ``priority_shed``), and the ``min_share`` floor keeps any
   model's interactive traffic from starving — a model over its allowance
   (1 - min_share x other demanding models) sheds (``share_exceeded``)
   while another model with queued work sits below the floor.

3. **Warm/cold weight paging.** A ``cold_start`` model boots with no
   parameter slot on the card; its first request (or ``POST
   .../{name}:warm``) warms it through the lifecycle's stage-then-publish
   path — integrity gates, the captures, the staged canary, the atomic
   publish — so no request is answered by unstaged weights, and requests
   during the warming window shed 503 ``model_warming`` + Retry-After.
   ``idle_demote_s`` of quiet demotes it back to cold: its slots and the
   CUDA graphs that bind them are freed (a graph holds its slot's storage
   by address), the variant registry stays, so a re-warm captures again
   and compiles nothing (``runtime_compiles_total`` does not move).

All scheduler state is event-loop-only (admission, the ledger callbacks and
the sweep task all run on the server's main loop); there is no lock.
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Awaitable, Callable

from tpuserve_torch.batcher import clamp_retry_after_s
from tpuserve_torch.config import SchedulerConfig
from tpuserve_torch.obs import PRIORITIES, SCHED_SHED_REASONS, Metrics
from tpuserve_torch.telemetry import events as events_mod

log = logging.getLogger("tpuserve_torch.scheduler")

COLD, WARMING, WARM = "cold", "warming", "warm"


@dataclass
class Shed:
    """One admission refusal: HTTP status, the reason label (one of
    obs.SCHED_SHED_REASONS — also the ``reason`` key in the response
    body, relayed by the router tier), a human message, and the
    Retry-After hint in seconds (None = no hint)."""

    status: int
    reason: str
    message: str
    retry_after: int | None = None


class _Entry:
    """Per-model scheduler state."""

    __slots__ = ("name", "batcher", "mcfg", "runtime", "warm_fn", "state",
                 "ledger", "window_sum", "last_used", "last_warm_s",
                 "next_warm_at", "warm_task", "shed_counters",
                 "device_seconds_total", "degree", "signature")

    def __init__(self, name: str, batcher: Any, mcfg: Any,
                 runtime: Any | None,
                 warm_fn: Callable[[], Awaitable[Any]] | None,
                 metrics: Metrics) -> None:
        self.name = name
        self.batcher = batcher
        self.mcfg = mcfg
        self.runtime = runtime
        self.warm_fn = warm_fn
        self.state = WARM
        # Placement facts: how many chips this model occupies when warm (the
        # runtime's n_chips: a replica@2 runtime counts 2, a sharded mesh its
        # ranks; recycle pools and test doubles count 1) and its parallel
        # signature ("replica@2", "sharded@d2", ...).
        self.degree = max(1, int(getattr(runtime, "n_chips", 1) or 1))
        self.signature = str(getattr(runtime, "parallel_signature",
                                     "single") or "single")
        # Sliding-window device-seconds ledger: (monotonic ts, seconds).
        self.ledger: deque[tuple[float, float]] = deque()
        self.window_sum = 0.0
        self.last_used = time.monotonic()
        self.last_warm_s: float | None = None
        self.next_warm_at = 0.0  # failed-warm backoff (monotonic)
        self.warm_task: asyncio.Task | None = None
        self.shed_counters = {r: metrics.sched_shed_counter(name, r)
                              for r in SCHED_SHED_REASONS}
        self.device_seconds_total = metrics.sched_device_seconds_counter(name)


class FleetScheduler:
    """Cross-model admission arbiter over the per-model batchers/engines.

    The server registers every model at start(); handle_predict consults
    ``resolve_priority`` / ``check_admission`` / ``check_deadline`` before
    a request reaches a batcher, and the batchers feed dispatch timings
    back through the per-model ``device_time_cb`` hook."""

    def __init__(self, cfg: SchedulerConfig, metrics: Metrics) -> None:
        self.cfg = cfg
        self.metrics = metrics
        self._entries: dict[str, _Entry] = {}
        self._sweep_task: asyncio.Task | None = None
        # SLO engine (tpuserve_torch.telemetry.slo), set by the server when
        # [telemetry] runs: slo_state() reads each model's live burn-rate
        # alert (ok/pending/firing).
        self.slo = None
        # Shed-on-burn engagement set: models the autopilot (or an operator)
        # has marked burning. While a model is in here its batch-class work
        # sheds at admission with reason ``burn_shed``: interactive traffic
        # keeps flowing, the backlog burning the budget does not grow.
        self.burn_shed: set[str] = set()

    # -- registration ---------------------------------------------------------
    def register(self, name: str, batcher: Any, mcfg: Any,
                 runtime: Any | None = None,
                 warm_fn: Callable[[], Awaitable[Any]] | None = None,
                 cold: bool = False) -> None:
        """Register one served model. ``warm_fn`` is the coroutine that
        stages weights to live (normally ``ModelLifecycle.reload``);
        ``cold=True`` starts the model in the cold state (no device params
        resident — ServerState.build skipped the load)."""
        e = _Entry(name, batcher, mcfg, runtime, warm_fn, self.metrics)
        if cold:
            e.state = COLD
        self._entries[name] = e
        self.metrics.set_model_state(name, e.state)
        # Ledger feed: the batcher/engine calls this per dispatch with the
        # device-section seconds (event loop only, like all state here).
        batcher.device_time_cb = self._make_recorder(e)

    def _make_recorder(self, e: _Entry):
        def record(seconds: float) -> None:
            now = time.monotonic()
            e.ledger.append((now, seconds))
            e.window_sum += seconds
            e.device_seconds_total.inc(seconds)
            self._trim(e, now)
        return record

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> None:
        if self.cfg.idle_demote_s > 0 and self._sweep_task is None:
            self._sweep_task = asyncio.get_running_loop().create_task(
                self._sweep_loop())

    async def stop(self) -> None:
        tasks = [t for t in ([self._sweep_task]
                             + [e.warm_task for e in self._entries.values()])
                 if t is not None and not t.done()]
        self._sweep_task = None
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: PERF203
                pass

    # -- prediction ------------------------------------------------------------
    def predict_completion_s(self, model: str, n_items: int = 1) -> float | None:
        """Predicted seconds until a request admitted NOW completes: the
        raw (unclamped) queue-clear estimate plus the service-time EWMA of
        the bucket covering it, plus — for a paged generation engine — the
        page-pressure term (kv_clear_s), so an exhausted
        page ledger makes deadline_unmeetable fire BEFORE enqueue even
        when the queue itself is empty. None before any duration evidence
        exists (admit optimistically — shedding needs proof)."""
        e = self._entries[model]
        clear = e.batcher.estimate_clear_s() or 0.0
        kv_fn = getattr(e.batcher, "kv_clear_s", None)
        kv = (kv_fn() or 0.0) if callable(kv_fn) else 0.0
        # estimate_clear_s already folds kv pressure in when a queue
        # exists; the standalone term matters when pending == 0.
        if clear <= 0.0:
            clear = kv
        svc = e.batcher.predicted_service_s(n_items)
        if svc is None and clear <= 0.0:
            return None
        return clear + (svc or 0.0)

    # -- priority / ledger ----------------------------------------------------
    def resolve_priority(self, model: str, header: str | None) -> str:
        """The request's priority class: the X-Priority header when
        present (validated), else the model's configured default. Raises
        ValueError (-> 400) on junk."""
        if header is None or header == "":
            e = self._entries.get(model)
            return e.mcfg.priority if e is not None else "interactive"
        value = header.strip().lower()
        if value not in PRIORITIES:
            raise ValueError(
                f"X-Priority must be one of {list(PRIORITIES)}, got {header!r}")
        return value

    def _trim(self, e: _Entry, now: float) -> None:
        horizon = now - self.cfg.window_s
        while e.ledger and e.ledger[0][0] < horizon:
            _, s = e.ledger.popleft()
            e.window_sum -= s

    def share(self, model: str) -> float:
        """The model's fraction of all device-seconds recorded in the
        sliding window (0.0 when the fleet is idle)."""
        now = time.monotonic()
        total = 0.0
        for e in self._entries.values():
            self._trim(e, now)
            total += e.window_sum
        if total <= 0.0:
            return 0.0
        return self._entries[model].window_sum / total

    def saturated(self) -> bool:
        """Aggregate demand exceeds capacity: the summed raw queue-clear
        prediction across warm models exceeds ``overload_clear_s``."""
        agg = sum((e.batcher.estimate_clear_s() or 0.0)
                  for e in self._entries.values() if e.state == WARM)
        return agg > self.cfg.overload_clear_s

    # -- admission ------------------------------------------------------------
    def _shed(self, e: _Entry, status: int, reason: str, message: str,
              retry_after: int | None) -> Shed:
        e.shed_counters[reason].inc()
        return Shed(status, reason, message, retry_after)

    def check_admission(self, model: str, priority: str) -> Shed | None:
        """Pre-body admission: warm/cold state and priority arbitration.
        Returns a Shed to answer immediately, or None to proceed. A cold
        model's first request triggers its warm-up as a side effect."""
        e = self._entries[model]
        if e.state != WARM:
            if e.state == COLD and not self._fits_budget(e):
                return self._shed(
                    e, 503, "chip_budget",
                    f"model {model!r} needs {e.degree} chip(s) but the "
                    f"fleet chip budget ({self.cfg.chip_budget}) is "
                    f"occupied ({self.chips_in_use()} in use)",
                    clamp_retry_after_s(self.cfg.warm_retry_after_s) or 1)
            self._ensure_warming(e)
            eta = max(1, math.ceil(e.last_warm_s
                                   if e.last_warm_s
                                   else self.cfg.warm_retry_after_s))
            return self._shed(
                e, 503, "model_warming",
                f"model {model!r} is {e.state}; weights are being staged",
                eta)
        if priority == "batch" and model in self.burn_shed:
            # Shed-on-burn engaged: the model is burning its error budget,
            # so deferrable work yields before saturation math even runs.
            return self._shed(
                e, 503, "burn_shed",
                f"model {model!r} is burning its SLO error budget; "
                "batch-priority work shed until the alert clears",
                clamp_retry_after_s(self.cfg.overload_clear_s) or 1)
        if not self.saturated():
            return None
        agg_hint = clamp_retry_after_s(sum(
            (x.batcher.estimate_clear_s() or 0.0)
            for x in self._entries.values())) or 1
        if priority == "batch":
            # Low-priority work sheds first under overload.
            return self._shed(
                e, 503, "priority_shed",
                "fleet saturated; batch-priority work shed first", agg_hint)
        if self.cfg.min_share > 0:
            others = [o for o in self._entries.values()
                      if o is not e and o.state == WARM]
            demanding = [o for o in others if o.batcher.pending > 0]
            starved = [o for o in demanding
                       if self.share(o.name) < self.cfg.min_share]
            allowed = 1.0 - self.cfg.min_share * len(demanding)
            if starved and self.share(model) > allowed:
                # The floor has teeth: the hog yields device time until the
                # starved model's interactive traffic catches up.
                return self._shed(
                    e, 503, "share_exceeded",
                    f"model {model!r} exceeds its device-time allowance "
                    f"({allowed:.2f}) while "
                    f"{', '.join(o.name for o in starved)} is starved",
                    agg_hint)
        return None

    def check_deadline(self, model: str,
                       deadline_at: float | None) -> Shed | None:
        """Post-stamping admission: shed when the deadline provably cannot
        be met (fast 504 ``deadline_unmeetable``: reject in microseconds
        rather than fail in seconds)."""
        if deadline_at is None:
            return None
        pred = self.predict_completion_s(model)
        if pred is None:
            return None
        now = time.perf_counter()
        remaining = deadline_at - now
        if remaining + self.cfg.headroom_ms / 1e3 >= pred:
            return None
        e = self._entries[model]
        hint = clamp_retry_after_s(e.batcher.estimate_clear_s()) \
            or clamp_retry_after_s(pred) or 1
        return self._shed(
            e, 504, "deadline_unmeetable",
            f"deadline_unmeetable: {remaining * 1e3:.0f} ms remaining but "
            f"predicted completion is {pred * 1e3:.0f} ms", hint)

    def touch(self, model: str) -> None:
        """Record model activity (the idle-demotion clock)."""
        self._entries[model].last_used = time.monotonic()

    def slo_state(self, model: str) -> str:
        """The model's live SLO alert state ("ok"/"pending"/"firing";
        "ok" when no engine is attached or the model has no objective) —
        the burn-rate signal admission policy can act on."""
        return self.slo.state_of(model) if self.slo is not None else "ok"

    # -- chip-budget placement --------------------------------------------------
    def chips_in_use(self) -> int:
        """Chips occupied by non-cold models — warm runtimes hold device
        params on every chip of their degree, warming ones are staging
        onto them."""
        return sum(e.degree for e in self._entries.values()
                   if e.state != COLD)

    def _fits_budget(self, e: _Entry) -> bool:
        """Whether warming ``e`` fits ``chip_budget``, demoting idle
        cold_start models (largest degree first — frees the most chips
        per staging cost) to make room. Placement is by parallelism
        degree: a replica@4 textgen claims 4 chips, a single-chip
        classifier 1, and the budget arbitrates between them."""
        budget = self.cfg.chip_budget
        if budget <= 0 or e.state != COLD:
            return True

        def overflow() -> int:
            return self.chips_in_use() + e.degree - budget

        if overflow() <= 0:
            return True
        victims = sorted(
            (o for o in self._entries.values()
             if o is not e and o.state == WARM and o.mcfg.cold_start
             and o.batcher.pending == 0),
            key=lambda o: -o.degree)
        for o in victims:
            if overflow() <= 0:
                break
            self.demote(o.name)
        return overflow() <= 0

    # -- warm/cold state machine ----------------------------------------------
    def is_warm(self, model: str) -> bool:
        e = self._entries.get(model)
        return e is None or e.state == WARM

    def state_of(self, model: str) -> str:
        return self._entries[model].state

    def _ensure_warming(self, e: _Entry) -> None:
        """Kick the warm-up task if none is running (failed warms back off
        ``warm_retry_after_s`` so a broken checkpoint can't hot-loop
        expensive staging)."""
        if e.warm_fn is None or e.state == WARM:
            return
        if e.warm_task is not None and not e.warm_task.done():
            return
        if time.monotonic() < e.next_warm_at:
            return
        if not self._fits_budget(e):
            return  # admission already shed 503 chip_budget
        e.warm_task = asyncio.get_running_loop().create_task(self._do_warm(e))

    async def _do_warm(self, e: _Entry) -> dict:
        self._set_state(e, WARMING)
        t0 = time.perf_counter()
        try:
            info = await e.warm_fn()
        except asyncio.CancelledError:
            self._set_state(e, COLD)
            raise
        except Exception:
            self._set_state(e, COLD)
            e.next_warm_at = time.monotonic() + self.cfg.warm_retry_after_s
            log.exception("%s: warm-up failed; model stays cold", e.name)
            raise
        e.last_warm_s = time.perf_counter() - t0
        e.last_used = time.monotonic()
        self._set_state(e, WARM)
        log.info("%s: warmed in %.2fs (version %s)", e.name, e.last_warm_s,
                 (info or {}).get("version"))
        return {"model": e.name, "state": WARM,
                "warm_ms": round(e.last_warm_s * 1e3, 1),
                "version": (info or {}).get("version")}

    async def warm(self, model: str) -> dict:
        """Explicit warm-up (``POST .../{name}:warm``): joins the in-flight
        warm task if one is running; returns once the model serves. The
        shared task is shielded so one impatient client disconnecting
        cannot cancel everyone's warm-up."""
        e = self._entries[model]
        if e.state == WARM:
            return {"model": model, "state": WARM, "already_warm": True}
        if e.warm_fn is None:
            raise ValueError(f"model {model!r} has no warm path registered")
        if e.state == COLD and not self._fits_budget(e):
            raise ValueError(
                f"model {model!r} needs {e.degree} chip(s) but the fleet "
                f"chip budget ({self.cfg.chip_budget}) is occupied "
                f"({self.chips_in_use()} in use)")
        e.next_warm_at = 0.0  # explicit ask overrides the failure backoff
        self._ensure_warming(e)
        return await asyncio.shield(e.warm_task)

    def demote(self, model: str) -> bool:
        """Demote a warm cold_start model back to cold, releasing its
        parameter slots and graphs (``ModelRuntime.release_params``: batches
        in flight finish on their own storage first). Returns True when a
        demotion happened."""
        e = self._entries[model]
        if e.state != WARM or not e.mcfg.cold_start or e.runtime is None:
            return False
        self._set_state(e, COLD)
        e.runtime.release_params()
        log.info("%s: idle-demoted to cold (device params released)", model)
        return True

    def _set_state(self, e: _Entry, state: str) -> None:
        prev, e.state = e.state, state
        self.metrics.set_model_state(e.name, state)
        if prev != state:
            # Paging transitions are rare and load-bearing: a postmortem
            # reader can see a model was mid-warm when it died.
            events_mod.emit("info", "scheduler", "model_state",
                            model=e.name, state=state, previous=prev)

    async def _sweep_loop(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.sweep_interval_s)
            try:
                self.sweep_idle()
            except asyncio.CancelledError:
                raise
            except Exception:  # one bad sweep must not end demotion
                log.exception("scheduler idle sweep failed")

    def sweep_idle(self) -> int:
        """Demote every warm cold_start model idle past ``idle_demote_s``
        with nothing queued or in flight; returns demotions performed."""
        if self.cfg.idle_demote_s <= 0:
            return 0
        now = time.monotonic()
        demoted = 0
        for e in self._entries.values():
            if not e.mcfg.cold_start or e.state != WARM:
                continue
            if now - e.last_used < self.cfg.idle_demote_s:
                continue
            if e.batcher.pending > 0:
                continue
            if self.demote(e.name):
                demoted += 1
        return demoted

    # -- introspection --------------------------------------------------------
    def stats(self) -> dict:
        """The /stats ``scheduler`` block: fleet saturation plus, per
        model, the paging state, priority default, windowed device-time
        share, and the live completion prediction."""
        now = time.monotonic()
        models: dict[str, dict] = {}
        for name, e in self._entries.items():
            self._trim(e, now)
            pred = self.predict_completion_s(name)
            models[name] = {
                "state": e.state,
                "slo_alert": self.slo_state(name),
                "priority": e.mcfg.priority,
                "cold_start": e.mcfg.cold_start,
                "parallel": {"signature": e.signature, "degree": e.degree},
                "share": round(self.share(name), 4),
                "device_seconds_window": round(e.window_sum, 4),
                "device_seconds_total": round(e.device_seconds_total.value, 4),
                "predicted_completion_s": round(pred, 4)
                if pred is not None else None,
                "pending": e.batcher.pending,
                "last_warm_ms": round(e.last_warm_s * 1e3, 1)
                if e.last_warm_s else None,
                "sheds": {r: c.value for r, c in e.shed_counters.items()
                          if c.value},
            }
        return {
            "saturated": self.saturated(),
            "window_s": self.cfg.window_s,
            "overload_clear_s": self.cfg.overload_clear_s,
            "min_share": self.cfg.min_share,
            "idle_demote_s": self.cfg.idle_demote_s,
            "chip_budget": self.cfg.chip_budget,
            "chips_in_use": self.chips_in_use(),
            "models": models,
        }
