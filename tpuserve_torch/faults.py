"""Fault injection and recovery machinery, ported from ``tpuserve/faults.py``.

- :class:`FaultInjector`: rules (``[[faults.rule]]`` in TOML,
  ``FaultRuleConfig``) name a *kind* — a call site on the serving path —
  plus model, probability and count, and draw from rule-local
  ``random.Random``s seeded exactly as the reference's, so one config fires
  the same sequence in both packages. The port's call sites: the batcher
  (``batch_error``, ``slow_dispatch``, ``kill_group_loop``), the runtime's
  ``dispatch`` (``device_error``, ``slow_compute``), its ``stage_params``
  gates (``reload_corrupt``, ``reload_nan``), the lifecycle's staged canary
  (``reload_regressed``) and the server (``decode_corrupt``,
  ``canary_fail``; ``worker_slow``, ``worker_hang`` and ``worker_crash``,
  which delay, wedge or end the serving process before a predict reads its
  body; and on a started stream only — after a unit was written —
  ``stream_stall``, which wedges the writer, and ``stream_disconnect``,
  which tears the transport with no terminal event). A rule with
  ``worker >= 0`` fires only in the worker process of that id
  (``tpuserve_torch.workerproc``).
  Kinds whose call sites the port lacks are refused when the config loads
  (``tpuserve_torch.config``).
- :class:`CircuitBreaker`: per model, trips to fast 503 + ``Retry-After``
  after N consecutive failed dispatches; the canary half-opens it and the
  first success closes it.
- :class:`Watchdog`: a periodic sweep that restarts dead group-accumulation
  tasks, counted in ``watchdog_restarts_total{model=,component=}``.

- :func:`run_chaos`: the chaos runner (``python -m tpuserve_torch chaos``):
  serves a built ``ServerState`` on an ephemeral local port, drives the
  port's load generator (``tpuserve_torch.bench.loadgen``) at one model,
  optionally hammers ``:reload`` (the ``reload`` drill), and reports
  availability, the injector's counts, the breakers and the lifecycle.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Callable

from tpuserve_torch.config import FaultRuleConfig, FaultsConfig
from tpuserve_torch.obs import BREAKER_STATES, Metrics
from tpuserve_torch.utils.locks import new_lock

log = logging.getLogger("tpuserve_torch.faults")


class FaultInjected(RuntimeError):
    """An injected chaos fault, not a real serving failure."""


class _ArmedRule:
    """One rule plus its mutable firing state (RNG, remaining budget)."""

    def __init__(self, cfg: FaultRuleConfig, derived_seed: int) -> None:
        self.cfg = cfg
        self.rng = random.Random(cfg.seed if cfg.seed else derived_seed)
        self.remaining = cfg.count  # -1 = unlimited
        self.fired = 0

    def matches(self, kind: str, model: str) -> bool:
        return self.cfg.kind == kind and self.cfg.model in ("*", model)

    def draw(self) -> bool:
        if self.remaining == 0:
            return False
        if self.cfg.probability < 1.0 and self.rng.random() >= self.cfg.probability:
            return False
        if self.remaining > 0:
            self.remaining -= 1
        self.fired += 1
        return True


class FaultInjector:
    """Deterministic config-driven fault injection for the serving path.

    Thread-safe: call sites run on the event loop and on the pipeline's
    stage threads."""

    def __init__(self, cfg: FaultsConfig, metrics: Metrics | None = None) -> None:
        self.cfg = cfg
        self.metrics = metrics
        self._lock = new_lock("faults.FaultInjector")
        # Epoch for rule.after_s: such a rule stays cold until the injector
        # has been alive that long.
        self._born = time.monotonic()
        # Worker-process id for rule.worker pinning (set by a worker process
        # behind the router); None/-1 rules match any process.
        self.worker_id: int | None = None
        # Derived seeds keep distinct rules decorrelated even when every
        # rule.seed is left at 0.
        self._rules = [_ArmedRule(r, cfg.seed * 1000003 + i + 1)
                       for i, r in enumerate(cfg.rules)]

    @classmethod
    def single(cls, kind: str, model: str = "*", probability: float = 1.0,
               count: int = -1, delay_ms: float = 0.0, seed: int = 0,
               metrics: Metrics | None = None) -> "FaultInjector":
        """One-rule injector (test/REPL convenience)."""
        rule = FaultRuleConfig(kind=kind, model=model, probability=probability,
                               count=count, delay_ms=delay_ms, seed=seed)
        return cls(FaultsConfig(enabled=True, seed=seed, rules=[rule]), metrics)

    def set_enabled(self, enabled: bool) -> None:
        """Flip injection live (chaos drills stop injecting mid-run)."""
        self.cfg.enabled = enabled

    def fire(self, kind: str, model: str) -> FaultRuleConfig | None:
        """First matching armed rule that draws true, or None."""
        if not self.cfg.enabled:
            return None
        with self._lock:
            alive_s = time.monotonic() - self._born
            for rule in self._rules:
                if rule.cfg.after_s > 0 and alive_s < rule.cfg.after_s:
                    continue
                if rule.cfg.worker >= 0 and rule.cfg.worker != self.worker_id:
                    continue
                if rule.matches(kind, model) and rule.draw():
                    if self.metrics is not None:
                        self.metrics.counter(
                            f"faults_injected_total{{model={model},kind={kind}}}").inc()
                    return rule.cfg
        return None

    def check(self, kind: str, model: str) -> None:
        """Raise FaultInjected when an armed rule fires at this call site."""
        if self.fire(kind, model) is not None:
            raise FaultInjected(f"injected fault: {kind} ({model})")

    def delay_s(self, kind: str, model: str) -> float:
        """Injected sleep for the slow_* kinds; 0.0 when nothing fires."""
        rule = self.fire(kind, model)
        return rule.delay_ms / 1e3 if rule is not None else 0.0

    def snapshot(self) -> list[dict]:
        """Per-rule firing state for /stats."""
        with self._lock:
            return [{
                "kind": r.cfg.kind,
                "model": r.cfg.model,
                "probability": r.cfg.probability,
                "fired": r.fired,
                "remaining": r.remaining,
            } for r in self._rules]


class CircuitBreaker:
    """Per-model breaker over consecutive failed dispatches.

    closed --(threshold consecutive failures)--> open
    open   --(canary probe admitted)-----------> half_open
    open/half_open --(any recorded success)----> closed

    While open or half-open the server sheds the model's traffic with a
    fast 503 + ``Retry-After`` before decoding the body. Recovery is driven
    by the canary, which keeps riding the batcher whatever the breaker's
    state; its first successful dispatch closes the breaker."""

    def __init__(self, model: str, threshold: int,
                 metrics: Metrics | None = None,
                 retry_after_s: float = 5.0) -> None:
        self.model = model
        self.threshold = threshold
        self.metrics = metrics
        self.retry_after_s = retry_after_s
        self._lock = new_lock("faults.CircuitBreaker")
        self.state = "closed"
        self.consecutive_errors = 0
        self.opened_total = 0
        self.shed_total = 0
        self._set_gauge()

    def allow(self) -> bool:
        """May normal (non-canary) traffic reach this model's batcher?"""
        if self.threshold <= 0:
            return True
        return self.state == "closed"

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_errors = 0
            changed = self.state != "closed"
            self.state = "closed"
        if changed:
            log.info("breaker for %s closed (recovered)", self.model)
            self._set_gauge()

    def record_failure(self) -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            self.consecutive_errors += 1
            was = self.state
            if was == "half_open":
                self.state = "open"  # failed probe: back to shedding
            elif was == "closed" and self.consecutive_errors >= self.threshold:
                self.state = "open"
                self.opened_total += 1
        if was != self.state:
            log.warning("breaker for %s opened after %d consecutive failures",
                        self.model, self.consecutive_errors)
            self._set_gauge()
        elif was == "half_open":
            self._set_gauge()

    def probe(self) -> None:
        """A canary was admitted while tripped: open -> half_open."""
        with self._lock:
            changed = self.state == "open"
            if changed:
                self.state = "half_open"
        if changed:
            self._set_gauge()

    def on_shed(self) -> None:
        """One request answered 503 because the breaker is not closed."""
        with self._lock:
            self.shed_total += 1
        if self.metrics is not None:
            self.metrics.counter(
                f"breaker_shed_total{{model={self.model}}}").inc()

    def _set_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge(
                f"breaker_state{{model={self.model}}}").set(BREAKER_STATES[self.state])

    def describe(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "threshold": self.threshold,
                "consecutive_errors": self.consecutive_errors,
                "opened_total": self.opened_total,
                "shed_total": self.shed_total,
            }


class Watchdog:
    """Periodic sweep restarting dead serving machinery.

    Components register a sweep callable returning how many restarts it
    performed; non-zero sweeps land in
    ``watchdog_restarts_total{model=,component=}``. Sweeps run on the event
    loop and must not block."""

    def __init__(self, interval_s: float, metrics: Metrics) -> None:
        self.interval_s = interval_s
        self.metrics = metrics
        self._targets: list[tuple[str, str, Callable[[], int]]] = []
        self._task: asyncio.Task | None = None

    def register(self, model: str, component: str, sweep: Callable[[], int]) -> None:
        self._targets.append((model, component, sweep))

    def start(self) -> None:
        if self.interval_s > 0 and self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                self.sweep()
            except Exception:  # one bad sweep must not end the watchdog
                log.exception("watchdog sweep failed")

    def sweep(self) -> int:
        """Run every registered sweep once; returns total restarts."""
        total = 0
        for model, component, fn in self._targets:
            try:
                n = fn()
            except Exception:
                log.exception("watchdog sweep for %s/%s failed", model, component)
                continue
            if n:
                log.warning("watchdog restarted %d %s for %s", n, component, model)
                self.metrics.counter(
                    f"watchdog_restarts_total{{model={model},component={component}}}").inc(n)
                total += n
        return total


# ---------------------------------------------------------------------------
# Chaos-run harness (python -m tpuserve_torch chaos)
# ---------------------------------------------------------------------------

async def run_chaos(state, model_name: str, duration_s: float = 10.0,
                    warmup_s: float = 1.0, concurrency: int = 16,
                    rate_per_s: float | None = None, verb: str = "predict",
                    edge: int = 256, drill: str | None = None,
                    drill_interval_s: float = 0.5) -> dict:
    """Serve ``state`` on an ephemeral local port, drive the load generator
    at one model, and report availability + per-rule injection counts.

    The server must be built (``state.build()``) but not started; this owns
    its lifecycle. Intended for staging chaos drills: arm ``[faults]`` rules
    in the config and assert the availability number here, not in prod.

    ``drill="reload"`` additionally hammers ``:reload`` every
    ``drill_interval_s`` throughout the run — with ``reload_corrupt`` /
    ``reload_nan`` / ``reload_regressed`` rules armed this proves the
    lifecycle gates hold availability while every reload is failing; the
    summary carries the reload outcomes and final lifecycle state.

    The load sends one npy image at ``edge`` to a vision model and one JSON
    text to a BERT model. For a recycle-mode model the summary also carries
    ``deferred``: its pool's epochs, respawns and replenished workers, the
    batcher's retries and failed retries, timeouts and sheds, the watchdog's
    restarts of its workers, and ``availability_all`` over every completion,
    late ones included (``n_late_ok``, ``n_late_err``): an epoch's readback
    and a dry acquire hold answers past the window, where ``availability``
    does not look."""
    from tpuserve_torch.bench.client import ClientSession
    from tpuserve_torch.bench.loadgen import run_load, run_load_open, synthetic_image_npy
    from tpuserve_torch.server import start_server, stop_server
    from tpuserve_torch.workerproc.drill import drill_payload

    server = await start_server(state, host="127.0.0.1", port=0)
    drill_task = None
    reload_stats = {"attempts": 0, "ok": 0, "rejected": 0, "rolled_back": 0,
                    "errors": 0}

    async def reload_driller(base: str) -> None:
        async with ClientSession() as session:
            while True:
                await asyncio.sleep(drill_interval_s)
                reload_stats["attempts"] += 1
                try:
                    r = await session.post(f"{base}/admin/models/{model_name}:reload")
                    body = r.json()
                    if r.status == 200:
                        reload_stats["ok"] += 1
                    elif body.get("rolled_back"):
                        reload_stats["rolled_back"] += 1
                    else:
                        reload_stats["rejected"] += 1
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — drill races teardown
                    reload_stats["errors"] += 1

    try:
        port = state.serving_addresses[0][1]
        base = f"http://127.0.0.1:{port}"
        url = f"{base}/v1/models/{model_name}:{verb}"
        if state.cfg.model(model_name).family == "bert":
            # A text model reads JSON: one text per request.
            payload, ctype, _ = drill_payload(state.cfg, model_name)
        else:
            payload, ctype = synthetic_image_npy(edge=edge), "application/x-npy"
        if drill == "reload":
            drill_task = asyncio.get_running_loop().create_task(
                reload_driller(base))
        if rate_per_s:
            result = await run_load_open(url, payload, ctype, rate_per_s, duration_s, warmup_s)
        else:
            result = await run_load(url, payload, ctype, duration_s, concurrency, warmup_s)
    finally:
        if drill_task is not None:
            drill_task.cancel()
            try:
                await drill_task
            except asyncio.CancelledError:
                pass
        # Snapshot lifecycle state BEFORE cleanup tears the server down.
        lifecycle_out = {n: lc.describe()
                         for n, lc in state.lifecycles.items()}
        await stop_server(state, server)
    out = result.summary()
    total = result.n_ok + result.n_err
    out["availability"] = round(result.n_ok / total, 5) if total else 0.0
    if state.injector is not None:
        out["faults"] = state.injector.snapshot()
    out["breakers"] = {n: br.describe() for n, br in state.breakers.items()}
    pools = state.pools()
    if pools:
        # What absorbed a worker's death: the pool's epochs, respawns and
        # replenished workers, the batch retries and the watchdog's sweeps;
        # and what did not: failed retries, timeouts, sheds, late failures.
        counters = state.metrics.counter_values()
        n_all = result.n_ok + result.n_err + result.n_late
        late = {"n_late_ok": result.n_late - result.n_late_err,
                "n_late_err": result.n_late_err,
                "availability_all": round((result.n_ok + result.n_late - result.n_late_err)
                                          / n_all, 5) if n_all else 0.0}
        out["deferred"] = {n: dict(
            pool.describe()["stats"], **late,
            **{c: counters.get(f"{c}{{model={n}}}", 0.0)
               for c in ("batch_retries_total", "batch_retry_failures_total",
                         "timeouts_total", "shed_total", "deadline_exceeded_total")},
            watchdog_restarts_total=counters.get(
                f"watchdog_restarts_total{{model={n},component=worker}}", 0.0))
            for n, pool in pools.items()}
    if lifecycle_out:
        out["lifecycle"] = lifecycle_out
    if drill is not None:
        out["reload_drill"] = reload_stats
    return out
