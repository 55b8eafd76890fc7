"""Observability for the port: counters, gauges, latency histograms with
trace-id exemplars, the span ring, request trace contexts, the flight
recorder and the Prometheus/OpenMetrics exposition, ported from
``tpuserve/obs.py``.

Metric names are the JAX package's, unchanged, so one dashboard reads both
servers: ``batches_total{model=}``, ``items_total{model=}``,
``queue_depth{model=}``, ``batch_fill_ratio{model=}``,
``latency_ms{model=,phase=}``, ``runtime_compiles_total{model=}``,
``runtime_variants{model=}``, and the ingest counters
``frame_errors_total{model=}``, ``native_decode_fallback_total{model=}``,
``ingest_requests_total{loop=}`` and ``ingest_bytes_total{loop=}`` (one pair
per accept loop, ``[server] ingest_loops``), the lifecycle's
``model_version{model=}``, ``reloads_total{model=}``,
``reload_rejected_total{model=,stage=}`` and
``rollbacks_total{model=,reason=}``, the fault injector's
``faults_injected_total{model=,kind=}``, the adaptive flush's
``adaptive_target_batch{model=}`` and ``batch_duration_ewma_ms{model=}``,
the retry path's ``batch_retries_total``, ``batch_retry_failures_total``
and ``poison_items_total{model=}``, the breaker's ``breaker_state`` and
``breaker_shed_total{model=}``, the watchdog's
``watchdog_restarts_total{model=,component=}``, the result cache's
``cache_<event>_total{model=}`` (``CACHE_EVENTS``) and
``cache_entries{model=}``, the flight recorder's
``trace_recorded_total{model=,kind=}``, the telemetry plane's
``device_seconds_total{model=,replica=}``,
``device_utilization{model=,replica=}``, ``slo_burn_rate{model=,window=}``,
``slo_alert_state{model=}``, ``telemetry_samples_total`` and
``profile_captures_total``, and the event plane's
``events_logged_total{level=,subsystem=}`` and
``audit_events_total{verb=,outcome=}``, and the router/worker tier's
``worker_up{worker=}``, ``worker_respawns_total{worker=}``,
``worker_backoff_s{worker=}``, ``worker_inflight{worker=}``,
``router_<kind>_total{model=}`` (``ROUTER_COUNTERS``),
``router_latency_ms{model=}``, ``router_first_unit_ms{model=}``,
``router_stream_terminated_total{model=,reason=}``
(``ROUTER_STREAM_REASONS``), the host failure domains' ``host_up{host=}``,
``host_respawns_total{host=}``, ``host_backoff_s{host=}`` and
``host_breaker_open{host=}``, and the peer router tier's
``router_up{router=}``, ``router_respawns_total{router=}`` and
``cache_peer_{hops,errors,serves}_total{model=}``.

Request tracing: a ``TraceContext`` is minted per HTTP request (128-bit
trace id, adopted from a well-formed ``X-Trace-Id``, returned as
``X-Trace-Id`` on every response) and collects completed spans from every
layer the request crosses; the ``FlightRecorder`` keeps the complete span
trees of the slowest-N requests per model and of every errored or shed
request (``/debug/slow``, ``/debug/trace?trace_id=``); the ``Tracer`` ring
keeps the newest batch spans (``/debug/trace``, ``/debug/profile``).

Everything is in-process, for one asyncio event loop plus thread pools:
histogram and counter updates take a short lock; spans are appended to a
list with no lock (``list.append`` is atomic).
"""

from __future__ import annotations

import bisect
import heapq
import json
import math
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable

from tpuserve_torch.utils.locks import new_lock


def _default_latency_buckets() -> list[float]:
    # Log-linear: 9 linear sub-buckets per decade, 0.1 ms .. 100 s (the JAX
    # package's bounds, so quantiles read the same on both servers).
    return [m * (10.0**d) for d in range(-1, 5) for m in range(1, 10)] + [1e5]


class Histogram:
    """Fixed-bucket histogram (milliseconds by default).

    ``exemplars=True`` keeps, per bucket, the last (trace_id, value, unix
    ts) observed there with a trace id, so a dashboard's p99 bucket names a
    recorded trace; memory stays one tuple per bucket."""

    def __init__(self, name: str, buckets: list[float] | None = None,
                 exemplars: bool = False) -> None:
        self.name = name
        self.bounds = buckets or _default_latency_buckets()
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.n = 0
        # bucket index -> (trace_id, value, unix ts); None when exemplars
        # are off, so the hot path pays one None check.
        self._exemplars: dict[int, tuple[str, float, float]] | None = (
            {} if exemplars else None)
        self._lock = new_lock("obs.Histogram")

    def observe(self, value: float, trace_id: str | None = None) -> None:
        i = bisect.bisect_left(self.bounds, value)  # first bound >= value
        with self._lock:
            self.counts[i] += 1
            self.total += value
            self.n += 1
            if trace_id is not None and self._exemplars is not None:
                self._exemplars[i] = (trace_id, value, time.time())

    def quantile(self, q: float) -> float:
        """Approximate quantile, linearly interpolated inside the bucket that
        holds the rank (Prometheus ``histogram_quantile``); inf when the rank
        lands in the overflow bucket."""
        with self._lock:
            n = self.n
            if n == 0:
                return 0.0
            rank = math.ceil(q * n)
            acc = 0
            for i, c in enumerate(self.counts):
                prev_acc = acc
                acc += c
                if acc >= rank and c > 0:
                    if i == len(self.bounds):
                        return float("inf")
                    lo = self.bounds[i - 1] if i > 0 else 0.0
                    return lo + (self.bounds[i] - lo) * (rank - prev_acc) / c
        return self.bounds[-1]

    def snapshot(self) -> dict:
        with self._lock:
            out = {"n": self.n, "total": self.total, "counts": list(self.counts)}
            if self._exemplars:
                out["exemplars"] = dict(self._exemplars)
            return out


class Counter:
    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0
        self._lock = new_lock("obs.Counter")

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Gauge:
    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value


@dataclass
class SpanEvent:
    """One completed span of the ring."""

    name: str
    ts_us: float  # start, microseconds since the epoch
    dur_us: float
    tid: str = "main"  # logical track: the model name
    args: dict = field(default_factory=dict)
    # The request trace the span belongs to, when the emitter knows one (a
    # batch span carries one member's).
    trace_id: str | None = None
    # Process lane in a Chrome trace: 0 for the single-process server.
    pid: int = 0


class Tracer:
    """Bounded ring of spans, dumped as Chrome trace JSON; keeps the newest
    ``capacity`` spans (overflow drops the oldest)."""

    def __init__(self, capacity: int = 65536) -> None:
        self._events: deque[SpanEvent] = deque(maxlen=capacity)
        self._lock = new_lock("obs.Tracer")

    def add(self, name: str, start_s: float, end_s: float, tid: str = "main",
            trace_id: str | None = None, pid: int = 0, **args) -> None:
        ev = SpanEvent(name, start_s * 1e6, (end_s - start_s) * 1e6, tid,
                       args, trace_id, pid)
        with self._lock:
            self._events.append(ev)

    def chrome_trace(self, limit: int | None = None,
                     since_us: float | None = None) -> str:
        """Chrome ``chrome://tracing`` JSON of the ring: ``limit`` keeps the
        newest that many events, ``since_us`` (epoch microseconds) drops
        older spans."""
        with self._lock:
            events = list(self._events)
        if since_us is not None:
            events = [e for e in events if e.ts_us >= since_us]
        if limit is not None and limit >= 0:
            # Not events[-limit:]: -0 slices the whole list.
            events = events[len(events) - limit:] if limit else []
        out = []
        for e in events:
            args = dict(e.args)
            if e.trace_id is not None:
                args["trace_id"] = e.trace_id
            out.append({"name": e.name, "ph": "X", "ts": e.ts_us, "dur": e.dur_us,
                        "pid": e.pid, "tid": e.tid, "args": args})
        return json.dumps({"traceEvents": out})


# -- request-scoped tracing -----------------------------------------------------

_TRACE_ID_HEX = 32  # 128-bit trace id
_SPAN_ID_HEX = 16   # 64-bit span id


def _hex_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def valid_trace_id(value) -> bool:
    """True for a well-formed 128-bit lowercase-hex trace id (the wire
    format of X-Trace-Id). A malformed client id is replaced, never echoed."""
    if not isinstance(value, str) or len(value) != _TRACE_ID_HEX:
        return False
    return all(c in "0123456789abcdef" for c in value)


def _valid_span_id(value) -> bool:
    if not isinstance(value, str) or len(value) != _SPAN_ID_HEX:
        return False
    return all(c in "0123456789abcdef" for c in value)


class TraceContext:
    """One request's trace identity plus its collected spans.

    Minted at ingest (adopted from ``X-Trace-Id`` / ``X-Parent-Span`` when
    well formed); every layer the request crosses appends completed spans
    with explicit wall-clock bounds, so recording is safe from any thread or
    loop and costs one small dict per span. The root span is the HTTP
    request itself (``span_id == root_id``); every ``span()`` without an
    explicit parent hangs off it.

    Span dict fields: name, trace_id, span_id, parent_id, ts_us, dur_us,
    tid, pid, args."""

    __slots__ = ("trace_id", "root_id", "parent_id", "pid", "spans")

    def __init__(self, trace_id: str | None = None,
                 parent_id: str | None = None, pid: int = 0) -> None:
        self.trace_id = trace_id if valid_trace_id(trace_id) \
            else _hex_id(_TRACE_ID_HEX // 2)
        self.parent_id = parent_id if _valid_span_id(parent_id) else None
        self.root_id = _hex_id(_SPAN_ID_HEX // 2)
        self.pid = pid
        self.spans: list[dict] = []

    @classmethod
    def from_headers(cls, headers, pid: int = 0) -> "TraceContext":
        """Adopt the upstream trace identity (X-Trace-Id / X-Parent-Span)
        or mint a fresh one. ``headers.get`` is looked up under the
        canonical names and their lower-case forms."""
        def get(name: str):
            value = headers.get(name)
            return value if value is not None else headers.get(name.lower())
        return cls(trace_id=get("X-Trace-Id"), parent_id=get("X-Parent-Span"),
                   pid=pid)

    def new_span_id(self) -> str:
        return _hex_id(_SPAN_ID_HEX // 2)

    def span(self, name: str, start_s: float, end_s: float, *,
             span_id: str | None = None, parent_id: str | None = None,
             tid: str = "req", **args) -> str:
        """Record one completed span (wall-clock seconds); returns its span
        id. The default parent is the request's root span."""
        sid = span_id or _hex_id(_SPAN_ID_HEX // 2)
        self.spans.append({
            "name": name,
            "trace_id": self.trace_id,
            "span_id": sid,
            "parent_id": self.root_id if parent_id is None else parent_id,
            "ts_us": start_s * 1e6,
            "dur_us": max(0.0, end_s - start_s) * 1e6,
            "tid": tid,
            "pid": self.pid,
            "args": args,
        })
        return sid

    def root_span(self, name: str, start_s: float, end_s: float,
                  tid: str = "req", **args) -> str:
        """Record the request's root span (span_id = root_id, parented under
        the upstream span when one was given)."""
        self.spans.append({
            "name": name,
            "trace_id": self.trace_id,
            "span_id": self.root_id,
            "parent_id": self.parent_id,
            "ts_us": start_s * 1e6,
            "dur_us": max(0.0, end_s - start_s) * 1e6,
            "tid": tid,
            "pid": self.pid,
            "args": args,
        })
        return self.root_id


def spans_to_chrome(spans: Iterable[dict],
                    events: Iterable[dict] = ()) -> str:
    """Recorded span dicts as Chrome ``chrome://tracing`` JSON (name, ph "X",
    ts, dur, pid, tid, args with trace_id / span_id / parent_id folded in),
    with event-plane records interleaved as instant events (``ph: "i"``),
    sorted by time."""
    out = []
    for s in spans:
        args = dict(s.get("args") or {})
        args["trace_id"] = s.get("trace_id")
        args["span_id"] = s.get("span_id")
        args["parent_id"] = s.get("parent_id")
        out.append({
            "name": s.get("name", ""),
            "ph": "X",
            "ts": float(s.get("ts_us", 0.0)),
            "dur": float(s.get("dur_us", 0.0)),
            "pid": int(s.get("pid", 0)),
            "tid": s.get("tid", "req"),
            "args": args,
        })
    if events:
        from tpuserve_torch.telemetry.events import events_to_chrome

        out.extend(events_to_chrome(list(events)))
    out.sort(key=lambda e: e["ts"])
    return json.dumps({"traceEvents": out})


class FlightRecorder:
    """Tail-latency flight recorder: complete span trees of

    - the slowest ``slow_n`` requests per model (a min-heap keyed by
      duration: a new request evicts the fastest retained one, so under
      churn the reservoir converges on the true tail), and
    - every errored or shed request (HTTP status >= 400), FIFO up to
      ``error_capacity``, retained even when fast.

    Dumped at ``GET /debug/slow`` and ``GET /debug/trace?trace_id=``.
    Thread-safe: every accept loop finishes its own requests into it."""

    def __init__(self, slow_n: int = 16, error_capacity: int = 256,
                 always_record_errors: bool = True,
                 metrics: "Metrics | None" = None) -> None:
        self.slow_n = max(0, int(slow_n))
        self.error_capacity = max(0, int(error_capacity))
        self.always_record_errors = always_record_errors
        self._metrics = metrics
        self._rec_counters: dict[tuple[str, str], Counter] = {}
        # model -> min-heap of (duration_ms, seq, record); heap[0] is the
        # fastest retained record, evicted first.
        self._slow: dict[str, list] = {}
        self._errors: deque = deque()
        self._by_id: dict[str, dict] = {}
        self._seq = 0
        self._lock = new_lock("obs.FlightRecorder")

    def _counter(self, model: str, kind: str) -> "Counter | None":
        if self._metrics is None:
            return None
        c = self._rec_counters.get((model, kind))
        if c is None:
            c = self._rec_counters[(model, kind)] = self._metrics.counter(
                f"trace_recorded_total{{model={model},kind={kind}}}")
        return c

    @staticmethod
    def _make_record(ctx: TraceContext, model: str, status: int,
                     duration_ms: float) -> dict:
        return {
            "trace_id": ctx.trace_id,
            "model": model,
            "status": int(status),
            "duration_ms": round(duration_ms, 3),
            "ts": time.time(),
            "spans": list(ctx.spans),
            "_slow": False,
            "_err": False,
        }

    def _maybe_drop(self, record: dict) -> None:
        """Forget a record no reservoir retains anymore."""
        if not record["_slow"] and not record["_err"]:
            self._by_id.pop(record["trace_id"], None)

    def finish(self, ctx: TraceContext, model: str, status: int,
               duration_ms: float) -> list[str]:
        """Offer one completed request to the reservoirs; returns the kinds
        that retained it (a subset of ``["error", "slow"]``)."""
        kinds: list[str] = []
        with self._lock:
            record: dict | None = None
            if status >= 400 and self.always_record_errors \
                    and self.error_capacity > 0:
                record = self._make_record(ctx, model, status, duration_ms)
                record["_err"] = True
                self._errors.append(record)
                if len(self._errors) > self.error_capacity:
                    old = self._errors.popleft()
                    old["_err"] = False
                    self._maybe_drop(old)
                kinds.append("error")
            if self.slow_n > 0:
                heap = self._slow.setdefault(model, [])
                if len(heap) < self.slow_n or duration_ms > heap[0][0]:
                    if record is None:
                        record = self._make_record(ctx, model, status, duration_ms)
                    record["_slow"] = True
                    self._seq += 1
                    heapq.heappush(heap, (duration_ms, self._seq, record))
                    if len(heap) > self.slow_n:
                        _, _, old = heapq.heappop(heap)
                        old["_slow"] = False
                        self._maybe_drop(old)
                    kinds.append("slow")
            if record is not None:
                self._by_id[record["trace_id"]] = record
        for kind in kinds:
            c = self._counter(model, kind)
            if c is not None:
                c.inc()
        return kinds

    @staticmethod
    def _public(record: dict) -> dict:
        return {k: v for k, v in record.items() if not k.startswith("_")}

    def get(self, trace_id: str) -> dict | None:
        """The retained record of one trace id, or None once both
        reservoirs have let it go."""
        with self._lock:
            rec = self._by_id.get(trace_id)
            return self._public(rec) if rec is not None else None

    def dump(self, model: str | None = None) -> dict:
        """The /debug/slow body: per-model slowest-first records plus the
        errored-request FIFO, newest first."""
        with self._lock:
            slow = {
                m: [self._public(r) for _, _, r in sorted(heap, key=lambda t: -t[0])]
                for m, heap in self._slow.items()
                if model is None or m == model
            }
            errors = [self._public(r) for r in reversed(self._errors)
                      if model is None or r["model"] == model]
        return {"slow": slow, "errors": errors,
                "slow_n": self.slow_n, "error_capacity": self.error_capacity}

    def stats(self) -> dict:
        """The /stats ``trace`` block: reservoir occupancy."""
        with self._lock:
            return {
                "slow_n": self.slow_n,
                "slow": {m: len(h) for m, h in self._slow.items()},
                "errors": len(self._errors),
                "error_capacity": self.error_capacity,
                "records": len(self._by_id),
            }


# Phase labels on latency_ms{model=,phase=}: "body_read" and "parse" are
# request-scoped (HTTP layer), the rest batch-scoped (batcher). "preproc" is
# the assemble stage, "h2d" the pinned copy plus the forward's dispatch,
# "compute" the fetch stage's wait for the device, "postproc" the top-k
# formatting.
PHASES = ("body_read", "parse", "queue", "preproc", "h2d", "compute",
          "postproc", "total")

# Lifecycle reload gates, in pipeline order (tpuserve_torch.lifecycle): the
# stage label on reload_rejected_total{model=,stage=}. "post_canary" is the
# only one that implies a rollback happened (the candidate had published).
RELOAD_STAGES = ("integrity", "nan_scan", "structure", "load",
                 "staged_canary", "post_canary")

# Reasons on rollbacks_total{model=,reason=}: the explicit admin endpoint, a
# failed post-publish canary, and the soak-window triggers (a breaker that
# left "closed", a failed periodic canary).
ROLLBACK_REASONS = ("manual", "post_publish_canary", "soak_breaker",
                    "soak_canary")

# Circuit-breaker states as the breaker_state{model=} gauge's values
# (tpuserve_torch.faults.CircuitBreaker): bigger = less healthy.
BREAKER_STATES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}

# SLO alert states as the slo_alert_state{model=} gauge's values
# (tpuserve_torch.telemetry.slo; /alerts carries the same words): bigger =
# less healthy.
SLO_ALERT_STATES = {"ok": 0.0, "pending": 1.0, "firing": 2.0}

# Result-cache events (tpuserve_torch.cache), the cache_<event>_total{model=}
# counters: "hits" answer from the cache, "misses" lead a real batch
# submission, "coalesced" join an identical in-flight miss (single-flight),
# "evictions" are LRU drops and "stale_drops" flights that completed after
# a mid-flight version change (served to their waiters, never cached).
CACHE_EVENTS = ("hits", "misses", "coalesced", "evictions", "stale_drops")

# Host-pipeline stage executors (tpuserve_torch.hostpipe): one thread pool
# per stage, labelled on pipeline_stage_depth{model=,stage=}.
PIPELINE_STAGES = ("assemble", "h2d", "fetch", "postproc")

# Priority classes (X-Priority, or the model's ``priority`` default): the
# label on queue_wait_ms{model=,priority=}. Under fleet overload the
# scheduler sheds "batch" first (tpuserve_torch.scheduler).
PRIORITIES = ("interactive", "batch")

# Reasons on sched_sheds_total{model=,reason=} (tpuserve_torch.scheduler):
# "deadline_unmeetable" — the stamped deadline provably cannot be met at
# admission (fast 504); "priority_shed" — batch-class work shed under fleet
# saturation; "share_exceeded" — an over-allowance model shed while another
# model's interactive traffic was starved below min_share; "model_warming" —
# shed during a cold model's warming window; "burn_shed" — batch-class work
# of a model burning its error budget; "kv_pressure" — the paged generation
# engine's free pages cannot cover the request; "chip_budget" — warming the
# model would exceed the warm fleet's chip budget.
SCHED_SHED_REASONS = ("deadline_unmeetable", "priority_shed",
                      "share_exceeded", "model_warming", "burn_shed",
                      "kv_pressure", "chip_budget")

# Tenant admission refusals (tpuserve_torch.scheduler.tenants), by cause.
TENANT_SHED_REASONS = ("tenant_unknown", "tenant_rate_exceeded",
                       "tenant_quota_exceeded", "tenant_share_exceeded")

# A model's paging state as a gauge value (model_state{model=}).
MODEL_STATES = {"cold": 0.0, "warming": 1.0, "warm": 2.0}

# Reasons on gen_stream_terminated_total{model=,reason=} — how a generation
# stream ended (tpuserve_torch.genserve.engine._terminate_stream): "done" is
# the only success; everything else names which machinery cut the stream.
# The engine refuses any other label, so the vocabulary stays closed.
GEN_STREAM_REASONS = ("done", "disconnect", "deadline_exceeded",
                      "engine_error", "drain", "shutdown")

# Reasons on router_stream_terminated_total{model=,reason=} — the router's
# stream relay (tpuserve_torch.workerproc.router): the same contract as
# GEN_STREAM_REASONS seen from the relay ("done" the only success;
# "upstream_error" folds any worker-side failure).
ROUTER_STREAM_REASONS = ("done", "client_disconnect", "deadline_exceeded",
                         "idle_timeout", "upstream_error", "drain")

# The router's per-model relay counters: router_<kind>_total{model=}
# (requests admitted, transport-failure retries, hedges, 504s at the
# router, committed streams relayed). Its sheds count in the breaker's
# breaker_shed_total{model=}.
ROUTER_COUNTERS = ("requests", "retries", "hedges", "timeouts", "streams")


class Metrics:
    """Registry of all server metrics, one per server process, and the span
    ring (``tracer``)."""

    def __init__(self, trace_capacity: int = 65536,
                 exemplars: bool = True) -> None:
        self._lock = new_lock("obs.Metrics")
        self._histograms: dict[str, Histogram] = {}
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        # [trace] exemplars: histograms keep per-bucket trace-id exemplars,
        # rendered in OpenMetrics exemplar syntax on /metrics.
        self.exemplars = exemplars
        self.tracer = Tracer(trace_capacity)
        self.started_at = time.time()

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, exemplars=self.exemplars)
            return h

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def counter_values(self) -> dict[str, float]:
        """Plain name -> value snapshot of every counter."""
        with self._lock:
            counters = list(self._counters.items())
        return {name: c.value for name, c in counters}

    def cache_counter(self, model: str, event: str) -> Counter:
        """cache_<event>_total{model=}: one of CACHE_EVENTS. Prebound by
        ModelCache at construction; never call this per request."""
        return self.counter(f"cache_{event}_total{{model={model}}}")

    def worker_up_gauge(self, worker: int) -> Gauge:
        """worker_up{worker=}: 1 while the supervised worker process is alive
        and passing health probes, 0 while dead, respawning or unhealthy
        (tpuserve_torch.workerproc.supervisor). Prebound per slot."""
        return self.gauge(f"worker_up{{worker={worker}}}")

    def worker_respawns_counter(self, worker: int) -> Counter:
        """worker_respawns_total{worker=}: times the supervisor respawned
        this worker slot after its process died (SIGKILL, crash, OOM)."""
        return self.counter(f"worker_respawns_total{{worker={worker}}}")

    def worker_backoff_gauge(self, worker: int) -> Gauge:
        """worker_backoff_s{worker=}: the exponential respawn delay applied
        to this slot's latest respawn (0 once it is back up)."""
        return self.gauge(f"worker_backoff_s{{worker={worker}}}")

    def worker_inflight_gauge(self, worker: int) -> Gauge:
        """worker_inflight{worker=}: relayed requests in flight on one worker
        (the router's least-loaded pick reads the same count)."""
        return self.gauge(f"worker_inflight{{worker={worker}}}")

    def host_up_gauge(self, host: int) -> Gauge:
        """host_up{host=}: 1 while the host agent process (one whole failure
        domain: the agent and its workers) is alive
        (tpuserve_torch.workerproc.hosts). Prebound per host."""
        return self.gauge(f"host_up{{host={host}}}")

    def host_respawns_counter(self, host: int) -> Counter:
        """host_respawns_total{host=}: times the router respawned this whole
        host (agent and workers) after its agent died."""
        return self.counter(f"host_respawns_total{{host={host}}}")

    def host_backoff_gauge(self, host: int) -> Gauge:
        """host_backoff_s{host=}: the exponential respawn delay applied to
        the host slot's latest respawn (0 once the domain is back up)."""
        return self.gauge(f"host_backoff_s{{host={host}}}")

    def host_breaker_gauge(self, host: int) -> Gauge:
        """host_breaker_open{host=}: 1 while consecutive relay transport
        failures have tripped the host breaker and picks shed around the
        whole domain; 0 when closed."""
        return self.gauge(f"host_breaker_open{{host={host}}}")

    def router_up_gauge(self, router: int) -> Gauge:
        """router_up{router=}: 1 while the supervised peer router process is
        alive and in the consistent-hash ring
        (tpuserve_torch.workerproc.peers). Emitted by the primary router."""
        return self.gauge(f"router_up{{router={router}}}")

    def router_respawns_counter(self, router: int) -> Counter:
        """router_respawns_total{router=}: times the primary respawned a dead
        peer router process (its cache shard rejoins the ring on boot)."""
        return self.counter(f"router_respawns_total{{router={router}}}")

    def router_counter(self, model: str, kind: str) -> Counter:
        """router_<kind>_total{model=}, ``kind`` one of ROUTER_COUNTERS.
        Prebound per model by the router."""
        if kind not in ROUTER_COUNTERS:
            raise ValueError(f"unknown router counter {kind!r}")
        return self.counter(f"router_{kind}_total{{model={model}}}")

    def router_stream_terminated_counter(self, model: str, reason: str) -> Counter:
        """router_stream_terminated_total{model=,reason=}: how a relayed
        stream ended; ``reason`` must be one of ROUTER_STREAM_REASONS (an
        off-list reason raises instead of minting a new label)."""
        if reason not in ROUTER_STREAM_REASONS:
            raise ValueError(f"unknown stream-termination reason {reason!r} "
                             "(add it to obs.ROUTER_STREAM_REASONS)")
        return self.counter(
            f"router_stream_terminated_total{{model={model},reason={reason}}}")

    def ingest_requests_counter(self, loop_index: int) -> Counter:
        """ingest_requests_total{loop=}: predict requests read by one accept
        loop (0 = the main serving loop, 1..N-1 the ingest threads)."""
        return self.counter(f"ingest_requests_total{{loop={loop_index}}}")

    def ingest_bytes_counter(self, loop_index: int) -> Counter:
        """ingest_bytes_total{loop=}: request-body bytes read by one accept
        loop."""
        return self.counter(f"ingest_bytes_total{{loop={loop_index}}}")

    def device_seconds_counter(self, model: str, replica: int) -> Counter:
        """device_seconds_total{model=,replica=}: cumulative seconds of the
        batcher's compute phase (dispatch to ready, host wall time) on one
        device; the sampler derives device_utilization from its rate.
        Prebound at batcher start; never call per batch."""
        return self.counter(
            f"device_seconds_total{{model={model},replica={replica}}}")

    def queue_wait_histogram(self, model: str, priority: str) -> Histogram:
        """queue_wait_ms{model=,priority=}: time a request spent queued
        before its batch flushed (or its generation slot admitted it), by
        priority class (PRIORITIES). Prebound at batcher/engine start —
        never call per request."""
        return self.histogram(
            f"queue_wait_ms{{model={model},priority={priority}}}")

    def sched_shed_counter(self, model: str, reason: str) -> Counter:
        """sched_sheds_total{model=,reason=}: requests refused at admission,
        by reason (SCHED_SHED_REASONS). Prebound — never call per
        request."""
        return self.counter(
            f"sched_sheds_total{{model={model},reason={reason}}}")

    def sched_device_seconds_counter(self, model: str) -> Counter:
        """sched_device_seconds_total{model=}: device-section seconds this
        model's dispatches consumed (batch compute phases, generation
        steps): the fleet scheduler's device-time ledger, monotonic."""
        return self.counter(f"sched_device_seconds_total{{model={model}}}")

    def tenant_requests_counter(self, tenant: str) -> Counter:
        """tenant_requests_total{tenant=}: predict requests admitted for one
        tenant. Prebound by the tenant ledger."""
        return self.counter(f"tenant_requests_total{{tenant={tenant}}}")

    def tenant_shed_counter(self, tenant: str, reason: str) -> Counter:
        """tenant_sheds_total{tenant=,reason=}: requests refused at the
        tenant front door, by reason (TENANT_SHED_REASONS)."""
        return self.counter(
            f"tenant_sheds_total{{tenant={tenant},reason={reason}}}")

    def tenant_device_seconds_counter(self, tenant: str) -> Counter:
        """tenant_device_seconds_total{tenant=}: the device-time proxy one
        tenant consumed (its windowed form drives quota and fair share)."""
        return self.counter(
            f"tenant_device_seconds_total{{tenant={tenant}}}")

    def tenant_latency_histogram(self, tenant: str) -> Histogram:
        """tenant_latency_ms{tenant=}: end-to-end predict latency per tenant
        (what the per-tenant SLO burn engine reads)."""
        return self.histogram(f"tenant_latency_ms{{tenant={tenant}}}")

    def autopilot_action_counter(self, kind: str, outcome: str) -> Counter:
        """autopilot_actions_total{kind=,outcome=}: fleet-controller
        decisions by action kind and outcome (ok/error/rollback)."""
        return self.counter(
            f"autopilot_actions_total{{kind={kind},outcome={outcome}}}")

    def set_model_state(self, model: str, state: str) -> None:
        """model_state{model=}: the paging state as a gauge (MODEL_STATES:
        cold 0 / warming 1 / warm 2)."""
        self.gauge(f"model_state{{model={model}}}").set(MODEL_STATES[state])

    def gen_replica_steps_counter(self, model: str, replica: int) -> Counter:
        """gen_replica_steps_total{model=,replica=}: decode iterations one
        generation engine executed (one engine per runtime replica: replica
        0 alone, or a GenEngineGroup's members). Prebound at engine
        construction."""
        return self.counter(
            f"gen_replica_steps_total{{model={model},replica={replica}}}")

    def gen_replica_units_counter(self, model: str, replica: int) -> Counter:
        """gen_replica_units_total{model=,replica=}: output units (tokens)
        retired by one generation engine. Prebound at engine construction."""
        return self.counter(
            f"gen_replica_units_total{{model={model},replica={replica}}}")

    def gen_replica_active_gauge(self, model: str, replica: int) -> Gauge:
        """gen_replica_active_slots{model=,replica=}: slots currently
        generating on one engine."""
        return self.gauge(
            f"gen_replica_active_slots{{model={model},replica={replica}}}")

    def gen_replica_kv_free_gauge(self, model: str, replica: int) -> Gauge:
        """gen_replica_kv_pages_free{model=,replica=}: free KV pages in one
        engine's page pool (paged mode only)."""
        return self.gauge(
            f"gen_replica_kv_pages_free{{model={model},replica={replica}}}")

    def device_utilization_gauge(self, model: str, replica: int) -> Gauge:
        """device_utilization{model=,replica=}: the share of wall time one
        device spent in this model's compute phase over the [telemetry]
        utilization window (0 idle .. 1 saturated)."""
        return self.gauge(
            f"device_utilization{{model={model},replica={replica}}}")

    def slo_burn_gauge(self, model: str, window_s: float,
                       label: str = "model") -> Gauge:
        """slo_burn_rate{model=,window=}: the error-budget burn rate over
        one [telemetry] burn window (bad fraction / budget; 1.0 spends the
        budget exactly at the sustainable pace)."""
        return self.gauge(
            f"slo_burn_rate{{{label}={model},window={window_s:g}s}}")

    def set_slo_alert_state(self, model: str, state: str,
                            label: str = "model") -> None:
        """slo_alert_state{model=}: the /alerts state as a gauge
        (SLO_ALERT_STATES: ok 0 / pending 1 / firing 2)."""
        self.gauge(f"slo_alert_state{{{label}={model}}}").set(
            SLO_ALERT_STATES[state])

    def set_model_version(self, model: str, version: int) -> None:
        """model_version{model=}: the live weight-tree version number
        (tpuserve_torch.lifecycle). A sawtooth on a dashboard = publish
        followed by rollback."""
        self.gauge(f"model_version{{model={model}}}").set(float(version))

    def render_prometheus(self) -> str:
        """Prometheus text exposition with OpenMetrics exemplars on histogram
        bucket lines, ending with the OpenMetrics ``# EOF``."""
        lines: list[str] = []
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        typed: set[str] = set()

        def emit(name: str, kind: str, value: float) -> None:
            base, labels = _split(name)
            if base not in typed:
                typed.add(base)
                lines.append(f"# TYPE {base} {kind}")
            label_str = "{" + labels.rstrip(",") + "}" if labels else ""
            lines.append(f"{base}{label_str} {value}")

        for c in counters:
            emit(c.name, "counter", c.value)
        for g in gauges:
            emit(g.name, "gauge", g.value)
        for h in hists:
            base, labels = _split(h.name)
            if base not in typed:
                typed.add(base)
                lines.append(f"# TYPE {base} histogram")
            snap = h.snapshot()
            # `... <count> # {trace_id="..."} <value> <ts>`: the last trace
            # id observed in the bucket.
            exemplars = snap.get("exemplars") or {}

            def _ex(i: int) -> str:
                e = exemplars.get(i)
                if e is None:
                    return ""
                tid, val, ts = e
                return f' # {{trace_id="{tid}"}} {val:g} {ts:.3f}'

            acc = 0
            for i, (bound, count) in enumerate(zip(h.bounds, snap["counts"])):
                acc += count
                lines.append(f'{base}_bucket{{{labels}le="{bound:g}"}} {acc}{_ex(i)}')
            lines.append(f'{base}_bucket{{{labels}le="+Inf"}} {snap["n"]}'
                         f'{_ex(len(h.bounds))}')
            lines.append(f"{base}_sum{{{labels.rstrip(',')}}} {snap['total']}")
            lines.append(f"{base}_count{{{labels.rstrip(',')}}} {snap['n']}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def summary(self) -> dict:
        """JSON-friendly summary used by /stats."""
        out: dict = {"uptime_s": time.time() - self.started_at,
                     "counters": {}, "gauges": {}, "latency": {}}
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        for name, c in counters.items():
            out["counters"][name] = c.value
        for name, g in gauges.items():
            out["gauges"][name] = g.value
        for name, h in hists.items():
            p50, p99 = h.quantile(0.5), h.quantile(0.99)
            row = {
                "n": h.n,
                "mean_ms": (h.total / h.n) if h.n else 0.0,
                # Capped to the top bound: inf is not valid JSON.
                "p50_ms": min(p50, h.bounds[-1]),
                "p99_ms": min(p99, h.bounds[-1]),
            }
            if not (math.isfinite(p50) and math.isfinite(p99)):
                row["saturated"] = True
            out["latency"][name] = row
        return out


# /metrics content negotiation: the OpenMetrics type when the client's
# Accept asks for it, the classic text type otherwise. The body is the same
# either way (valid under both parsers).
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def exposition_content_type(accept: str | None) -> str:
    """The /metrics Content-Type for the request's Accept header."""
    if accept and "application/openmetrics-text" in accept:
        return OPENMETRICS_CONTENT_TYPE
    return PROMETHEUS_CONTENT_TYPE


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _split(name: str) -> tuple[str, str]:
    """'lat{model=x,phase=y}' -> ('lat', 'model="x",phase="y",')."""
    if "{" not in name:
        return name, ""
    base, _, rest = name.partition("{")
    rest = rest.rstrip("}")
    pairs = [p.split("=", 1) for p in rest.split(",") if p]
    labels = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return base, labels + "," if labels else ""


class phase_timer:
    """Context manager: time a phase into Metrics (+ an optional ring span)."""

    def __init__(self, metrics: Metrics, model: str, phase: str, trace: bool = False) -> None:
        self.metrics = metrics
        self.model = model
        self.phase = phase
        self.trace = trace

    def __enter__(self) -> "phase_timer":
        self.t0 = time.perf_counter()
        self.wall0 = time.time()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self.metrics.histogram(
            f"latency_ms{{model={self.model},phase={self.phase}}}").observe((t1 - self.t0) * 1e3)
        if self.trace:
            self.metrics.tracer.add(self.phase, self.wall0, self.wall0 + (t1 - self.t0),
                                    tid=self.model)


def percentile(values: Iterable[float], q: float) -> float:
    """Exact percentile of a finite sample (bench-side helper): the
    ``ceil(q * n)``-th smallest value, as the reference's."""
    vs = sorted(values)
    if not vs:
        return 0.0
    idx = min(len(vs) - 1, max(0, math.ceil(q * len(vs)) - 1))
    return vs[idx]
