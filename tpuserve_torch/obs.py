"""Observability for the port: counters, gauges, latency histograms and the
Prometheus exposition, ported from ``tpuserve/obs.py``.

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
``watchdog_restarts_total{model=,component=}`` and the result cache's
``cache_<event>_total{model=}`` (``CACHE_EVENTS``) and
``cache_entries{model=}``.

Not ported yet (ROADMAP.md queue 1, "Observability and analysis"): request
trace contexts, the flight recorder, the span ring and histogram exemplars.
"""

from __future__ import annotations

import bisect
import math
import time

from tpuserve_torch.utils.locks import new_lock


def _default_latency_buckets() -> list[float]:
    # Log-linear: 9 linear sub-buckets per decade, 0.1 ms .. 100 s (the JAX
    # package's bounds, so quantiles read the same on both servers).
    return [m * (10.0**d) for d in range(-1, 5) for m in range(1, 10)] + [1e5]


class Histogram:
    """Fixed-bucket histogram (milliseconds by default)."""

    def __init__(self, name: str, buckets: list[float] | None = None) -> None:
        self.name = name
        self.bounds = buckets or _default_latency_buckets()
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.n = 0
        self._lock = new_lock("obs.Histogram")

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)  # first bound >= value
        with self._lock:
            self.counts[i] += 1
            self.total += value
            self.n += 1

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
            return {"n": self.n, "total": self.total, "counts": list(self.counts)}


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

# Result-cache events (tpuserve_torch.cache), the cache_<event>_total{model=}
# counters: "hits" answer from the cache, "misses" lead a real batch
# submission, "coalesced" join an identical in-flight miss (single-flight),
# "evictions" are LRU drops and "stale_drops" flights that completed after
# a mid-flight version change (served to their waiters, never cached).
CACHE_EVENTS = ("hits", "misses", "coalesced", "evictions", "stale_drops")

# Host-pipeline stage executors (tpuserve_torch.hostpipe): one thread pool
# per stage, labelled on pipeline_stage_depth{model=,stage=}.
PIPELINE_STAGES = ("assemble", "h2d", "fetch", "postproc")


class Metrics:
    """Registry of all server metrics. One instance per server process."""

    def __init__(self) -> None:
        self._lock = new_lock("obs.Metrics")
        self._histograms: dict[str, Histogram] = {}
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self.started_at = time.time()

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
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

    def cache_counter(self, model: str, event: str) -> Counter:
        """cache_<event>_total{model=}: one of CACHE_EVENTS. Prebound by
        ModelCache at construction; never call this per request."""
        return self.counter(f"cache_{event}_total{{model={model}}}")

    def ingest_requests_counter(self, loop_index: int) -> Counter:
        """ingest_requests_total{loop=}: predict requests read by one accept
        loop (0 = the main serving loop, 1..N-1 the ingest threads)."""
        return self.counter(f"ingest_requests_total{{loop={loop_index}}}")

    def ingest_bytes_counter(self, loop_index: int) -> Counter:
        """ingest_bytes_total{loop=}: request-body bytes read by one accept
        loop."""
        return self.counter(f"ingest_bytes_total{{loop={loop_index}}}")

    def set_model_version(self, model: str, version: int) -> None:
        """model_version{model=}: the live weight-tree version number
        (tpuserve_torch.lifecycle). A sawtooth on a dashboard = publish
        followed by rollback."""
        self.gauge(f"model_version{{model={model}}}").set(float(version))

    def render_prometheus(self) -> str:
        """Prometheus text exposition, ending with the OpenMetrics ``# EOF``."""
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
            acc = 0
            for bound, count in zip(h.bounds, snap["counts"]):
                acc += count
                lines.append(f'{base}_bucket{{{labels}le="{bound:g}"}} {acc}')
            lines.append(f'{base}_bucket{{{labels}le="+Inf"}} {snap["n"]}')
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


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


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
