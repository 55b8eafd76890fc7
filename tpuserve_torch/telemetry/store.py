"""Time-series store + background sampler, copied from
``tpuserve/telemetry/store.py``.

Every counter, gauge and histogram in the process's ``Metrics`` registry is
snapshotted into a bounded per-metric ring every ``[telemetry]
sample_interval_s``. ``GET /stats/history?metric=&window_s=`` serves the raw
samples plus derived counter rates and histogram window-delta quantiles
(the p50/p99 of exactly the requests inside the window), and the SLO engine
(``tpuserve_torch.telemetry.slo``) reads the same rings.

Counter resets: a sampled value below its predecessor means the counter
restarted from 0, so the increase over that step is the new value itself,
never a negative rate; the same rule holds per histogram bucket.

Threading: the sampler is a daemon thread (it ticks while the event loop is
busy); metric snapshots are collected before the store's lock is taken, so
the registry's locks and the store's never nest.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque

from tpuserve_torch.obs import Metrics, _split
from tpuserve_torch.utils.locks import new_lock

log = logging.getLogger("tpuserve_torch.telemetry")

# Hard cap on ring capacity per metric: history_s / sample_interval_s can
# be misconfigured into the millions; 4096 samples is > an hour at 1 s.
MAX_RING = 4096


class _Series:
    """One metric's bounded ring of (t, value) samples.

    ``kind`` is "counter" / "gauge" / "histogram". Counter and gauge
    samples are floats; histogram samples are ``(n, total, counts)`` with
    ``counts`` the cumulative-per-bucket tuple from ``Histogram.snapshot``
    (bucket bounds are process-wide constants, so only counts are kept).
    """

    __slots__ = ("kind", "samples")

    def __init__(self, kind: str, capacity: int) -> None:
        self.kind = kind
        self.samples: deque = deque(maxlen=capacity)


def _increase(prev: float, cur: float) -> float:
    """Monotonic increase across one sample step, reset-aware: a drop
    means the source process restarted and the counter began again at 0,
    so the increase is the new value — never negative."""
    if cur >= prev:
        return cur - prev
    return cur


def quantile_from_counts(bounds: list[float], counts: list[float],
                         q: float) -> float | None:
    """Interpolated quantile over one window's per-bucket DELTA counts
    (the histogram_quantile rule, same math as obs.Histogram.quantile but
    over a delta instead of the lifetime counts). None on an empty window;
    inf when the rank lands in the overflow bucket."""
    n = sum(counts)
    if n <= 0:
        return None
    rank = math.ceil(q * n)
    acc = 0.0
    for i, c in enumerate(counts):
        prev_acc = acc
        acc += c
        if acc >= rank and c > 0:
            if i == len(bounds):
                return float("inf")
            lo = bounds[i - 1] if i > 0 else 0.0
            return lo + (bounds[i] - lo) * (rank - prev_acc) / c
    return bounds[-1]


class TimeSeriesStore:
    """Bounded per-metric history over one ``Metrics`` registry."""

    def __init__(self, metrics: Metrics, capacity: int = 600) -> None:
        self.metrics = metrics
        self.capacity = max(2, min(MAX_RING, int(capacity)))
        self._series: dict[str, _Series] = {}
        self._lock = new_lock("telemetry.TimeSeriesStore")
        self.samples_total = 0
        self.last_sample_at: float | None = None
        # Histogram bucket bounds are shared process-wide (obs module
        # default); captured from the first histogram seen.
        self._bounds: list[float] | None = None

    # -- sampling ------------------------------------------------------------
    def sample(self, now: float | None = None) -> None:
        """Snapshot every registered metric into its ring (one tick).

        Registry + per-histogram locks are taken during collection, the
        store lock only afterwards — no nesting between the two families.
        """
        now = time.time() if now is None else now
        with self.metrics._lock:
            counters = list(self.metrics._counters.values())
            gauges = list(self.metrics._gauges.values())
            hists = list(self.metrics._histograms.values())
        rows: list[tuple[str, str, object]] = []
        rows.extend(("counter", c.name, c.value) for c in counters)
        rows.extend(("gauge", g.name, g.value) for g in gauges)
        for h in hists:
            snap = h.snapshot()
            if self._bounds is None:
                self._bounds = list(h.bounds)
            rows.append(("histogram", h.name,
                         (snap["n"], snap["total"], tuple(snap["counts"]))))
        with self._lock:
            for kind, name, value in rows:
                s = self._series.get(name)
                if s is None:
                    s = self._series[name] = _Series(kind, self.capacity)
                s.samples.append((now, value))
            self.samples_total += 1
            self.last_sample_at = now

    # -- reads ---------------------------------------------------------------
    def metric_names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def _window(self, s: _Series, window_s: float | None,
                now: float) -> list[tuple]:
        if window_s is None:
            return list(s.samples)
        horizon = now - window_s
        samples = list(s.samples)
        # Keep the last pre-window sample too: a delta over the window
        # needs the value at its left edge, not just inside it.
        start = 0
        for i, (t, _) in enumerate(samples):
            if t >= horizon:
                start = max(0, i - 1)
                break
        else:
            start = max(0, len(samples) - 1)
        return samples[start:]

    def counter_increase(self, metric: str, window_s: float | None = None,
                         now: float | None = None) -> float | None:
        """Reset-safe increase of one counter over the window (None when
        the series is unknown or has < 2 samples)."""
        now = time.time() if now is None else now
        with self._lock:
            s = self._series.get(metric)
            if s is None or s.kind != "counter":
                return None
            samples = self._window(s, window_s, now)
        if len(samples) < 2:
            return None
        return sum(_increase(samples[i][1], samples[i + 1][1])
                   for i in range(len(samples) - 1))

    def histogram_delta(self, metric: str, window_s: float | None = None,
                        now: float | None = None) -> dict | None:
        """One histogram's window delta: n / total / per-bucket counts,
        reset-safe per bucket. None when unknown or < 2 samples."""
        now = time.time() if now is None else now
        with self._lock:
            s = self._series.get(metric)
            if s is None or s.kind != "histogram":
                return None
            samples = self._window(s, window_s, now)
        if len(samples) < 2:
            return None
        nb = len(samples[0][1][2])
        d_counts = [0.0] * nb
        d_n = 0.0
        d_total = 0.0
        for i in range(len(samples) - 1):
            (_, (n0, tot0, c0)), (_, (n1, tot1, c1)) = \
                samples[i], samples[i + 1]
            reset = n1 < n0
            d_n += n1 if reset else n1 - n0
            d_total += tot1 if reset else tot1 - tot0
            for j in range(nb):
                d_counts[j] += c1[j] if reset else _increase(c0[j], c1[j])
        return {"n": d_n, "total": d_total, "counts": d_counts,
                "span_s": samples[-1][0] - samples[0][0]}

    def history(self, metric: str,
                window_s: float | None = None) -> dict | None:
        """The /stats/history body for one series: raw samples plus the
        derived view — counters get per-step and window rates, histograms
        get window-delta count/mean/p50/p99. None for an unknown metric."""
        now = time.time()
        with self._lock:
            s = self._series.get(metric)
            if s is None:
                return None
            kind = s.kind
            samples = self._window(s, window_s, now)
        out: dict = {"metric": metric, "kind": kind,
                     "window_s": window_s, "n_samples": len(samples)}
        if kind in ("counter", "gauge"):
            out["t"] = [round(t, 3) for t, _ in samples]
            out["v"] = [v for _, v in samples]
            if kind == "counter" and len(samples) >= 2:
                rates = []
                for i in range(len(samples) - 1):
                    dt = samples[i + 1][0] - samples[i][0]
                    inc = _increase(samples[i][1], samples[i + 1][1])
                    rates.append(round(inc / dt, 6) if dt > 0 else 0.0)
                out["rate_per_s"] = rates
                span = samples[-1][0] - samples[0][0]
                inc = sum(_increase(samples[i][1], samples[i + 1][1])
                          for i in range(len(samples) - 1))
                out["increase"] = inc
                out["window_rate_per_s"] = \
                    round(inc / span, 6) if span > 0 else 0.0
        else:
            out["t"] = [round(t, 3) for t, _ in samples]
            out["n"] = [v[0] for _, v in samples]
            delta = self.histogram_delta(metric, window_s, now)
            if delta is not None:
                bounds = self._bounds or []
                p50 = quantile_from_counts(bounds, delta["counts"], 0.5)
                p99 = quantile_from_counts(bounds, delta["counts"], 0.99)
                out["delta"] = {
                    "n": delta["n"],
                    "mean_ms": (delta["total"] / delta["n"])
                    if delta["n"] else 0.0,
                    "p50_ms": p50 if p50 is None or math.isfinite(p50)
                    else (bounds[-1] if bounds else None),
                    "p99_ms": p99 if p99 is None or math.isfinite(p99)
                    else (bounds[-1] if bounds else None),
                    "rate_per_s": round(delta["n"] / delta["span_s"], 6)
                    if delta["span_s"] > 0 else 0.0,
                }
        return out

    def match(self, metric: str) -> list[str]:
        """Series whose full name OR base name (labels stripped) equals
        ``metric`` — `?metric=requests_total` pulls every model's series
        without spelling the labels."""
        with self._lock:
            names = list(self._series)
        if metric in names:
            return [metric]
        return [n for n in names if _split(n)[0] == metric]

    def stats(self) -> dict:
        """The /stats ``telemetry`` block: sampler heartbeat + occupancy."""
        with self._lock:
            n = len(self._series)
        return {
            "series": n,
            "capacity": self.capacity,
            "samples_total": self.samples_total,
            "last_sample_age_s": round(time.time() - self.last_sample_at, 3)
            if self.last_sample_at is not None else None,
        }


class MetricSampler(threading.Thread):
    """The background sampling thread: ticks the store every
    ``interval_s`` and then runs each hook (SLO evaluation, utilization
    derivation) on the fresh sample. Daemon + event-signalled stop so a
    drain always gets a prompt, clean shutdown (no dangling thread)."""

    def __init__(self, store: TimeSeriesStore, interval_s: float,
                 hooks: "list | None" = None) -> None:
        super().__init__(name="tpuserve-torch-telemetry", daemon=True)
        self.store = store
        self.interval_s = max(0.01, float(interval_s))
        self.hooks = list(hooks or [])
        self._stop_ev = threading.Event()
        self.ticks = self.store.metrics.counter("telemetry_samples_total")

    def run(self) -> None:
        while not self._stop_ev.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # one bad tick must not end sampling
                log.exception("telemetry sample tick failed")

    def tick(self) -> None:
        """One sample + hook pass (callable directly from tests)."""
        self.store.sample()
        self.ticks.inc()
        for hook in self.hooks:
            hook()

    def stop(self, timeout: float = 5.0) -> None:
        """Signal and join (idempotent; called from drain AND stop)."""
        self._stop_ev.set()
        if self.is_alive():
            self.join(timeout)
