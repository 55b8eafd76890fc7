"""SLO burn-rate engine + device-utilization derivation, copied from
``tpuserve/telemetry/slo.py``.

**Burn rates** (the multi-window form). Each ``[model.slo]`` block names a
latency objective (ms) and an availability target; the error budget is
``1 - availability``. Per ``[telemetry] burn_windows_s`` window the engine
takes the window delta of the model's latency histogram from the
time-series store, computes the bad fraction (requests over the objective,
interpolated inside the objective's bucket) and divides by the budget:

    burn = bad_fraction / (1 - availability)

**firing** when the burn exceeds the model's ``burn_alert`` over both the
short and the mid window, **pending** on the short window alone, **ok**
otherwise. Exported as ``slo_burn_rate{model=,window=}`` and
``slo_alert_state{model=}`` gauges and the ``/alerts`` endpoint.

**Utilization**. ``device_seconds_total{model=,replica=}`` (the batcher's
compute phase, host wall time) over wall time in ``utilization_window_s``
is the device's busy share: ``device_utilization{model=,replica=}``.
"""

from __future__ import annotations

import re
import time

from tpuserve_torch.obs import SLO_ALERT_STATES, Metrics
from tpuserve_torch.telemetry.store import TimeSeriesStore
from tpuserve_torch.utils.locks import new_lock

OK, PENDING, FIRING = "ok", "pending", "firing"
assert set((OK, PENDING, FIRING)) == set(SLO_ALERT_STATES)


def good_fraction(bounds: list[float], counts: list[float],
                  objective_ms: float) -> float | None:
    """Fraction of a window delta's requests at or under the objective,
    linearly interpolated inside the bucket containing it. None on an
    empty window (no evidence — the alert machine holds its state)."""
    n = sum(counts)
    if n <= 0:
        return None
    good = 0.0
    lo = 0.0
    for i, b in enumerate(bounds):
        c = counts[i]
        if objective_ms >= b:
            good += c
        else:
            if b > lo:
                good += c * max(0.0, (objective_ms - lo) / (b - lo))
            break
        lo = b
    return min(1.0, good / n)


class _ModelSlo:
    """One model's objective + live evaluation state."""

    __slots__ = ("name", "slo", "metric", "burn_gauges", "state", "since")

    def __init__(self, name: str, slo, metric: str, metrics: Metrics,
                 windows: list[float], label: str = "model") -> None:
        self.name = name
        self.slo = slo
        self.metric = metric
        self.burn_gauges = {w: metrics.slo_burn_gauge(name, w, label=label)
                            for w in windows}
        self.state = OK
        self.since = time.time()


class SloEngine:
    """Multi-window burn-rate evaluation over the time-series store.

    One instance per process, evaluating ``latency_ms{model=,phase=total}``
    (what the model served). ``tick()`` runs on the sampler thread,
    ``alerts()`` on HTTP handlers; state is behind one short lock."""

    def __init__(self, metrics: Metrics, store: TimeSeriesStore,
                 windows: list[float],
                 metric_fmt: str = "latency_ms{{model={name},phase=total}}",
                 label: str = "model") -> None:
        self.metrics = metrics
        self.store = store
        self.windows = list(windows)
        self.metric_fmt = metric_fmt
        # Subject dimension of the exported gauges ("model").
        self.label = label
        self._models: dict[str, _ModelSlo] = {}
        self._lock = new_lock("telemetry.SloEngine")

    def register(self, name: str, slo, metric: str | None = None) -> bool:
        """Track one model's [model.slo] block; False when it is disabled
        (latency_ms = 0). ``metric`` overrides the engine's metric_fmt: the
        first-unit objective registers "<model>:first_unit" over
        ``gen_first_unit_ms{model=}`` this way."""
        if slo is None or slo.latency_ms <= 0:
            return False
        m = _ModelSlo(name, slo,
                      metric or self.metric_fmt.format(name=name),
                      self.metrics, self.windows, label=self.label)
        with self._lock:
            self._models[name] = m
        self.metrics.set_slo_alert_state(name, OK, label=self.label)
        return True

    # -- evaluation (sampler thread) -----------------------------------------
    def burn_rates(self, name: str) -> dict[float, float | None]:
        """Current burn per window for one registered model (None = no
        evidence in that window)."""
        with self._lock:
            m = self._models[name]
        budget = 1.0 - m.slo.availability
        out: dict[float, float | None] = {}
        for w in self.windows:
            delta = self.store.histogram_delta(m.metric, w)
            if delta is None:
                out[w] = None
                continue
            good = good_fraction(self.store._bounds or [], delta["counts"],
                                 m.slo.latency_ms)
            out[w] = None if good is None else (1.0 - good) / budget
        return out

    def tick(self) -> None:
        """One evaluation pass (a sampler hook): refresh every model's
        burn gauges and step its alert state machine."""
        with self._lock:
            names = list(self._models)
        for name in names:
            burns = self.burn_rates(name)
            with self._lock:
                m = self._models[name]
                for w, b in burns.items():
                    m.burn_gauges[w].set(b if b is not None else 0.0)
                short, mid = self.windows[0], self.windows[1]
                over_short = (burns[short] or 0.0) > m.slo.burn_alert
                over_mid = (burns[mid] or 0.0) > m.slo.burn_alert
                new_state = (FIRING if over_short and over_mid
                             else PENDING if over_short else OK)
                if new_state != m.state:
                    m.state = new_state
                    m.since = time.time()
            self.metrics.set_slo_alert_state(name, new_state,
                                             label=self.label)

    # -- reads (HTTP) --------------------------------------------------------
    def state_of(self, name: str) -> str:
        """The model's alert state (OK when the model has no SLO
        registered)."""
        with self._lock:
            m = self._models.get(name)
            return m.state if m is not None else OK

    def alerts(self) -> dict:
        """The /alerts body: per-model state + live burn per window."""
        with self._lock:
            models = list(self._models.items())
        rows = {}
        worst = OK
        order = [OK, PENDING, FIRING]
        for name, m in models:
            burns = self.burn_rates(name)
            with self._lock:
                state, since = m.state, m.since
            if order.index(state) > order.index(worst):
                worst = state
            rows[name] = {
                "state": state,
                "since": round(since, 3),
                "objective_latency_ms": m.slo.latency_ms,
                "availability": m.slo.availability,
                "error_budget": round(1.0 - m.slo.availability, 6),
                "burn_alert": m.slo.burn_alert,
                "burn": {f"{w:g}s": (round(b, 3) if b is not None else None)
                         for w, b in burns.items()},
                "metric": m.metric,
            }
        return {"status": worst, "windows_s": self.windows, "models": rows}


# -- device utilization -------------------------------------------------------

_DEVSEC_RE = re.compile(
    r"^device_seconds_total\{model=([^,}]+),replica=(\d+)\}$")


class UtilizationDeriver:
    """Sampler hook turning ``device_seconds_total{model=,replica=}``
    counter rates into ``device_utilization{model=,replica=}`` gauges:
    seconds of device time per second of wall time on one device is that
    device's busy fraction for the model. Gauges are created as the
    counters appear (replica sets are static after start)."""

    def __init__(self, metrics: Metrics, store: TimeSeriesStore,
                 window_s: float) -> None:
        self.metrics = metrics
        self.store = store
        self.window_s = window_s
        self._gauges: dict[tuple[str, int], object] = {}

    def tick(self) -> None:
        for name in self.store.metric_names():
            match = _DEVSEC_RE.match(name)
            if match is None:
                continue
            model, replica = match.group(1), int(match.group(2))
            h = self.store.history(name, self.window_s)
            if h is None or "window_rate_per_s" not in h:
                continue
            g = self._gauges.get((model, replica))
            if g is None:
                g = self._gauges[(model, replica)] = \
                    self.metrics.device_utilization_gauge(model, replica)
            # rate of a seconds-counter is dimensionless busy fraction;
            # clamp: sampling jitter can push a saturated device past 1.0.
            g.set(min(1.0, max(0.0, h["window_rate_per_s"])))

    def stats(self) -> dict:
        """The /stats ``utilization`` block: per model, per-replica busy
        fractions plus the lifetime device-seconds ledger."""
        out: dict[str, dict] = {}
        for (model, replica), g in sorted(self._gauges.items()):
            row = out.setdefault(model, {"per_replica": {},
                                         "device_seconds_total": 0.0})
            row["per_replica"][str(replica)] = round(g.value, 4)
        for name in self.store.metric_names():
            match = _DEVSEC_RE.match(name)
            if match is None:
                continue
            hist = self.store.history(name)
            if hist is None or not hist.get("v"):
                continue
            row = out.get(match.group(1))
            if row is not None:
                row["device_seconds_total"] = round(
                    row["device_seconds_total"] + hist["v"][-1], 4)
        for row in out.values():
            vals = list(row["per_replica"].values())
            row["mean_utilization"] = round(sum(vals) / len(vals), 4) \
                if vals else 0.0
        return out
