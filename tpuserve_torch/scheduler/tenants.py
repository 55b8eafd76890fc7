"""Per-tenant containment: API keys, a weighted device-seconds ledger and
quota/rate/fair-share admission, ported from
``tpuserve/scheduler/tenants.py``.

The fleet scheduler keeps a sliding-window device-seconds ledger per MODEL
so one model cannot starve another. Tenancy is the same ledger grown one
dimension: every request carries an ``X-Api-Key`` resolved to a tenant, and
admission charges and enforces per TENANT —

1. **Rate** (token bucket, ``rate_per_s``/``burst``): a flood is refused at
   request granularity before it costs anything.
2. **Quota** (``quota_device_s`` per ``window_s`` sliding window): a tenant
   that spent its windowed allowance is 429'd with a Retry-After from when
   the window actually frees.
3. **Fair share** (``weight`` under fleet saturation): when the fleet is
   saturated (``saturated_fn``, threaded in by the owner) a tenant using
   more than ``share_slack`` x its weighted share of the window sheds while
   its neighbours keep flowing.

Every refusal is a :class:`tpuserve_torch.scheduler.fleet.Shed` with a
``tenant_*`` reason (obs.TENANT_SHED_REASONS). State is behind one lock: the
router admits on its event loop but charges completions from relay
callbacks, and the single-process server may run several ingest loops. The
module touches no device: the router, which never initializes CUDA,
imports it.
"""

from __future__ import annotations

import time
from collections import deque

from tpuserve_torch.batcher import clamp_retry_after_s
from tpuserve_torch.config import TenantConfig, TenantsConfig
from tpuserve_torch.obs import TENANT_SHED_REASONS, Metrics
from tpuserve_torch.scheduler.fleet import Shed
from tpuserve_torch.utils.locks import new_lock


class _TenantState:
    """One tenant's mutable ledger + token-bucket state."""

    __slots__ = ("cfg", "ledger", "window_sum", "tokens", "refilled_at",
                 "admitted_total", "requests_counter", "shed_counters",
                 "device_counter", "latency_hist", "device_seconds_total")

    def __init__(self, cfg: TenantConfig, metrics: Metrics | None) -> None:
        self.cfg = cfg
        self.ledger: deque[tuple[float, float]] = deque()
        self.window_sum = 0.0
        self.device_seconds_total = 0.0
        self.tokens = cfg.burst or max(1.0, 2.0 * cfg.rate_per_s)
        self.refilled_at = time.monotonic()
        self.admitted_total = 0
        self.requests_counter = (
            metrics.tenant_requests_counter(cfg.name)
            if metrics is not None else None)
        self.shed_counters = (
            {r: metrics.tenant_shed_counter(cfg.name, r)
             for r in TENANT_SHED_REASONS}
            if metrics is not None else None)
        self.device_counter = (
            metrics.tenant_device_seconds_counter(cfg.name)
            if metrics is not None else None)
        self.latency_hist = (
            metrics.tenant_latency_histogram(cfg.name)
            if metrics is not None else None)


class TenantLedger:
    """Resolve API keys to tenants and enforce their containment
    envelopes at admission. One instance per serving process that fronts
    clients (the router tier, or the single-process server)."""

    def __init__(self, cfg: TenantsConfig,
                 metrics: Metrics | None = None) -> None:
        self.cfg = cfg
        self.metrics = metrics
        self._lock = new_lock("scheduler.TenantLedger")
        self._by_key: dict[str, str] = {}
        self._tenants: dict[str, _TenantState] = {}
        for t in cfg.tenants:
            self._by_key[t.api_key] = t.name
            self._tenants[t.name] = _TenantState(t, metrics)
        if cfg.allow_anonymous and cfg.allow_anonymous not in self._tenants:
            # The anonymous tenant rides with default weight and no
            # quota/rate unless configured explicitly.
            anon = TenantConfig(name=cfg.allow_anonymous,
                                api_key="\0anonymous")
            self._tenants[anon.name] = _TenantState(anon, metrics)
        # Fleet-saturation signal for fair-share shedding; threaded in by
        # the owner (router: aggregate pressure; server: scheduler
        # saturated()). None = fair-share shedding never fires.
        self.saturated_fn = None
        self._unknown_counter = (
            metrics.tenant_shed_counter("unknown", "tenant_unknown")
            if metrics is not None else None)

    # -- identity -------------------------------------------------------------
    def resolve(self, api_key: str | None) -> str | None:
        """Tenant name for a presented key; the anonymous tenant when the
        key is absent/unknown and [tenants] allows it; None = reject."""
        if api_key and api_key in self._by_key:
            return self._by_key[api_key]
        if self.cfg.allow_anonymous:
            return self.cfg.allow_anonymous
        return None

    def names(self) -> list[str]:
        return sorted(self._tenants)

    def weight_of(self, tenant: str) -> float:
        st = self._tenants.get(tenant)
        return st.cfg.weight if st is not None else 1.0

    def weights(self) -> dict[str, float]:
        """Tenant -> fairness weight (the cache partitioner's input)."""
        return {n: st.cfg.weight for n, st in self._tenants.items()}

    # -- admission ------------------------------------------------------------
    def shed_unknown(self) -> Shed:
        """The refusal for a request whose key resolves to no tenant."""
        if self._unknown_counter is not None:
            self._unknown_counter.inc()
        return Shed(401, "tenant_unknown",
                    "unknown or missing API key (X-Api-Key)")

    def admit(self, tenant: str) -> Shed | None:
        """Charge one request against the tenant's envelope; a Shed means
        refuse (429 + Retry-After), None means admitted."""
        now = time.monotonic()
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                pass  # fall through to unknown below, outside the lock
            else:
                shed = self._admit_locked(st, now)
                if shed is None:
                    st.admitted_total += 1
                    if st.requests_counter is not None:
                        st.requests_counter.inc()
                elif st.shed_counters is not None:
                    st.shed_counters[shed.reason].inc()
                return shed
        return self.shed_unknown()

    def _admit_locked(self, st: _TenantState, now: float) -> Shed | None:
        cfg = st.cfg
        # 1. Rate: refill-then-spend token bucket.
        if cfg.rate_per_s > 0:
            burst = cfg.burst or max(1.0, 2.0 * cfg.rate_per_s)
            st.tokens = min(burst, st.tokens
                            + (now - st.refilled_at) * cfg.rate_per_s)
            st.refilled_at = now
            if st.tokens < 1.0:
                retry = clamp_retry_after_s((1.0 - st.tokens) / cfg.rate_per_s)
                return Shed(429, "tenant_rate_exceeded",
                            f"tenant {cfg.name!r} over {cfg.rate_per_s:g} "
                            "req/s", retry_after=retry)
            st.tokens -= 1.0
        self._prune_locked(st, now)
        # 2. Quota: windowed device-seconds allowance.
        if cfg.quota_device_s > 0 and st.window_sum >= cfg.quota_device_s:
            oldest = st.ledger[0][0] if st.ledger else now
            retry = clamp_retry_after_s(
                max(1.0, self.cfg.window_s - (now - oldest)))
            return Shed(429, "tenant_quota_exceeded",
                        f"tenant {cfg.name!r} spent its "
                        f"{cfg.quota_device_s:g} device-seconds per "
                        f"{self.cfg.window_s:g}s window", retry_after=retry)
        # 3. Fair share, only under fleet saturation.
        if self.cfg.share_slack > 0 and self.saturated_fn is not None \
                and self.saturated_fn():
            total = sum(t.window_sum for t in self._tenants.values())
            if total > 0 and st.window_sum > 0:
                total_w = sum(t.cfg.weight for t in self._tenants.values())
                fair = cfg.weight / total_w
                if st.window_sum / total > fair * self.cfg.share_slack:
                    return Shed(429, "tenant_share_exceeded",
                                f"tenant {cfg.name!r} over its weighted "
                                "fair share while the fleet is saturated",
                                retry_after=clamp_retry_after_s(1.0))
        return None

    # -- ledger ---------------------------------------------------------------
    def record(self, tenant: str, seconds: float,
               latency_ms: float | None = None) -> None:
        """Charge completed work (a device-time proxy in seconds) and
        optionally the observed latency to the tenant's ledger."""
        if seconds < 0:
            seconds = 0.0
        now = time.monotonic()
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return
            st.ledger.append((now, seconds))
            st.window_sum += seconds
            st.device_seconds_total += seconds
            self._prune_locked(st, now)
        if st.device_counter is not None and seconds > 0:
            st.device_counter.inc(seconds)
        if st.latency_hist is not None and latency_ms is not None:
            st.latency_hist.observe(latency_ms)

    def _prune_locked(self, st: _TenantState, now: float) -> None:
        cutoff = now - self.cfg.window_s
        while st.ledger and st.ledger[0][0] < cutoff:
            _, s = st.ledger.popleft()
            st.window_sum -= s
        if not st.ledger:
            st.window_sum = 0.0

    # -- reads ----------------------------------------------------------------
    def usage(self) -> dict:
        """The /tenants body: per-tenant envelope + live window usage."""
        now = time.monotonic()
        rows = {}
        with self._lock:
            for name, st in sorted(self._tenants.items()):
                self._prune_locked(st, now)
                cfg = st.cfg
                rows[name] = {
                    "weight": cfg.weight,
                    "quota_device_s": cfg.quota_device_s,
                    "rate_per_s": cfg.rate_per_s,
                    "window_device_s": round(st.window_sum, 4),
                    "device_seconds_total": round(
                        st.device_seconds_total, 4),
                    "admitted_total": st.admitted_total,
                }
        return {"enabled": self.cfg.enabled,
                "window_s": self.cfg.window_s,
                "share_slack": self.cfg.share_slack,
                "tenants": rows}
