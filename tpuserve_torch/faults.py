"""Deterministic fault injection, ported from ``tpuserve/faults.py``
(``FaultInjected`` and ``FaultInjector``).

Rules (``[[faults.rule]]`` in TOML, ``FaultRuleConfig``) name a *kind* — a
call site on the serving path — plus model, probability and count, and draw
from rule-local seeded ``random.Random``s seeded exactly as the reference's,
so one config fires the same sequence in both packages. The port's call
sites: the runtime's ``dispatch`` (``device_error``, ``slow_compute``), its
``stage_params`` gates (``reload_corrupt``, ``reload_nan``), the lifecycle's
staged canary (``reload_regressed``) and the server (``decode_corrupt``,
``canary_fail``). Kinds whose call sites the port lacks are refused when the
config loads (``tpuserve_torch.config``). The reference's CircuitBreaker,
Watchdog and chaos runner are not ported (ROADMAP.md queue 1, "Batcher
robustness").
"""

from __future__ import annotations

import random
import time

from tpuserve_torch.config import FaultRuleConfig, FaultsConfig
from tpuserve_torch.obs import Metrics
from tpuserve_torch.utils.locks import new_lock


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

    def fire(self, kind: str, model: str) -> FaultRuleConfig | None:
        """First matching armed rule that draws true, or None."""
        if not self.cfg.enabled:
            return None
        with self._lock:
            alive_s = time.monotonic() - self._born
            for rule in self._rules:
                if rule.cfg.after_s > 0 and alive_s < rule.cfg.after_s:
                    continue
                if rule.cfg.worker >= 0:
                    # Pinned to a worker process; the port serves in one
                    # process, which has no worker id (the reference's
                    # single-process server matches none either).
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
