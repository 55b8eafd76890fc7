"""The self-healing fleet controller, ported from
``tpuserve/scheduler/autopilot.py``.

Every control signal the fleet emits — SLO burn state per model
(tpuserve_torch.telemetry.slo), queue pressure per host domain, predicted
queue-clear time — and every actuator an operator has — scale a host
domain's worker slots, engage shed-on-burn, warm/demote a model — already
exists. This module closes the loop: a reconcile tick reads the signals and
acts through the same audited verbs a human would use, so the audit trail
reads the same whether a person or the controller turned the knob.

Decision is split from actuation:

- :class:`AutopilotPolicy` is a PURE function of (:class:`Signals`, its own
  bounded memory): signals in, actions out. All time comes from
  ``Signals.now`` — no clocks, no I/O — so the damping (hysteresis, per-knob
  cooldowns, the windowed action budget, rollback-on-worse) is
  table-testable without a server.
- :class:`AutopilotLoop` owns the asyncio tick: collect signals, run the
  policy, actuate, audit every decision with the triggering signal values,
  and keep a bounded decision history for ``/debug/autopilot``.

Damping, because a controller that flaps is worse than none:

- **Hysteresis**: a trigger must hold ``hysteresis_ticks`` consecutive
  ticks before it acts.
- **Cooldown**: the same (action kind, target) pair is untouchable for
  ``cooldown_s`` after an action (rollbacks are exempt).
- **Budget**: at most ``max_actions_per_window`` non-rollback actions per
  ``window_s``.
- **Rollback**: every action opens a follow-up watch holding the objective
  it was to improve; ``follow_up_s`` later an action that made it worse by
  more than ``rollback_tolerance`` is inverted and audited as a rollback.

The module touches no device: the primary router, which never initializes
CUDA, runs it.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass, field

from tpuserve_torch.config import AutopilotConfig

log = logging.getLogger("tpuserve_torch.autopilot")

# Action kinds and their inverses (the rollback map).
INVERSE = {
    "scale_up": "scale_down",
    "scale_down": "scale_up",
    "shed_on": "shed_off",
    "shed_off": "shed_on",
    "warm": "demote",
    "demote": "warm",
}

_BURN_SCORE = {"ok": 0.0, "pending": 1.0, "firing": 2.0}


@dataclass
class DomainSignal:
    """One host failure domain as the controller sees it."""

    hid: int
    up: bool = True
    # Active worker slots vs the domain's configured ceiling.
    active: int = 1
    max_slots: int = 1
    healthy: int = 1
    # Mean in-flight relays per active healthy slot — the queue-pressure
    # signal scale decisions read.
    pressure: float = 0.0


@dataclass
class ModelSignal:
    """One model as the controller sees it."""

    name: str
    # SLO burn alert state: ok / pending / firing (telemetry.slo).
    burn_state: str = "ok"
    # Is shed-on-burn currently engaged for this model?
    shed_engaged: bool = False
    # Paging state (scheduler warm/cold); warm=True for unpaged models.
    warm: bool = True
    # Collector verdicts for the paging actuator: demand exists for a
    # cold model / a warm model has been idle past the demote threshold.
    wants_warm: bool = False
    idle: bool = False


@dataclass
class Signals:
    """One reconcile tick's complete input. ``now`` is the ONLY clock the
    policy sees — tests drive time by constructing it."""

    now: float
    domains: list[DomainSignal] = field(default_factory=list)
    models: list[ModelSignal] = field(default_factory=list)
    # Fleet-aggregate predicted queue-clear time (s); 0 when unknown.
    predicted_clear_s: float = 0.0


@dataclass
class Action:
    """One controller decision, ready to actuate and audit."""

    kind: str
    target: str  # "host:<hid>" for scale kinds, the model name otherwise
    reason: str
    # Triggering signal values, recorded verbatim into the audit trail.
    signals: dict = field(default_factory=dict)
    # Set on rollback actions: the kind of the action being undone.
    rollback_of: str | None = None


def objective(sig: Signals) -> float:
    """The scalar the controller minimizes: SLO burn dominates (x10 per
    severity step of the worst model), queue pressure breaks ties. Lower
    is better."""
    worst_burn = max((_BURN_SCORE.get(m.burn_state, 0.0)
                      for m in sig.models), default=0.0)
    live = [d for d in sig.domains if d.up]
    mean_pressure = (sum(d.pressure for d in live) / len(live)
                     if live else 0.0)
    return worst_burn * 10.0 + mean_pressure


class _Watch:
    """Follow-up watch for one emitted action."""

    __slots__ = ("action", "objective_before", "due")

    def __init__(self, action: Action, objective_before: float,
                 due: float) -> None:
        self.action = action
        self.objective_before = objective_before
        self.due = due


class AutopilotPolicy:
    """Signals in, actions out — with bounded memory for damping.

    ``decide`` is deterministic given the Signals sequence it has seen;
    nothing here touches a clock, a lock, or the network."""

    def __init__(self, cfg: AutopilotConfig) -> None:
        self.cfg = cfg
        # Consecutive ticks each named trigger condition has held.
        self._streak: dict[str, int] = {}
        # (kind, target) -> monotonic-now the knob unlocks.
        self._cooldown_until: dict[tuple[str, str], float] = {}
        # Timestamps of non-rollback actions (the window budget).
        self._acted_at: deque[float] = deque()
        self._watches: list[_Watch] = []
        self.rollbacks_total = 0
        self.budget_deferrals_total = 0

    # -- damping predicates ---------------------------------------------------
    def _held(self, key: str, condition: bool) -> bool:
        """Track one trigger condition's consecutive-tick streak; True
        when it has held for >= hysteresis_ticks."""
        streak = self._streak.get(key, 0) + 1 if condition else 0
        self._streak[key] = streak
        return streak >= self.cfg.hysteresis_ticks

    def _cooled(self, kind: str, target: str, now: float) -> bool:
        return now >= self._cooldown_until.get((kind, target), 0.0)

    def _budget_open(self, now: float) -> bool:
        while self._acted_at and self._acted_at[0] < now - self.cfg.window_s:
            self._acted_at.popleft()
        return len(self._acted_at) < self.cfg.max_actions_per_window

    def _emit(self, out: list[Action], action: Action, sig: Signals,
              *, rollback: bool = False, streak_key: str | None = None) -> None:
        now = sig.now
        self._cooldown_until[(action.kind, action.target)] = \
            now + self.cfg.cooldown_s
        if rollback:
            self.rollbacks_total += 1
            # The undone knob cools too: without this the original
            # trigger (still held) would re-fire the very same tick and
            # the pair would flap at tick frequency.
            if action.rollback_of is not None:
                self._cooldown_until[(action.rollback_of, action.target)] = \
                    now + self.cfg.cooldown_s
        else:
            self._acted_at.append(now)
            if self.cfg.follow_up_s > 0 and action.kind in INVERSE:
                self._watches.append(_Watch(action, objective(sig),
                                            now + self.cfg.follow_up_s))
        # Acting consumes the streak: the condition must re-accumulate
        # hysteresis_ticks before the same trigger fires again.
        if streak_key is not None:
            self._streak.pop(streak_key, None)
        out.append(action)

    # -- the decision function ------------------------------------------------
    def decide(self, sig: Signals) -> list[Action]:
        out: list[Action] = []
        self._check_rollbacks(sig, out)
        self._decide_shed(sig, out)
        self._decide_scale(sig, out)
        if self.cfg.paging:
            self._decide_paging(sig, out)
        return out

    def _check_rollbacks(self, sig: Signals, out: list[Action]) -> None:
        """Follow-up watches due this tick: invert any action whose
        objective got worse. Rollbacks bypass cooldown AND budget — an
        undo that queues behind the budget is not an undo."""
        due = [w for w in self._watches if sig.now >= w.due]
        if not due:
            return
        self._watches = [w for w in self._watches if sig.now < w.due]
        obj_now = objective(sig)
        for w in due:
            if obj_now <= w.objective_before + self.cfg.rollback_tolerance:
                continue  # held or improved: the action stands
            a = w.action
            self._emit(out, Action(
                kind=INVERSE[a.kind], target=a.target, reason="rollback",
                rollback_of=a.kind,
                signals={"objective_before": round(w.objective_before, 4),
                         "objective_now": round(obj_now, 4),
                         "tolerance": self.cfg.rollback_tolerance,
                         "undoes": a.kind}), sig, rollback=True)

    def _gated_emit(self, out: list[Action], action: Action, sig: Signals,
                    streak_key: str) -> None:
        """Emit one triggered action through cooldown + budget."""
        if not self._cooled(action.kind, action.target, sig.now):
            return
        if not self._budget_open(sig.now):
            self.budget_deferrals_total += 1
            return
        self._emit(out, action, sig, streak_key=streak_key)

    def _decide_shed(self, sig: Signals, out: list[Action]) -> None:
        if not self.cfg.burn_shed:
            return
        for m in sig.models:
            sigvals = {"burn_state": m.burn_state,
                       "shed_engaged": m.shed_engaged}
            if self._held(f"burn_firing:{m.name}",
                          m.burn_state == "firing" and not m.shed_engaged):
                self._gated_emit(out, Action(
                    "shed_on", m.name, "burn_firing", sigvals), sig,
                    f"burn_firing:{m.name}")
            if self._held(f"burn_clear:{m.name}",
                          m.burn_state == "ok" and m.shed_engaged):
                self._gated_emit(out, Action(
                    "shed_off", m.name, "burn_clear", sigvals), sig,
                    f"burn_clear:{m.name}")

    def _decide_scale(self, sig: Signals, out: list[Action]) -> None:
        if not self.cfg.scale:
            return
        any_burning = any(m.burn_state != "ok" for m in sig.models)
        clear_hot = (self.cfg.clear_high_s > 0
                     and sig.predicted_clear_s > self.cfg.clear_high_s)
        for d in sig.domains:
            if not d.up:
                continue
            target = f"host:{d.hid}"
            sigvals = {"pressure": round(d.pressure, 4),
                       "active": d.active, "max_slots": d.max_slots,
                       "predicted_clear_s": round(sig.predicted_clear_s, 4)}
            hot = d.pressure > self.cfg.pressure_high or clear_hot
            if self._held(f"pressure_high:{target}",
                          hot and d.active < d.max_slots):
                self._gated_emit(out, Action(
                    "scale_up", target, "pressure_high", sigvals), sig,
                    f"pressure_high:{target}")
            cold = (d.pressure < self.cfg.pressure_low and not any_burning
                    and not clear_hot)
            if self._held(f"pressure_low:{target}",
                          cold and d.active > self.cfg.min_slots):
                self._gated_emit(out, Action(
                    "scale_down", target, "pressure_low", sigvals), sig,
                    f"pressure_low:{target}")

    def _decide_paging(self, sig: Signals, out: list[Action]) -> None:
        warm_count = sum(1 for m in sig.models if m.warm)
        for m in sig.models:
            sigvals = {"warm": m.warm, "wants_warm": m.wants_warm,
                       "idle": m.idle, "warm_count": warm_count,
                       "max_warm": self.cfg.max_warm}
            budget_ok = (self.cfg.max_warm <= 0
                         or warm_count < self.cfg.max_warm)
            if self._held(f"wants_warm:{m.name}",
                          m.wants_warm and not m.warm and budget_ok):
                self._gated_emit(out, Action(
                    "warm", m.name, "demand_cold", sigvals), sig,
                    f"wants_warm:{m.name}")
                warm_count += 1
            over_budget = (self.cfg.max_warm > 0
                           and warm_count > self.cfg.max_warm)
            if self._held(f"idle_warm:{m.name}",
                          m.warm and (m.idle or over_budget)
                          and not m.wants_warm):
                self._gated_emit(out, Action(
                    "demote", m.name,
                    "warm_budget" if over_budget else "idle", sigvals), sig,
                    f"idle_warm:{m.name}")
                warm_count -= 1

    def describe(self) -> dict:
        return {
            "watches_open": len(self._watches),
            "rollbacks_total": self.rollbacks_total,
            "budget_deferrals_total": self.budget_deferrals_total,
            "actions_in_window": len(self._acted_at),
        }


class AutopilotLoop:
    """The asyncio side: tick -> collect -> decide -> actuate -> audit.

    ``signal_fn()`` returns a :class:`Signals`; ``actuate_fn(action)`` is
    an async callable returning an outcome string ("ok"/"error: ...").
    Both are injected by the owner (the primary router) so this class
    needs no knowledge of supervisors or HTTP."""

    def __init__(self, cfg: AutopilotConfig, signal_fn, actuate_fn,
                 audit=None, metrics=None) -> None:
        self.cfg = cfg
        self.policy = AutopilotPolicy(cfg)
        self.signal_fn = signal_fn
        self.actuate_fn = actuate_fn
        self.audit = audit
        self.metrics = metrics
        self.ticks = 0
        self.actions_total = 0
        self.errors_total = 0
        self._decisions: deque[dict] = deque(maxlen=cfg.history)
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.interval_s)
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:  # one bad tick must not end the controller
                log.exception("autopilot tick failed")

    async def tick(self) -> list[Action]:
        """One reconcile pass (exposed for drills/tests)."""
        self.ticks += 1
        sig = self.signal_fn()
        actions = self.policy.decide(sig)
        for a in actions:
            t0 = time.monotonic()
            try:
                outcome = await self.actuate_fn(a)
            except Exception as e:  # noqa: BLE001 — audit the failure
                outcome = f"error: {type(e).__name__}: {e}"
            ok = outcome == "ok"
            self.actions_total += 1
            if not ok:
                self.errors_total += 1
            if self.metrics is not None:
                self.metrics.autopilot_action_counter(
                    a.kind, "rollback" if a.rollback_of else
                    ("ok" if ok else "error")).inc()
            rec = {
                "ts": round(time.time(), 3),
                "kind": a.kind,
                "target": a.target,
                "reason": a.reason,
                "outcome": outcome,
                "signals": a.signals,
            }
            if a.rollback_of:
                rec["rollback_of"] = a.rollback_of
            self._decisions.append(rec)
            if self.audit is not None:
                self.audit.record(
                    f"autopilot:{a.kind}", a.target,
                    "rollback" if a.rollback_of and ok else
                    ("ok" if ok else "error"),
                    duration_ms=(time.monotonic() - t0) * 1e3,
                    reason=a.reason, **a.signals)
            log.info("autopilot %s %s (%s): %s",
                     a.kind, a.target, a.reason, outcome)
        return actions

    def describe(self) -> dict:
        """The /debug/autopilot body."""
        return {
            "enabled": self.cfg.enabled,
            "running": self._task is not None,
            "interval_s": self.cfg.interval_s,
            "ticks": self.ticks,
            "actions_total": self.actions_total,
            "errors_total": self.errors_total,
            "policy": self.policy.describe(),
            "decisions": list(self._decisions),
        }
