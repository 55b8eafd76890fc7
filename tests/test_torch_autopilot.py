"""The fleet controller (``tpuserve_torch.scheduler.autopilot``) against the
reference's (``tpuserve/scheduler/autopilot.py``): each scenario of
``tests/test_autopilot.py`` runs on both packages with the same ``Signals``
tables (time comes from ``Signals.now`` only, so the runs are exact), and
the port's decisions — every action's kind, target, reason, triggering
signals and rollback mark, the damping counters (hysteresis streaks,
cooldowns, the action budget, rollbacks) and the loop's decision records —
equal the reference's, beside the reference's own expectations.
"""

import asyncio
from types import SimpleNamespace

import pytest

from tpuserve import config as jconfig
from tpuserve.scheduler import autopilot as jap
from tpuserve_torch import config as tconfig
from tpuserve_torch.scheduler import autopilot as tap

PKGS = {"jax": SimpleNamespace(ap=jap, cfg=jconfig), "port": SimpleNamespace(ap=tap, cfg=tconfig)}


def ap_cfg(ns, **over):
    base = dict(enabled=True, interval_s=0.25, hysteresis_ticks=2,
                cooldown_s=5.0, max_actions_per_window=8, window_s=60.0,
                follow_up_s=10.0, rollback_tolerance=0.5,
                pressure_high=2.0, pressure_low=0.25, min_slots=1)
    base.update(over)
    return ns.cfg.AutopilotConfig(**base)


def dom(ns, hid=0, pressure=0.0, active=1, max_slots=2, healthy=1, up=True):
    return ns.ap.DomainSignal(hid=hid, up=up, active=active, max_slots=max_slots,
                              healthy=healthy, pressure=pressure)


def mod(ns, name="m", burn_state="ok", shed_engaged=False, warm=True,
        wants_warm=False, idle=False):
    return ns.ap.ModelSignal(name=name, burn_state=burn_state, shed_engaged=shed_engaged,
                             warm=warm, wants_warm=wants_warm, idle=idle)


def sig(ns, now, domains=(), models=(), clear=0.0):
    return ns.ap.Signals(now=now, domains=list(domains), models=list(models),
                         predicted_clear_s=clear)


def kinds(actions) -> list[str]:
    return [a.kind for a in actions]


def flat(actions) -> list[tuple]:
    """Everything an action carries, for the exact comparison."""
    return [(a.kind, a.target, a.reason, dict(a.signals), a.rollback_of) for a in actions]


def both(scenario):
    """Run ``scenario(ns)`` on both packages; the port's result must equal
    the reference's."""
    out = {pkg: scenario(ns) for pkg, ns in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# -- objective -------------------------------------------------------------------

@pytest.mark.parametrize("case, expect", [
    ("empty", 0.0), ("ok", 0.5), ("pending", 10.0), ("firing", 21.0),
    ("down_excluded", 2.0), ("worst_dominates", 22.0)])
def test_objective_scalar(case, expect):
    def scenario(ns):
        m, d = {
            "empty": ([], []),
            "ok": ([mod(ns, burn_state="ok")], [dom(ns, pressure=0.5)]),
            "pending": ([mod(ns, burn_state="pending")], [dom(ns, pressure=0.0)]),
            "firing": ([mod(ns, burn_state="firing")], [dom(ns, pressure=1.0)]),
            # Down domains are excluded from the pressure mean.
            "down_excluded": ([], [dom(ns, hid=0, pressure=2.0),
                                   dom(ns, hid=1, pressure=0.0, up=False)]),
            # Worst model dominates; mean over live domains breaks ties.
            "worst_dominates": ([mod(ns, "a", "ok"), mod(ns, "b", "firing")],
                                [dom(ns, hid=0, pressure=1.0), dom(ns, hid=1, pressure=3.0)]),
        }[case]
        return ns.ap.objective(sig(ns, 0.0, d, m))

    assert both(scenario) == pytest.approx(expect)


# -- hysteresis ------------------------------------------------------------------

@pytest.mark.parametrize("pressures,expect_tick", [
    ([5.0, 5.0, 5.0], 2),                       # the third hot tick acts
    ([5.0, 5.0, 0.5, 5.0, 5.0, 5.0], 5),        # a cool sample resets the streak
    ([5.0, 0.5, 5.0, 0.5, 5.0, 0.5], None),     # never 3 in a row
])
def test_hysteresis_consecutive_ticks(pressures, expect_tick):
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=3))
        fired_at, trace = None, []
        for i, pr in enumerate(pressures):
            acts = p.decide(sig(ns, float(i), [dom(ns, pressure=pr)]))
            trace.append(flat(acts))
            if acts and fired_at is None:
                fired_at = i
                assert kinds(acts) == ["scale_up"]
        return fired_at, trace

    assert both(scenario)[0] == expect_tick


def test_acting_consumes_the_streak():
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=2, cooldown_s=0.0,
                                         follow_up_s=0.0))
        hot = [dom(ns, pressure=5.0, active=1, max_slots=4)]
        return [kinds(p.decide(sig(ns, float(t), hot))) for t in range(4)]

    assert both(scenario) == [[], ["scale_up"], [], ["scale_up"]]


# -- cooldown --------------------------------------------------------------------

def test_cooldown_locks_the_knob_then_releases():
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, cooldown_s=10.0,
                                         follow_up_s=0.0))
        hot = [dom(ns, pressure=5.0, active=1, max_slots=4)]
        return [kinds(p.decide(sig(ns, t, hot))) for t in (0.0, 1.0, 5.0, 9.9, 10.0)]

    assert both(scenario) == [["scale_up"], [], [], [], ["scale_up"]]


def test_cooldown_is_per_target():
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, cooldown_s=10.0,
                                         follow_up_s=0.0))
        first = flat(p.decide(sig(ns, 0.0, [dom(ns, hid=0, pressure=5.0)])))
        acts = p.decide(sig(ns, 1.0, [dom(ns, hid=0, pressure=5.0),
                                      dom(ns, hid=1, pressure=5.0)]))
        return first, [(a.kind, a.target) for a in acts]

    first, second = both(scenario)
    assert [f[0] for f in first] == ["scale_up"]
    assert second == [("scale_up", "host:1")]


# -- action budget ---------------------------------------------------------------

def test_budget_caps_actions_per_window_and_reopens():
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, cooldown_s=0.0,
                                         follow_up_s=0.0, max_actions_per_window=2,
                                         window_s=60.0))
        hosts = [dom(ns, hid=h, pressure=5.0) for h in range(4)]
        a0 = flat(p.decide(sig(ns, 0.0, hosts)))
        deferred = p.budget_deferrals_total
        a1 = flat(p.decide(sig(ns, 1.0, hosts)))
        a61 = flat(p.decide(sig(ns, 61.0, hosts)))
        return a0, deferred, a1, a61, p.describe()

    a0, deferred, a1, a61, _ = both(scenario)
    assert len(a0) == 2 and deferred == 2 and a1 == [] and len(a61) == 2


# -- rollback --------------------------------------------------------------------

def test_rollback_on_worse_objective():
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, cooldown_s=0.0,
                                         follow_up_s=10.0, rollback_tolerance=0.5))
        first = kinds(p.decide(sig(ns, 0.0, [dom(ns, pressure=5.0)])))
        acts = p.decide(sig(ns, 10.0, [dom(ns, pressure=9.0, active=2)]))
        return first, flat(acts), p.rollbacks_total

    first, acts, rollbacks = both(scenario)
    assert first == ["scale_up"]
    rb = [a for a in acts if a[4]]
    assert len(rb) == 1 and rb[0][0] == "scale_down" and rb[0][4] == "scale_up"
    assert rb[0][2] == "rollback"
    assert rb[0][3]["objective_before"] == pytest.approx(5.0)
    assert rb[0][3]["objective_now"] == pytest.approx(9.0)
    assert rollbacks == 1


@pytest.mark.parametrize("pressure_later", [5.0, 4.0, 5.4])
def test_no_rollback_when_objective_held_or_improved(pressure_later):
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, cooldown_s=0.0,
                                         follow_up_s=10.0, rollback_tolerance=0.5))
        p.decide(sig(ns, 0.0, [dom(ns, pressure=5.0)]))
        acts = p.decide(sig(ns, 10.0, [dom(ns, pressure=pressure_later, active=2)]))
        return flat(acts), p.rollbacks_total

    acts, rollbacks = both(scenario)
    assert not [a for a in acts if a[4]] and rollbacks == 0


def test_rollback_bypasses_budget():
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, cooldown_s=0.0,
                                         follow_up_s=10.0, max_actions_per_window=1,
                                         window_s=60.0))
        first = kinds(p.decide(sig(ns, 0.0, [dom(ns, pressure=5.0)])))
        return first, kinds(p.decide(sig(ns, 10.0, [dom(ns, pressure=9.0, active=2)])))

    first, later = both(scenario)
    assert first == ["scale_up"] and "scale_down" in later


def test_rollback_cools_both_kinds_no_flap():
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, cooldown_s=30.0,
                                         follow_up_s=10.0))
        p.decide(sig(ns, 0.0, [dom(ns, pressure=5.0, active=1, max_slots=4)]))
        hot = [dom(ns, pressure=9.0, active=2, max_slots=4)]
        return [kinds(p.decide(sig(ns, t, hot))) for t in (30.0, 31.0, 40.0, 59.9, 60.0)]

    assert both(scenario) == [["scale_down"], [], [], [], ["scale_up"]]


# -- shed-on-burn ----------------------------------------------------------------

@pytest.mark.parametrize("burn,engaged,expect", [
    ("firing", False, ["shed_on"]),
    ("firing", True, []),
    ("pending", False, []),
    ("ok", True, ["shed_off"]),
    ("ok", False, []),
    ("pending", True, []),
])
def test_shed_decision_table(burn, engaged, expect):
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, follow_up_s=0.0))
        return flat(p.decide(sig(ns, 0.0, models=[mod(ns, "m", burn, engaged)])))

    acts = both(scenario)
    assert [a[0] for a in acts] == expect
    if expect:
        assert acts[0][1] == "m" and acts[0][3]["burn_state"] == burn


def test_burn_shed_disabled_by_config():
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, burn_shed=False))
        return flat(p.decide(sig(ns, 0.0, models=[mod(ns, "m", "firing")])))

    assert both(scenario) == []


# -- scale -----------------------------------------------------------------------

@pytest.mark.parametrize("d,burning,expect", [
    (dict(pressure=5.0, active=1, max_slots=2), False, ["scale_up"]),
    (dict(pressure=5.0, active=2, max_slots=2), False, []),
    (dict(pressure=0.0, active=2, max_slots=2), False, ["scale_down"]),
    (dict(pressure=0.0, active=1, max_slots=2), False, []),
    (dict(pressure=0.0, active=2, max_slots=2), True, []),  # never down into a burn
    (dict(pressure=1.0, active=1, max_slots=2), False, []),  # the band: hold
    (dict(pressure=5.0, active=1, max_slots=2, up=False), False, []),  # down: never
])
def test_scale_decision_table(d, burning, expect):
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, follow_up_s=0.0))
        models = [mod(ns, "m", "pending")] if burning else []
        return flat(p.decide(sig(ns, 0.0, [dom(ns, **d)], models)))

    acts = both(scenario)
    assert [a[0] for a in acts] == expect
    if expect:
        assert acts[0][1] == "host:0"


def test_clear_time_trigger():
    def scenario(ns):
        cfg = ap_cfg(ns, hysteresis_ticks=1, follow_up_s=0.0, clear_high_s=5.0)
        up = flat(ns.ap.AutopilotPolicy(cfg).decide(
            sig(ns, 0.0, [dom(ns, pressure=0.0, active=1, max_slots=2)], clear=9.0)))
        veto = flat(ns.ap.AutopilotPolicy(cfg).decide(
            sig(ns, 0.0, [dom(ns, pressure=0.0, active=2, max_slots=2)], clear=9.0)))
        return up, veto

    up, veto = both(scenario)
    assert [a[0] for a in up] == ["scale_up"]
    assert up[0][3]["predicted_clear_s"] == pytest.approx(9.0) and veto == []


def test_scale_disabled_by_config():
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, scale=False))
        return flat(p.decide(sig(ns, 0.0, [dom(ns, pressure=9.0)])))

    assert both(scenario) == []


# -- paging ----------------------------------------------------------------------

@pytest.mark.parametrize("m,expect", [
    (dict(warm=False, wants_warm=True), ["warm"]),
    (dict(warm=True, wants_warm=True), []),
    (dict(warm=True, idle=True), ["demote"]),
    (dict(warm=True, idle=True, wants_warm=True), []),  # demand wins
    (dict(warm=False, wants_warm=False), []),
])
def test_paging_decision_table(m, expect):
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, follow_up_s=0.0,
                                         paging=True, max_warm=0))
        return flat(p.decide(sig(ns, 0.0, models=[mod(ns, "m", **m)])))

    assert [a[0] for a in both(scenario)] == expect


def test_paging_warm_budget():
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, follow_up_s=0.0,
                                         paging=True, max_warm=1))
        return flat(p.decide(sig(ns, 0.0, models=[
            mod(ns, "a", warm=True), mod(ns, "b", warm=False, wants_warm=True)])))

    assert both(scenario) == []


def test_paging_off_by_default():
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1))
        return flat(p.decide(sig(ns, 0.0, models=[mod(ns, "m", warm=False,
                                                          wants_warm=True)])))

    assert both(scenario) == []


# -- inverse map / describe -------------------------------------------------------

def test_inverse_map_is_an_involution():
    assert tap.INVERSE == jap.INVERSE
    for kind, inv in tap.INVERSE.items():
        assert tap.INVERSE[inv] == kind


def test_describe_counters():
    def scenario(ns):
        p = ns.ap.AutopilotPolicy(ap_cfg(ns, hysteresis_ticks=1, cooldown_s=0.0,
                                         follow_up_s=10.0, max_actions_per_window=1))
        p.decide(sig(ns, 0.0, [dom(ns, hid=0, pressure=5.0), dom(ns, hid=1, pressure=5.0)]))
        return p.describe()

    assert both(scenario) == {"actions_in_window": 1, "budget_deferrals_total": 1,
                              "watches_open": 1, "rollbacks_total": 0}


# -- the loop (injected signal and actuate functions) -------------------------------

def _decisions(loop) -> list[dict]:
    """The loop's decision records without their wall-clock stamps."""
    return [{k: v for k, v in r.items() if k != "ts"} for r in loop.describe()["decisions"]]


def test_loop_tick_actuates_and_records():
    def scenario(ns):
        async def run():
            cfg = ap_cfg(ns, hysteresis_ticks=1, cooldown_s=0.0, follow_up_s=0.0)
            ticks = iter([sig(ns, 0.0, [dom(ns, pressure=5.0)]),
                          sig(ns, 1.0, [dom(ns, hid=1, pressure=5.0)])])
            acted = []

            async def actuate(a) -> str:
                acted.append((a.kind, a.target))
                return "ok" if a.target == "host:0" else "error: host down"

            loop = ns.ap.AutopilotLoop(cfg, lambda: next(ticks), actuate)
            await loop.tick()
            await loop.tick()
            return acted, loop.ticks, loop.actions_total, loop.errors_total, _decisions(loop)

        return asyncio.run(run())

    acted, ticks, actions, errors, decisions = both(scenario)
    assert acted == [("scale_up", "host:0"), ("scale_up", "host:1")]
    assert ticks == 2 and actions == 2 and errors == 1
    assert [r["outcome"] for r in decisions] == ["ok", "error: host down"]
    assert decisions[0]["signals"]["pressure"] == pytest.approx(5.0)


def test_loop_actuator_exception_is_an_error_outcome():
    def scenario(ns):
        async def run():
            cfg = ap_cfg(ns, hysteresis_ticks=1, follow_up_s=0.0)

            async def actuate(a) -> str:
                raise RuntimeError("boom")

            loop = ns.ap.AutopilotLoop(cfg, lambda: sig(ns, 0.0, [dom(ns, pressure=5.0)]),
                                       actuate)
            await loop.tick()
            return loop.errors_total, _decisions(loop)

        return asyncio.run(run())

    errors, decisions = both(scenario)
    assert errors == 1 and decisions[0]["outcome"].startswith("error: RuntimeError")


def test_loop_decision_history_is_bounded():
    def scenario(ns):
        async def run():
            cfg = ap_cfg(ns, hysteresis_ticks=1, cooldown_s=0.0, follow_up_s=0.0,
                         max_actions_per_window=1000, history=4)
            t = [0.0]

            def signals():
                t[0] += 1.0
                return sig(ns, t[0], [dom(ns, hid=int(t[0]) % 997, pressure=5.0)])

            async def actuate(a) -> str:
                return "ok"

            loop = ns.ap.AutopilotLoop(cfg, signals, actuate)
            for _ in range(10):
                await loop.tick()
            return _decisions(loop)

        return asyncio.run(run())

    assert len(both(scenario)) == 4


def test_loop_audits_every_decision_and_counts_outcomes():
    """Every decision lands in the audit trail as ``autopilot:<kind>`` with
    its triggering signals, and ``autopilot_actions_total{kind=,outcome=}``
    counts it: the same records and counters in both packages."""
    def scenario(ns):
        from importlib import import_module

        root = "tpuserve" if ns.ap is jap else "tpuserve_torch"
        obs = import_module(f"{root}.obs")
        events = import_module(f"{root}.telemetry.events")

        async def run():
            metrics = obs.Metrics()
            audit = events.AuditLog(metrics, 64)
            cfg = ap_cfg(ns, hysteresis_ticks=1, cooldown_s=0.0, follow_up_s=0.0)

            async def actuate(a) -> str:
                return "ok"

            loop = ns.ap.AutopilotLoop(cfg, lambda: sig(ns, 0.0, [dom(ns, pressure=5.0)],
                                                       [mod(ns, "m", "firing")]),
                                       actuate, audit=audit, metrics=metrics)
            await loop.tick()
            recs = [{k: v for k, v in r.items() if k not in ("ts", "duration_ms", "seq")}
                    for r in audit.dump()]
            counters = {k: v for k, v in metrics.counter_values().items()
                        if k.startswith("autopilot_actions_total")}
            return recs, counters

        return asyncio.run(run())

    recs, counters = both(scenario)
    assert sorted(r["verb"] for r in recs) == ["autopilot:scale_up", "autopilot:shed_on"]
    assert all(r["outcome"] == "ok" and "reason" in r for r in recs)
    assert counters == {"autopilot_actions_total{kind=shed_on,outcome=ok}": 1.0,
                        "autopilot_actions_total{kind=scale_up,outcome=ok}": 1.0}
