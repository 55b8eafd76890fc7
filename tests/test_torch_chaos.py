"""The port's chaos runner (``tpuserve_torch.faults.run_chaos``) against the
reference's (``tpuserve.faults.run_chaos``): the three ``run_chaos``
scenarios of ``tests/test_faults.py`` — 10 % ``batch_error``, the
``reload_corrupt`` drill and the ``reload_nan`` drill — each on both
packages' own runner and toy ``ServerState`` on the CPU, with the same
assertions on both: the reference's availability bar (>= 0.99), its fired
and attempt counts, breaker states and lifecycle outcomes, and the summary's
keys.

The reference's drills are known to be timing-sensitive under parallel test
workers (ROADMAP.md §3). Here each window is 2.5 s after a 0.5 s warm-up
(the reference: 1.5 s and 1.0 s after 0.3 s and 0.2 s) and the reload drill
fires every 0.2 s (the reference: 0.1 s), so a slowed host still fits the
reference's request and attempt counts into the window; the bars themselves
are the reference's.
"""

import asyncio

import pytest
import torch

from tpuserve import config as jconfig
from tpuserve import faults as jfaults
from tpuserve.server import ServerState as JaxServerState
from tpuserve_torch import config as tconfig
from tpuserve_torch import faults as tfaults
from tpuserve_torch.server import ServerState

TOY = dict(name="toy", family="toy", batch_buckets=[1, 2, 4], deadline_ms=5.0,
           dtype="float32", num_classes=10, parallelism="single",
           request_timeout_ms=10_000.0)
SUMMARY_KEYS = ["availability", "breakers", "duration_s", "faults", "lifecycle", "mode",
                "n_err", "n_late", "n_ok", "p50_ms", "p90_ms", "p99_ms", "throughput_per_s"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def chaos_both(rules: list[dict], seed: int, **kw) -> dict:
    """``run_chaos`` on each package's toy server with the same fault rules."""
    out = {}
    for pkg, cfgm, faults in (("jax", jconfig, jfaults), ("port", tconfig, tfaults)):
        cfg = cfgm.ServerConfig(
            models=[cfgm.ModelConfig(**TOY)], decode_threads=2,
            faults=cfgm.FaultsConfig(enabled=True, seed=seed,
                                     rules=[cfgm.FaultRuleConfig(**r) for r in rules]))
        state = JaxServerState(cfg) if pkg == "jax" else ServerState(cfg, device="cpu")
        state.build()
        out[pkg] = asyncio.run(faults.run_chaos(state, "toy", concurrency=8, edge=8, **kw))
    assert sorted(out["port"]) == sorted(out["jax"]), out
    return out


def test_availability_with_10pct_batch_failures():
    """10 % injected batch failures: >= 99 % of the load generator's
    requests still succeed through the one-shot retry, and the breaker never
    trips."""
    out = chaos_both([dict(kind="batch_error", model="toy", probability=0.10)], seed=1,
                     duration_s=2.5, warmup_s=0.5)
    for pkg, summary in out.items():
        assert sorted(summary) == SUMMARY_KEYS, pkg
        assert summary["n_ok"] > 100, (pkg, summary)
        assert summary["availability"] >= 0.99, (pkg, summary)
        fired = sum(r["fired"] for r in summary["faults"])
        assert fired > 5, (pkg, summary)  # chaos actually ran
        assert summary["breakers"]["toy"]["state"] == "closed"
        assert summary["breakers"]["toy"]["opened_total"] == 0


def test_reload_drill_availability():
    """``reload_corrupt`` at 100 % and :reload hammered throughout the run:
    every reload is rejected at the integrity gate, the original version
    keeps serving, and availability stays >= 99 %."""
    out = chaos_both([dict(kind="reload_corrupt", model="toy")], seed=3,
                     duration_s=2.5, warmup_s=0.5, drill="reload", drill_interval_s=0.2)
    for pkg, summary in out.items():
        assert sorted(summary) == sorted([*SUMMARY_KEYS, "reload_drill"]), pkg
        assert summary["n_ok"] > 100, (pkg, summary)
        assert summary["availability"] >= 0.99, (pkg, summary)
        drill = summary["reload_drill"]
        assert drill["attempts"] >= 5, (pkg, drill)  # the drill actually hammered
        assert drill["ok"] == 0 and drill["rolled_back"] == 0
        assert drill["rejected"] == drill["attempts"] - drill["errors"]
        lc = summary["lifecycle"]["toy"]
        assert lc["live_version"] == 1
        assert all(h["status"] in ("live", "rejected") for h in lc["history"])


def test_reload_nan_drill_keeps_serving():
    """Same bound for the NaN gate (``reload_nan`` at 100 %)."""
    out = chaos_both([dict(kind="reload_nan", model="toy")], seed=4,
                     duration_s=2.5, warmup_s=0.5, drill="reload", drill_interval_s=0.2)
    for pkg, summary in out.items():
        assert summary["availability"] >= 0.99, (pkg, summary)
        assert summary["lifecycle"]["toy"]["live_version"] == 1
        assert summary["reload_drill"]["ok"] == 0
        assert summary["reload_drill"]["attempts"] >= 5
