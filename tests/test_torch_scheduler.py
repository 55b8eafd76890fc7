"""The fleet scheduler (``tpuserve_torch.scheduler``) against the reference's
(``tpuserve/scheduler/``): each scenario of ``tests/test_scheduler.py`` runs
on both packages on the same inputs — stub batchers, the same injected
durations and queue depths, toy models served from the same seeded
checkpoint — and the port's observations are held EXACTLY equal to the
reference's: shed reasons, status codes, Retry-After and response bodies
(a trace id stripped; ``deadline_unmeetable``'s measured milliseconds
normalized), the warm/cold transitions and the ``model_state`` gauge,
``runtime_compiles_total`` unchanged across a demote and re-warm, versions,
and the toy's answers before and after the re-warm against the
reference's (probabilities within 1e-6: two frameworks in float32; each
server's own answers bit-identical across its re-warm).

Port-only: a dispatch on a released (or never published) runtime raises
instead of replaying; a warm whose capture fails leaves the model cold and
shedding 503 ``model_warming``, never served eagerly; the port's form of
"a re-warm recompiles nothing" (``captures_total`` grows by slots x buckets
on the card, 0 on the CPU, where nothing is captured).
"""

import asyncio
import io
import math
import re
import shutil
import time
from types import SimpleNamespace

import aiohttp
import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tpuserve import batcher as jbatcher
from tpuserve import config as jconfig
from tpuserve import obs as jobs
from tpuserve import scheduler as jsched
from tpuserve.models import build as jax_build
from tpuserve.savedmodel import save_orbax
from tpuserve.server import ServerState as JaxServerState
from tpuserve.server import make_app
from tpuserve_torch import batcher as tbatcher
from tpuserve_torch import config as tconfig
from tpuserve_torch import obs as tobs
from tpuserve_torch import savedmodel as sm
from tpuserve_torch import scheduler as tsched
from tpuserve_torch.server import ServerState, start_server, stop_server

pytestmark = pytest.mark.filterwarnings("ignore::pytest.PytestUnraisableExceptionWarning")

PKGS = {"jax": SimpleNamespace(cfg=jconfig, obs=jobs, sched=jsched, batcher=jbatcher),
        "port": SimpleNamespace(cfg=tconfig, obs=tobs, sched=tsched, batcher=tbatcher)}
NPY = {"Content-Type": "application/x-npy"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def npy_image(seed: int = 0, edge: int = 8) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.random.default_rng(seed).integers(0, 200, (edge, edge, 3), dtype=np.uint8))
    return buf.getvalue()


def toy_model_cfg(ns, name: str = "toy", **over):
    base = dict(family="toy", batch_buckets=[1, 2, 4], deadline_ms=5.0, dtype="float32",
                num_classes=10, parallelism="single", request_timeout_ms=10_000.0, wire_size=8)
    base.update(over)
    return ns.cfg.ModelConfig(name=name, **base)


def sched_server_cfg(ns, models, **over):
    base = dict(models=models, decode_threads=2, startup_canary=False,
                scheduler=ns.cfg.SchedulerConfig(enabled=True))
    base.update(over)
    return ns.cfg.ServerConfig(**base)


class StubBatcher:
    """The batcher surface the scheduler reads."""

    def __init__(self, clear=None, service=None, pending=0):
        self.clear, self.service, self.pending = clear, service, pending
        self.device_time_cb = None

    def estimate_clear_s(self):
        return self.clear

    def predicted_service_s(self, n_items=1):
        return self.service


def make_sched(ns, **cfg_over):
    return ns.sched.FleetScheduler(ns.cfg.SchedulerConfig(**dict(enabled=True, **cfg_over)),
                                   ns.obs.Metrics())


def shed(s) -> tuple | None:
    return None if s is None else (s.status, s.reason, s.message, s.retry_after)


def both(scenario):
    out = {pkg: scenario(ns) for pkg, ns in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def build_state(pkg: str, cfg):
    state = JaxServerState(cfg) if pkg == "jax" else ServerState(cfg, device="cpu")
    state.build()
    return state


# -- the batcher's raw estimate vs the clamped hint --------------------------------

def test_estimate_clear_raw_and_clamped_hint():
    """estimate_clear_s stays RAW for admission; clamp_retry_after_s owns the
    [1, 30] s hint."""
    def scenario(ns):
        state = build_state("jax" if ns is PKGS["jax"] else "port",
                            ns.cfg.ServerConfig(models=[toy_model_cfg(ns)], decode_threads=2,
                                                startup_canary=False))

        async def go():
            await state.start()
            b = state.batchers["toy"]
            seen = []
            for ewma, pending in ((1000.0, 90), (1000.0, 2), (10.0, 1)):
                b._ewma_ms[(1,)] = ewma
                b._pending = pending
                est = b.estimate_clear_s()
                seen.append((round(est, 9), ns.batcher.clamp_retry_after_s(est),
                             state.queue_retry_after("toy")))
            b._pending = 0
            await state.stop()
            return seen, ns.batcher.clamp_retry_after_s(None)

        return asyncio.run(go())

    seen, none_hint = both(scenario)
    assert seen == [(90.0, 30, 30), (2.0, 2, 2), (0.01, 1, 1)] and none_hint is None


def test_predicted_service_picks_covering_bucket():
    def scenario(ns):
        state = build_state("jax" if ns is PKGS["jax"] else "port",
                            ns.cfg.ServerConfig(models=[toy_model_cfg(ns)], decode_threads=2,
                                                startup_canary=False))

        async def go():
            await state.start()
            b = state.batchers["toy"]
            first = b.predicted_service_s()
            b._ewma_ms[(1,)] = 10.0
            b._ewma_ms[(4,)] = 40.0
            out = [first] + [round(b.predicted_service_s(n), 9) for n in (1, 3, 8)]
            await state.stop()
            return out

        return asyncio.run(go())

    assert both(scenario) == [None, 0.01, 0.04, 0.04]


# -- predictor and admission units (stub batchers) ---------------------------------

def test_predict_completion_combines_clear_and_service():
    def scenario(ns):
        s = make_sched(ns)
        s.register("m", StubBatcher(clear=2.0, service=0.5), toy_model_cfg(ns, "m"))
        s.register("empty", StubBatcher(), toy_model_cfg(ns, "empty"))
        s.register("idle", StubBatcher(service=0.3), toy_model_cfg(ns, "idle"))
        return [s.predict_completion_s(n) for n in ("m", "empty", "idle")]

    assert both(scenario) == [2.5, None, 0.3]


def test_deadline_unmeetable_shed_unit():
    def scenario(ns):
        s = make_sched(ns)
        s.register("m", StubBatcher(clear=2.0, service=1.0, pending=5), toy_model_cfg(ns, "m"))
        now = time.perf_counter()
        got = s.check_deadline("m", now + 1.0)
        counter = s._entries["m"].shed_counters["deadline_unmeetable"].value
        return ((got.status, got.reason, got.retry_after), counter,
                shed(s.check_deadline("m", now + 10.0)), shed(s.check_deadline("m", None)))

    assert both(scenario) == ((504, "deadline_unmeetable", 2), 1, None, None)


def test_deadline_headroom_grace():
    def scenario(ns):
        s = make_sched(ns, headroom_ms=2000.0)
        s.register("m", StubBatcher(clear=2.0, service=1.0), toy_model_cfg(ns, "m"))
        now = time.perf_counter()
        return (shed(s.check_deadline("m", now + 1.5)) is None,
                shed(s.check_deadline("m", now + 0.5)) is None)

    assert both(scenario) == (True, False)


def test_priority_shed_and_floor_under_saturation():
    """Under saturation batch-class sheds first; the min_share floor sheds
    the hog's interactive traffic while a starved model catches up."""
    def scenario(ns):
        s = make_sched(ns, overload_clear_s=0.5, min_share=0.2)
        hot = StubBatcher(clear=5.0, service=0.5, pending=10)
        quiet = StubBatcher(clear=0.0, service=0.01, pending=1)
        s.register("hot", hot, toy_model_cfg(ns, "hot"))
        s.register("quiet", quiet, toy_model_cfg(ns, "quiet"))
        hot.device_time_cb(0.99)
        quiet.device_time_cb(0.01)
        seen = [s.saturated(), round(s.share("hot"), 9)]
        for model, prio in (("hot", "batch"), ("quiet", "batch"), ("hot", "interactive"),
                            ("quiet", "interactive")):
            seen.append(shed(s.check_admission(model, prio)))
        quiet.device_time_cb(0.5)
        seen.append(shed(s.check_admission("hot", "interactive")))
        return seen

    seen = both(scenario)
    assert seen[0] is True and seen[1] > 0.9
    assert seen[2][:2] == (503, "priority_shed") and seen[2][3] >= 1
    assert seen[3][1] == "priority_shed" and seen[4][1] == "share_exceeded"
    assert seen[5] is None and seen[6] is None


def test_unsaturated_fleet_admits_everything():
    def scenario(ns):
        s = make_sched(ns, overload_clear_s=1.0)
        s.register("m", StubBatcher(clear=0.2, service=0.1, pending=1), toy_model_cfg(ns, "m"))
        return s.saturated(), shed(s.check_admission("m", "batch")), \
            shed(s.check_admission("m", "interactive"))

    assert both(scenario) == (False, None, None)


def test_ledger_window_trims_and_counts():
    def scenario(ns):
        s = make_sched(ns, window_s=0.1)
        b = StubBatcher()
        s.register("m", b, toy_model_cfg(ns, "m"))
        b.device_time_cb(0.5)
        e = s._entries["m"]
        seen = [e.window_sum, e.device_seconds_total.value]
        time.sleep(0.15)
        seen += [s.share("m"), e.window_sum, e.device_seconds_total.value]
        return [round(v, 9) for v in seen]

    assert both(scenario) == [0.5, 0.5, 0.0, 0.0, 0.5]


def test_resolve_priority_header_default_and_junk():
    def scenario(ns):
        s = make_sched(ns)
        s.register("m", StubBatcher(), toy_model_cfg(ns, "m", priority="batch"))
        seen = [s.resolve_priority("m", h) for h in (None, "Interactive", "batch")]
        with pytest.raises(ValueError, match="X-Priority") as e:
            s.resolve_priority("m", "urgent")
        return seen, str(e.value)

    assert both(scenario)[0] == ["batch", "interactive", "batch"]


def test_scheduler_config_validation_and_toml(tmp_path):
    text = ("[scheduler]\nenabled = true\noverload_clear_s = 0.25\nmin_share = 0.1\n"
            "idle_demote_s = 3.0\n[[model]]\nname = \"toy\"\nfamily = \"toy\"\n"
            "priority = \"batch\"\ncold_start = true\n")
    p = tmp_path / "sched.toml"
    p.write_text(text)

    def scenario(ns):
        msgs = []
        for make, match in ((lambda: ns.cfg.SchedulerConfig(min_share=0.6), "min_share"),
                            (lambda: ns.cfg.SchedulerConfig(window_s=0.0), "window_s"),
                            (lambda: ns.cfg.ModelConfig(name="m", priority="urgent"),
                             "priority")):
            with pytest.raises(ValueError, match=match) as e:
                make()
            msgs.append(str(e.value))
        cfg = ns.cfg.load_config(str(p))
        cfg2 = ns.cfg.load_config(str(p), overrides=["scheduler.overload_clear_s=2.0"])
        return (msgs, cfg.scheduler.enabled, cfg.scheduler.min_share,
                cfg.scheduler.idle_demote_s, cfg.models[0].priority, cfg.models[0].cold_start,
                cfg2.scheduler.overload_clear_s)

    assert both(scenario)[1:] == (True, 0.1, 3.0, "batch", True, 2.0)
    # cold_start with recycle mode: refused by both, at construction and
    # at load (session_mode is typed in both).
    with pytest.raises(ValueError, match="cold_start"):
        jconfig.ModelConfig(name="m", cold_start=True, session_mode="recycle")
    with pytest.raises(ValueError, match="cold_start"):
        tconfig.ModelConfig(name="m", cold_start=True, session_mode="recycle")
    p.write_text(text + 'session_mode = "recycle"\n')
    with pytest.raises(ValueError, match="cold_start"):
        tconfig.load_config(str(p))


# -- the warm/cold state machine -----------------------------------------------------

def test_warm_cold_state_machine():
    def scenario(ns):
        async def go():
            s = make_sched(ns, warm_retry_after_s=0.2)
            calls = []

            async def warm_fn():
                calls.append(1)
                await asyncio.sleep(0.02)
                return {"version": 2}

            s.register("m", StubBatcher(), toy_model_cfg(ns, "m", cold_start=True),
                       warm_fn=warm_fn, cold=True)
            seen = [s.state_of("m"), s.is_warm("m"), shed(s.check_admission("m", "interactive"))]
            info = await s.warm("m")
            info.pop("warm_ms")
            seen += [info, list(calls), s.is_warm("m"), shed(s.check_admission("m", "interactive"))]
            seen += [await s.warm("m"), list(calls)]
            await s.stop()
            return seen

        return asyncio.run(go())

    seen = both(scenario)
    assert seen[:2] == ["cold", False] and seen[2][:2] == (503, "model_warming")
    assert seen[3] == {"model": "m", "state": "warm", "version": 2} and seen[4] == [1]
    assert seen[5] is True and seen[6] is None
    assert seen[7] == {"model": "m", "state": "warm", "already_warm": True} and seen[8] == [1]


def test_failed_warm_backs_off_then_explicit_retry():
    def scenario(ns):
        async def go():
            s = make_sched(ns, warm_retry_after_s=5.0)
            attempts = []

            async def bad_warm():
                attempts.append(1)
                raise RuntimeError("corrupt checkpoint")

            s.register("m", StubBatcher(), toy_model_cfg(ns, "m", cold_start=True),
                       warm_fn=bad_warm, cold=True)
            with pytest.raises(RuntimeError, match="corrupt"):
                await s.warm("m")
            seen = [s.state_of("m"), len(attempts)]
            seen.append(shed(s.check_admission("m", "interactive")))
            await asyncio.sleep(0.01)
            seen.append(len(attempts))  # backoff: no new task
            with pytest.raises(RuntimeError):
                await s.warm("m")  # an explicit :warm overrides the backoff
            seen.append(len(attempts))
            return seen

        return asyncio.run(go())

    seen = both(scenario)
    assert seen[:2] == ["cold", 1] and seen[2][:2] == (503, "model_warming")
    assert seen[3:] == [1, 2]


def test_idle_sweep_demotes_via_runtime():
    def scenario(ns):
        async def go():
            s = make_sched(ns, idle_demote_s=0.05)
            released = []

            class StubRuntime:
                def release_params(self):
                    released.append(1)

            async def warm_fn():
                return {}

            b = StubBatcher(pending=0)
            s.register("m", b, toy_model_cfg(ns, "m", cold_start=True),
                       runtime=StubRuntime(), warm_fn=warm_fn)
            seen = [s.state_of("m")]
            s._entries["m"].last_used = time.monotonic() - 1.0
            b.pending = 3
            seen.append(s.sweep_idle())   # queued work blocks demotion
            b.pending = 0
            seen += [s.sweep_idle(), s.state_of("m"), len(released)]
            s.register("pinned", StubBatcher(), toy_model_cfg(ns, "pinned"),
                       runtime=StubRuntime(), warm_fn=warm_fn)
            s._entries["pinned"].last_used = time.monotonic() - 1.0
            seen.append(s.sweep_idle())   # a model not cold_start never demotes
            return seen

        return asyncio.run(go())

    assert both(scenario) == ["warm", 0, 1, "cold", 1, 0]


def test_chip_budget_demotes_idle_then_sheds():
    """The chip budget (1 chip per warm model on one card): warming a cold
    model past it demotes an idle warm cold_start model first, and sheds
    503 ``chip_budget`` when no room can be made."""
    def scenario(ns):
        async def go():
            s = make_sched(ns, chip_budget=1)
            released = []

            class StubRuntime:
                def release_params(self):
                    released.append(1)

            async def warm_fn():
                return {"version": 2}

            busy = StubBatcher(pending=2)
            s.register("a", StubBatcher(), toy_model_cfg(ns, "a", cold_start=True),
                       runtime=StubRuntime(), warm_fn=warm_fn)
            s.register("b", busy, toy_model_cfg(ns, "b", cold_start=True),
                       runtime=StubRuntime(), warm_fn=warm_fn, cold=True)
            seen = [s.chips_in_use()]
            seen.append(shed(s.check_admission("b", "interactive")))  # demotes a
            seen += [s.state_of("a"), len(released)]
            await s.warm("b")
            s.register("c", StubBatcher(), toy_model_cfg(ns, "c", cold_start=True),
                       runtime=StubRuntime(), warm_fn=warm_fn, cold=True)
            seen.append(shed(s.check_admission("c", "interactive")))  # b is busy
            seen.append(s.stats()["chips_in_use"])
            await s.stop()
            return seen

        return asyncio.run(go())

    seen = both(scenario)
    assert seen[0] == 1 and seen[1][1] == "model_warming"
    assert seen[2:4] == ["cold", 1] and seen[4][:2] == (503, "chip_budget") and seen[5] == 1


# -- HTTP end to end: the port's server beside the reference's ------------------------

def toy_tree(key: int = 1):
    jm = jax_build(toy_model_cfg(PKGS["jax"]))
    return jax.device_get(jm.init_params(jax.random.key(key)))


class Side:
    """One server (the reference's or the port's) and an HTTP client."""

    def __init__(self, pkg: str, cfg_fn, tmp_path=None) -> None:
        ns = PKGS[pkg]
        self.pkg = pkg
        weights = None
        if tmp_path is not None:
            # The same seeded tree for both: an orbax checkpoint for the
            # reference, the port's .npz.
            weights = str(tmp_path / ("ckpt" if pkg == "jax" else "ckpt.npz"))
            if pkg == "jax":
                shutil.rmtree(weights, ignore_errors=True)
                save_orbax(weights, toy_tree(1))
            else:
                sm.save_npz(weights, toy_tree(1))
        self.state = build_state(pkg, cfg_fn(ns, weights))

    async def __aenter__(self):
        if self.pkg == "jax":
            self.client = TestClient(TestServer(make_app(self.state)))
            await self.client.start_server()
        else:
            self.server = await start_server(self.state, "127.0.0.1", 0)
            self.client = aiohttp.ClientSession(
                f"http://127.0.0.1:{self.state.serving_addresses[0][1]}")
        return self

    async def __aexit__(self, *exc):
        await self.client.close()
        if self.pkg == "port":
            await stop_server(self.state, self.server)

    async def call(self, method: str, path: str, data=None, headers=None, params=None):
        """(status, body without its trace id, Retry-After)."""
        async with self.client.request(method, path, data=data, headers=headers,
                                       params=params) as r:
            body = await r.json() if r.content_type == "application/json" else await r.text()
            if isinstance(body, dict):
                body.pop("trace_id", None)
            return r.status, body, r.headers.get("Retry-After")


def run_both(cfg_fn, scenario, tmp_path=None) -> dict:
    async def go(pkg):
        async with Side(pkg, cfg_fn, tmp_path / pkg if tmp_path else None) as side:
            return await scenario(side)

    out = {}
    for pkg in PKGS:
        if tmp_path is not None:
            (tmp_path / pkg).mkdir()
        out[pkg] = asyncio.run(go(pkg))
    return out


def test_unmeetable_deadline_shed_504_before_enqueue():
    """With a 5 s service EWMA on the books a 200 ms-deadline request sheds
    with a fast 504 ``deadline_unmeetable`` + Retry-After before decode or
    enqueue; a roomy deadline serves."""
    async def scenario(side):
        b = side.state.batchers["toy"]
        b._ewma_ms[(4,)] = 5000.0
        before = b._c_batches.value
        t0 = time.perf_counter()
        st, body, ra = await side.call("POST", "/v1/models/toy:predict", npy_image(), NPY,
                                       {"timeout_ms": "200"})
        fast = time.perf_counter() - t0 < 0.15
        # The remaining milliseconds are measured: normalized.
        body["error"] = re.sub(r"\d+ ms remaining", "N ms remaining", body["error"])
        seen = [st, body, ra, fast, b._c_batches.value == before,
                side.state.metrics.counter(
                    "sched_sheds_total{model=toy,reason=deadline_unmeetable}").value]
        seen.append((await side.call("POST", "/v1/models/toy:predict", npy_image(), NPY,
                                     {"timeout_ms": "30000"}))[0])
        return seen

    out = run_both(lambda ns, w: sched_server_cfg(ns, [toy_model_cfg(ns)]), scenario)
    assert out["port"] == out["jax"]
    st, body, ra, fast, untouched, sheds, roomy = out["port"]
    assert st == 504 and body["reason"] == "deadline_unmeetable" and int(ra) >= 1
    assert fast and untouched and sheds == 1 and roomy == 200


def test_priority_shed_and_queue_wait_split_http():
    """Both classes serve and land in their own queue-wait histogram; junk
    X-Priority 400s; a saturated fleet sheds batch-class 503
    ``priority_shed`` with Retry-After; /stats' scheduler block counts it."""
    async def scenario(side):
        seen = []
        for prio in ("interactive", "batch"):
            seen.append((await side.call("POST", "/v1/models/toy:predict", npy_image(),
                                         {**NPY, "X-Priority": prio}))[0])
        seen.append([side.state.metrics.queue_wait_histogram("toy", p).n >= 1
                     for p in ("interactive", "batch")])
        seen.append((await side.call("POST", "/v1/models/toy:predict", npy_image(),
                                     {**NPY, "X-Priority": "urgent"}))[:2])
        b = side.state.batchers["toy"]
        b._ewma_ms[(1,)] = 1000.0
        b._pending = 5
        seen.append(side.state.scheduler.saturated())
        seen.append(await side.call("POST", "/v1/models/toy:predict", npy_image(),
                                    {**NPY, "X-Priority": "batch"}))
        b._pending = 0
        stats = (await side.call("GET", "/stats"))[1]["scheduler"]
        row = stats["models"]["toy"]
        seen.append((row["sheds"], row["state"], row["priority"], row["cold_start"],
                     stats["min_share"], stats["overload_clear_s"], stats["chips_in_use"],
                     sorted(stats), sorted(row)))
        return seen

    out = run_both(lambda ns, w: sched_server_cfg(
        ns, [toy_model_cfg(ns)],
        scheduler=ns.cfg.SchedulerConfig(enabled=True, overload_clear_s=0.5)), scenario)
    assert out["port"] == out["jax"]
    seen = out["port"]
    assert seen[:3] == [200, 200, [True, True]]
    assert seen[3][0] == 400 and seen[4] is True
    st, body, ra = seen[5]
    assert st == 503 and body["reason"] == "priority_shed" and int(ra) >= 1
    assert seen[6][0] == {"priority_shed": 1} and seen[6][4] == 0.05


async def _poll_until_200(side, deadline_s=30.0):
    t0 = time.monotonic()
    statuses = []
    while time.monotonic() - t0 < deadline_s:
        st, body, ra = await side.call("POST", "/v1/models/toy:predict", npy_image(7), NPY)
        statuses.append((st, body.get("reason") if st != 200 else None, ra))
        if st == 200:
            return statuses, [e["prob"] for e in body["top_k"]]
        assert st == 503, body  # warming sheds only
        await asyncio.sleep(0.05)
    raise AssertionError(f"never warmed: {statuses}")


def test_cold_start_warm_demote_rewarm_zero_recompiles(tmp_path):
    """Weight paging end to end on the same seeded checkpoint: a cold model
    boots with no params and no compile; its first request sheds 503
    ``model_warming`` and starts the warm through the lifecycle; the idle
    sweep demotes (params released, the gauge back to 0); the next request
    warms again with ``runtime_compiles_total`` unchanged and a newer
    version; the answers equal the reference's and, within each server,
    equal across the re-warm."""
    async def scenario(side):
        rt = side.state.runtimes["toy"]
        gauge = side.state.metrics.gauge("model_state{model=toy}")
        seen = {"boot": (rt.params_resident, rt.compiles_total, gauge.value)}
        statuses, probs = await _poll_until_200(side)
        seen["first"] = (statuses[0], statuses[-1][0], rt.params_resident, rt.version)
        compiles = rt.compiles_total
        t0 = time.monotonic()
        while rt.params_resident and time.monotonic() - t0 < 10.0:
            await asyncio.sleep(0.05)
        seen["demoted"] = (rt.params_resident, side.state.scheduler.state_of("toy"), gauge.value)
        # The re-warm's first shed hints the last warm's own wall time
        # (fleet.py: max(1, ceil(last_warm_s))), which each package measures
        # on its own clock: held within each side, not across them.
        stats = (await side.call("GET", "/stats"))[1]
        last_warm_ms = stats["scheduler"]["models"]["toy"]["last_warm_ms"]
        hint = str(max(1, math.ceil(last_warm_ms / 1000)))
        statuses2, probs2 = await _poll_until_200(side)
        (st2, reason2, ra2) = statuses2[0]
        seen["rewarm"] = ((st2, reason2, ra2 == hint), rt.compiles_total == compiles,
                          rt.version, probs2 == probs, gauge.value)
        seen["sheds"] = side.state.metrics.counter(
            "sched_sheds_total{model=toy,reason=model_warming}").value >= 2
        return seen, probs, compiles

    out = run_both(lambda ns, w: sched_server_cfg(
        ns, [toy_model_cfg(ns, cold_start=True, weights=w)],
        scheduler=ns.cfg.SchedulerConfig(enabled=True, idle_demote_s=0.3,
                                         sweep_interval_s=0.05)), scenario, tmp_path)
    (jseen, jprobs, jcompiles), (pseen, pprobs, pcompiles) = out["jax"], out["port"]
    assert pseen == jseen
    assert pseen["boot"] == (False, 0, 0.0)
    assert pseen["first"][0] == (503, "model_warming", "5") and pseen["first"][2] is True
    assert pseen["demoted"] == (False, "cold", 0.0)
    assert pseen["rewarm"][0] == (503, "model_warming", True)
    assert pseen["rewarm"][1] is True and pseen["rewarm"][2] == 3 and pseen["rewarm"][3] is True
    assert pseen["rewarm"][4] == 2.0 and pseen["sheds"]
    assert pcompiles == jcompiles == 3
    np.testing.assert_allclose(pprobs, jprobs, rtol=0, atol=1e-6)


def test_warm_endpoint_http():
    """``:warm`` stages a cold model synchronously; ``/stats`` shows the
    state; a second ``:warm`` answers ``already_warm``; an unknown model
    404s; without a scheduler ``:warm`` 409s."""
    async def scenario(side):
        seen = [(await side.call("GET", "/stats"))[1]["scheduler"]["models"]["toy"]["state"]]
        st, body, _ = await side.call("POST", "/admin/models/toy:warm")
        seen.append((st, sorted(body), body["state"], body["version"], body["warm_ms"] > 0,
                     side.state.runtimes["toy"].params_resident))
        seen.append((await side.call("POST", "/v1/models/toy:predict", npy_image(), NPY))[0])
        seen.append(await side.call("POST", "/admin/models/toy:warm"))
        seen.append((await side.call("POST", "/admin/models/nope:warm"))[0])
        return seen

    out = run_both(lambda ns, w: sched_server_cfg(ns, [toy_model_cfg(ns, cold_start=True)]),
                   scenario)
    assert out["port"] == out["jax"]
    assert out["port"] == ["cold",
                           (200, ["model", "state", "version", "warm_ms"], "warm", 2, True, True),
                           200, (200, {"model": "toy", "state": "warm", "already_warm": True},
                                 None), 404]

    async def refused(side):
        return await side.call("POST", "/admin/models/toy:warm")

    out = run_both(lambda ns, w: ns.cfg.ServerConfig(models=[toy_model_cfg(ns)],
                                                     decode_threads=2, startup_canary=False),
                   refused)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 409


def test_demote_endpoint_http_and_audit():
    """``:demote`` pages a warm cold_start model out (200 ``demoted``
    true, then false), the next request warms it again; each verb leaves
    its audit record; a model not declared cold_start is never demoted."""
    async def scenario(side):
        seen = [(await side.call("POST", "/admin/models/toy:warm"))[0]]
        seen.append(await side.call("POST", "/admin/models/toy:demote"))
        seen.append(await side.call("POST", "/admin/models/toy:demote"))
        seen.append(await side.call("POST", "/admin/models/pinned:demote"))
        seen.append((side.state.scheduler.state_of("toy"),
                     side.state.runtimes["toy"].params_resident))
        # The re-warm's shed hints the last warm's own wall time (fleet.py:
        # max(1, ceil(last_warm_s))), which each package measures on its
        # own clock: held within each side, not across them.
        stats = (await side.call("GET", "/stats"))[1]
        last_warm_ms = stats["scheduler"]["models"]["toy"]["last_warm_ms"]
        hint = str(max(1, math.ceil(last_warm_ms / 1000)))
        st, body, ra = await side.call("POST", "/v1/models/toy:predict", npy_image(), NPY)
        seen.append((st, body.get("reason"), ra == hint))
        audit = (await side.call("GET", "/debug/audit"))[1]["audit"]
        seen.append(sorted((r["verb"], r["target"], r["outcome"], r.get("demoted"))
                           for r in audit))
        return seen

    out = run_both(lambda ns, w: sched_server_cfg(
        ns, [toy_model_cfg(ns, cold_start=True), toy_model_cfg(ns, "pinned")]), scenario)
    assert out["port"] == out["jax"]
    seen = out["port"]
    assert seen[0] == 200
    assert seen[1] == (200, {"model": "toy", "demoted": True}, None)
    assert seen[2] == (200, {"model": "toy", "demoted": False}, None)
    assert seen[3] == (200, {"model": "pinned", "demoted": False}, None)
    assert seen[4] == ("cold", False) and seen[5] == (503, "model_warming", True)
    assert ("demote", "toy", "ok", True) in seen[6] and ("warm", "toy", "ok", None) in seen[6]


def test_quiet_model_survives_hot_neighbor_saturation():
    """A hot model with slow compute and a deep backlog does not starve a
    quiet model's interactive traffic: every quiet request answers 200."""
    async def scenario(side):
        async def one(i):
            return (await side.call("POST", "/v1/models/hot:predict", npy_image(i), NPY))[0]

        flood = asyncio.ensure_future(asyncio.gather(*(one(i) for i in range(24))))
        await asyncio.sleep(0.2)
        quiet = [(await side.call("POST", "/v1/models/quiet:predict", npy_image(100 + i),
                                  NPY))[0] for i in range(10)]
        await flood
        return quiet

    out = run_both(lambda ns, w: sched_server_cfg(
        ns, [toy_model_cfg(ns, "hot"), toy_model_cfg(ns, "quiet")],
        scheduler=ns.cfg.SchedulerConfig(enabled=True, overload_clear_s=0.2),
        faults=ns.cfg.FaultsConfig(enabled=True, rules=[ns.cfg.FaultRuleConfig(
            kind="slow_compute", model="hot", probability=1.0, delay_ms=60.0)])), scenario)
    assert out["port"] == out["jax"] == [200] * 10


# -- the isolation drill ---------------------------------------------------------------

def test_fleet_drill_victim_contained_survivors_hold():
    """run_fleet_drill on both packages: 3 toy models, one poisoned with
    device_error at 100 %: the victim's breaker opens and both survivors
    hold availability >= 0.99; the same summary keys, roles and breaker
    states."""
    def scenario(ns):
        cfg = sched_server_cfg(ns, [toy_model_cfg(ns, "victim", breaker_threshold=3),
                                    toy_model_cfg(ns, "ok_a"), toy_model_cfg(ns, "ok_b")])
        kw = dict(victim="victim", duration_s=1.5, warmup_s=0.3, concurrency=4)
        if ns is PKGS["port"]:
            kw["device"] = "cpu"
        s = asyncio.run(ns.sched.run_fleet_drill(cfg, **kw))
        fired = any(f["kind"] == "device_error" and f["fired"] > 0 for f in s["faults"])
        return (s["victim"], s["victim_breaker_open"], s["availability"] >= 0.99,
                {n: (r["role"], r["availability"] >= 0.99, r["n_ok"] > 0)
                 for n, r in s["models"].items()},
                s["breakers"]["victim"]["state"], fired,
                sorted(set(s) - {"kernels"}), sorted(s["scheduler"]))

    got = both(scenario)
    assert got[0] == "victim" and got[1] and got[2] and got[5]
    assert got[3] == {"victim": ("victim", False, False), "ok_a": ("survivor", True, True),
                      "ok_b": ("survivor", True, True)}


def test_fleet_drill_requires_three_models():
    def scenario(ns):
        cfg = sched_server_cfg(ns, [toy_model_cfg(ns, "a"), toy_model_cfg(ns, "b")])
        with pytest.raises(ValueError, match=">= 3 models") as e:
            asyncio.run(ns.sched.run_fleet_drill(cfg))
        return str(e.value)

    both(scenario)


# -- port-only: the runtime's paging contract --------------------------------------------

def test_dispatch_on_a_released_runtime_raises():
    """A cold runtime has no slot and a demoted one released its slots: a
    dispatch raises instead of replaying over storage another model may now
    own; a staged candidate is dispatchable before its publish (the staged
    canary), the live slot only after it."""
    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    model = build(toy_model_cfg(PKGS["port"]))
    rt = build_runtime(model, device="cpu", cold=True)
    host = model.assemble([model.canary_item()], (1,))
    assert not rt.params_resident and rt.compiles_total == 0 and rt.slots == []
    with pytest.raises(RuntimeError, match="not resident"):
        rt.run((1,), host)
    staged = rt.stage_params()
    assert len(rt.slots) == 3 and not rt.params_resident
    with pytest.raises(RuntimeError, match="not resident"):
        rt.run((1,), host)
    assert rt.ensure_compiled() == 3 and rt.compiles_total == 3
    staged_out = rt.fetch(rt.run((1,), host, params_override=staged))
    rt.publish(staged)
    assert rt.params_resident and rt.version == 2
    live = rt.fetch(rt.run((1,), host))
    assert live.keys() == staged_out.keys()
    for k in live:
        np.testing.assert_array_equal(live[k], staged_out[k])
    rt.release_params()
    assert not rt.params_resident and rt.slots == [] and rt.previous_version is None
    with pytest.raises(RuntimeError, match="not resident"):
        rt.run((1,), host)
    with pytest.raises(RuntimeError, match="not resident"):
        rt.run((1,), host, params_override=staged)
    # The re-warm: no compile; the same answers.
    rt.publish(rt.stage_params())
    assert rt.ensure_compiled() == 0 and rt.compiles_total == 3 and rt.captures_total == 0
    again = rt.fetch(rt.run((1,), host))
    for k in live:
        np.testing.assert_array_equal(again[k], live[k])
    assert rt.describe()["params_resident"] is True


def test_failed_capture_at_warm_leaves_the_model_cold_and_shedding(monkeypatch):
    """A warm whose capture fails (ensure_compiled raising, as a failed CUDA
    capture does) is rejected at the lifecycle's load gate: the model stays
    cold, every request sheds 503 ``model_warming``, ``:warm`` answers 500,
    and no request is ever served eagerly."""
    from tpuserve_torch.runtime import ModelRuntime

    def failed_capture(self):
        raise RuntimeError("CUDA graph capture failed (injected)")

    cfg = sched_server_cfg(PKGS["port"], [toy_model_cfg(PKGS["port"], cold_start=True)])
    state = build_state("port", cfg)
    monkeypatch.setattr(ModelRuntime, "ensure_compiled", failed_capture)

    async def run():
        server = await start_server(state, "127.0.0.1", 0)
        base = f"http://127.0.0.1:{state.serving_addresses[0][1]}"
        try:
            async with aiohttp.ClientSession(base) as s:
                async with s.post("/admin/models/toy:warm") as r:
                    warm = (r.status, (await r.json())["error"])
                seen = []
                for _ in range(3):
                    async with s.post("/v1/models/toy:predict", data=npy_image(),
                                      headers=NPY) as r:
                        seen.append((r.status, (await r.json()).get("reason")))
                rt = state.runtimes["toy"]
                return (warm, seen, state.scheduler.state_of("toy"), rt.params_resident,
                        state.batchers["toy"]._c_batches.value)
        finally:
            await stop_server(state, server)

    warm, seen, sched_state, resident, batches = asyncio.run(run())
    assert warm[0] == 500 and "capture failed" in warm[1] and "stays cold" in warm[1]
    assert seen == [(503, "model_warming")] * 3
    assert sched_state == "cold" and not resident and batches == 0
