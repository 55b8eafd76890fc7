"""The port's robustness layer against the reference's: each scenario of
``tests/test_faults.py`` (the deferred ``worker_death`` one aside) run on
both packages — the fault injector, the circuit breaker and the watchdog as
units, then served: both servers side by side on the CPU, the toy model
from the same weights (the JAX package's seed-0 tree; the port reads it
from a ``.npz``). The reference drives its availability drills with its
aiohttp load generator (``run_chaos``); here a plain asyncio client sends
the same load (8 concurrent clients) to both servers.

Held exactly, on both servers: status codes, error messages' shed reasons
(``circuit open``, ``draining``), ``Retry-After`` values, breaker states and
counters (``describe()``), injected-fault counts where the call sequence is
deterministic, retry and watchdog counters, lifecycle outcomes of the
reload drills, and drain outcomes. Held with the reference's bounds:
availability >= 0.99 under a 10 % batch-failure rate and under the reload
drills. The breaker's fast shed is held by what it skips (no shed request
reaches decode or the batcher) and by a shed p50 under 25 ms, recovery by
two canary intervals + 1 s: the reference's 5 ms and + 0.1 s are timing
bounds that parallel test workers can break. The two servers' top-k
probabilities agree within 1e-6 (float32 toy, two frameworks).
"""

import asyncio
import io
import os
import signal
import time

import aiohttp
import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tpuserve import config as jconfig
from tpuserve import faults as jfaults
from tpuserve import obs as jobs
from tpuserve.models import build as jax_build
from tpuserve.server import ServerState as JaxServerState
from tpuserve.server import make_app
from tpuserve.server import serve_async as jax_serve_async
from tpuserve_torch import config as tconfig
from tpuserve_torch import faults as tfaults
from tpuserve_torch import obs as tobs
from tpuserve_torch import savedmodel as sm
from tpuserve_torch.server import ServerState, serve_async, start_server, stop_server

PKGS = {"jax": (jconfig, jfaults, jobs), "port": (tconfig, tfaults, tobs)}
NPY = {"Content-Type": "application/x-npy"}
PREDICT = "/v1/models/toy:predict"
MODEL = dict(name="toy", family="toy", batch_buckets=[1, 2, 4], deadline_ms=5.0,
             dtype="float32", num_classes=10, parallelism="single",
             request_timeout_ms=10_000.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """The JAX package's seed-0 toy tree (its default init) as the port's
    checkpoint, so both servers answer from the same weights."""
    jm = jax_build(jconfig.ModelConfig(**MODEL))
    path = str(tmp_path_factory.mktemp("toy") / "toy.npz")
    sm.save_npz(path, jax.device_get(jm.init_params(jax.random.key(0))))
    return path


def npy_image(seed: int = 0) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.random.default_rng(seed).integers(0, 200, (8, 8, 3), dtype=np.uint8))
    return buf.getvalue()


def server_cfg(pkg, npz, model_over=None, rules=(), seed=0, **over):
    cfgm = PKGS[pkg][0]
    model = dict(MODEL, **(model_over or {}))
    if pkg == "port":
        model["weights"] = npz
    faults = cfgm.FaultsConfig(enabled=bool(rules), seed=seed,
                               rules=[cfgm.FaultRuleConfig(**r) for r in rules])
    return cfgm.ServerConfig(models=[cfgm.ModelConfig(**model)], decode_threads=2,
                             faults=faults, **over)


class Side:
    """One server (the JAX package's or the port's) and an HTTP client."""

    def __init__(self, pkg: str, npz: str, **cfg_kw) -> None:
        self.pkg = pkg
        cfg = server_cfg(pkg, npz, **cfg_kw)
        self.state = JaxServerState(cfg) if pkg == "jax" else ServerState(cfg, device="cpu")
        self.state.build()

    async def __aenter__(self):
        if self.pkg == "jax":
            self.client = TestClient(TestServer(make_app(self.state)))
            await self.client.start_server()
        else:
            self.server = await start_server(self.state, "127.0.0.1", 0)
            port = self.state.serving_addresses[0][1]
            self.client = aiohttp.ClientSession(f"http://127.0.0.1:{port}")
        return self

    async def __aexit__(self, *exc):
        await self.client.close()
        if self.pkg == "port":
            await stop_server(self.state, self.server)

    async def request(self, method: str, path: str, data=None, headers=None):
        async with self.client.request(method, path, data=data, headers=headers) as r:
            body = await r.json() if r.content_type == "application/json" else await r.text()
            return r.status, body, r.headers.get("Retry-After")

    async def predict(self, seed: int = 0):
        return await self.request("POST", PREDICT, npy_image(seed), NPY)

    async def load(self, n_clients: int = 8, per_client: int = 40) -> list[int]:
        """A plain closed-loop load: each client sends ``per_client``
        requests back to back; returns every status."""
        async def client(c):
            return [(await self.predict(c * 1000 + i))[0] for i in range(per_client)]
        return [s for part in await asyncio.gather(*(client(c) for c in range(n_clients)))
                for s in part]


def both(npz, scenario, **cfg_kw) -> tuple[dict, dict]:
    """Run ``scenario(side)`` against the JAX server, then the port's."""
    out = []
    for pkg in ("jax", "port"):
        async def go(pkg=pkg):
            async with Side(pkg, npz, **cfg_kw) as side:
                return await scenario(side)
        out.append(asyncio.run(go()))
    return out[0], out[1]


# -- FaultInjector ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 8])
def test_injector_is_deterministic(seed):
    """The same rule and seed fire the same sequence in both packages."""
    def draws(mod):
        inj = mod.FaultInjector.single("batch_error", probability=0.3, seed=seed)
        return [inj.fire("batch_error", "m") is not None for _ in range(200)]

    assert draws(tfaults) == draws(jfaults)
    assert 0.15 < sum(draws(tfaults)) / 200 < 0.45


@pytest.mark.parametrize("pkg", PKGS)
def test_injector_count_filters_toggle_delay(pkg):
    _, fmod, omod = PKGS[pkg]
    inj = fmod.FaultInjector.single("batch_error", count=2)
    assert [inj.fire("batch_error", "m") is not None for _ in range(10)] == [True] * 2 + [False] * 8
    assert (inj.snapshot()[0]["fired"], inj.snapshot()[0]["remaining"]) == (2, 0)
    inj = fmod.FaultInjector.single("batch_error", model="a")
    assert inj.fire("batch_error", "b") is None and inj.fire("slow_dispatch", "a") is None
    assert inj.fire("batch_error", "a") is not None
    inj.set_enabled(False)
    assert inj.fire("batch_error", "a") is None
    inj.set_enabled(True)
    with pytest.raises(fmod.FaultInjected):
        inj.check("batch_error", "a")
    m = omod.Metrics()
    inj = fmod.FaultInjector.single("slow_dispatch", delay_ms=250.0, metrics=m)
    assert inj.delay_s("slow_dispatch", "m") == pytest.approx(0.25)
    assert m.counter("faults_injected_total{model=m,kind=slow_dispatch}").value == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_faults_config_from_toml(pkg, tmp_path):
    cfgm = PKGS[pkg][0]
    with pytest.raises(ValueError, match="unknown fault kind"):
        cfgm.FaultRuleConfig(kind="nope")
    p = tmp_path / "chaos.toml"
    p.write_text('port = 8001\n[faults]\nenabled = true\nseed = 42\n'
                 '[[faults.rule]]\nkind = "batch_error"\nmodel = "toy"\nprobability = 0.1\n'
                 '[[faults.rule]]\nkind = "slow_dispatch"\ndelay_ms = 50.0\ncount = 3\n'
                 '[[faults.rule]]\nkind = "kill_group_loop"\ncount = 1\n')
    cfg = cfgm.load_config(str(p))
    assert cfg.faults.enabled and cfg.faults.seed == 42
    assert [r.kind for r in cfg.faults.rules] == ["batch_error", "slow_dispatch",
                                                  "kill_group_loop"]
    assert cfg.faults.rules[0].probability == 0.1 and cfg.faults.rules[1].count == 3
    if pkg == "port":
        assert tconfig.unported_settings(cfg) == []


# -- CircuitBreaker and Watchdog ------------------------------------------------------

def _breaker_trace(fmod, omod, threshold, events) -> list:
    m = omod.Metrics()
    br = fmod.CircuitBreaker("m", threshold=threshold, metrics=m)
    out = []
    for ev in events:
        getattr(br, ev)()
        out.append((br.state, br.allow(), br.describe(),
                    m.gauge("breaker_state{model=m}").value))
    return out


@pytest.mark.parametrize("threshold, events", [
    (3, ["record_failure"] * 3 + ["probe", "record_failure", "probe", "record_success",
                                  "on_shed", "record_failure"]),
    (0, ["record_failure"] * 10 + ["probe", "on_shed"]),
    (3, ["record_failure", "record_failure", "record_success", "record_failure",
         "record_failure"]),
    (1, ["record_failure", "on_shed", "on_shed", "record_success", "record_failure",
         "probe", "record_success"]),
])
def test_breaker_state_machine(threshold, events):
    """closed -> open -> half_open -> closed on the same event sequence:
    states, allow(), describe() and the gauge equal on both packages."""
    trace = _breaker_trace(tfaults, tobs, threshold, events)
    assert trace == _breaker_trace(jfaults, jobs, threshold, events)
    if threshold == 3 and len(events) == 9:
        assert [s for s, *_ in trace][:7] == ["closed", "closed", "open", "half_open",
                                              "open", "half_open", "closed"]
        assert trace[-1][2]["opened_total"] == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_watchdog_sweep_unit(pkg):
    _, fmod, omod = PKGS[pkg]
    m = omod.Metrics()
    wd = fmod.Watchdog(1.0, m)
    wd.register("a", "group_loop", lambda: 2)
    wd.register("a", "worker", lambda: 0)

    def boom() -> int:
        raise RuntimeError("sweep failed")

    wd.register("b", "group_loop", boom)
    assert wd.sweep() == 2
    assert m.counter("watchdog_restarts_total{model=a,component=group_loop}").value == 2


# -- served ---------------------------------------------------------------------------

def test_one_shot_device_error_answers_200(npz):
    """A one-shot device_error below the batcher: the retry absorbs it and
    the client gets 200 on both servers, with the same top-k."""
    async def scenario(side):
        status, body, _ = await side.predict()
        fired = [r["fired"] for r in side.state.injector.snapshot()]
        return {"status": status, "fired": fired, "body": body,
                "retries": side.state.metrics.counter("batch_retries_total{model=toy}").value}

    j, t = both(npz, scenario, rules=[dict(kind="device_error", model="toy", count=1)])
    jb, tb = j.pop("body"), t.pop("body")
    assert t == j == {"status": 200, "fired": [1], "retries": 1}
    assert [e["class"] for e in tb["top_k"]] == [e["class"] for e in jb["top_k"]]
    np.testing.assert_allclose([e["prob"] for e in tb["top_k"]],
                               [e["prob"] for e in jb["top_k"]], atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind, want", [("slow_compute", 200), ("decode_corrupt", 400)])
def test_below_and_above_batcher_faults(npz, kind, want):
    """slow_compute sleeps inside the runtime's dispatch (the request still
    answers 200, at least the delay later); decode_corrupt answers 400 once,
    then its budget is spent."""
    async def scenario(side):
        t0 = time.perf_counter()
        s1 = (await side.predict())[0]
        elapsed = time.perf_counter() - t0
        s2 = (await side.predict())[0]
        return {"statuses": (s1, s2), "slow": elapsed >= 0.3,
                "fired": [r["fired"] for r in side.state.injector.snapshot()]}

    j, t = both(npz, scenario, startup_canary=False,
                rules=[dict(kind=kind, model="toy", count=1, delay_ms=300.0)])
    assert t == j
    assert t["statuses"] == (want, 200) and t["fired"] == [1]
    assert t["slow"] == (kind == "slow_compute")


def test_availability_with_10pct_batch_failures(npz):
    """A 10 % batch-failure rate (seed 1) under 8 clients: >= 99 % of 320
    requests succeed through the one-shot retry, the faults really fired,
    and the breaker never trips, on both servers."""
    async def scenario(side):
        statuses = await side.load()
        br = side.state.breakers["toy"].describe()
        fired = sum(r["fired"] for r in side.state.injector.snapshot())
        return {"availability": statuses.count(200) / len(statuses), "fired": fired,
                "breaker": (br["state"], br["opened_total"])}

    j, t = both(npz, scenario, seed=1,
                rules=[dict(kind="batch_error", model="toy", probability=0.10)])
    for side in (j, t):
        assert side["availability"] >= 0.99, side
        assert side["fired"] > 5, side
        assert side["breaker"] == ("closed", 0)


@pytest.mark.parametrize("kind, stage", [("reload_corrupt", "integrity"),
                                         ("reload_nan", "nan_scan")])
def test_reload_drill_availability(npz, kind, stage):
    """Every reload fails its gate while :reload is hammered under load: the
    original version keeps serving, no candidate ever publishes, and
    availability stays >= 99 %, on both servers."""
    async def scenario(side):
        stop = asyncio.Event()
        outcomes = []

        async def drill():
            while not stop.is_set():
                status, body, _ = await side.request("POST", "/admin/models/toy:reload")
                outcomes.append((status, body.get("stage"), body.get("version")))
                await asyncio.sleep(0.05)

        task = asyncio.ensure_future(drill())
        statuses = await side.load(per_client=25)
        stop.set()
        await task
        _, stats, _ = await side.request("GET", "/stats")
        lc = stats["lifecycle"]["toy"]
        return {"availability": statuses.count(200) / len(statuses),
                "outcomes": set(outcomes), "attempts": len(outcomes),
                "live": lc["live_version"],
                "history": {h["status"] for h in lc["history"]}}

    j, t = _drill_both(npz, scenario, kind)
    for side in (j, t):
        assert side["availability"] >= 0.99, side
        assert side["attempts"] >= 3, side
        assert side["outcomes"] == {(409, stage, 1)}, side
        assert side["live"] == 1 and side["history"] <= {"live", "rejected"}


def _drill_both(npz, scenario, kind):
    """Both servers for the reload drills; the JAX server reloads an orbax
    checkpoint of the same tree the port reads from its ``.npz``."""
    from tpuserve.savedmodel import save_orbax

    ckpt = os.path.join(os.path.dirname(npz), "jax_ckpt")
    if not os.path.exists(ckpt):
        save_orbax(ckpt, sm.load_npz(npz))
    out = []
    for pkg, weights in (("jax", ckpt), ("port", npz)):
        async def go(pkg=pkg, weights=weights):
            async with Side(pkg, npz, model_over=dict(weights=weights),
                            rules=[dict(kind=kind, model="toy")]) as side:
                return await scenario(side)
        out.append(asyncio.run(go()))
    return out[0], out[1]


def test_breaker_trips_fast_503_and_recovers_via_canary(npz):
    """Every dispatch fails: after breaker_threshold (2) failed requests
    (500) the breaker opens and predict sheds with a fast 503 + Retry-After
    (1: the canary interval), dispatching nothing; once the fault stops, the
    periodic canary half-opens and closes the breaker within two intervals,
    and 200s return."""
    interval = 0.25

    async def scenario(side):
        b = side.state.batchers["toy"]
        pkg_faults = PKGS[side.pkg][1]
        b.injector = pkg_faults.FaultInjector.single("batch_error")
        first = [(await side.predict())[0] for _ in range(2)]
        opened = side.state.breakers["toy"].state
        requests = side.state.metrics.counter("requests_total{model=toy}")
        requests0 = requests.value
        lat_ms, sheds = [], set()
        for _ in range(40):
            t0 = time.perf_counter()
            status, body, retry_after = await side.predict()
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            sheds.add((status, retry_after, "circuit open" in body["error"]))
        # No shed request was decoded or submitted (requests_total counts
        # the ones past the shed checks); only canaries ride the batcher.
        requests1 = requests.value
        shed_total = side.state.breakers["toy"].shed_total
        b.injector = None
        t_stop = time.perf_counter()
        deadline = t_stop + 2 * interval + 1.0
        while time.perf_counter() < deadline:
            status = (await side.predict())[0]
            if status == 200:
                break
            await asyncio.sleep(0.01)
        recovered_s = time.perf_counter() - t_stop
        _, text, _ = await side.request("GET", "/metrics")
        return {"first": first, "opened": opened, "sheds": sheds, "shed_total": shed_total,
                "p50_fast": sorted(lat_ms)[20] < 25.0,
                "none_reached_the_batcher": requests1 == requests0,
                "recovered": (status, recovered_s <= 2 * interval + 1.0,
                              side.state.breakers["toy"].state),
                "metrics": ('breaker_state{model="toy"}' in text,
                            'breaker_shed_total{model="toy"}' in text)}

    j, t = both(npz, scenario, model_over=dict(breaker_threshold=2),
                canary_interval_s=interval)
    assert t == j
    assert t["first"] == [500, 500] and t["opened"] == "open"
    assert t["sheds"] == {(503, "1", True)} and t["shed_total"] == 40
    assert t["recovered"] == (200, True, "closed")


def test_429_carries_retry_after_and_stats_robustness(npz):
    async def scenario(side):
        first = asyncio.ensure_future(side.predict())
        await asyncio.sleep(0.05)  # queued, batch not yet flushed
        status, _, retry_after = await side.predict()
        fst, fbody, _ = await first
        _, stats, _ = await side.request("GET", "/stats")
        rob = stats["robustness"]
        return {"shed": (status, retry_after), "first": (fst, len(fbody["top_k"])),
                "draining": rob["draining"], "breaker": rob["breakers"]["toy"]}

    j, t = both(npz, scenario, model_over=dict(max_queue=1, deadline_ms=200.0))
    assert t == j
    assert t["shed"] == (429, "1") and t["first"][0] == 200
    assert t["breaker"] == {"state": "closed", "threshold": 5, "consecutive_errors": 0,
                            "opened_total": 0, "shed_total": 0}


def test_watchdog_revives_killed_group_loop(npz):
    async def scenario(side):
        b = side.state.batchers["toy"]
        b.injector = PKGS[side.pkg][1].FaultInjector.single("kill_group_loop", count=1)
        s1 = (await side.predict())[0]
        await asyncio.sleep(0.02)
        (task,) = b._tasks.values()
        died = task.done() and type(task.exception()).__name__ == "FaultInjected"
        await asyncio.sleep(0.2)  # a few watchdog sweeps
        (task,) = b._tasks.values()
        restarts = side.state.metrics.counter(
            "watchdog_restarts_total{model=toy,component=group_loop}").value
        s2 = (await side.predict())[0]
        return {"statuses": (s1, s2), "died": died, "revived": not task.done(),
                "restarts": restarts >= 1}

    j, t = both(npz, scenario, watchdog_interval_s=0.05)
    assert t == j == {"statuses": (200, 200), "died": True, "revived": True,
                      "restarts": True}


def test_drain_completes_accepted_rejects_new(npz):
    async def scenario(side):
        inflight = [asyncio.ensure_future(side.predict(i)) for i in range(5)]
        await asyncio.sleep(0.05)  # all accepted, the dispatch mid-sleep
        drain_task = asyncio.ensure_future(side.state.drain())
        await asyncio.sleep(0)
        late = await side.predict()
        health = await side.request("GET", "/healthz")
        _, stats, _ = await side.request("GET", "/stats")
        done = [s for s, _, _ in await asyncio.gather(*inflight)]
        return {"late": (late[0], late[2], "draining" in late[1]["error"]),
                "health": (health[0], health[1]["status"]),
                "stats_draining": stats["robustness"]["draining"],
                "accepted": done, "drained": await drain_task}

    j, t = both(npz, scenario, drain_timeout_s=5.0,
                rules=[dict(kind="slow_dispatch", delay_ms=150.0)])
    assert t == j == {"late": (503, "1", True), "health": (503, "draining"),
                      "stats_draining": True, "accepted": [200] * 5, "drained": True}


@pytest.mark.parametrize("pkg", PKGS)
def test_sigterm_drains_under_load(npz, pkg):
    """serve_async end to end: SIGTERM while requests are in flight; every
    accepted request answers 200, then the server exits."""
    cfg = server_cfg(pkg, npz, host="127.0.0.1", port=0, startup_canary=False,
                     drain_timeout_s=10.0,
                     rules=[dict(kind="slow_dispatch", delay_ms=150.0)])
    state = JaxServerState(cfg) if pkg == "jax" else ServerState(cfg, device="cpu")
    state.build()
    serve = jax_serve_async if pkg == "jax" else serve_async

    async def go():
        ready = asyncio.Event()
        server = asyncio.ensure_future(serve(state, ready=ready))
        await ready.wait()
        url = f"http://127.0.0.1:{state.serving_addresses[0][1]}{PREDICT}"
        async with aiohttp.ClientSession() as session:
            async def one(i):
                async with session.post(url, data=npy_image(i), headers=NPY) as r:
                    return r.status, await r.json()

            reqs = [asyncio.ensure_future(one(i)) for i in range(4)]
            await asyncio.sleep(0.05)
            os.kill(os.getpid(), signal.SIGTERM)
            results = await asyncio.gather(*reqs)
        await asyncio.wait_for(server, 30)
        return results

    results = asyncio.run(go())
    assert [s for s, _ in results] == [200] * 4
    assert all("top_k" in body for _, body in results)
    assert state.draining
