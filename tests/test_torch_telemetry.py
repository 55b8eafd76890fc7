"""The port's telemetry plane (``tpuserve_torch.telemetry``: store, slo,
profile; the server's history, alerts, utilization and profile routes)
against the reference's (``tests/test_telemetry.py``), without the router's
fleet scrape and the fleet scheduler's hook.

Units run on both packages (``pkg`` = "jax" or "port") with the same
injected samples and clocks and must agree exactly: bounded rings,
reset-safe counter increases and rates, histogram window deltas and their
quantiles, the SLO engine's objective interpolation and its ok / pending /
firing machine (burn windows of 0.4-1 s: the reference's margins), the
utilization derivation from ``device_seconds_total``, the sampler thread's
clean stop and the ``[telemetry]`` / ``[model.slo]`` config.

Over HTTP both servers run side by side on the CPU (the toy model with a
20 ms objective, the sampler ticked by hand): ``/metrics`` content
negotiation and ``# EOF``, ``/stats/history`` (inventory, counter rates,
histogram deltas, 404 and 400 as the reference answers), ``/alerts``
firing then clearing, ``device_utilization`` after traffic, ``POST
/debug/profile`` (400s, the merged trace — on the CPU the port's device
half is torch's CPU profiler — and 409 while armed) and the sampler
joining on drain.
"""

import asyncio
import io
import threading
import time

import aiohttp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tpuserve import config as jconfig
from tpuserve import obs as jobs
from tpuserve.server import ServerState as JaxServerState
from tpuserve.server import make_app
from tpuserve.telemetry import slo as jslo
from tpuserve.telemetry import store as jstore
from tpuserve_torch import config as tconfig
from tpuserve_torch import obs as tobs
from tpuserve_torch.server import ServerState, start_server, stop_server
from tpuserve_torch.telemetry import slo as tslo
from tpuserve_torch.telemetry import store as tstore

PKGS = {"jax": (jobs, jstore, jslo, jconfig), "port": (tobs, tstore, tslo, tconfig)}
SAMPLER_THREAD = {"jax": "tpuserve-telemetry", "port": "tpuserve-torch-telemetry"}
NPY = "application/x-npy"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- time-series store -------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_rings_are_bounded(pkg):
    obs, store_mod = PKGS[pkg][:2]
    m = obs.Metrics(16)
    c = m.counter("x_total")
    store = store_mod.TimeSeriesStore(m, capacity=8)
    for i in range(50):
        c.inc()
        store.sample(now=1000.0 + i)
    h = store.history("x_total")
    assert len(h["t"]) == 8 and h["v"][-1] == 50.0 and h["v"][0] == 43.0


@pytest.mark.parametrize("pkg", PKGS)
def test_counter_rate_handles_resets_without_negative_rates(pkg):
    obs, store_mod = PKGS[pkg][:2]
    m = obs.Metrics(16)
    c = m.counter("req_total")
    store = store_mod.TimeSeriesStore(m, capacity=32)
    for i, v in enumerate([10.0, 20.0, 30.0, 3.0, 6.0]):
        c.value = v
        store.sample(now=100.0 + i)
    h = store.history("req_total")
    assert all(r >= 0 for r in h["rate_per_s"])
    assert h["increase"] == pytest.approx(26.0)
    assert store.counter_increase("req_total") == pytest.approx(26.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_counter_window_selects_left_edge_sample(pkg):
    obs, store_mod = PKGS[pkg][:2]
    m = obs.Metrics(16)
    c = m.counter("w_total")
    store = store_mod.TimeSeriesStore(m, capacity=32)
    t0 = time.time()
    for i in range(10):
        c.value = float(i)
        store.sample(now=t0 - 9 + i)
    assert 3.0 <= store.counter_increase("w_total", window_s=3.0) <= 4.0


@pytest.mark.parametrize("pkg", PKGS)
def test_histogram_window_delta_and_quantiles(pkg):
    obs, store_mod = PKGS[pkg][:2]
    m = obs.Metrics(16)
    h = m.histogram("lat_ms{model=t,phase=total}")
    store = store_mod.TimeSeriesStore(m, capacity=32)
    store.sample(now=time.time() - 1.0)
    for _ in range(100):
        h.observe(5.0)
    for _ in range(10):
        h.observe(500.0)
    store.sample(now=time.time())
    d = store.history("lat_ms{model=t,phase=total}")["delta"]
    assert d["n"] == 110 and d["p50_ms"] < 10.0 and d["p99_ms"] > 100.0
    assert store.histogram_delta("lat_ms{model=t,phase=total}")["n"] == 110


@pytest.mark.parametrize("pkg", PKGS)
def test_histogram_delta_survives_reset(pkg):
    obs, store_mod = PKGS[pkg][:2]
    m = obs.Metrics(16)
    h = m.histogram("r_ms{model=t}")
    store = store_mod.TimeSeriesStore(m, capacity=32)
    for _ in range(5):
        h.observe(1.0)
    store.sample(now=200.0)
    with m._lock:
        m._histograms.clear()
    m.histogram("r_ms{model=t}").observe(2.0)
    store.sample(now=201.0)
    d = store.histogram_delta("r_ms{model=t}")
    assert d["n"] == 1 and all(c >= 0 for c in d["counts"])


@pytest.mark.parametrize("pkg", PKGS)
def test_quantile_from_counts_empty_and_overflow(pkg):
    store_mod = PKGS[pkg][1]
    assert store_mod.quantile_from_counts([1.0, 2.0], [0, 0, 0], 0.5) is None
    assert store_mod.quantile_from_counts([1.0, 2.0], [0, 0, 5], 0.99) == float("inf")


@pytest.mark.parametrize("pkg", PKGS)
def test_match_by_base_name(pkg):
    obs, store_mod = PKGS[pkg][:2]
    m = obs.Metrics(16)
    m.counter("req_total{model=a}")
    m.counter("req_total{model=b}")
    m.counter("other_total")
    store = store_mod.TimeSeriesStore(m, capacity=4)
    store.sample()
    assert sorted(store.match("req_total")) == ["req_total{model=a}", "req_total{model=b}"]
    assert store.match("req_total{model=a}") == ["req_total{model=a}"]
    assert store.match("nope") == []


def test_history_equal_across_packages():
    """The same samples at the same injected times give the same history
    bodies (counter, gauge and histogram series) on both packages."""
    outs = []
    for obs, store_mod, _, _ in PKGS.values():
        m = obs.Metrics(16)
        c, g = m.counter("req_total{model=t}"), m.gauge("queue_depth{model=t}")
        h = m.histogram("latency_ms{model=t,phase=total}")
        store = store_mod.TimeSeriesStore(m, capacity=16)
        rng = np.random.default_rng(4)
        for i in range(12):
            c.inc(float(rng.integers(0, 20)))
            g.set(float(rng.integers(0, 5)))
            for v in rng.exponential(30.0, 15):
                h.observe(float(v))
            store.sample(now=500.0 + i)
        outs.append([store.history(n) for n in store.metric_names()])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_sampler_thread_stops_cleanly(pkg):
    obs, store_mod = PKGS[pkg][:2]
    m = obs.Metrics(16)
    m.counter("x_total")
    store = store_mod.TimeSeriesStore(m, capacity=8)
    s = store_mod.MetricSampler(store, 0.02)
    s.start()
    deadline = time.time() + 5.0
    while store.samples_total < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert store.samples_total >= 3
    s.stop()
    assert not s.is_alive()
    s.stop()
    assert all(SAMPLER_THREAD[pkg] != t.name for t in threading.enumerate())


# -- SLO engine --------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_good_fraction_interpolates_inside_bucket(pkg):
    slo = PKGS[pkg][2]
    bounds, counts = [10.0, 20.0, 30.0], [0, 10, 0, 0]
    assert slo.good_fraction(bounds, counts, 15.0) == pytest.approx(0.5)
    assert slo.good_fraction(bounds, counts, 20.0) == pytest.approx(1.0)
    assert slo.good_fraction(bounds, counts, 9.0) == pytest.approx(0.0)
    assert slo.good_fraction(bounds, [0, 0, 0, 0], 15.0) is None


def _slo_rig(pkg, windows=(0.5, 1.0, 30.0), latency_ms=20.0, burn_alert=10.0):
    obs, store_mod, slo, cfgm = PKGS[pkg]
    m = obs.Metrics(16)
    store = store_mod.TimeSeriesStore(m, capacity=64)
    eng = slo.SloEngine(m, store, list(windows))
    assert eng.register("toy", cfgm.SloConfig(latency_ms=latency_ms, availability=0.999,
                                              burn_alert=burn_alert))
    return m, store, eng, m.histogram("latency_ms{model=toy,phase=total}")


@pytest.mark.parametrize("pkg", PKGS)
def test_slo_disabled_model_not_registered(pkg):
    obs, store_mod, slo, cfgm = PKGS[pkg]
    m = obs.Metrics(16)
    eng = slo.SloEngine(m, store_mod.TimeSeriesStore(m, 8), [1.0, 2.0])
    assert not eng.register("off", cfgm.SloConfig())
    assert eng.state_of("off") == "ok" and eng.alerts()["models"] == {}


@pytest.mark.parametrize("pkg", PKGS)
def test_burn_fires_and_clears(pkg):
    m, store, eng, h = _slo_rig(pkg, windows=(0.4, 0.8, 30.0))
    store.sample()
    for _ in range(50):
        h.observe(500.0)
    store.sample()
    eng.tick()
    assert eng.state_of("toy") == "firing"
    alerts = eng.alerts()
    assert alerts["status"] == "firing" and alerts["models"]["toy"]["burn"]["0.4s"] > 100
    assert m.gauge("slo_alert_state{model=toy}").value == 2.0
    time.sleep(1.0)
    for _ in range(50):
        h.observe(1.0)
    store.sample()
    eng.tick()
    assert eng.state_of("toy") == "ok", eng.alerts()
    assert m.gauge("slo_alert_state{model=toy}").value == 0.0
    assert "slo_burn_rate{model=toy,window=0.4s}" in m._gauges


@pytest.mark.parametrize("pkg", PKGS)
def test_burn_pending_on_short_window_only(pkg):
    m, store, eng, h = _slo_rig(pkg, windows=(0.4, 30.0, 60.0))
    store.sample()
    for _ in range(1000):
        h.observe(1.0)
    store.sample()
    time.sleep(0.5)
    for _ in range(5):
        h.observe(500.0)
    store.sample()
    eng.tick()
    assert eng.state_of("toy") == "pending", eng.alerts()


@pytest.mark.parametrize("pkg", PKGS)
def test_no_evidence_holds_ok(pkg):
    _, _, eng, _ = _slo_rig(pkg)
    eng.tick()
    assert eng.state_of("toy") == "ok"
    assert all(b is None for b in eng.burn_rates("toy").values())


def test_burn_rates_equal_across_packages():
    """The same window deltas give the same burn rates and alert rows."""
    rows = []
    for pkg in PKGS:
        m, store, eng, h = _slo_rig(pkg, windows=(30.0, 60.0, 120.0))
        store.sample(now=time.time() - 2.0)
        for v in np.random.default_rng(9).exponential(8.0, 400):
            h.observe(float(v))
        store.sample()
        eng.tick()
        row = eng.alerts()["models"]["toy"]
        row.pop("since")
        rows.append((eng.burn_rates("toy"), row))
    assert rows[0] == rows[1]


# -- utilization ------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_utilization_from_device_seconds_rate(pkg):
    obs, store_mod, slo, _ = PKGS[pkg]
    m = obs.Metrics(16)
    store = store_mod.TimeSeriesStore(m, capacity=32)
    util = slo.UtilizationDeriver(m, store, window_s=10.0)
    c0, c1 = m.device_seconds_counter("toy", 0), m.device_seconds_counter("toy", 1)
    t0 = time.time() - 4.0
    for i in range(5):
        c0.value = 0.9 * i
        c1.value = 0.1 * i
        store.sample(now=t0 + i)
    util.tick()
    assert m.gauge("device_utilization{model=toy,replica=0}").value == pytest.approx(0.9, abs=0.05)
    assert m.gauge("device_utilization{model=toy,replica=1}").value == pytest.approx(0.1, abs=0.05)
    stats = util.stats()
    assert stats["toy"]["device_seconds_total"] == pytest.approx(4.0)
    assert stats["toy"]["mean_utilization"] == pytest.approx(0.5, abs=0.05)


# -- config ----------------------------------------------------------------------

TOML = """
[telemetry]
sample_interval_s = 0.5
history_s = 60.0
burn_windows_s = [2.0, 5.0, 30.0]

[[model]]
name = "toy"
family = "toy"

[model.slo]
latency_ms = 50.0
availability = 0.99
burn_alert = 5.0
"""


@pytest.mark.parametrize("pkg", PKGS)
def test_telemetry_and_slo_toml(pkg, tmp_path):
    cfgm = PKGS[pkg][3]
    p = tmp_path / "c.toml"
    p.write_text(TOML)
    cfg = cfgm.load_config(str(p))
    assert cfg.telemetry.sample_interval_s == 0.5
    assert cfg.telemetry.burn_windows_s == [2.0, 5.0, 30.0]
    assert (cfg.models[0].slo.latency_ms, cfg.models[0].slo.availability) == (50.0, 0.99)
    cfg2 = cfgm.load_config(str(p), overrides=["model.toy.slo.latency_ms=75.0",
                                               "telemetry.sample_interval_s=0.1"])
    assert cfg2.models[0].slo.latency_ms == 75.0
    assert cfg2.telemetry.sample_interval_s == 0.1


@pytest.mark.parametrize("pkg", PKGS)
def test_telemetry_config_validation(pkg):
    cfgm = PKGS[pkg][3]
    with pytest.raises(ValueError, match="sample_interval_s"):
        cfgm.TelemetryConfig(sample_interval_s=0.0)
    with pytest.raises(ValueError, match="burn_windows_s"):
        cfgm.TelemetryConfig(burn_windows_s=[60.0])
    with pytest.raises(ValueError, match="burn_windows_s"):
        cfgm.TelemetryConfig(burn_windows_s=[300.0, 60.0])
    with pytest.raises(ValueError, match="availability"):
        cfgm.SloConfig(latency_ms=10.0, availability=1.0)
    with pytest.raises(ValueError, match="burn_alert"):
        cfgm.SloConfig(latency_ms=10.0, burn_alert=0.0)
    with pytest.raises(ValueError, match="latency_ms"):
        cfgm.SloConfig(latency_ms=-1.0)


# -- over HTTP: both servers, manual sampler ticks ---------------------------------

def server_cfg(pkg: str, **over):
    cfgm = PKGS[pkg][3]
    model = dict(name="toy", family="toy", batch_buckets=[1, 2], deadline_ms=5.0,
                 dtype="float32", num_classes=10, parallelism="single",
                 request_timeout_ms=10_000.0, wire_size=8,
                 slo=cfgm.SloConfig(latency_ms=20.0, availability=0.999))
    base = dict(decode_threads=2,
                telemetry=cfgm.TelemetryConfig(sample_interval_s=30.0,
                                               burn_windows_s=[0.5, 1.0, 30.0]))
    base.update(over)
    return cfgm.ServerConfig(models=[cfgm.ModelConfig(**model)], **base)


class Side:
    def __init__(self, pkg: str, cfg) -> None:
        self.pkg = pkg
        self.state = JaxServerState(cfg) if pkg == "jax" else ServerState(cfg, device="cpu")
        self.state.build()

    async def start(self) -> "Side":
        if self.pkg == "jax":
            self.client = TestClient(TestServer(make_app(self.state)))
            await self.client.start_server()
        else:
            self.server = await start_server(self.state, "127.0.0.1", 0)
            self.client = aiohttp.ClientSession(
                f"http://127.0.0.1:{self.state.serving_addresses[0][1]}")
        return self

    async def close(self) -> None:
        await self.client.close()
        if self.pkg == "port":
            await stop_server(self.state, self.server)

    async def request(self, method: str, path: str, data=None, headers=None, params=None):
        async with self.client.request(method, path, data=data, headers=headers,
                                       params=params) as r:
            body = await r.json() if r.content_type == "application/json" else await r.text()
            return r.status, body, dict(r.headers)


@pytest.fixture(scope="module")
def sides():
    loop = asyncio.new_event_loop()
    made = {pkg: loop.run_until_complete(Side(pkg, server_cfg(pkg)).start()) for pkg in PKGS}
    yield (lambda coro: loop.run_until_complete(coro)), made
    for side in made.values():
        loop.run_until_complete(side.close())
    loop.close()


def npy_bytes(seed: int = 0) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.random.default_rng(seed).integers(0, 255, (8, 8, 3), dtype=np.uint8))
    return buf.getvalue()


@pytest.mark.parametrize("pkg", PKGS)
def test_metrics_content_negotiation_and_eof(sides, pkg):
    run, made = sides
    side = made[pkg]

    async def go():
        status, body, hdr = await side.request("GET", "/metrics")
        assert status == 200 and hdr["Content-Type"].startswith("text/plain; version=0.0.4")
        assert body.rstrip().endswith("# EOF")
        accept = "application/openmetrics-text; version=1.0.0,text/plain;q=0.5"
        _, body, hdr = await side.request("GET", "/metrics", headers={"Accept": accept})
        assert hdr["Content-Type"].startswith("application/openmetrics-text; version=1.0.0")
        assert body.rstrip().endswith("# EOF")

    run(go())


def test_history_endpoint(sides):
    run, made = sides
    statuses = {}

    async def go():
        for pkg, side in made.items():
            side.state.sampler.tick()
            for i in range(4):
                status, _, _ = await side.request("POST", "/v1/models/toy:classify",
                                                  npy_bytes(i), {"Content-Type": NPY})
                assert status == 200
            side.state.sampler.tick()
            status, inv, _ = await side.request("GET", "/stats/history")
            assert status == 200 and "requests_total{model=toy}" in inv["metrics"]
            assert inv["samples_total"] >= 2
            _, data, _ = await side.request("GET", "/stats/history",
                                            params={"metric": "requests_total"})
            (series,) = data["series"]
            assert series["kind"] == "counter" and len(series["t"]) >= 2
            assert "rate_per_s" in series and "increase" in series
            _, data, _ = await side.request(
                "GET", "/stats/history",
                params={"metric": "latency_ms{model=toy,phase=total}", "window_s": "60"})
            assert data["series"][0]["delta"]["n"] >= 1
            got = []
            for params in ({"metric": "nope_total"}, {"metric": "requests_total", "window_s": "-3"}):
                status, body, _ = await side.request("GET", "/stats/history", params=params)
                got.append((status, body["error"]))
            statuses[pkg] = got

    run(go())
    assert statuses["port"] == statuses["jax"]
    assert [s for s, _ in statuses["port"]] == [404, 400]


@pytest.mark.parametrize("pkg", PKGS)
def test_alerts_lifecycle_over_http(sides, pkg):
    run, made = sides
    side = made[pkg]
    state = side.state

    async def go():
        h = state.metrics.histogram("latency_ms{model=toy,phase=total}")
        state.sampler.tick()
        for _ in range(50):
            h.observe(500.0)
        state.sampler.tick()
        status, alerts, _ = await side.request("GET", "/alerts")
        assert status == 200 and alerts["models"]["toy"]["state"] == "firing", alerts
        assert alerts["status"] == "firing" and alerts["models"]["toy"]["burn"]["0.5s"] > 100
        _, stats, _ = await side.request("GET", "/stats")
        assert stats["slo"]["models"]["toy"]["state"] == "firing"
        assert stats["telemetry"]["samples_total"] >= 1
        await asyncio.sleep(1.2)
        for _ in range(20):
            h.observe(1.0)
        state.sampler.tick()
        await asyncio.sleep(0.05)
        state.sampler.tick()
        _, alerts, _ = await side.request("GET", "/alerts")
        assert alerts["models"]["toy"]["state"] == "ok", alerts

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_utilization_gauges_after_traffic(sides, pkg):
    run, made = sides
    side = made[pkg]

    async def go():
        for i in range(6):
            status, _, _ = await side.request("POST", "/v1/models/toy:classify",
                                              npy_bytes(100 + i), {"Content-Type": NPY})
            assert status == 200
        side.state.sampler.tick()
        await asyncio.sleep(0.05)
        side.state.sampler.tick()
        _, stats, _ = await side.request("GET", "/stats")
        util = stats["utilization"]["toy"]
        assert "0" in util["per_replica"] and util["device_seconds_total"] > 0
        _, text, _ = await side.request("GET", "/metrics")
        assert "device_utilization{" in text and "device_seconds_total{" in text

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_profile_endpoint(sides, pkg):
    run, made = sides
    side = made[pkg]

    async def go():
        status, _, _ = await side.request("POST", "/debug/profile", params={"duration_ms": "junk"})
        assert status == 400
        status, _, _ = await side.request("POST", "/debug/profile",
                                          params={"duration_ms": "99999999"})
        assert status == 400
        status, data, _ = await side.request("POST", "/debug/profile",
                                             params={"duration_ms": "150"})
        assert status == 200, data
        assert isinstance(data["traceEvents"], list)
        meta = data["tpuserve_profile"]
        assert meta["duration_ms"] == 150.0 and meta["device_trace"]
        if pkg == "port":
            # torch's CPU profiler on the CPU: events, on the ring's clock.
            assert meta["device_trace"] == "ok" and meta["device_events"] > 0
            lo, hi = meta["window_us"]
            dev = [e for e in data["traceEvents"] if e.get("pid", 0) >= 1000 and e.get("ph") == "X"]
            assert dev and all(lo - 1e6 <= e["ts"] <= hi for e in dev)
        side.state.profiler._armed = True
        try:
            status, _, _ = await side.request("POST", "/debug/profile",
                                              params={"duration_ms": "50"})
            assert status == 409
        finally:
            side.state.profiler._armed = False
        _, stats, _ = await side.request("GET", "/stats")
        assert stats["telemetry"]["profile"]["captures_total"] >= 1

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_sampler_stops_on_drain(pkg):
    loop = asyncio.new_event_loop()
    try:
        cfgm = PKGS[pkg][3]
        cfg = cfgm.ServerConfig(
            models=[cfgm.ModelConfig(name="toy", family="toy", batch_buckets=[1],
                                     deadline_ms=2.0, dtype="float32", num_classes=10,
                                     parallelism="single", wire_size=8)],
            decode_threads=2, startup_canary=False,
            telemetry=cfgm.TelemetryConfig(sample_interval_s=0.05))
        state = JaxServerState(cfg) if pkg == "jax" else ServerState(cfg, device="cpu")
        state.build()

        async def go():
            await state.start()
            assert state.sampler.is_alive()
            deadline = time.time() + 5.0
            while state.store.samples_total < 2 and time.time() < deadline:
                await asyncio.sleep(0.02)
            assert state.store.samples_total >= 2
            assert await state.drain()
            assert not state.sampler.is_alive()
            await state.stop()

        loop.run_until_complete(go())
    finally:
        loop.close()
