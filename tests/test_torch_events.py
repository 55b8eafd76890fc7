"""The port's event plane, audit trail and postmortem ledger
(``tpuserve_torch.telemetry.events``) against the reference's
(``tests/test_events.py``), the cases without the router's fleet.

Units run on both packages (``pkg`` = "jax" or "port") with the same inputs
and must behave alike, exactly: the ring's bounds and newest-kept order,
query filters, the ``events_logged_total`` and ``audit_events_total``
counters, the logging bridge over each package's own loggers
(``tpuserve.*`` / ``tpuserve_torch.*``; subsystem = the suffix), the
``/debug/events`` query hardening, postmortem capture from files, the
black-box writer's atomic checkpoints, the Chrome instant events and the
``[events]`` validation.

Over HTTP both servers run side by side on the CPU (the toy model, a
``reload_corrupt`` fault armed at 1.0): ``/debug/events`` carries bridged
log lines and the request's ``request_error`` under its trace id; junk
query parameters answer 400; a rejected reload leaves an audit record
naming its gate and a ``reload_rejected`` lifecycle event;
``/debug/trace?trace_id=`` interleaves the events into the record and the
Chrome output; ``/stats`` has the ``events`` block; with ``[events]``
off nothing is built and the routes answer 409 — the same statuses on both.
"""

import asyncio
import io
import json
import logging
import os
import signal
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
from tpuserve.telemetry import events as jevents
from tpuserve_torch import config as tconfig
from tpuserve_torch import obs as tobs
from tpuserve_torch.server import ServerState, start_server, stop_server
from tpuserve_torch.telemetry import events as tevents

PKGS = {"jax": (jevents, jobs, jconfig, "tpuserve"),
        "port": (tevents, tobs, tconfig, "tpuserve_torch")}
NPY = "application/x-npy"

pytestmark = pytest.mark.filterwarnings("ignore::pytest.PytestUnraisableExceptionWarning")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def npy_bytes(seed: int = 0) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.random.default_rng(seed).integers(0, 255, (8, 8, 3), dtype=np.uint8))
    return buf.getvalue()


# -- units -----------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_ring_bounds_and_newest_kept_ordering(pkg):
    ev, obs = PKGS[pkg][:2]
    el = ev.EventLog(obs.Metrics(16), capacity=8)
    for i in range(20):
        el.emit("info", "test", f"e{i}", seq=i)
    evs = el.query()
    assert [e["fields"]["seq"] for e in evs] == list(range(12, 20))
    assert [e["fields"]["seq"] for e in el.query(limit=3)] == [17, 18, 19]
    assert el.query(limit=0) == []
    ts = [e["ts_us"] for e in evs]
    assert ts == sorted(ts)


@pytest.mark.parametrize("pkg", PKGS)
def test_query_filters_compose(pkg):
    ev, obs = PKGS[pkg][:2]
    el = ev.EventLog(obs.Metrics(16), capacity=64)
    el.emit("info", "http", "a", trace_id="aa" * 16)
    el.emit("warning", "http", "b", trace_id="bb" * 16)
    el.emit("warning", "lifecycle", "c")
    mid = el.query()[-1]["ts_us"]
    el.emit("error", "http", "d", trace_id="bb" * 16)
    assert [e["event"] for e in el.query(level="warning")] == ["b", "c"]
    assert [e["event"] for e in el.query(subsystem="http")] == ["a", "b", "d"]
    assert [e["event"] for e in el.query(trace_id="bb" * 16)] == ["b", "d"]
    assert [e["event"] for e in el.query(since_us=mid)] == ["c", "d"]
    assert [e["event"] for e in el.query(subsystem="http", trace_id="bb" * 16,
                                         level="error")] == ["d"]


@pytest.mark.parametrize("pkg", PKGS)
def test_events_logged_counters_split_by_level_and_subsystem(pkg):
    ev, obs = PKGS[pkg][:2]
    m = obs.Metrics(16)
    el = ev.EventLog(m, capacity=16)
    el.emit("info", "http", "x")
    el.emit("info", "http", "y")
    el.emit("error", "batcher", "z")
    cv = m.counter_values()
    assert cv["events_logged_total{level=info,subsystem=http}"] == 2.0
    assert cv["events_logged_total{level=error,subsystem=batcher}"] == 1.0


@pytest.mark.parametrize("pkg", PKGS)
def test_logging_bridge_captures_the_package_loggers(pkg):
    """An existing ``logging.getLogger("<package>.lifecycle")`` call site
    flows into the ring: subsystem from the logger's suffix, level mapped,
    message rendered; records below the bridge level stay out."""
    ev, obs, _, root = PKGS[pkg]
    el = ev.EventLog(obs.Metrics(16), capacity=16)
    ev.install_bridge(el, "INFO")
    try:
        logging.getLogger(f"{root}.lifecycle").warning("reload rejected at %s gate", "integrity")
        logging.getLogger(f"{root}.runtime").info("worker %d up", 3)
        logging.getLogger(f"{root}.lifecycle").debug("below bridge_level")
        evs = el.query()
        assert [(e["subsystem"], e["level"]) for e in evs] == [
            ("lifecycle", "warning"), ("runtime", "info")]
        assert evs[0]["msg"] == "reload rejected at integrity gate"
    finally:
        logging.getLogger(root).handlers.clear()


@pytest.mark.parametrize("pkg", PKGS)
def test_bridge_never_raises(pkg):
    ev = PKGS[pkg][0]

    class Boom:
        def emit(self, *a, **k):
            raise RuntimeError("ring on fire")

    h = ev.EventLogBridge(Boom())
    h.emit(logging.LogRecord(f"{PKGS[pkg][3]}.x", logging.INFO, __file__, 1, "msg", None, None))


@pytest.mark.parametrize("pkg", PKGS)
def test_parse_events_query_hardening(pkg):
    ev = PKGS[pkg][0]
    ok = ev.parse_events_query({"since_us": "12.5", "level": "warning", "subsystem": "http",
                                "trace_id": "ab", "limit": "7"})
    assert ok == {"since_us": 12.5, "level": "warning", "subsystem": "http",
                  "trace_id": "ab", "limit": 7}
    assert ev.parse_events_query({}) == {"limit": 1000}
    for junk in ({"level": "loud"}, {"since_us": "yesterday"}, {"limit": "many"},
                 {"limit": "-1"}, {"bogus": "1"}):
        with pytest.raises(ValueError):
            ev.parse_events_query(junk)


def test_query_errors_word_for_word():
    for junk in ({"level": "loud"}, {"since_us": "yesterday"}, {"limit": "many"},
                 {"limit": "-1"}, {"bogus": "1"}):
        msgs = []
        for ev in (jevents, tevents):
            with pytest.raises(ValueError) as err:
                ev.parse_events_query(junk)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_audit_log_fifo_and_counters(pkg):
    ev, obs = PKGS[pkg][:2]
    m = obs.Metrics(16)
    au = ev.AuditLog(m, capacity=2)
    au.record("reload", "toy", "ok", duration_ms=10.0, version=2)
    au.record("reload", "toy", "rejected", stage="integrity")
    au.record("drain", "server", "ok")
    dump = au.dump()
    assert [r["verb"] for r in dump] == ["drain", "reload"]
    assert dump[1]["stage"] == "integrity"
    cv = m.counter_values()
    assert cv["audit_events_total{verb=reload,outcome=ok}"] == 1.0
    assert cv["audit_events_total{verb=reload,outcome=rejected}"] == 1.0
    assert cv["audit_events_total{verb=drain,outcome=ok}"] == 1.0


@pytest.mark.parametrize("pkg", PKGS)
def test_postmortem_capture_reads_tail_and_snapshot(pkg, tmp_path):
    ev, obs = PKGS[pkg][:2]
    m = obs.Metrics(16)
    el = ev.EventLog(m, capacity=16)
    pm = ev.PostmortemLog(m, capacity=4, tail_bytes=32, events=el)
    stderr = tmp_path / "w0.stderr"
    stderr.write_text("x" * 100 + "final words")
    snap = tmp_path / "w0.snapshot.json"
    snap.write_text(json.dumps({"events": [{"event": "e"}], "pid": 7}))
    rec = pm.capture_blocking("worker", "worker0", 1234, -signal.SIGKILL,
                              stderr_path=str(stderr), snapshot_path=str(snap), worker=0)
    assert rec["signal"] == "SIGKILL" and rec["exitcode"] == -9
    assert rec["stderr_tail"].endswith("final words") and len(rec["stderr_tail"]) <= 32
    assert rec["snapshot"]["pid"] == 7
    assert m.counter_values()["postmortems_total{component=worker,signal=SIGKILL}"] == 1.0
    assert any(e["event"] == "postmortem" for e in el.query())
    rec2 = pm.capture_blocking("worker", "worker1", 1, 0, stderr_path=str(tmp_path / "nope"),
                               snapshot_path=str(tmp_path / "nope2"))
    assert rec2["signal"] is None and rec2["stderr_tail"] is None and rec2["snapshot"] is None
    assert ev.signal_name(-signal.SIGTERM) == "SIGTERM"
    assert ev.read_tail(None, 10) is None and ev.read_snapshot(None) is None


@pytest.mark.parametrize("pkg", PKGS)
def test_blackbox_writer_atomic_and_initial_snapshot(pkg, tmp_path):
    ev = PKGS[pkg][0]
    path = str(tmp_path / "sub" / "snap.json")
    calls = []

    def collect():
        calls.append(1)
        return {"n": len(calls)}

    bb = ev.BlackBoxWriter(path, interval_s=30.0, collect=collect)
    bb.start()
    try:
        deadline = time.monotonic() + 5.0
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert json.load(open(path)) == {"n": 1}
        assert not os.path.exists(path + ".tmp")
    finally:
        bb.stop()
    assert not bb.is_alive()
    bad = ev.BlackBoxWriter(str(tmp_path / "bad.json"), 30.0,
                            lambda: (_ for _ in ()).throw(RuntimeError()))
    bad.write_once()
    assert not os.path.exists(str(tmp_path / "bad.json"))


def test_events_to_chrome_equal_across_packages():
    outs = []
    for ev, obs, _, _ in PKGS.values():
        el = ev.EventLog(obs.Metrics(16), capacity=8, pid=3)
        el.emit("warning", "http", "request_error", model="toy", trace_id="cd" * 16, status=500)
        (out,) = ev.events_to_chrome(el.query())
        out.pop("ts")
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[1]["ph"] == "i" and outs[1]["pid"] == 3 and outs[1]["name"] == "http:request_error"
    assert outs[1]["args"]["trace_id"] == "cd" * 16 and outs[1]["args"]["status"] == 500


@pytest.mark.parametrize("pkg", PKGS)
def test_events_config_validation(pkg):
    cfgm = PKGS[pkg][2]
    with pytest.raises(ValueError, match="capacity"):
        cfgm.EventsConfig(capacity=0)
    with pytest.raises(ValueError, match="bridge_level"):
        cfgm.EventsConfig(bridge_level="LOUD")
    with pytest.raises(ValueError, match="snapshot_interval_s"):
        cfgm.EventsConfig(snapshot_interval_s=-1.0)
    cfgm.EventsConfig(bridge_level="warning")


def test_emit_is_a_no_op_without_an_active_log():
    tevents.set_active(None)
    tevents.emit("info", "lifecycle", "published", model="m", version=2)
    el = tevents.EventLog(tobs.Metrics(16), capacity=4)
    tevents.set_active(el)
    try:
        tevents.emit("info", "lifecycle", "published", model="m", version=2)
        (rec,) = el.query()
        assert (rec["subsystem"], rec["event"], rec["model"], rec["fields"]) == \
            ("lifecycle", "published", "m", {"version": 2})
    finally:
        tevents.set_active(None)


# -- over HTTP: both servers ------------------------------------------------------

def server_cfg(pkg: str, name: str = "toy", **over):
    cfgm = PKGS[pkg][2]
    return cfgm.ServerConfig(
        models=[cfgm.ModelConfig(name=name, family="toy", batch_buckets=[1, 2],
                                 deadline_ms=2.0, dtype="float32", num_classes=10,
                                 parallelism="single", request_timeout_ms=10_000.0,
                                 wire_size=8)],
        decode_threads=2, trace=cfgm.TraceConfig(slow_n=8, error_capacity=32),
        faults=cfgm.FaultsConfig(enabled=True, rules=[
            cfgm.FaultRuleConfig(kind="reload_corrupt", model=name, probability=1.0)]),
        **over)


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

    async def request(self, method: str, path: str, data=None, headers=None):
        async with self.client.request(method, path, data=data, headers=headers) as r:
            return r.status, await r.read(), dict(r.headers)


@pytest.fixture(scope="module")
def sides():
    loop = asyncio.new_event_loop()
    made = {}
    for pkg in PKGS:  # one at a time: each installs its package's bridge
        made[pkg] = loop.run_until_complete(Side(pkg, server_cfg(pkg)).start())
    yield (lambda coro: loop.run_until_complete(coro)), made
    for side in made.values():
        loop.run_until_complete(side.close())
    loop.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_debug_events_carries_bridged_and_request_events(sides, pkg):
    run, made = sides
    side = made[pkg]

    async def go():
        status, _, hdr = await side.request("POST", "/v1/models/toy:predict", b"junk",
                                            {"Content-Type": NPY})
        assert status == 400
        tid = hdr["X-Trace-Id"]
        status, raw, _ = await side.request("GET", "/debug/events")
        assert status == 200
        body = json.loads(raw)
        assert body["size"] > 0 and body["capacity"] == 4096
        assert any(e["event"] == "log" for e in body["events"])
        mine = [e for e in body["events"] if e.get("trace_id") == tid]
        assert mine and mine[0]["event"] == "request_error"
        assert mine[0]["fields"]["status"] == 400
        _, raw, _ = await side.request("GET", f"/debug/events?trace_id={tid}&subsystem=http")
        filt = json.loads(raw)["events"]
        assert len(filt) == 1 and filt[0]["trace_id"] == tid

    run(go())


def test_debug_events_junk_params_400(sides):
    run, made = sides

    async def go():
        for q in ("level=loud", "since_us=yesterday", "limit=many", "limit=-2", "bogus=1"):
            bodies = []
            for side in made.values():
                status, raw, _ = await side.request("GET", f"/debug/events?{q}")
                assert status == 400, q
                bodies.append(json.loads(raw)["error"])
            assert bodies[0] == bodies[1], q

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_rejected_reload_leaves_audit_record(sides, pkg):
    run, made = sides
    side = made[pkg]

    async def go():
        status, _, _ = await side.request("POST", "/admin/models/toy:reload")
        assert status == 409
        status, raw, _ = await side.request("GET", "/debug/audit")
        assert status == 200
        rec = next(a for a in json.loads(raw)["audit"] if a["verb"] == "reload")
        assert (rec["target"], rec["outcome"], rec["stage"]) == ("toy", "rejected", "integrity")
        assert rec["duration_ms"] >= 0
        _, raw, _ = await side.request("GET", "/debug/events?subsystem=lifecycle")
        assert any(e["event"] == "reload_rejected" and e["fields"]["stage"] == "integrity"
                   for e in json.loads(raw)["events"])

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_trace_event_interleave_by_trace_id(sides, pkg):
    run, made = sides
    side = made[pkg]

    async def go():
        _, _, hdr = await side.request("POST", "/v1/models/toy:predict", b"junk",
                                       {"Content-Type": NPY})
        tid = hdr["X-Trace-Id"]
        status, raw, _ = await side.request("GET", f"/debug/trace?trace_id={tid}&format=record")
        assert status == 200
        rec = json.loads(raw)
        assert rec["spans"] and rec["events"]
        assert all(e["trace_id"] == tid for e in rec["events"])
        _, raw, _ = await side.request("GET", f"/debug/trace?trace_id={tid}")
        trace = json.loads(raw)
        assert {e["ph"] for e in trace["traceEvents"]} == {"X", "i"}
        assert any(e["args"].get("trace_id") == tid
                   for e in trace["traceEvents"] if e["ph"] == "i")

    run(go())


def test_stats_events_block_and_disabled_409(sides):
    run, made = sides
    keys = {}

    async def go():
        for pkg, side in made.items():
            _, raw, _ = await side.request("GET", "/stats")
            block = json.loads(raw)["events"]
            assert block["size"] > 0 and "audit" in block and "postmortems" in block
            keys[pkg] = sorted(block)
            status, raw, _ = await side.request("GET", "/debug/postmortems")
            assert status == 200 and json.loads(raw)["postmortems"] == []

    run(go())
    assert keys["port"] == keys["jax"]
    cfg2 = server_cfg("port", "t2", events=tconfig.EventsConfig(enabled=False))
    s2 = ServerState(cfg2, device="cpu")
    assert s2.events is None and s2.audit is None and s2.postmortems is None
    for route in (s2.debug_events, s2.debug_audit, s2.debug_postmortems):
        assert route(None).status == 409
    assert s2.stats(None).body and "events" not in json.loads(s2.stats(None).body)
