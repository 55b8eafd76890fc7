"""Request tracing of the port (``tpuserve_torch.obs``, ``cache``,
``server``) against the reference's (``tests/test_trace.py``), the cases
that need no router.

Units run on both packages (``pkg`` = "jax" or "port") with the same
inputs and must behave alike, exactly: trace and span ids (format, adoption
of a well-formed header only), the span fields, the ring's bounds and
Chrome output, the flight recorder's reservoirs and counters, the
coalesced link of the result cache, and the exemplar exposition (the two
registries render the same text for the same observations, exemplar
timestamps aside).

Over HTTP both servers run side by side on the CPU with the toy model:
``X-Trace-Id`` on every response, adoption, ``trace_id`` in error bodies
(400, 429, 503, 504) and in the flight recorder, a complete slow span tree
(the same span names on both), ``/debug/trace`` by id and its ring limits
(the same statuses), exemplars on ``/metrics`` and the ``/stats`` blocks
``trace``, ``events`` and ``telemetry`` (the same keys). For the served
examples (BERT-flash, ResNet-50, MobileNetV3) both packages' servers build
the same blocks from the file.
"""

import asyncio
import io
import json
import re

import aiohttp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tpuserve import cache as jcache
from tpuserve import config as jconfig
from tpuserve import obs as jobs
from tpuserve.server import ServerState as JaxServerState
from tpuserve.server import make_app
from tpuserve_torch import cache as tcache
from tpuserve_torch import config as tconfig
from tpuserve_torch import obs as tobs
from tpuserve_torch.server import ServerState, start_server, stop_server

PKGS = {"jax": (jobs, jcache, jconfig), "port": (tobs, tcache, tconfig)}
NPY = "application/x-npy"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- TraceContext ---------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_trace_context_mints_valid_ids(pkg):
    obs = PKGS[pkg][0]
    a, b = obs.TraceContext(), obs.TraceContext()
    assert obs.valid_trace_id(a.trace_id) and obs.valid_trace_id(b.trace_id)
    assert a.trace_id != b.trace_id
    assert len(a.root_id) == 16


@pytest.mark.parametrize("pkg", PKGS)
def test_trace_context_adopts_wellformed_header_only(pkg):
    obs = PKGS[pkg][0]
    tid = "ab" * 16
    ctx = obs.TraceContext.from_headers({"X-Trace-Id": tid, "X-Parent-Span": "cd" * 8})
    assert ctx.trace_id == tid
    assert ctx.parent_id == "cd" * 8
    for junk in ("short", "Z" * 32, "AB" * 16, "ab" * 17, "", None, 42):
        bad = obs.TraceContext(trace_id=junk)
        assert bad.trace_id != junk
        assert obs.valid_trace_id(bad.trace_id)


def test_port_adopts_lower_cased_headers():
    """The port's front door lower-cases header names: adoption reads them."""
    ctx = tobs.TraceContext.from_headers({"x-trace-id": "ab" * 16, "x-parent-span": "cd" * 8})
    assert (ctx.trace_id, ctx.parent_id) == ("ab" * 16, "cd" * 8)


@pytest.mark.parametrize("pkg", PKGS)
def test_span_records_documented_fields(pkg):
    obs = PKGS[pkg][0]
    ctx = obs.TraceContext(pid=3)
    sid = ctx.span("queue", 100.0, 100.25, tid="toy", batch=7)
    ctx.root_span("request", 99.0, 101.0, tid="toy", status=200)
    queue, root = ctx.spans
    for s in ctx.spans:
        assert set(s) == {"name", "trace_id", "span_id", "parent_id", "ts_us", "dur_us",
                          "tid", "pid", "args"}
        assert s["trace_id"] == ctx.trace_id and s["pid"] == 3
    assert queue["span_id"] == sid and queue["parent_id"] == ctx.root_id
    assert queue["args"]["batch"] == 7
    assert root["span_id"] == ctx.root_id and root["parent_id"] is None
    assert abs(queue["dur_us"] - 250_000) < 1


@pytest.mark.parametrize("pkg", PKGS)
def test_root_span_parents_under_relayed_attempt(pkg):
    obs = PKGS[pkg][0]
    ctx = obs.TraceContext.from_headers({"X-Trace-Id": "12" * 16, "X-Parent-Span": "ef" * 8})
    ctx.root_span("request", 0.0, 1.0, tid="toy")
    assert ctx.spans[0]["parent_id"] == "ef" * 8


# -- the ring -------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_ring_overflow_keeps_newest(pkg):
    t = PKGS[pkg][0].Tracer(capacity=8)
    for i in range(50):
        t.add(f"e{i}", float(i), float(i) + 0.1, tid="m")
    names = [e["name"] for e in json.loads(t.chrome_trace())["traceEvents"]]
    assert names == [f"e{i}" for i in range(42, 50)]


@pytest.mark.parametrize("pkg", PKGS)
def test_chrome_trace_limit_and_since_us(pkg):
    t = PKGS[pkg][0].Tracer(capacity=64)
    for i in range(20):
        t.add(f"e{i}", float(i), float(i) + 0.1)
    evs = json.loads(t.chrome_trace(limit=3))["traceEvents"]
    assert [e["name"] for e in evs] == ["e17", "e18", "e19"]
    evs = json.loads(t.chrome_trace(since_us=15e6))["traceEvents"]
    assert [e["name"] for e in evs] == [f"e{i}" for i in range(15, 20)]
    assert json.loads(t.chrome_trace(limit=0))["traceEvents"] == []


@pytest.mark.parametrize("pkg", PKGS)
def test_chrome_trace_event_fields_valid_json(pkg):
    t = PKGS[pkg][0].Tracer()
    t.add("batch[(2, 8)]", 100.0, 100.5, tid="toy", trace_id="ab" * 16, pid=2, n=2,
          trace_ids=["ab" * 16])
    (ev,) = json.loads(t.chrome_trace())["traceEvents"]
    assert set(ev) == {"name", "ph", "ts", "dur", "pid", "tid", "args"}
    assert ev["ph"] == "X" and ev["pid"] == 2 and ev["tid"] == "toy"
    assert ev["args"]["trace_id"] == "ab" * 16 and ev["args"]["trace_ids"] == ["ab" * 16]


def test_ring_and_chrome_output_equal_across_packages():
    outs = []
    for obs, _, _ in PKGS.values():
        t = obs.Tracer(capacity=16)
        for i in range(20):
            t.add(f"e{i}", 100.0 + i, 100.5 + i, tid="toy", trace_id="ab" * 16, n=i)
        outs.append(t.chrome_trace(limit=5, since_us=105e6))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_spans_to_chrome_documented_fields(pkg):
    obs = PKGS[pkg][0]
    ctx = obs.TraceContext(pid=1)
    ctx.span("compute", 100.2, 100.4, tid="toy", batch=3)
    ctx.root_span("request", 100.0, 100.5, tid="toy", status=200)
    evs = json.loads(obs.spans_to_chrome(ctx.spans))["traceEvents"]
    assert [e["name"] for e in evs] == ["request", "compute"]
    for e in evs:
        assert set(e) == {"name", "ph", "ts", "dur", "pid", "tid", "args"}
        assert e["ph"] == "X" and e["pid"] == 1
        assert e["args"]["trace_id"] == ctx.trace_id
        assert "span_id" in e["args"] and "parent_id" in e["args"]


# -- the flight recorder --------------------------------------------------------

def _ctx_with_span(obs, dur_ms: float = 1.0):
    ctx = obs.TraceContext()
    ctx.root_span("request", 100.0, 100.0 + dur_ms / 1e3, tid="toy")
    return ctx


@pytest.mark.parametrize("pkg", PKGS)
def test_slow_reservoir_keeps_slowest_under_churn(pkg):
    obs = PKGS[pkg][0]
    fr = obs.FlightRecorder(slow_n=4, error_capacity=8)
    durations = list(np.random.default_rng(0).permutation(50).astype(float) + 1.0)
    ids = {}
    for d in durations:
        ctx = _ctx_with_span(obs, d)
        ids[d] = ctx.trace_id
        fr.finish(ctx, "toy", 200, d)
    kept = [r["duration_ms"] for r in fr.dump()["slow"]["toy"]]
    assert kept == sorted(durations, reverse=True)[:4]
    assert fr.get(ids[max(durations)]) is not None
    assert fr.get(ids[min(durations)]) is None
    assert fr.stats()["slow"]["toy"] == 4


@pytest.mark.parametrize("pkg", PKGS)
def test_slow_reservoirs_are_per_model(pkg):
    obs = PKGS[pkg][0]
    fr = obs.FlightRecorder(slow_n=2, error_capacity=0, always_record_errors=False)
    for model in ("a", "b"):
        for d in (5.0, 10.0, 1.0):
            fr.finish(_ctx_with_span(obs, d), model, 200, d)
    dump = fr.dump()
    assert [r["duration_ms"] for r in dump["slow"]["a"]] == [10.0, 5.0]
    assert [r["duration_ms"] for r in dump["slow"]["b"]] == [10.0, 5.0]
    assert fr.dump(model="a")["slow"].keys() == {"a"}


@pytest.mark.parametrize("pkg", PKGS)
def test_errored_requests_retained_even_when_fast(pkg):
    obs = PKGS[pkg][0]
    fr = obs.FlightRecorder(slow_n=2, error_capacity=8)
    for d in (500.0, 400.0):
        fr.finish(_ctx_with_span(obs, d), "toy", 200, d)
    ctx = _ctx_with_span(obs, 0.2)
    fr.finish(ctx, "toy", 503, 0.2)
    assert fr.get(ctx.trace_id) is not None
    dump = fr.dump()
    assert [r["status"] for r in dump["errors"]] == [503]
    assert all(r["status"] == 200 for r in dump["slow"]["toy"])


@pytest.mark.parametrize("pkg", PKGS)
def test_error_fifo_bounded_newest_kept(pkg):
    obs = PKGS[pkg][0]
    fr = obs.FlightRecorder(slow_n=0, error_capacity=3)
    ids = []
    for _ in range(7):
        ctx = _ctx_with_span(obs, 1.0)
        ids.append(ctx.trace_id)
        fr.finish(ctx, "toy", 500, 1.0)
    assert [r["trace_id"] for r in fr.dump()["errors"]] == ids[-1:-4:-1]
    assert fr.get(ids[0]) is None and fr.get(ids[-1]) is not None


@pytest.mark.parametrize("pkg", PKGS)
def test_record_in_both_reservoirs_survives_single_eviction(pkg):
    obs = PKGS[pkg][0]
    fr = obs.FlightRecorder(slow_n=2, error_capacity=16)
    slow_err = _ctx_with_span(obs, 900.0)
    fr.finish(slow_err, "toy", 504, 900.0)
    for d in (1000.0, 1100.0):
        fr.finish(_ctx_with_span(obs, d), "toy", 200, d)
    rec = fr.get(slow_err.trace_id)
    assert rec is not None and rec["status"] == 504
    assert all(r["status"] == 200 for r in fr.dump()["slow"]["toy"])


@pytest.mark.parametrize("pkg", PKGS)
def test_always_record_errors_off(pkg):
    obs = PKGS[pkg][0]
    fr = obs.FlightRecorder(slow_n=0, error_capacity=8, always_record_errors=False)
    ctx = _ctx_with_span(obs, 1.0)
    assert not fr.finish(ctx, "toy", 500, 1.0)
    assert fr.get(ctx.trace_id) is None


@pytest.mark.parametrize("pkg", PKGS)
def test_recorder_dump_and_records_are_json_clean(pkg):
    obs = PKGS[pkg][0]
    fr = obs.FlightRecorder(slow_n=2, error_capacity=2)
    fr.finish(_ctx_with_span(obs, 5.0), "toy", 200, 5.0)
    rec = json.loads(json.dumps(fr.dump()))["slow"]["toy"][0]
    assert set(rec) == {"trace_id", "model", "status", "duration_ms", "ts", "spans"}
    assert rec["spans"][0]["name"] == "request"


@pytest.mark.parametrize("pkg", PKGS)
def test_recorder_ticks_trace_recorded_counters(pkg):
    obs = PKGS[pkg][0]
    m = obs.Metrics()
    fr = obs.FlightRecorder(slow_n=2, error_capacity=2, metrics=m)
    fr.finish(_ctx_with_span(obs, 5.0), "toy", 200, 5.0)
    fr.finish(_ctx_with_span(obs, 1.0), "toy", 503, 1.0)
    assert m.counter("trace_recorded_total{model=toy,kind=slow}").value == 2
    assert m.counter("trace_recorded_total{model=toy,kind=error}").value == 1


def test_recorder_sequence_equal_across_packages():
    """The same finishes (durations, statuses, models) leave the same
    reservoirs on both packages: kinds returned, dumps and stats equal up to
    the ids and timestamps."""
    rng = np.random.default_rng(3)
    seq = [(str(rng.choice(["a", "b"])), int(rng.choice([200, 200, 400, 503])),
            float(rng.uniform(0.1, 100.0))) for _ in range(200)]
    out = []
    for obs, _, _ in PKGS.values():
        fr = obs.FlightRecorder(slow_n=5, error_capacity=7)
        kinds = [fr.finish(_ctx_with_span(obs, d), m, st, d) for m, st, d in seq]
        dump = fr.dump()
        shape = ({m: [(r["status"], r["duration_ms"]) for r in rs] for m, rs in dump["slow"].items()},
                 [(r["model"], r["status"], r["duration_ms"]) for r in dump["errors"]])
        out.append((kinds, shape, fr.stats()))
    assert out[0] == out[1]


# -- exemplars ------------------------------------------------------------------

_TS = re.compile(r"( # \{trace_id=\"[0-9a-f]{32}\"\} \S+) \d+\.\d{3}$", re.M)


def test_exemplar_exposition_equal_across_packages():
    texts = []
    for obs, _, _ in PKGS.values():
        m = obs.Metrics(16)
        h = m.histogram("latency_ms{model=toy,phase=total}")
        for i, v in enumerate((0.05, 3.0, 3.5, 250.0, 2e5)):
            h.observe(v, trace_id=f"{i:032x}")
        h.observe(4.0)  # untraced: no exemplar
        m.counter("requests_total{model=toy}").inc(3)
        texts.append(_TS.sub(r"\1 TS", m.render_prometheus()))
    assert texts[0] == texts[1]
    assert texts[1].count("# {trace_id=") == 5 and texts[1].endswith("# EOF\n")
    off = tobs.Metrics(16, exemplars=False)
    off.histogram("x").observe(1.0, trace_id="ab" * 16)
    assert "trace_id" not in off.render_prometheus()


@pytest.mark.parametrize("pkg", PKGS)
def test_exposition_content_type(pkg):
    obs = PKGS[pkg][0]
    assert obs.exposition_content_type(None).startswith("text/plain; version=0.0.4")
    assert obs.exposition_content_type("application/openmetrics-text; version=1.0.0") \
        .startswith("application/openmetrics-text")


# -- single-flight trace links ----------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_coalesced_waiter_links_leader_trace(pkg):
    obs, cache, cfgm = PKGS[pkg]

    async def go():
        m = obs.Metrics()
        c = cache.ModelCache("toy", cfgm.CacheConfig(enabled=True), m, version_fn=lambda: 1)
        base = asyncio.get_running_loop().create_future()
        leader, waiter = obs.TraceContext(), obs.TraceContext()
        w1 = c.submit_through("k", lambda: base, ctx=leader)
        w2 = c.submit_through("k", lambda: 1 / 0, ctx=waiter)
        link = [s for s in waiter.spans if s["name"] == "coalesced"]
        assert len(link) == 1 and link[0]["args"]["linked_trace"] == leader.trace_id
        assert not leader.spans
        base.set_result({"ok": 1})
        assert await w1 == {"ok": 1} and await w2 == {"ok": 1}

    asyncio.new_event_loop().run_until_complete(go())


# -- over HTTP: both servers, the toy model ------------------------------------------

def toy_server_cfg(pkg: str):
    cfgm = PKGS[pkg][2]
    return cfgm.ServerConfig(
        models=[cfgm.ModelConfig(name="toy", family="toy", batch_buckets=[1, 2],
                                 deadline_ms=5.0, dtype="float32", num_classes=10,
                                 parallelism="single", request_timeout_ms=10_000.0,
                                 wire_size=8)],
        decode_threads=2, trace=cfgm.TraceConfig(slow_n=8, error_capacity=32))


class Side:
    """One server (the JAX package's or the port's) and an HTTP client."""

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
            port = self.state.serving_addresses[0][1]
            self.client = aiohttp.ClientSession(f"http://127.0.0.1:{port}")
        return self

    async def close(self) -> None:
        await self.client.close()
        if self.pkg == "port":
            await stop_server(self.state, self.server)

    async def request(self, method: str, path: str, data=None, headers=None):
        async with self.client.request(method, path, data=data, headers=headers) as r:
            body = await r.read()
            return r.status, body, dict(r.headers)


@pytest.fixture(scope="module")
def sides():
    loop = asyncio.new_event_loop()
    made = {pkg: loop.run_until_complete(Side(pkg, toy_server_cfg(pkg)).start())
            for pkg in PKGS}
    yield (lambda coro: loop.run_until_complete(coro)), made
    for side in made.values():
        loop.run_until_complete(side.close())
    loop.close()


def npy_bytes(seed: int = 0) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.random.default_rng(seed).integers(0, 255, (8, 8, 3), dtype=np.uint8))
    return buf.getvalue()


@pytest.mark.parametrize("pkg", PKGS)
def test_every_response_carries_trace_id(sides, pkg):
    run, made = sides
    side = made[pkg]

    async def go():
        seen = set()
        for path, data in (("/v1/models/toy:predict", npy_bytes()),
                           ("/v1/models/ghost:predict", npy_bytes()),
                           ("/v1/models/toy:predict", b"garbage")):
            status, _, hdr = await side.request("POST", path, data, {"Content-Type": NPY})
            tid = hdr.get("X-Trace-Id")
            assert PKGS[pkg][0].valid_trace_id(tid), (path, status, tid)
            seen.add(tid)
        assert len(seen) == 3

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_client_supplied_trace_id_adopted(sides, pkg):
    run, made = sides
    side = made[pkg]
    tid = "5a" * 16

    async def go():
        status, _, hdr = await side.request("POST", "/v1/models/toy:predict", npy_bytes(),
                                            {"Content-Type": NPY, "X-Trace-Id": tid})
        assert status == 200 and hdr["X-Trace-Id"] == tid
        status, _, hdr = await side.request("POST", "/v1/models/toy:predict", npy_bytes(),
                                            {"Content-Type": NPY, "X-Trace-Id": "not-hex!"})
        assert status == 200 and hdr["X-Trace-Id"] != "not-hex!"
        assert tobs.valid_trace_id(hdr["X-Trace-Id"])

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_error_bodies_carry_trace_id(sides, pkg):
    """400, 429, 503 and 504 bodies carry the X-Trace-Id header's id, and
    each lands in the flight recorder's error FIFO."""
    run, made = sides
    side = made[pkg]
    state = side.state

    async def go():
        statuses = {}

        async def check(resp, want):
            status, body, hdr = resp
            assert status == want, body
            body = json.loads(body)
            assert tobs.valid_trace_id(body.get("trace_id")) and body["trace_id"] == hdr["X-Trace-Id"]
            statuses[want] = body["trace_id"]

        await check(await side.request("POST", "/v1/models/toy:predict", b"junk",
                                       {"Content-Type": NPY}), 400)
        b = state.batchers["toy"]
        saved = b._pending
        b._pending = b.cfg.max_queue
        try:
            await check(await side.request("POST", "/v1/models/toy:predict", npy_bytes(),
                                           {"Content-Type": NPY}), 429)
        finally:
            b._pending = saved
        state.draining = True
        try:
            await check(await side.request("POST", "/v1/models/toy:predict", npy_bytes(),
                                           {"Content-Type": NPY}), 503)
        finally:
            state.draining = False
        await check(await side.request("POST", "/v1/models/toy:predict?timeout_ms=0.01",
                                       npy_bytes(), {"Content-Type": NPY}), 504)
        for want, tid in statuses.items():
            rec = state.recorder.get(tid)
            assert rec is not None and rec["status"] == want

    run(go())


def test_slow_dump_has_complete_span_tree(sides):
    """Both servers record the same span names for one request, batch-tagged
    phase spans included; /stats holds the reservoir's occupancy."""
    run, made = sides
    names = {}

    async def go():
        for pkg, side in made.items():
            status, _, hdr = await side.request("POST", "/v1/models/toy:predict", npy_bytes(3),
                                                {"Content-Type": NPY})
            assert status == 200
            tid = hdr["X-Trace-Id"]
            _, raw, _ = await side.request("GET", "/debug/slow")
            recs = {r["trace_id"]: r for r in json.loads(raw)["slow"]["toy"]}
            assert tid in recs
            spans = recs[tid]["spans"]
            names[pkg] = sorted(s["name"] for s in spans)
            assert all(s["trace_id"] == tid for s in spans)
            assert len({s["args"]["batch"] for s in spans if s["name"] == "compute"}) == 1
            _, raw, _ = await side.request("GET", "/stats")
            assert json.loads(raw)["trace"]["slow"]["toy"] >= 1

    run(go())
    assert names["port"] == names["jax"]
    assert {"request", "body_read", "parse", "dispatch", "queue", "preproc", "h2d",
            "compute", "postproc"} <= set(names["port"])


def test_trace_endpoint_by_id_and_ring_limits(sides):
    run, made = sides
    seen = {}

    async def go():
        for pkg, side in made.items():
            _, _, hdr = await side.request("POST", "/v1/models/toy:predict", npy_bytes(4),
                                           {"Content-Type": NPY})
            tid = hdr["X-Trace-Id"]
            status, raw, _ = await side.request("GET", f"/debug/trace?trace_id={tid}")
            assert status == 200
            assert {e["name"] for e in json.loads(raw)["traceEvents"]} >= {"request", "compute"}
            _, raw, _ = await side.request("GET", f"/debug/trace?trace_id={tid}&format=record")
            rec = json.loads(raw)
            assert rec["trace_id"] == tid and rec["spans"]
            statuses = []
            for q in (f"trace_id={'0' * 32}", "limit=2", "limit=nope", "limit=-1",
                      "since_us=99999999999999999"):
                status, raw, _ = await side.request("GET", f"/debug/trace?{q}")
                statuses.append(status)
                if q == "limit=2":
                    assert len(json.loads(raw)["traceEvents"]) <= 2
                if q.startswith("since_us"):
                    assert json.loads(raw)["traceEvents"] == []
            seen[pkg] = statuses

    run(go())
    assert seen["port"] == seen["jax"] == [404, 200, 400, 400, 200]


def test_metrics_exemplars_over_http(sides):
    run, made = sides
    pat = re.compile(r'_bucket\{.*le="[^"]+"\} \d+ '
                     r'# \{trace_id="([0-9a-f]{32})"\} [0-9.e+-]+ \d+\.\d+$')

    async def go():
        for side in made.values():
            _, _, hdr = await side.request("POST", "/v1/models/toy:predict", npy_bytes(5),
                                           {"Content-Type": NPY})
            tid = hdr["X-Trace-Id"]
            _, raw, _ = await side.request("GET", "/metrics")
            lines = [ln for ln in raw.decode().splitlines() if "# {trace_id=" in ln]
            assert lines and all(pat.search(ln) for ln in lines), lines[:3]
            assert any(tid in ln and 'phase="total"' in ln for ln in lines)

    run(go())


def test_stats_blocks_have_the_same_keys(sides):
    run, made = sides
    keys = {}

    async def go():
        for pkg, side in made.items():
            _, raw, _ = await side.request("GET", "/stats")
            stats = json.loads(raw)
            keys[pkg] = {b: sorted(stats[b]) for b in ("trace", "events", "telemetry")}
            keys[pkg]["events.audit"] = sorted(stats["events"]["audit"])
            keys[pkg]["telemetry.profile"] = sorted(stats["telemetry"]["profile"])

    run(go())
    assert keys["port"] == keys["jax"]


def _blocks(state) -> dict:
    """The /stats trace, events and telemetry blocks a server builds (as
    both servers' stats handlers compose them)."""
    return {"trace": sorted(state.recorder.stats()),
            "events": sorted({**state.events.stats(), "audit": 0, "postmortems": 0}),
            "telemetry": sorted({**state.store.stats(), "sample_interval_s": 0, "profile": 0}),
            "profile": sorted(state.profiler.stats()),
            "alerts": sorted(state.slo.alerts())}


@pytest.mark.parametrize("path", ["examples/bert_flash.toml", "examples/resnet50.toml",
                                  "examples/mobilenetv3.toml"])
def test_examples_serve_the_same_observability_blocks(path):
    """For each served example, the two packages' servers turn the same
    planes on from the file (the reference's defaults) and build the same
    blocks, with the same capacities."""
    jstate = JaxServerState(jconfig.load_config(path))
    tstate = ServerState(tconfig.load_config(path), device="cpu")
    assert _blocks(tstate) == _blocks(jstate)
    for attr in ("recorder", "events", "audit", "postmortems", "store", "sampler", "slo",
                 "util", "profiler"):
        assert getattr(tstate, attr) is not None, attr
    assert tstate.recorder.stats() == jstate.recorder.stats()
    assert tstate.events.capacity == jstate.events.capacity
    assert tstate.store.capacity == jstate.store.capacity
    assert tstate.slo.windows == jstate.slo.windows
    assert tstate.metrics.tracer._events.maxlen == jstate.metrics.tracer._events.maxlen


@pytest.mark.parametrize("pkg", PKGS)
def test_phase_timer_observes_and_traces(pkg):
    obs = PKGS[pkg][0]
    m = obs.Metrics(16)
    with obs.phase_timer(m, "toy", "preproc", trace=True):
        pass
    with obs.phase_timer(m, "toy", "preproc"):
        pass
    assert m.histogram("latency_ms{model=toy,phase=preproc}").n == 2
    (ev,) = json.loads(m.tracer.chrome_trace())["traceEvents"]
    assert (ev["name"], ev["tid"]) == ("preproc", "toy")
