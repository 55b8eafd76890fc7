"""The port's load generator (``tpuserve_torch.bench``) against the
reference's (``tpuserve.bench``), and the port's standard-library HTTP
client.

Every scenario of ``tests/test_loadgen.py`` runs on both load generators
against one stub server written with the standard library (``Stub``: an
asyncio HTTP/1.1 server on its own thread). Held exactly where the stub
makes them deterministic: the straggler counts (4 in the window, 4 late),
the shed's ``n_ok`` 0, the error counts' ``n_ok`` 0, the window length,
the summary keys, every body of a distinct pool on the wire. Held with the
reference's bounds where timing decides: the open loop's 25-60 completions
and p50 in [25, 150] ms at 50 req/s, the closed loop's p50 >= the stub's
delay. The straggler scenario runs at 0.5 s per answer and a 0.75 s window
(the reference: 0.3 s and 0.45 s), so parallel test workers cannot push the
first round out of the window or the second into it.

Pure functions are held equal, value for value or byte for byte: every
``synthetic_*`` body for the same seeds, ``closed_loop_concurrency``,
``gap_histogram``, ``percentile``, ``_record``, ``merge_load_summaries``,
``LoadResult.summary()``, ``StreamLoadResult.summary()``, ``SseParser``'s
events under any chunking, and every function of ``bench/roofline.py``.
The streaming path (``stream_generate``, ``run_stream_load``) runs on both
against a stub SSE server, whose chunked bytes are split on the wire inside
chunk-size lines and inside events: the same records. The ``/stats``
``roofline`` block of both servers (toy model, CPU,
``roofline_probe_iters = 2``) has the same keys and bucket keys, and ``GET
/`` is equal byte for byte.
"""

import asyncio
import io
import json
import socket
import sys
import threading
import time
from http import HTTPStatus

import aiohttp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import given, settings
from hypothesis import strategies as st

from tpuserve import config as jconfig
from tpuserve import obs as jobs
from tpuserve.bench import loadgen as jlg
from tpuserve.bench import roofline as jroof
from tpuserve.server import ServerState as JaxServerState
from tpuserve.server import make_app
from tpuserve_torch import config as tconfig
from tpuserve_torch import obs as tobs
from tpuserve_torch.bench import client as tclient
from tpuserve_torch.bench import loadgen as tlg
from tpuserve_torch.bench import roofline as troof
from tpuserve_torch.server import ServerState, start_server, stop_server

LG = {"jax": jlg, "port": tlg}
PKGS = tuple(LG)
OCTET = "application/octet-stream"
JSON_CT = {"Content-Type": "application/json"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the stub server ---------------------------------------------------------------

class Stub:
    """A standard-library HTTP/1.1 server on its own thread and event loop,
    so in-process load generators and subprocesses can both reach it.

    Each request is answered after ``delay_s`` with ``status`` and ``body``
    (``Content-Length`` framed, or ``Transfer-Encoding: chunked`` in two
    chunks with ``chunked``), plus ``headers``; ``close`` answers
    ``Connection: close`` and closes. ``pieces(body) -> list[bytes]``
    replaces the answer by raw bytes written one piece at a time
    (``piece_gap_s`` apart), the connection closed after them. Counts
    ``connections`` and ``requests`` and keeps the request ``bodies``."""

    def __init__(self, delay_s: float = 0.0, status: int = 200, body: bytes = b'{"ok": true}',
                 headers: dict | None = None, chunked: bool = False, close: bool = False,
                 pieces=None, piece_gap_s: float = 0.0) -> None:
        self.delay_s, self.status, self.body = delay_s, status, body
        self.headers = headers or {}
        self.chunked, self.close = chunked, close
        self.pieces, self.piece_gap_s = pieces, piece_gap_s
        self.connections = 0
        self.requests = 0
        self.bodies: list[bytes] = []
        self._writers: set = set()
        self._ready = threading.Event()
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _answer(self) -> bytes:
        lines = [f"HTTP/1.1 {self.status} {HTTPStatus(self.status).phrase}",
                 "Content-Type: application/json"]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        if self.close:
            lines.append("Connection: close")
        if self.chunked:
            half = len(self.body) // 2
            parts = [self.body[:half], self.body[half:]]
            lines.append("Transfer-Encoding: chunked")
            data = b"".join(b"%x\r\n%s\r\n" % (len(p), p) for p in parts if p) + b"0\r\n\r\n"
        else:
            lines.append(f"Content-Length: {len(self.body)}")
            data = self.body
        return ("\r\n".join(lines) + "\r\n\r\n").encode() + data

    async def _handle(self, reader, writer) -> None:
        self.connections += 1
        self._writers.add(writer)
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                hdrs = {}
                for line in head.decode("latin-1").split("\r\n")[1:]:
                    k, _, v = line.partition(":")
                    hdrs[k.strip().lower()] = v.strip()
                body = await reader.readexactly(int(hdrs.get("content-length", "0")))
                self.requests += 1
                self.bodies.append(body)
                if self.delay_s:
                    await asyncio.sleep(self.delay_s)
                if self.pieces is not None:
                    for piece in self.pieces(body):
                        writer.write(piece)
                        await writer.drain()
                        await asyncio.sleep(self.piece_gap_s)
                    return
                writer.write(self._answer())
                await writer.drain()
                if self.close:
                    return
        except ConnectionError:
            return
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _start(self) -> None:
        self._server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self._start())
        self._ready.set()
        self.loop.run_forever()

    async def _shutdown(self) -> None:
        self._server.close()
        for w in list(self._writers):
            w.close()
        tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    def __enter__(self) -> "Stub":
        self._thread.start()
        assert self._ready.wait(10)
        return self

    def __exit__(self, *exc) -> None:
        asyncio.run_coroutine_threadsafe(self._shutdown(), self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(10)
        assert not self._thread.is_alive()
        self.loop.close()

    @property
    def base(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def url(self) -> str:
        return f"{self.base}/v1/models/m:predict"


def closed_port() -> int:
    """A local port nothing listens on (bound, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- tests/test_loadgen.py's scenarios, on both load generators ---------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_closed_loop_measures_latency_and_window(pkg):
    with Stub(delay_s=0.02) as stub:
        res = asyncio.run(LG[pkg].run_load(stub.url, b"x", OCTET, duration_s=0.5,
                                           concurrency=4, warmup_s=0.1))
    assert res.mode == "closed"
    assert res.n_ok > 0 and res.n_err == 0
    assert res.duration_s == pytest.approx(0.5, abs=1e-6)
    s = res.summary()
    assert s["p50_ms"] >= 20.0  # can't be faster than the handler
    assert s["throughput_per_s"] == pytest.approx(res.n_ok / 0.5, rel=1e-6)
    assert sorted(s) == ["duration_s", "mode", "n_err", "n_late", "n_ok", "p50_ms",
                         "p90_ms", "p99_ms", "throughput_per_s"]


@pytest.mark.parametrize("pkg", PKGS)
def test_closed_loop_excludes_stragglers(pkg):
    """Completions after the window close land in n_late, never in n_ok:
    round 1 completes at ~0.5 s (inside the 0.75 s window), round 2 at
    ~1.0 s (outside)."""
    with Stub(delay_s=0.5) as stub:
        res = asyncio.run(LG[pkg].run_load(stub.url, b"x", OCTET, duration_s=0.75,
                                           concurrency=4, warmup_s=0.0))
    assert (res.n_ok, res.n_late, res.n_err) == (4, 4, 0)


@pytest.mark.parametrize("pkg", PKGS)
def test_open_loop_issues_on_a_clock(pkg):
    """Offered rate is held regardless of completions; latency is server
    latency, not Little's-law queueing."""
    with Stub(delay_s=0.03) as stub:
        res = asyncio.run(LG[pkg].run_load_open(stub.url, b"x", OCTET, rate_per_s=50.0,
                                                duration_s=1.0, warmup_s=0.2))
        hits = stub.requests
    assert res.mode == "open"
    s = res.summary()
    assert s["offered_rate_per_s"] == 50.0
    assert 25 <= res.n_ok <= 60  # ~50 inside the 1 s window
    assert 25.0 <= s["p50_ms"] <= 150.0
    assert 50 <= hits <= 62  # 60 issues over warmup + window, each answered


@pytest.mark.parametrize("pkg", PKGS)
def test_open_loop_sheds_beyond_max_inflight(pkg):
    with Stub(delay_s=0.5) as stub:
        res = asyncio.run(LG[pkg].run_load_open(stub.url, b"x", OCTET, rate_per_s=100.0,
                                                duration_s=0.5, warmup_s=0.0,
                                                max_inflight=2))
    assert res.n_err > 10  # client-side shed is reported, not hidden
    assert res.n_ok == 0  # nothing completes inside a 0.5 s window
    assert res.n_late == 2


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("status, headers", [(500, {}), (429, {"Retry-After": "1"})])
def test_errors_counted(pkg, status, headers):
    """A 500 and a 429 with Retry-After are errors; nothing is retried (one
    request on the wire per error counted)."""
    with Stub(status=status, headers=headers) as stub:
        res = asyncio.run(LG[pkg].run_load(stub.url, b"x", OCTET, duration_s=0.3,
                                           concurrency=2, warmup_s=0.0))
        requests = stub.requests
    assert res.n_ok == 0 and res.n_err > 0
    assert requests == res.n_err + res.n_late


@pytest.mark.parametrize("pkg", PKGS)
def test_refused_connection_counts_errors_without_raising(pkg):
    url = f"http://127.0.0.1:{closed_port()}/v1/models/m:predict"
    closed = asyncio.run(LG[pkg].run_load(url, b"x", OCTET, duration_s=0.2,
                                          concurrency=2, warmup_s=0.0))
    opened = asyncio.run(LG[pkg].run_load_open(url, b"x", OCTET, rate_per_s=50.0,
                                               duration_s=0.2, warmup_s=0.0))
    for res in (closed, opened):
        assert res.n_ok == 0 and res.n_err > 0


@pytest.mark.parametrize("pkg", PKGS)
def test_items_per_request_scales_throughput(pkg):
    LoadResult = LG[pkg].LoadResult
    r = LoadResult(mode="closed", n_ok=10, duration_s=2.0, items_per_request=8)
    assert r.throughput == 40.0
    assert r.summary()["items_per_request"] == 8
    assert "items_per_request" not in LoadResult(n_ok=1, duration_s=1.0).summary()


@pytest.mark.parametrize("pkg", PKGS)
def test_closed_loop_cycles_distinct_pool(pkg):
    """A list payload round-robins across workers and is reported in the
    summary; all four bodies hit the wire."""
    pool = [f"payload-{i}".encode() for i in range(4)]
    with Stub() as stub:
        res = asyncio.run(LG[pkg].run_load(f"{stub.base}/v1/x", pool, OCTET,
                                           duration_s=0.4, concurrency=4, warmup_s=0.0))
        seen = set(stub.bodies)
    assert res.n_ok > 0
    assert res.summary()["distinct_payloads"] == 4
    assert seen == set(pool)


# -- the client --------------------------------------------------------------------

def test_client_reuses_one_connection_per_closed_loop_worker():
    with Stub() as stub:
        res = asyncio.run(tlg.run_load(stub.url, b"x", OCTET, duration_s=0.3,
                                       concurrency=4, warmup_s=0.0))
        assert stub.requests == res.n_ok + res.n_late > 8
        assert stub.connections == 4


def test_client_honours_connection_close():
    """Every answer says ``Connection: close``: one connection per request,
    none reused, no request failed."""
    with Stub(close=True) as stub:
        res = asyncio.run(tlg.run_load(stub.url, b"x", OCTET, duration_s=0.3,
                                       concurrency=2, warmup_s=0.0))
        assert res.n_err == 0 and res.n_ok > 2
        assert stub.connections == stub.requests == res.n_ok + res.n_late


def test_client_reads_chunked_answers_and_sends_content_length():
    body = json.dumps({"results": list(range(50))}).encode()

    async def go(stub):
        async with tclient.ClientSession() as s:
            a = await s.post(stub.url, b"abc", {"Content-Type": OCTET})
            b = await s.post(stub.url, b"", {"Content-Type": OCTET})
            return a, b

    with Stub(body=body, chunked=True) as stub:
        a, b = asyncio.run(go(stub))
        assert stub.bodies == [b"abc", b""]
        assert stub.connections == 1  # the chunked answer left the connection reusable
    assert a.status == b.status == 200
    assert a.body == b.body == body and a.json()["results"][-1] == 49
    assert a.headers["transfer-encoding"] == "chunked"
    with Stub(chunked=True) as stub:
        res = asyncio.run(tlg.run_load(stub.url, b"x", OCTET, duration_s=0.2,
                                       concurrency=2, warmup_s=0.0))
    assert res.n_ok > 0 and res.n_err == 0


def test_client_timeout_and_refusal_raise_client_errors():
    async def go(url, timeout_s):
        async with tclient.ClientSession(timeout_s=timeout_s) as s:
            return await s.post(url, b"x")

    with Stub(delay_s=1.0) as stub:
        t0 = time.perf_counter()
        with pytest.raises(tclient.ClientTimeout):
            asyncio.run(go(stub.url, 0.1))
        assert time.perf_counter() - t0 < 0.9
    with pytest.raises(tclient.ClientError):
        asyncio.run(go(f"http://127.0.0.1:{closed_port()}/x", 5.0))
    # An answer cut off inside its body is an error, not a short body.
    cut = Stub(pieces=lambda body: [b"HTTP/1.1 200 OK\r\nContent-Length: 10\r\n\r\nabc"])
    with cut as stub, pytest.raises(tclient.ClientError):
        asyncio.run(go(stub.url, 5.0))


def test_client_pool_limit_caps_open_connections():
    """``limit`` caps connections open at once: 8 concurrent requests on a
    limit of 2 open 2 connections."""
    async def go(stub):
        async with tclient.ClientSession(limit=2) as s:
            out = await asyncio.gather(*(s.post(stub.url, b"x") for _ in range(8)))
            return [r.status for r in out]

    with Stub(delay_s=0.05) as stub:
        assert asyncio.run(go(stub)) == [200] * 8
        assert stub.connections == 2


# -- streaming (SSE), on both load generators ----------------------------------------

def sse_events(n_tokens: int, terminal: str | None = "done") -> bytes:
    out = [b": hb\n\n"]
    for i in range(n_tokens):
        out.append(b"event: token\ndata: " + json.dumps({"index": i, "text": f"t{i} "}).encode()
                   + b"\n\n")
    if terminal == "done":
        out.append(b'event: done\ndata: {"finish_reason": "length", "usage": {"tokens": %d}}\n\n'
                   % n_tokens)
    elif terminal == "error":
        out.append(b'event: error\ndata: {"error": "injected"}\n\n')
    return b"".join(out)


def chunked(data: bytes, sizes=(7, 30, 5, 61, 3)) -> bytes:
    """``data`` as a chunked body whose chunk boundaries cut events."""
    out, i, k = [], 0, 0
    while i < len(data):
        n = sizes[k % len(sizes)]
        out.append(b"%x\r\n%s\r\n" % (len(data[i:i + n]), data[i:i + n]))
        i, k = i + n, k + 1
    return b"".join(out) + b"0\r\n\r\n"


# The stub closes the connection after ``pieces``, so the head says so.
SSE_HEAD = (b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
            b"X-Tpuserve-Stream: 1\r\nConnection: close\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n")


def split_at(data: bytes, cuts) -> list[bytes]:
    cuts = sorted({c for c in cuts if 0 < c < len(data)})
    return [data[a:b] for a, b in zip([0, *cuts], [*cuts, len(data)])]


def stream_record(pkg: str, url: str) -> dict:
    async def go():
        if pkg == "jax":
            async with aiohttp.ClientSession() as s:
                return await jlg.stream_generate(s, url, b"{}", JSON_CT)
        async with tclient.ClientSession() as s:
            return await tlg.stream_generate(s, url, b"{}", JSON_CT)

    rec = asyncio.run(go())
    assert len(rec.pop("token_times")) == len(rec["indices"])
    assert (rec.pop("first_token_ms") is None) == (not rec["indices"])
    return rec


@pytest.mark.parametrize("terminal", ["done", "error", None])
def test_stream_generate_same_records_under_any_split(terminal):
    """The SSE bytes in HTTP chunks that cut events, written to the socket
    in pieces cut inside chunk-size lines and inside events (and not cut):
    both packages' records are equal, whatever the cuts."""
    wire = chunked(sse_events(6, terminal))
    size_lines = [i + 1 for i in range(len(wire) - 1) if wire[i:i + 2] == b"\r\n"]
    cuts_variants = [[], [1, 2, len(wire) // 2],
                     [c + 1 for c in size_lines[::3]],
                     list(range(5, len(wire), 11))]
    records = []
    for cuts in cuts_variants:
        pieces = [SSE_HEAD, *split_at(wire, cuts)]
        with Stub(pieces=lambda body, p=pieces: p, piece_gap_s=0.002) as stub:
            for pkg in PKGS:
                records.append((pkg, cuts, stream_record(pkg, stub.url)))
    first = records[0][2]
    assert first["indices"] == list(range(6))
    assert first["terminal"] == terminal and first["torn"] == (terminal is None)
    for pkg, cuts, rec in records:
        assert rec == first, (pkg, cuts)


def test_stream_generate_torn_and_plain_answers_agree():
    """A stream cut off mid-chunk is torn on both; a plain 400 is no stream."""
    wire = chunked(sse_events(3, "done"))
    torn = [SSE_HEAD, wire[: len(wire) // 2]]
    with Stub(pieces=lambda body: torn) as stub:
        recs = [stream_record(pkg, stub.url) for pkg in PKGS]
    assert recs[0] == recs[1] and recs[0]["torn"] and recs[0]["status"] == 200
    with Stub(status=400) as stub:
        recs = [stream_record(pkg, stub.url) for pkg in PKGS]
    assert recs[0] == recs[1] and recs[0]["status"] == 400 and not recs[0]["torn"]
    url = f"http://127.0.0.1:{closed_port()}/x"
    recs = [stream_record(pkg, url) for pkg in PKGS]
    assert recs[0] == recs[1] and recs[0]["status"] == -1


@pytest.mark.parametrize("pkg", PKGS)
def test_run_stream_load_against_sse_stub(pkg):
    """Closed-loop streaming: every stream in the window ends "done", none
    torn, first-token latencies at the stub's delay; the summaries of the
    two packages have the same keys."""
    pieces = [SSE_HEAD, chunked(sse_events(4, "done"))]
    with Stub(pieces=lambda body: pieces, delay_s=0.02) as stub:
        pool = tlg.synthetic_prompt_pool(4)
        res = asyncio.run(LG[pkg].run_stream_load(stub.url, pool, "application/json",
                                                  duration_s=0.5, concurrency=2,
                                                  warmup_s=0.1))
        assert set(stub.bodies) == set(pool)
    s = res.summary()
    assert res.n_ok > 0 and res.n_err == 0 and res.torn == 0
    assert res.terminals == {"done": res.n_ok}
    assert len(res.first_token_ms) == res.n_ok and min(res.first_token_ms) >= 20.0
    assert res.tokens > 0 and s["distinct_payloads"] == 4
    assert sorted(s) == sorted(jlg.StreamLoadResult(duration_s=1.0, distinct_payloads=4).summary())


# -- pure functions, equal on both packages ------------------------------------------

@pytest.mark.parametrize("edge, seed", [(8, 0), (16, 3), (256, 7)])
def test_synthetic_image_bodies_byte_equal(edge, seed):
    assert tlg.synthetic_image_npy(edge, seed) == jlg.synthetic_image_npy(edge, seed)
    assert (tlg.synthetic_image_npy_batch(edge, 4, seed)
            == jlg.synthetic_image_npy_batch(edge, 4, seed))
    arr = np.load(io.BytesIO(tlg.synthetic_image_npy_batch(edge, 4, seed)))
    assert arr.shape == (4, edge, edge, 3) and arr.dtype == np.uint8


@pytest.mark.parametrize("kind, n, edge, batch, seed_base",
                         [("npy", 8, 8, 0, 0), ("npy", 3, 8, 4, 5), ("jpeg", 3, 16, 0, 2)])
def test_synthetic_pools_byte_equal(kind, n, edge, batch, seed_base):
    pool = tlg.synthetic_pool(kind, n, edge, batch, seed_base=seed_base)
    assert pool == jlg.synthetic_pool(kind, n, edge, batch, seed_base=seed_base)
    assert len(set(pool)) == n


@pytest.mark.parametrize("kind", ["yuv420", "rgb8"])
def test_synthetic_frames_byte_equal(kind):
    assert (tlg.synthetic_frame(16, 3, kind, seed=4)
            == jlg.synthetic_frame(16, 3, kind, seed=4))
    assert (tlg.synthetic_frame_pool(3, 8, 2, kind, seed_base=9)
            == jlg.synthetic_frame_pool(3, 8, 2, kind, seed_base=9))


@pytest.mark.parametrize("kw", [dict(n=16, max_new=(2, 24)), dict(n=4, sd=True),
                                dict(n=12, long_every=3, long_words=9, seed=5),
                                dict(n=7, max_new=(3, 3), seed=2)])
def test_synthetic_prompt_pools_byte_equal(kw):
    assert tlg.synthetic_prompt_pool(**kw) == jlg.synthetic_prompt_pool(**kw)


def test_synthetic_prompt_pool_refuses_bad_range_on_both():
    for lg in LG.values():
        with pytest.raises(ValueError, match="max_new"):
            lg.synthetic_prompt_pool(4, max_new=(5, 2))


def test_synthetic_jpeg_without_pil_says_so(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="need PIL"):
        tlg.synthetic_image_jpeg(16)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(1, 512), max_size=5), st.integers(0, 16), st.integers(1, 1024))
def test_closed_loop_concurrency_equal(buckets, n_chips, cap):
    assert (tlg.closed_loop_concurrency(buckets, n_chips, cap)
            == jlg.closed_loop_concurrency(buckets, n_chips, cap))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(0, 1000, allow_nan=False), max_size=40), st.floats(0, 1))
def test_gap_histogram_and_percentile_equal(gaps, q):
    assert tlg.gap_histogram(gaps) == jlg.gap_histogram(gaps)
    assert tobs.percentile(gaps, q) == jobs.percentile(gaps, q)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.booleans(), st.floats(0, 5), st.floats(0, 5)), max_size=30))
def test_record_window_accounting_equal(events):
    """``_record`` on the same completions: the same counts and samples."""
    out = []
    for lg in LG.values():
        r = lg.LoadResult()
        for ok, t0, dt in events:
            lg._record(r, ok, t0, t0 + dt, 1.0, 4.0)
        out.append((r.n_ok, r.n_err, r.n_late, r.latencies_ms))
    assert out[0] == out[1]


def result_pair(seed: int, mode: str, items: int, distinct: int):
    rng = np.random.default_rng(seed)
    lats = [float(x) for x in rng.gamma(2.0, 3.0, 200)]
    kw = dict(mode=mode, n_ok=len(lats), n_err=int(rng.integers(0, 5)),
              n_late=int(rng.integers(0, 5)), duration_s=float(rng.uniform(1, 5)),
              offered_rate=float(rng.uniform(10, 90)), items_per_request=items,
              distinct_payloads=distinct, latencies_ms=lats)
    return jlg.LoadResult(**kw), tlg.LoadResult(**kw)


@pytest.mark.parametrize("mode, items, distinct", [("closed", 1, 0), ("open", 32, 0),
                                                   ("open", 1, 8), ("closed", 8, 4)])
def test_load_summaries_and_merge_equal(mode, items, distinct):
    parts = {"jax": [], "port": []}
    for seed in range(3):
        j, t = result_pair(seed, mode, items, distinct)
        assert t.summary() == j.summary()
        parts["jax"].append({"summary": j.summary(), "latencies_ms": j.latencies_ms})
        parts["port"].append({"summary": t.summary(), "latencies_ms": t.latencies_ms})
    merged = tlg.merge_load_summaries(parts["port"])
    assert merged == jlg.merge_load_summaries(parts["jax"])
    assert merged["load_workers"] == 3
    with pytest.raises(ValueError):
        tlg.merge_load_summaries([])


def test_stream_summaries_equal():
    rng = np.random.default_rng(3)
    kw = dict(n_ok=40, n_err=2, n_late=1, duration_s=2.5, distinct_payloads=6, tokens=811,
              torn=1, terminals={"done": 40, "error": 1, "torn": 1},
              first_token_ms=[float(x) for x in rng.gamma(2, 5, 40)],
              gap_ms=[float(x) for x in rng.gamma(1.5, 20, 300)])
    assert tlg.StreamLoadResult(**kw).summary() == jlg.StreamLoadResult(**kw).summary()
    assert tlg.StreamLoadResult().summary() == jlg.StreamLoadResult().summary()


@settings(max_examples=80, deadline=None)
@given(st.binary(max_size=300), st.lists(st.integers(1, 300), max_size=8))
def test_sse_parser_events_equal_under_any_chunking(noise, cuts):
    data = sse_events(5, "done") + noise + sse_events(2, "error")
    whole_j, whole_t = jlg.SseParser(), tlg.SseParser()
    want = whole_j.feed(data)
    assert whole_t.feed(data) == want
    for mod in (jlg, tlg):
        p = mod.SseParser()
        got = [ev for piece in split_at(data, cuts) for ev in p.feed(piece)]
        assert got == want
        assert p.pending == whole_j.pending


# -- roofline -------------------------------------------------------------------------

PHASES = ("body_read", "parse", "queue", "preproc", "h2d", "compute", "postproc")


def seeded_latency(seed: int, model: str = "m") -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for phase in PHASES:
        if rng.random() < 0.8:
            n = int(rng.integers(0, 3))
            out[f"latency_ms{{model={model},phase={phase}}}"] = {
                "n": n, "p50_ms": float(rng.uniform(0.01, 30)), "p99_ms": 99.0}
    return out


@pytest.mark.parametrize("seed", range(6))
def test_roofline_functions_equal(seed):
    rng = np.random.default_rng(seed)
    values = [float(v) for v in rng.uniform(100, 700, int(rng.integers(0, 9)))]
    for k in (1, 3, 5):
        assert troof.best_window(values, k) == jroof.best_window(values, k)
    assert troof.spread_pct(values) == jroof.spread_pct(values)
    assert troof.cv_pct(values) == jroof.cv_pct(values)
    lat = seeded_latency(seed)
    buckets = sorted({int(b) for b in rng.choice([1, 4, 8, 32, 128], 3)})
    raw = {b: (float(rng.uniform(0.5, 20)) if rng.random() < 0.8 else None) for b in buckets}
    link = float(rng.choice([0.0, 12.5, 800.0]))
    for phase in PHASES:
        assert troof.phase_p50(lat, "m", phase) == jroof.phase_p50(lat, "m", phase)
    for b in buckets:
        assert (troof.wire_ms_per_batch(b, 150528, link)
                == jroof.wire_ms_per_batch(b, 150528, link))
    for obs_ms, dev_ms in [(None, 1.0), (5.0, None), (5.0, 0.0), (5.0, 2.0), (1.0, 3.0)]:
        assert troof.compute_split(obs_ms, dev_ms) == jroof.compute_split(obs_ms, dev_ms)
    args = (lat, "m", buckets, raw, link, 150528, float(rng.uniform(100, 900)),
            float(rng.uniform(10, 900)))
    for kw in ({}, {"n_chips": 4, "req_bytes": 36912}):
        assert troof.build_roofline(*args, **kw) == jroof.build_roofline(*args, **kw)
    assert troof.ROOFLINE_PHASES == jroof.ROOFLINE_PHASES
    assert troof.ROOFLINE_CEILINGS == jroof.ROOFLINE_CEILINGS


TOY = dict(name="toy", family="toy", batch_buckets=[1, 2, 4], deadline_ms=5.0,
           dtype="float32", num_classes=10, parallelism="single",
           request_timeout_ms=10_000.0)


def test_stats_roofline_block_and_index_page_on_both_servers():
    """Both servers, toy model on the CPU, ``roofline_probe_iters = 2`` and a
    0.1 s telemetry sampler: after a few requests the ``roofline`` row has
    the same keys (``variants``, ``compiles_total``, ``raw_ms_per_batch``,
    ``utilization``, ``compute_split``) and the same bucket keys on both, a
    positive probe per bucket; ``GET /`` answers the same page."""
    body = jlg.synthetic_image_npy(edge=8)
    headers = {"Content-Type": "application/x-npy"}

    def cfg(mod):
        return mod.ServerConfig(models=[mod.ModelConfig(**TOY)], decode_threads=2,
                                roofline_probe_iters=2,
                                telemetry=mod.TelemetryConfig(sample_interval_s=0.1))

    async def poll_roofline(get_stats) -> dict:
        for _ in range(100):
            row = (await get_stats()).get("roofline", {}).get("toy", {})
            if "utilization" in row and "compute_split" in row:
                return row
            await asyncio.sleep(0.1)
        raise AssertionError(f"roofline row never complete: {row}")

    async def jax_side():
        state = JaxServerState(cfg(jconfig))
        state.build()
        client = TestClient(TestServer(make_app(state)))
        await client.start_server()
        try:
            for _ in range(4):
                async with client.post("/v1/models/toy:predict", data=body, headers=headers) as r:
                    assert r.status == 200
            async with client.get("/") as r:
                index = (r.status, r.content_type, await r.read())

            async def get_stats():
                async with client.get("/stats") as r:
                    return await r.json()
            return await poll_roofline(get_stats), index
        finally:
            await client.close()

    async def port_side():
        state = ServerState(cfg(tconfig), device="cpu")
        state.build()
        server = await start_server(state, "127.0.0.1", 0)
        base = f"http://127.0.0.1:{state.serving_addresses[0][1]}"
        try:
            async with tclient.ClientSession() as s:
                for _ in range(4):
                    r = await s.post(f"{base}/v1/models/toy:predict", body, headers)
                    assert r.status == 200
                r = await s.get(f"{base}/")
                index = (r.status, r.headers["content-type"].split(";")[0], r.body)

                async def get_stats():
                    return (await s.get(f"{base}/stats")).json()
                return await poll_roofline(get_stats), index
        finally:
            await stop_server(state, server)

    j_row, j_index = asyncio.run(jax_side())
    t_row, t_index = asyncio.run(port_side())
    assert t_index == j_index and t_index[:2] == (200, "text/html")
    assert sorted(t_row) == sorted(j_row) == ["compiles_total", "compute_split",
                                              "raw_ms_per_batch", "utilization", "variants"]
    assert sorted(t_row["raw_ms_per_batch"]) == sorted(j_row["raw_ms_per_batch"]) \
        == ["[1]", "[2]", "[4]"]
    assert all(v > 0 for v in t_row["raw_ms_per_batch"].values())
    assert sorted(t_row["compute_split"]) == sorted(j_row["compute_split"])
    assert t_row["compute_split"]["device_ms"] == max(t_row["raw_ms_per_batch"].values())
    assert sorted(t_row["utilization"]) == sorted(j_row["utilization"])
    assert [v["bucket"] for v in t_row["variants"]] == [v["bucket"] for v in j_row["variants"]]
