"""Streamed generation in the port (``GenEngine.submit_stream``, the SSE
front door, the stream event frame) beside the reference's, scenario by
scenario from ``tests/test_stream.py``, on the CPU: textgen at the reference
tests' tiny options (1 layer, d 32, vocab 512, float32) on the same weights
(``tests/test_torch_genserve.py``'s harness).

Held on both packages alike (``pkg``), exactly: the one-terminal contract
(every stream ends in exactly one "done" or "error"), contiguous token
indices, the concatenated token text equal to the unary text, and across
packages equal to the reference's streamed text for the same seeded request;
a disconnect frees the slot (dense) and every KV page (paged); the drain
budget ends stragglers with "drain"; shutdown ends open streams with
"shutdown"; an engine error ends them with "engine_error"; the slow-consumer
policies; the closed termination vocabulary.

Held between the packages' wire code, byte for byte: the SSE encoding of the
same units, the heartbeat and content type; the stream event frame in both
directions (the port's encoder read by the reference's reader and back)
under every two-piece tear; ``SseParser`` on torn events.

Over HTTP, through the port's own server and its stdlib client (the
reference's tests drive aiohttp, which the port does not have): a byte audit
(headers, chunked framing, one done, the text equal to the unary answer's
and the reference's), heartbeats across idle gaps, junk ``stream=`` 400, a
non-generative model 400, a multi-item body 400, a pre-first-unit deadline
as a plain 504, an injected ``stream_disconnect`` as a torn stream whose
slot comes back, a client that hangs up mid-stream freeing its slot and
pages, a stream served from an ingest loop, and the stream spans and
first-unit histogram.
"""

import asyncio
import json
import socket
import time

import numpy as np
import pytest

from test_torch_genserve import (MODS, PKGS, Served, build_side, counter,  # noqa: F401
                                 prompt_item, run, sides, weights)
from tpuserve import frame as jframe
from tpuserve.bench import loadgen as jloadgen
from tpuserve_torch import config as tconfig
from tpuserve_torch import faults as tfaults
from tpuserve_torch import frame as tframe
from tpuserve_torch.bench import client as tclient
from tpuserve_torch.bench import loadgen as tloadgen

FRAMES = {"jax": jframe, "port": tframe}
PARSERS = {"jax": jloadgen.SseParser, "port": tloadgen.SseParser}
JSON_HDR = {"Content-Type": "application/json"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_engine(sides, pkg: str, slots: int = 4, **gc_over):
    model, rt = sides[pkg]
    mods = MODS[pkg]
    m = mods.obs.Metrics()
    eng = mods.genserve.GenEngine(model, rt, m,
                                  mods.config.GenserveConfig(slots=slots, **gc_over))
    eng.compile()  # reuses the runtime's registered programs
    return eng, m


async def drain_stream(stream, timeout_s: float = 30.0) -> list:
    """Consume a GenStream to its terminal (the one-terminal contract says
    this always returns)."""
    units = []
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while True:
        budget = deadline - loop.time()
        assert budget > 0, f"no terminal within {timeout_s}s: {units}"
        unit = await asyncio.wait_for(stream.get(), budget)
        units.append(unit)
        if unit["type"] in ("done", "error"):
            return units


def terminated(m, reason: str) -> float:
    return m.counter(f"gen_stream_terminated_total{{model=tg,reason={reason}}}").value


async def wait_until(cond, timeout_s: float = 30.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while not cond():
        assert loop.time() < deadline, "condition not reached"
        await asyncio.sleep(0.01)


# ---------------------------------------------------------------------------
# Wire goldens, byte for byte against the reference
# ---------------------------------------------------------------------------

UNITS = [{"type": "token", "text": "hi", "index": 3},
         {"type": "token", "text": " café 中", "token": 17, "index": 0},
         {"type": "done", "finish_reason": "stop", "usage": {"completion_tokens": 6}},
         {"type": "progress", "step": 2, "droppable": True},
         {"type": "error", "error": "drain", "message": "server draining; stream budget spent"}]


def test_sse_wire_goldens(sides):
    """The SSE encoding is a wire contract: event name = unit type, data =
    the unit minus "type" and "droppable", blank-line terminated — the same
    bytes from both packages."""
    jm, tm = sides["jax"][0], sides["port"][0]
    assert tm.encode_stream_unit(UNITS[0]) == (b"event: token\n"
                                               b'data: {"text": "hi", "index": 3}\n\n')
    for unit in UNITS:
        assert tm.encode_stream_unit(unit) == jm.encode_stream_unit(unit), unit
    assert b"droppable" not in tm.encode_stream_unit(UNITS[3])
    assert tm.stream_heartbeat() == jm.stream_heartbeat() == b": hb\n\n"
    assert tm.stream_content_type() == jm.stream_content_type() == "text/event-stream"


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port"),
                                            ("port", "port")])
def test_frame_stream_event_roundtrip(writer, reader):
    """Binary stream events survive every two-piece tear between one
    package's encoder and the other's reader, image frames between them
    included; ``pending`` flags a torn tail."""
    enc, rd = FRAMES[writer], FRAMES[reader]
    a = enc.encode_stream_event(json.dumps({"type": "progress", "step": 1}).encode())
    img = enc.encode_frame([np.arange(2 * 2 * 3, dtype=np.uint8).reshape(2, 2, 3)],
                           enc.KIND_RGB8, 2)
    b = enc.encode_stream_event(json.dumps({"type": "done", "finish_reason": "stop"}).encode())
    assert a == FRAMES["jax"].encode_stream_event(
        json.dumps({"type": "progress", "step": 1}).encode())
    blob = a + img + b
    for cut in range(1, len(blob)):
        r = rd.StreamFrameReader()
        frames = list(r.feed(blob[:cut])) + list(r.feed(blob[cut:]))
        assert [k for k, _ in frames] == [rd.KIND_EVENT, rd.KIND_RGB8, rd.KIND_EVENT]
        assert json.loads(frames[0][1]) == {"type": "progress", "step": 1}
        assert frames[1][1] == img
        assert json.loads(frames[2][1])["type"] == "done"
        assert not r.pending
    r = rd.StreamFrameReader()
    assert list(r.feed(blob[:len(a) + 3])) == [(rd.KIND_EVENT, a[rd.HEADER_SIZE:])]
    assert r.pending == 3  # torn mid-frame: the tail is visible, not silent
    with pytest.raises(rd.FrameError, match="magic"):
        rd.StreamFrameReader().feed(b"XXXX" + a[4:])


@pytest.mark.parametrize("pkg", PKGS)
def test_sse_parser_torn_event_tolerance(pkg):
    """A stream torn mid-event with an error terminal glued after it: the
    torn fragment surfaces as junk and never swallows the terminal; both
    packages' parsers give the same events for every split of the bytes."""
    raw = (b'event: token\ndata: {"text": "a", "index": 0}\n\n'
           b'event: token\ndata: {"te'
           b'\nevent: error\ndata: {"error": "upstream_error", "message": "worker died"}\n\n')
    want = None
    for cut in range(1, len(raw)):
        p = PARSERS[pkg]()
        events = list(p.feed(raw[:cut])) + list(p.feed(raw[cut:]))
        ref = jloadgen.SseParser()
        assert events == list(ref.feed(raw[:cut])) + list(ref.feed(raw[cut:]))
        want = want or events
        assert events == want
        assert not p.pending
    assert [e for e, _ in want] == ["token", "token", "error"]
    assert json.loads(want[-1][1])["error"] == "upstream_error"
    with pytest.raises(json.JSONDecodeError):
        json.loads(want[1][1])


# ---------------------------------------------------------------------------
# Engine: one terminal, disconnect, drain budget, shutdown, errors
# ---------------------------------------------------------------------------

REQUESTS = [("stream me", 9, 6, 0.0), ("the model serves text", -4, 17, 0.7),
            ("fast", 12, 1, 0.7), ("slow and new old high low tokens", 33, 40, 0.0)]


def test_stream_happy_path_one_terminal(sides):
    """Four concurrent streams on each package: exactly one terminal each,
    "done" with finish reason and usage, contiguous indices, the
    concatenated text equal to the unary result's — and the port's streamed
    text and tokens equal to the reference's, request by request."""
    streamed = {}
    for pkg in PKGS:
        model, _ = sides[pkg]
        eng, m = make_engine(sides, pkg)

        async def go():
            await eng.start()
            try:
                subs = [eng.submit_stream(prompt_item(model, p, seed=s, max_new=n, temp=t))
                        for p, s, n, t in REQUESTS]
                out = []
                for fut, stream in subs:
                    units = await drain_stream(stream)
                    out.append((units, await fut))
                return out
            finally:
                await eng.stop()

        streamed[pkg] = run(go())
        for (units, result), (_, _, max_new, _) in zip(streamed[pkg], REQUESTS):
            assert sum(u["type"] in ("done", "error") for u in units) == 1
            terminal = units[-1]
            assert terminal["type"] == "done"
            assert terminal["finish_reason"] == model.stream_finish_reason(result)
            assert terminal["usage"] == {"completion_tokens": result["n_tokens"]}
            tokens = [u for u in units if u["type"] == "token"]
            assert [u["index"] for u in tokens] == list(range(len(tokens)))
            assert [u["token"] for u in tokens] == result["tokens"]
            assert "".join(u["text"] for u in tokens) == result["text"]
            assert len(tokens) <= max_new
        assert m.counter("gen_streams_total{model=tg}").value == len(REQUESTS)
        assert terminated(m, "done") == len(REQUESTS)
        assert m.histogram("gen_first_unit_ms{model=tg}").n == len(REQUESTS)
    for (pu, pr), (ju, jr) in zip(streamed["port"], streamed["jax"]):
        assert pu == ju and pr == jr


@pytest.mark.parametrize("pkg", PKGS)
def test_stream_text_audit_with_eos_and_continuations(sides, pkg):
    """The incremental detokenize against the unary text on hand-made
    step outputs: "##" continuations (also as the first piece), EOS and PAD
    mid-stream, unknown ids, and one token at a time or several per step."""
    model, _ = sides[pkg]
    tok = model.tokenizer
    cont = [i for p, i in tok.vocab.items() if p.startswith("##")][:3]
    words = [i for p, i in tok.vocab.items() if p.isalpha() and len(p) > 2][:3]
    seq = [cont[0], words[0], cont[1], tok.pad_id, words[1], cont[2], 10_000,
           words[2], model.eos_id]
    for per_step in (1, 2, 4):
        state, text = {}, ""
        for n in range(per_step, len(seq) + per_step, per_step):
            n = min(n, len(seq))
            out = {"n_new": np.array([0, n]),
                   "tokens": np.array([[0] * len(seq), seq])}
            text += "".join(u["text"] for u in model.stream_units(out, 1, state))
        assert text == model.detokenize(seq) == sides["jax"][0].detokenize(seq)
        assert model.stream_finish_reason({"tokens": seq}) == "stop"
    assert model.stream_units({"n_new": np.array([0]), "tokens": np.zeros((1, 4))},
                              0, {}) == []
    assert model.stream_finish_reason({"tokens": seq[:2]}) == "length"


@pytest.mark.parametrize("pkg", PKGS)
def test_disconnect_frees_slot_and_ledger_balances(sides, pkg):
    """A client disconnect (cancelled future + closed stream, what the HTTP
    layer's abandon hook does) frees the slot for fold-in and ticks
    gen_client_disconnects_total; the arena ledger ends balanced."""
    model, _ = sides[pkg]
    eng, m = make_engine(sides, pkg)

    async def go():
        await eng.start()
        try:
            fut, stream = eng.submit_stream(prompt_item(model, "abandoned", seed=3, max_new=64))
            first = await asyncio.wait_for(stream.get(), 30.0)
            assert first["type"] == "token"
            fut.cancel()
            stream.close()
            await wait_until(lambda: not eng.arena.n_active)
            assert eng.arena.n_free == eng.slots
            assert counter(m, "gen_client_disconnects_total") == 1
            assert terminated(m, "disconnect") == 1
            assert m.gauge("gen_active_slots{model=tg}").value == 0
        finally:
            await eng.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_paged_disconnect_returns_every_page(weights, pkg):
    """The paged engine: streams abandoned mid-generation return their KV
    pages the instant their slots free; gen_kv_pages_free is back to full."""
    model, rt = build_side(pkg, weights)
    mods = MODS[pkg]
    m = mods.obs.Metrics()
    eng = mods.genserve.GenEngine(model, rt, m, mods.config.GenserveConfig(
        slots=4, kv_paging=True, kv_page_tokens=8, prefill_chunk=4))
    eng.compile()

    async def go():
        await eng.start()
        try:
            full = eng.pages.n_free
            subs = [eng.submit_stream(prompt_item(model, "abandon me " * k, seed=k, max_new=64))
                    for k in range(1, 4)]
            for fut, stream in subs:
                assert (await asyncio.wait_for(stream.get(), 30.0))["type"] == "token"
            assert eng.pages.n_free < full
            for fut, stream in subs:
                fut.cancel()
                stream.close()
            await wait_until(lambda: not eng.arena.n_active)
            assert eng.pages.n_free == full and eng.pages.n_reserved == 0
            assert m.gauge("gen_kv_pages_free{model=tg}").value == full
            assert terminated(m, "disconnect") == 3
        finally:
            await eng.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_stream_drain_budget_terminates_stragglers(sides, pkg):
    """Drain gives in-flight streams a bounded budget (stream_drain_s); past
    it they get the well-formed "drain" error terminal."""
    model, _ = sides[pkg]
    eng, m = make_engine(sides, pkg, stream_drain_s=0.05)
    # Slow each iteration so the generation outlives the 50 ms budget.
    eng.injector = MODS[pkg].faults.FaultInjector.single("slow_dispatch", delay_ms=20.0)

    async def go():
        await eng.start()
        try:
            fut, stream = eng.submit_stream(prompt_item(model, "long haul", seed=5, max_new=64))
            first = await asyncio.wait_for(stream.get(), 30.0)
            assert first["type"] == "token"
            loop = asyncio.get_running_loop()
            assert await eng.drain(loop.time() + 30.0), "drain converges once stragglers end"
            units = await drain_stream(stream, timeout_s=5.0)
            assert units[-1]["type"] == "error" and units[-1]["error"] == "drain"
            assert fut.done()
            assert terminated(m, "drain") == 1
        finally:
            await eng.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_shutdown_terminates_streams(sides, pkg):
    """stop() mid-generation pushes the "shutdown" error terminal; the tiny
    stream queue keeps the step loop mid-flight when stop lands."""
    model, _ = sides[pkg]
    eng, m = make_engine(sides, pkg, stream_queue=4)

    async def go():
        await eng.start()
        fut, stream = eng.submit_stream(prompt_item(model, "cut off", seed=8, max_new=64))
        await asyncio.wait_for(stream.get(), 30.0)
        await eng.stop()
        units = await drain_stream(stream, timeout_s=5.0)
        assert units[-1] == {"type": "error", "error": "shutdown",
                             "message": "server shutting down; tg not served"}
        assert terminated(m, "shutdown") == 1
        with pytest.raises(RuntimeError, match="shutting down"):
            await fut

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_deadline_terminates_stream(sides, pkg):
    """A mid-generation deadline evicts the slot with the
    "deadline_exceeded" terminal (the in-stream half of the deadline
    contract)."""
    model, _ = sides[pkg]
    eng, m = make_engine(sides, pkg)
    eng.injector = MODS[pkg].faults.FaultInjector.single("slow_dispatch", delay_ms=10.0)

    async def go():
        await eng.start()
        try:
            fut, stream = eng.submit_stream(prompt_item(model, "late", seed=2, max_new=64),
                                            deadline_at=time.perf_counter() + 0.15)
            units = await drain_stream(stream)
            assert units[-1]["type"] == "error"
            assert units[-1]["error"] == "deadline_exceeded"
            assert eng.arena.n_active == 0
        finally:
            await eng.stop()
        assert terminated(m, "deadline_exceeded") == 1

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_engine_error_terminates_stream_with_reason(sides, pkg):
    """A step failure poisons the in-flight set: every active stream gets the
    "engine_error" terminal, counted by reason."""
    model, _ = sides[pkg]
    eng, m = make_engine(sides, pkg)
    eng.injector = MODS[pkg].faults.FaultInjector.single("batch_error")

    async def go():
        await eng.start()
        try:
            fut, stream = eng.submit_stream(prompt_item(model, "doomed", seed=7, max_new=8))
            units = await drain_stream(stream)
            assert units[-1]["type"] == "error"
            assert units[-1]["error"] == "engine_error"
            with pytest.raises(Exception):
                await fut
        finally:
            await eng.stop()
        assert terminated(m, "engine_error") >= 1

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_stream_policies_drop_and_block(sides, pkg):
    """Policy "drop" discards a droppable unit when the consumer lags
    (gen_stream_dropped_total); tokens block until the consumer drains;
    a terminal on a full queue displaces the oldest unit, never itself."""
    model, _ = sides[pkg]
    eng, m = make_engine(sides, pkg, stream_queue=1)
    g = MODS[pkg].genserve

    async def go():
        await eng.start()
        try:
            s = g.engine.GenStream(1, "drop")
            await eng._emit_unit(s, {"type": "token", "text": "a"})
            await eng._emit_unit(s, {"type": "progress", "droppable": True})
            assert s.dropped == 1 and counter(m, "gen_stream_dropped_total") == 1
            blocked = asyncio.ensure_future(eng._emit_unit(s, {"type": "token", "text": "b"}))
            await asyncio.sleep(0.12)
            assert not blocked.done()  # a token never drops: it waits
            assert (await s.get())["text"] == "a"
            await asyncio.wait_for(blocked, 5.0)
            eng._terminate_stream(s, "done", unit={"type": "done"})
            assert (await s.get()) == {"type": "done"} and s.terminated
            b = g.engine.GenStream(1, "block")
            await eng._emit_unit(b, {"type": "progress", "droppable": True})
            late = asyncio.ensure_future(eng._emit_unit(b, {"type": "progress",
                                                            "droppable": True}))
            await asyncio.sleep(0.12)
            assert not late.done() and b.dropped == 0
            b.close()  # the consumer leaves: the producer is freed
            await asyncio.wait_for(late, 5.0)
        finally:
            await eng.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_engine_termination_vocabulary_is_closed(sides, pkg):
    """_count_termination refuses off-vocabulary reasons; the vocabulary is
    the reference's."""
    eng, m = make_engine(sides, pkg)
    assert MODS["port"].obs.GEN_STREAM_REASONS == MODS["jax"].obs.GEN_STREAM_REASONS
    for reason in MODS[pkg].obs.GEN_STREAM_REASONS:
        eng._count_termination(reason)
        assert terminated(m, reason) == 1
    with pytest.raises(ValueError, match="unknown stream-termination"):
        eng._count_termination("made_up_reason")


def test_fault_kinds_registered_and_served():
    """stream_stall and stream_disconnect are the reference's kinds, and the
    port serves a rule of either (no refusal)."""
    for kind in ("stream_stall", "stream_disconnect"):
        assert kind in tconfig.FAULT_KINDS and kind in MODS["jax"].config.FAULT_KINDS
        cfg = tconfig.ServerConfig(faults=tconfig.FaultsConfig(
            enabled=True, rules=[tconfig.FaultRuleConfig(kind=kind)]))
        assert tconfig.unported_settings(cfg) == []


# ---------------------------------------------------------------------------
# HTTP: the port's own server and client
# ---------------------------------------------------------------------------

@pytest.fixture
def served(weights):
    holder = []

    def make(**kw):
        holder.append(Served(weights, **kw))
        return holder[-1]

    yield make
    for s in holder:
        s.close()


def stream_call(s, body: dict, query: str = "stream=true", timeout_s: float = 60.0):
    """POST one streamed generation with the port's load-generator client:
    (status, headers, raw body bytes, SSE events)."""
    async def go():
        async with tclient.ClientSession() as session:
            async with session.stream("POST", f"http://127.0.0.1:{s.port}/v1/models/"
                                      f"tg:generate?{query}", data=json.dumps(body).encode(),
                                      headers=JSON_HDR, timeout_s=timeout_s) as r:
                raw = b""
                async for chunk in r.iter_any():
                    raw += chunk
                return r.status, dict(r.headers), raw

    st, hdrs, raw = asyncio.run(go())
    return st, hdrs, raw, tloadgen.SseParser().feed(raw)


def jax_stream_text(weights, body: dict) -> list:
    """The reference engine's stream units for one request, same weights."""
    model, rt = build_side("jax", weights)
    eng = MODS["jax"].genserve.GenEngine(model, rt, MODS["jax"].obs.Metrics(),
                                         MODS["jax"].config.GenserveConfig(slots=4))
    eng.compile()

    async def go():
        await eng.start()
        try:
            item = model.host_decode(json.dumps(body).encode(), "application/json")
            _fut, stream = eng.submit_stream(item)
            return await drain_stream(stream)
        finally:
            await eng.stop()

    return run(go())


def test_http_stream_end_to_end_byte_audited(served, weights):
    """stream=true over HTTP: the stream's headers, chunked framing (read
    raw off the socket), exactly one done with finish reason and usage,
    contiguous indices, the concatenated text equal to the unary answer's
    and to the reference engine's stream; a keep-alive connection carries a
    unary request after a complete stream; the stream bypasses the cache."""
    s = served(cache=tconfig.CacheConfig(enabled=True))
    body = {"prompt": "stream parity", "seed": 11, "max_new_tokens": 8, "temperature": 0.7}
    st, raw_unary, _ = s.call("POST", "/v1/models/tg:generate", body)
    assert st == 200
    unary = json.loads(raw_unary)
    st, hdrs, raw, events = stream_call(s, body)
    assert st == 200
    assert hdrs["x-tpuserve-stream"] == "1" and hdrs["content-type"] == "text/event-stream"
    assert hdrs["transfer-encoding"] == "chunked" and len(hdrs["x-trace-id"]) == 32
    tokens = [json.loads(d) for e, d in events if e == "token"]
    terminals = [(e, json.loads(d)) for e, d in events if e in ("done", "error")]
    assert terminals == [("done", {"finish_reason": "length",
                                   "usage": {"completion_tokens": 8}})]
    assert [t["index"] for t in tokens] == list(range(8))
    assert [t["token"] for t in tokens] == unary["tokens"]
    assert "".join(t["text"] for t in tokens) == unary["text"]
    ref_units = jax_stream_text(weights, body)
    assert "".join(u["text"] for u in ref_units if u["type"] == "token") == unary["text"]
    assert [(e, json.loads(d)) for e, d in events] == \
        [(u["type"], {k: v for k, v in u.items() if k != "type"}) for u in ref_units]
    assert s.state.caches["tg"].stats()["hits"] == 0  # a stream never reads the cache

    # Raw framing and keep-alive: one socket, a stream then a unary answer.
    with socket.create_connection(("127.0.0.1", s.port), timeout=60) as sock:
        data = json.dumps(body).encode()
        head = (f"POST /v1/models/tg:generate?stream=1 HTTP/1.1\r\nHost: x\r\n"
                f"Content-Type: application/json\r\nContent-Length: {len(data)}\r\n\r\n")
        sock.sendall(head.encode() + data)
        buf = b""

        def complete(buf: bytes) -> bool:
            # The last chunk (0) after the head: a head alone can end in
            # "0\r\n\r\n" too (a trace id ending in 0 on the last line).
            head_end = buf.find(b"\r\n\r\n")
            return head_end >= 0 and \
                (b"\r\n" + buf[head_end + 4:]).endswith(b"\r\n0\r\n\r\n")

        while not complete(buf):
            chunk = sock.recv(65536)
            assert chunk, buf
            buf += chunk
        head_end = buf.index(b"\r\n\r\n")
        assert b"Transfer-Encoding: chunked" in buf[:head_end]
        chunked, payload = buf[head_end + 4:], b""
        while True:
            size, _, rest = chunked.partition(b"\r\n")
            n = int(size, 16)
            if n == 0:
                assert rest == b"\r\n"
                break
            payload, chunked = payload + rest[:n], rest[n + 2:]
            assert rest[n:n + 2] == b"\r\n"
        assert payload == raw  # the same request streams the same bytes
        sock.sendall(f"POST /v1/models/tg:generate HTTP/1.1\r\nHost: x\r\n"
                     f"Content-Type: application/json\r\nContent-Length: {len(data)}\r\n"
                     f"Connection: close\r\n\r\n".encode() + data)
        rest = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            rest += chunk
        assert rest.startswith(b"HTTP/1.1 200") and rest.endswith(raw_unary)
    metrics = s.call("GET", "/metrics")[1].decode()
    assert 'gen_streams_total{model="tg"} 2.0' in metrics
    assert 'gen_stream_terminated_total{model="tg",reason="done"} 2.0' in metrics
    assert "gen_first_unit_ms" in metrics


def test_http_stream_spans_and_heartbeats(served):
    """Heartbeat comments fill idle gaps (stream_heartbeat_s); the trace
    carries first_unit, stream_gap and stream_terminal spans; the recorder
    scores the stream by its first unit and largest gap."""
    s = served(genserve=tconfig.GenserveConfig(enabled=True, slots=4,
                                               stream_heartbeat_s=0.02))
    eng = s.state.engines["tg"]
    eng.injector = tfaults.FaultInjector.single("slow_dispatch", delay_ms=60.0)
    try:
        st, hdrs, raw, events = stream_call(s, {"prompt": "slow", "seed": 1,
                                                "max_new_tokens": 4})
    finally:
        eng.injector = None
    assert st == 200 and b": hb\n\n" in raw
    assert [e for e, _ in events] == ["token"] * 4 + ["done"]
    rec = json.loads(s.call("GET", f"/debug/trace?trace_id={hdrs['x-trace-id']}"
                                   "&format=record")[1])
    names = {sp["name"] for sp in rec["spans"]}
    assert {"first_unit", "stream_gap", "stream_terminal", "request"} <= names
    term = next(sp for sp in rec["spans"] if sp["name"] == "stream_terminal")
    assert term["args"]["type"] == "done" and term["args"]["units"] == 5


def test_http_junk_stream_flag_rejects(served, monkeypatch):
    """A typo'd ?stream= is a 400; stream=false/0 serve the unary body; a
    model with no engine and a multi-item body are 400s, never the unary
    path."""
    s = served()
    body = {"prompt": "x", "seed": 1, "max_new_tokens": 2}
    for junk in ("banana", "yes", "2"):
        st, raw, _ = s.call("POST", f"/v1/models/tg:generate?stream={junk}", body)
        assert st == 400 and "stream" in json.loads(raw)["error"], junk
    for off in ("false", "0"):
        st, raw, hdrs = s.call("POST", f"/v1/models/tg:generate?stream={off}", body)
        assert st == 200 and "X-Tpuserve-Stream" not in hdrs
        assert json.loads(raw)["n_tokens"] == 2
    model = s.state.models["tg"]
    monkeypatch.setattr(model, "host_decode_items",
                        lambda payload, ctype: ([model.canary_item()] * 2, True))
    st, raw, _ = s.call("POST", "/v1/models/tg:generate?stream=true", body)
    assert st == 400 and "single-item" in json.loads(raw)["error"]


def test_http_non_generative_model_rejects_stream(weights):
    """stream=true on a model without an engine (textgen with [genserve]
    off, served as locked batches) is a 400 naming the reason."""
    s = Served(weights, genserve=tconfig.GenserveConfig(enabled=False))
    try:
        st, raw, _ = s.call("POST", "/v1/models/tg:generate?stream=true",
                            {"prompt": "x", "max_new_tokens": 2})
        assert st == 400 and "does not support streaming" in json.loads(raw)["error"]
        assert s.state.metrics.counter("bad_requests_total{model=tg}").value == 1
    finally:
        s.close()


def test_http_pre_first_unit_deadline_is_plain_504(served):
    """Before the first unit the deadline is a plain 504 JSON answer: no
    stream header, no stream byte."""
    s = served()
    eng = s.state.engines["tg"]
    eng.injector = tfaults.FaultInjector.single("slow_dispatch", delay_ms=300.0)
    try:
        st, raw, hdrs = s.call("POST", "/v1/models/tg:generate?stream=true&timeout_ms=50",
                               {"prompt": "late", "seed": 1, "max_new_tokens": 4})
    finally:
        eng.injector = None
    assert st == 504 and "X-Tpuserve-Stream" not in hdrs
    assert "deadline" in json.loads(raw)["error"]


def test_injected_stream_disconnect_is_a_torn_stream(served):
    """The stream_disconnect kind tears a STARTED stream's transport with no
    terminal; the abandon hook frees the slot. bench's stream_generate
    counts it torn."""
    s = served()
    s.state.injector = tfaults.FaultInjector.single("stream_disconnect")
    try:
        async def go():
            async with tclient.ClientSession() as session:
                return await tloadgen.stream_generate(
                    session, f"http://127.0.0.1:{s.port}/v1/models/tg:generate",
                    json.dumps({"prompt": "torn", "seed": 2, "max_new_tokens": 8}).encode(),
                    JSON_HDR)

        rec = asyncio.run(go())
    finally:
        s.state.injector = None
    assert rec["status"] == 200 and rec["torn"] and rec["terminal"] is None
    assert len(rec["indices"]) >= 1
    eng = s.state.engines["tg"]
    deadline = time.monotonic() + 30
    while eng.arena.n_active:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert eng.arena.n_free == eng.slots
    m = s.state.metrics
    assert m.counter("gen_stream_terminated_total{model=tg,reason=disconnect}").value == 1


def test_http_client_hangup_frees_slot_and_pages(served):
    """A client that reads one unit and hangs up: the next write (at worst
    the next heartbeat) sees it, the engine future is cancelled, the slot
    and every KV page come back (gen_active_slots, gen_kv_pages_free)."""
    s = served(genserve=tconfig.GenserveConfig(enabled=True, slots=4, kv_paging=True,
                                               kv_page_tokens=8, stream_heartbeat_s=0.05))
    eng = s.state.engines["tg"]
    full = eng.pages.n_free
    eng.injector = tfaults.FaultInjector.single("slow_dispatch", delay_ms=20.0)
    try:
        with socket.create_connection(("127.0.0.1", s.port), timeout=60) as sock:
            data = json.dumps({"prompt": "hang up", "seed": 3, "max_new_tokens": 64}).encode()
            sock.sendall(f"POST /v1/models/tg:generate?stream=true HTTP/1.1\r\nHost: x\r\n"
                         f"Content-Type: application/json\r\nContent-Length: {len(data)}"
                         f"\r\n\r\n".encode() + data)
            got = b""
            while b"event: token" not in got:
                got += sock.recv(65536)
            assert eng.arena.n_active == 1 and eng.pages.n_free < full
        deadline = time.monotonic() + 30
        while eng.arena.n_active:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        eng.injector = None
    m = s.state.metrics
    assert eng.pages.n_free == full
    assert m.gauge("gen_active_slots{model=tg}").value == 0
    assert m.gauge("gen_kv_pages_free{model=tg}").value == full
    assert m.counter("gen_client_disconnects_total{model=tg}").value == 1


def test_http_stream_from_an_ingest_loop(served):
    """With ingest_loops = 2 streams accepted by the second loop read the
    engine's queue through the main loop and write on their own: whole
    streams, equal text, from both loops."""
    s = served(ingest_loops=2)
    body = {"prompt": "two loops", "seed": 5, "max_new_tokens": 3}
    want = json.loads(s.call("POST", "/v1/models/tg:generate", body)[1])["text"]
    for _ in range(48):
        st, _, _, events = stream_call(s, body)
        assert st == 200 and [e for e, _ in events] == ["token"] * 3 + ["done"]
        assert "".join(json.loads(d)["text"] for e, d in events if e == "token") == want
        loops = json.loads(s.call("GET", "/stats")[1])["ingest"]["loops"]
        if loops.get("1", {}).get("requests", 0) >= 1:
            break
    assert loops["1"]["requests"] >= 1, loops


def test_injected_stream_stall_wedges_then_tears(served, monkeypatch):
    """The stream_stall kind wedges a STARTED stream's writer: after its
    first unit nothing is written for the stall (shortened here from the
    reference's hour), then the stream ends torn and its slot comes back.

    The silence is timed where the stall makes it, at the server's writer:
    the first unit's write, then no write until the handler gives the
    connection up. The client's clock cannot time it: it stamps the first
    unit when its own thread gets to parse it, which under a loaded CPU
    lags the write by more than the tear lags the handler's end (0.497 s
    of a 0.5 s stall seen that way)."""
    from tpuserve_torch import server as tserver

    monkeypatch.setattr(tserver, "_STREAM_STALL_S", 0.5)
    writes: list[tuple[float, bytes]] = []
    ends: list[float] = []
    real_write, real_stream = tserver.StreamResponse.write, tserver.ServerState._predict_stream

    async def write(self, data):
        await real_write(self, data)
        writes.append((time.perf_counter(), data))

    async def predict_stream(self, *args, **kw):
        try:
            return await real_stream(self, *args, **kw)
        finally:
            ends.append(time.perf_counter())

    monkeypatch.setattr(tserver.StreamResponse, "write", write)
    monkeypatch.setattr(tserver.ServerState, "_predict_stream", predict_stream)
    s = served()
    s.state.injector = tfaults.FaultInjector.single("stream_stall")
    try:
        async def go():
            async with tclient.ClientSession() as session:
                return await tloadgen.stream_generate(
                    session, f"http://127.0.0.1:{s.port}/v1/models/tg:generate",
                    json.dumps({"prompt": "stall", "seed": 4, "max_new_tokens": 8}).encode(),
                    JSON_HDR)

        t0 = time.perf_counter()
        rec = asyncio.run(go())
        t_end = time.perf_counter()
    finally:
        s.state.injector = None
    assert rec["status"] == 200 and rec["torn"] and len(rec["indices"]) == 1
    assert rec["token_times"][0] <= t_end
    # The server wrote the first unit and then nothing for the stall.
    assert len(writes) == 1 and writes[0][1].startswith(b"event: token")
    assert len(ends) == 1 and ends[0] - writes[0][0] >= 0.5
    eng = s.state.engines["tg"]
    deadline = time.monotonic() + 30
    while eng.arena.n_active:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert eng.arena.n_free == eng.slots


@pytest.mark.parametrize("pkg", PKGS)
def test_bench_stream_against_the_port(served, pkg):
    """``bench --stream``'s closed loop (``run_stream_load``) of either
    package against the port's server: streams complete, none torn, no
    error, tokens counted from token events."""
    s = served()
    loadgen = {"jax": jloadgen, "port": tloadgen}[pkg]
    pool = [json.dumps({"prompt": f"bench stream {i}", "seed": i,
                        "max_new_tokens": 4 + i}).encode() for i in range(6)]
    res = asyncio.run(loadgen.run_stream_load(
        f"http://127.0.0.1:{s.port}/v1/models/tg:generate", pool, "application/json",
        duration_s=1.0, concurrency=4, warmup_s=0.2))
    summary = res.summary()
    assert summary["n_ok"] > 0 and summary["n_err"] == 0, summary
    assert summary["torn_streams"] == 0 and summary["tokens_per_s"] > 0
    assert set(summary["terminals"]) == {"done"}
