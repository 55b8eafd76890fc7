"""Parallel ingest loops and the loop-safe batcher entry of the port
(``[server] ingest_loops``, ``decode_inline``,
``ModelBatcher.submit_threadsafe``) against the reference's: each scenario
of ``tests/test_ingest.py`` that concerns them, run on both packages — a
real ``serve_async`` server with 3 accept loops (1 main + 2 SO_REUSEPORT
ingest threads) on an ephemeral port, driven over plain blocking HTTP with
a fresh connection per request, the toy model from the same weights (the
JAX package's seed-0 tree; the port reads it from a ``.npz``), with
``[cache]`` on.

Held exactly, on both servers: status codes, the per-loop request and byte
sums (every loop serves some of 90 fresh connections), the ``/stats`` ingest
block's loops, ``frame: ...`` 400s from any loop, identical answers from
whichever loop carried a request (the cache answering the repeats),
``QueueFull`` through ``submit_threadsafe``'s future, and the config checks.
The two servers' top-k probabilities agree within 1e-6 (float32 toy, two
frameworks).
"""

import asyncio
import concurrent.futures as cf
import json
import socket
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tpuserve import batcher as jbatcher
from tpuserve import config as jconfig
from tpuserve import obs as jobs
from tpuserve.models import build as jax_build
from tpuserve.runtime import build_runtime as jax_build_runtime
from tpuserve.server import ServerState as JaxServerState
from tpuserve.server import serve_async as jax_serve_async
from tpuserve_torch import batcher as tbatcher
from tpuserve_torch import config as tconfig
from tpuserve_torch import frame
from tpuserve_torch import obs as tobs
from tpuserve_torch import savedmodel as sm
from tpuserve_torch.models import build as torch_build
from tpuserve_torch.runtime import build_runtime as torch_build_runtime
from tpuserve_torch.server import ServerState, serve_async

EDGE = 8
N_LOOPS = 3
PKGS = ("jax", "port")
MODEL = dict(name="toy", family="toy", batch_buckets=[1, 2, 4], deadline_ms=2.0,
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
    jm = jax_build(jconfig.ModelConfig(**MODEL))
    path = str(tmp_path_factory.mktemp("toy") / "toy.npz")
    sm.save_npz(path, jax.device_get(jm.init_params(jax.random.key(0))))
    return path


# -- config ------------------------------------------------------------------------

@pytest.mark.parametrize("cfgm", [jconfig, tconfig], ids=PKGS)
def test_ingest_loops_validation_and_toml(cfgm, tmp_path):
    with pytest.raises(ValueError, match="ingest_loops must be >= 1, got 0"):
        cfgm.ServerConfig(ingest_loops=0)
    p = tmp_path / "cfg.toml"
    p.write_text('ingest_loops = 3\ndecode_inline = true\n'
                 '[[model]]\nname = "toy"\nfamily = "toy"\n')
    cfg = cfgm.load_config(str(p))
    assert (cfg.ingest_loops, cfg.decode_inline) == (3, True)
    assert cfgm.load_config(str(p), overrides=["ingest_loops=2"]).ingest_loops == 2


# -- a real multi-loop server ---------------------------------------------------------

@pytest.fixture(scope="module", params=PKGS)
def multi_loop_server(request, npz):
    """A real serve_async server with 3 accept loops, run on its own thread
    and event loop, stopped at the end of the module."""
    if not hasattr(socket, "SO_REUSEPORT"):
        pytest.skip("SO_REUSEPORT unavailable")
    pkg = request.param
    cfgm = jconfig if pkg == "jax" else tconfig
    model = dict(MODEL, weights=npz) if pkg == "port" else dict(MODEL)
    cfg = cfgm.ServerConfig(host="127.0.0.1", port=0, ingest_loops=N_LOOPS,
                            startup_canary=False, decode_threads=2,
                            cache=cfgm.CacheConfig(enabled=True, capacity=64),
                            models=[cfgm.ModelConfig(**model)])
    state = JaxServerState(cfg) if pkg == "jax" else ServerState(cfg, device="cpu")
    state.build()
    serve = jax_serve_async if pkg == "jax" else serve_async
    holder, ready = {}, threading.Event()

    def run_server():
        async def main():
            a_ready, a_stop = asyncio.Event(), asyncio.Event()
            holder["loop"], holder["stop"] = asyncio.get_running_loop(), a_stop
            task = asyncio.ensure_future(serve(state, a_ready, a_stop))
            await a_ready.wait()
            ready.set()
            await task

        asyncio.run(main())

    t = threading.Thread(target=run_server, daemon=True)
    t.start()
    assert ready.wait(60), "server did not come up"
    yield pkg, state, f"http://127.0.0.1:{state.serving_addresses[0][1]}"
    holder["loop"].call_soon_threadsafe(holder["stop"].set)
    t.join(30)
    assert not t.is_alive()


def post(base, path, body, ctype):
    req = urllib.request.Request(f"{base}{path}", data=body,
                                 headers={"Content-Type": ctype, "Connection": "close"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def get(base, path):
    req = urllib.request.Request(f"{base}{path}", headers={"Connection": "close"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.read()


def frames(n: int, seed: int = 0) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [frame.encode_frame([rng.integers(0, 255, (EDGE, EDGE, 3), dtype=np.uint8)
                                for _ in range(2)], frame.KIND_RGB8, EDGE) for _ in range(n)]


_ANSWERS: dict[str, list] = {}


def test_every_ingest_loop_serves(multi_loop_server):
    """90 fresh-connection requests spread across all three accept loops;
    the per-loop counters sum to the requests and bytes sent, and every
    answer is right whichever loop carried it."""
    pkg, state, base = multi_loop_server
    bodies = frames(90)
    answers = []
    for body in bodies:
        status, raw = post(base, "/v1/models/toy:classify", body, frame.CONTENT_TYPE)
        assert status == 200, raw
        out = json.loads(raw)
        assert len(out["results"]) == 2
        answers.append(out["results"])
    _ANSWERS[pkg] = answers
    per_loop = [state.ingest[i].requests.value for i in range(N_LOOPS)]
    assert len(state.ingest) == N_LOOPS
    assert sum(per_loop) == 90 and all(v > 0 for v in per_loop), per_loop
    assert sum(state.ingest[i].bytes.value for i in range(N_LOOPS)) == \
        sum(len(b) for b in bodies)
    if len(_ANSWERS) == 2:
        for j, t in zip(*(_ANSWERS[p] for p in PKGS)):
            for je, te in zip(j, t):
                assert [e["class"] for e in te["top_k"]] == [e["class"] for e in je["top_k"]]
                np.testing.assert_allclose([e["prob"] for e in te["top_k"]],
                                           [e["prob"] for e in je["top_k"]], atol=1e-6, rtol=0)


def test_cache_and_stats_work_from_ingest_loops(multi_loop_server):
    """The single-flight cache lives on the main loop: identical uploads
    from whatever loop answer byte-identically (repeats from the cache), and
    /stats reports every loop."""
    _, state, base = multi_loop_server
    body = frames(1, seed=12345)[0]
    hits0 = state.metrics.counter("cache_hits_total{model=toy}").value
    answers = {post(base, "/v1/models/toy:classify", body, frame.CONTENT_TYPE)[1]
               for _ in range(6)}
    assert len(answers) == 1
    assert state.metrics.counter("cache_hits_total{model=toy}").value - hits0 >= 4
    status, raw = get(base, "/stats")
    stats = json.loads(raw)
    assert status == 200
    assert set(stats["ingest"]["loops"]) == {str(i) for i in range(N_LOOPS)}
    assert "frame_errors_total" in stats["ingest"]
    assert stats["cache"]["toy"]["hits"] >= 4


def test_malformed_frame_400_from_any_loop(multi_loop_server):
    _, _, base = multi_loop_server
    for _ in range(6):
        status, raw = post(base, "/v1/models/toy:classify", b"garbage", frame.CONTENT_TYPE)
        assert status == 400, raw
        assert json.loads(raw)["error"].startswith("frame:")


# -- the loop-safe batcher entry ------------------------------------------------------

def _batcher(pkg, npz, max_queue=4):
    if pkg == "jax":
        cfg = jconfig.ModelConfig(**dict(MODEL, batch_buckets=[1, 2], max_queue=max_queue))
        m = jax_build(cfg)
        return jbatcher.ModelBatcher(m, jax_build_runtime(m), jobs.Metrics(),
                                     cf.ThreadPoolExecutor(2)), jbatcher
    cfg = tconfig.ModelConfig(**dict(MODEL, batch_buckets=[1, 2], max_queue=max_queue,
                                     weights=npz))
    m = torch_build(cfg)
    return tbatcher.ModelBatcher(m, torch_build_runtime(m, device="cpu"),
                                 tobs.Metrics()), tbatcher


@pytest.mark.parametrize("pkg", PKGS)
def test_submit_threadsafe_from_worker_thread(pkg, npz):
    """A thread that is not the batcher's loop submits and gets the result
    through a concurrent future; QueueFull arrives the same way."""
    b, bmod = _batcher(pkg, npz)
    item = np.zeros((EDGE, EDGE, 3), dtype=np.uint8)

    async def go():
        with pytest.raises(RuntimeError, match="not started"):
            b.submit_threadsafe(item)
        await b.start()
        loop = asyncio.get_running_loop()
        res = await loop.run_in_executor(None, lambda: b.submit_threadsafe(item).result(10))
        assert "top_k" in res

        def flood():
            futs = [b.submit_threadsafe(item) for _ in range(64)]
            outcomes = []
            for f in futs:
                try:
                    outcomes.append(f.result(timeout=10))
                except bmod.QueueFull:
                    outcomes.append("shed")
            return outcomes

        outcomes = await loop.run_in_executor(None, flood)
        assert "shed" in outcomes and any(isinstance(o, dict) for o in outcomes)
        await b.stop()

    asyncio.new_event_loop().run_until_complete(go())


def test_decode_inline_serves_the_same_answers(npz):
    """decode_inline decodes on the accept loop: the same answers as the
    thread-pool decode."""
    import io

    buf = io.BytesIO()
    np.save(buf, np.random.default_rng(3).integers(0, 200, (EDGE, EDGE, 3), dtype=np.uint8))

    async def answer(inline: bool):
        from tpuserve_torch.server import start_server, stop_server

        cfg = tconfig.ServerConfig(models=[tconfig.ModelConfig(**dict(MODEL, weights=npz))],
                                   decode_inline=inline, decode_threads=1)
        state = ServerState(cfg, device="cpu")
        state.build()
        server = await start_server(state, "127.0.0.1", 0)
        try:
            port = state.serving_addresses[0][1]
            return await asyncio.get_running_loop().run_in_executor(
                None, post, f"http://127.0.0.1:{port}", "/v1/models/toy:predict",
                buf.getvalue(), "application/x-npy")
        finally:
            await stop_server(state, server)

    inline, pooled = asyncio.run(answer(True)), asyncio.run(answer(False))
    assert inline[0] == pooled[0] == 200 and inline[1] == pooled[1]
