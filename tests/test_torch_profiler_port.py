"""``profiler_port``: the port's counterpart of the reference's
``jax.profiler.start_server(profiler_port)`` (``tpuserve/server.py``).

Torch has no remote profiler server, so with ``profiler_port`` > 0 the
port's server opens a second listener on that port whose ``POST
/profile?duration_ms=`` answers the merged Chrome trace ``POST
/debug/profile`` gives (``telemetry/profile.py``), through the same
one-at-a-time capture. On the CPU, in process: a capture answers 200 with
the trace and its ``tpuserve_profile`` metadata while a second one started
inside its window answers 409; any other path is 404 and another method
405; a bad ``duration_ms`` 400 as on the serving port; the captures land in
the same audit trail and counter as ``/debug/profile``'s; the listener is
closed with the server; and the key is typed (``profiler_port = 0``, the
reference's default, opens nothing).
"""

import asyncio
import json
import socket

import pytest

from tpuserve_torch.bench.client import ClientSession
from tpuserve_torch.config import ModelConfig, ServerConfig, load_config, unported_settings
from tpuserve_torch.server import ServerState, start_server, stop_server


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def toy_cfg(profiler_port: int) -> ServerConfig:
    return ServerConfig(
        decode_threads=2, startup_canary=False, profiler_port=profiler_port,
        models=[ModelConfig(name="toy", family="toy", batch_buckets=[1, 2],
                            deadline_ms=2.0, dtype="float32", num_classes=10,
                            parallelism="single", wire_size=8,
                            request_timeout_ms=10_000.0)])


def test_profiler_port_serves_the_capture_200_and_409():
    pport = free_port()
    state = ServerState(toy_cfg(pport), device="cpu")
    state.build()

    async def go():
        server = await start_server(state, host="127.0.0.1", port=0)
        base = f"http://127.0.0.1:{pport}"
        session = ClientSession()
        try:
            first = asyncio.ensure_future(
                session.request("POST", base + "/profile?duration_ms=400"))
            await asyncio.sleep(0.15)
            busy = await session.request("POST", base + "/profile?duration_ms=50")
            ok = await first
            other = [(await session.request(m, base + p)).status for m, p in (
                ("GET", "/profile"), ("POST", "/nope"), ("POST", "/profile?duration_ms=x"))]
            serving = f"http://127.0.0.1:{state.serving_addresses[0][1]}"
            stats = json.loads((await session.request("GET", serving + "/stats")).body)
            audit = json.loads((await session.request(
                "GET", serving + "/debug/audit")).body)["audit"]
        finally:
            await session.close()
            await stop_server(state, server)
        return ok, busy, other, stats, audit

    ok, busy, other, stats, audit = asyncio.run(go())
    assert ok.status == 200 and busy.status == 409
    trace = json.loads(ok.body)
    meta = trace["tpuserve_profile"]
    assert isinstance(trace["traceEvents"], list) and meta["duration_ms"] == 400.0
    assert meta["device_trace"] == "ok" and meta["device_events"] > 0
    assert "already armed" in json.loads(busy.body)["error"]
    assert other == [405, 404, 400]
    assert stats["telemetry"]["profile"]["captures_total"] == 1
    assert sorted(a["outcome"] for a in audit if a["verb"] == "profile") == ["busy", "ok"]
    with pytest.raises(OSError):  # closed with the server
        socket.create_connection(("127.0.0.1", pport), timeout=2).close()


def test_profiler_port_is_typed_and_off_by_default(tmp_path):
    path = tmp_path / "c.toml"
    path.write_text("profiler_port = 9999\n")
    assert load_config(str(path)).profiler_port == 9999
    assert unported_settings(load_config(str(path))) == []
    assert ServerConfig().profiler_port == 0
    state = ServerState(toy_cfg(0), device="cpu")
    state.build()

    async def go():
        server = await start_server(state, host="127.0.0.1", port=0)
        try:
            return server.profiler
        finally:
            await stop_server(state, server)

    assert asyncio.run(go()) is None


def test_profiler_port_per_worker_behind_the_router():
    """Behind the router each worker's listener takes profiler_port + its
    worker id (one port per process, as ``[worker] port_base`` does); 0
    stays 0."""
    from tpuserve_torch.workerproc.worker import worker_config

    assert [worker_config(toy_cfg(9100), i).profiler_port for i in range(3)] == [9100, 9101, 9102]
    assert worker_config(toy_cfg(0), 2).profiler_port == 0
