"""The port's router over real worker processes on the CPU, each scenario of
the reference's ``tests/test_router.py`` (status codes, ``Retry-After``,
shed reasons, counters, trace propagation), ported to a narrow seeded
BERT-flash (2 layers, d_model 32; the port's K1 takes its plain version on
the CPU).

A module-scoped fleet: one router (on a thread of this process, its own
event loop) over 2 spawned CPU workers, serving ``bert`` on weights
converted from the reference's seeded flax tree (an ``.npz`` written by the
port's ``save_npz``) and five chaos-armed copies: ``bertslow``
(``slow_compute`` 600 ms), ``berthang`` (``worker_hang``), ``bertlag``
(``worker_slow`` 300 ms), ``berterr`` (``batch_error``, no worker-side
retry: a definitive 500) and ``berttrip`` (the same with a router breaker
at threshold 2). Proven across the process boundary: answers through the
router byte-identical to the port's direct server on the same weights and
to the reference's top-5 (float32: logits atol 1e-4 as
``tests/test_torch_bert.py`` states, so probabilities within 1e-4 and the
top-5 classes identical); the router-owned cache (a hit never reaches a
worker); a deadline that expires inside a worker, or on the wire with both
workers SIGSTOPped (504 at the stamped deadline, never extended by the
hedge or a retry); no double execution after a definitive 500; a wedged
worker hedged and then 504; ``worker_slow``; the router's breaker with
its probe ETA; the atomic ``:reload`` fan-out; drain; one trace id end to
end with the worker's spans parented under the router's attempt span.
A function-scoped fleet proves ``worker_crash``: a fast 503 with the live
respawn ETA, then supervised respawn back to health, each death folded
into a postmortem with the worker's stderr tail and black-box snapshot.

No pytest-asyncio: the router runs on its own thread, the tests speak
plain blocking HTTP to it. Every spawn, join and wait is bounded in code.
"""

import asyncio
import http.client
import json
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tpuserve.config import ModelConfig as JaxModelConfig
from tpuserve.models import build as jax_build
from tpuserve_torch import savedmodel as sm
from tpuserve_torch.config import (CacheConfig, FaultRuleConfig, FaultsConfig, ModelConfig,
                                   RouterConfig, ServerConfig)
from tpuserve_torch.models import build
from tpuserve_torch.server import ServerState, start_server, stop_server
from tpuserve_torch.workerproc.router import RouterState, serve_router_async

TINY = dict(layers=2, d_model=32, heads=2, d_ff=64, vocab_size=512, attention="flash")
TEXTS = ["hello world", "serve this text please", "the router relays to a worker",
         "a worker may die", "x " * 9]
JSON = "application/json"
BOOT_S = 240.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    prev_env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the spawned workers read it at import
    yield
    torch.set_num_threads(prev)
    if prev_env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = prev_env


def _kw(**kw) -> dict:
    base = dict(family="bert", batch_buckets=[1, 2], seq_buckets=[16], deadline_ms=2.0,
                dtype="float32", num_classes=16, parallelism="single",
                request_timeout_ms=10_000.0, max_inflight=2, options=dict(TINY))
    base.update(kw)
    return base


def _bert(name: str, **kw) -> ModelConfig:
    return ModelConfig(name=name, **_kw(**kw))


@pytest.fixture(scope="module")
def jax_tree():
    jm = jax_build(JaxModelConfig(name="bert", **_kw()))
    return jm, jax.device_get(jm.init_params(jax.random.key(3)))


@pytest.fixture(scope="module")
def weights(tmp_path_factory, jax_tree):
    path = str(tmp_path_factory.mktemp("ckpt") / "bert.npz")
    sm.save_npz(path, jax_tree[1])
    return path


class Fleet:
    """A router (its own thread and event loop) over spawned CPU workers."""

    def __init__(self, cfg: ServerConfig) -> None:
        self.state = RouterState(cfg, device="cpu")
        self._ready = threading.Event()
        self._stop: asyncio.Event | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        if not self._ready.wait(BOOT_S) or self.error is not None:
            self.close()
            raise RuntimeError(f"router fleet did not start: {self.error!r}")
        self.port = self.state.serving_addresses[0][1]

    def _run(self) -> None:
        async def main():
            self._loop = asyncio.get_running_loop()
            self._stop = asyncio.Event()
            ready = asyncio.Event()
            task = asyncio.ensure_future(serve_router_async(self.state, ready, self._stop))
            waiter = asyncio.ensure_future(ready.wait())
            done, _ = await asyncio.wait({task, waiter}, return_when=asyncio.FIRST_COMPLETED)
            if task in done:
                waiter.cancel()
                await task  # raises the startup failure
            self._ready.set()
            await task

        try:
            asyncio.run(main())
        except BaseException as e:  # noqa: BLE001 — surfaced to the fixture
            self.error = e
            self._ready.set()

    def close(self) -> None:
        if self._loop is not None and self._stop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)
        self.thread.join(60.0)
        assert not self.thread.is_alive(), "router thread did not stop"

    def request(self, method: str, path: str, body: bytes | None = None,
                headers: dict | None = None, timeout: float = 30.0):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=timeout)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            return r.status, r.read(), {k.lower(): v for k, v in r.getheaders()}
        finally:
            conn.close()

    def post(self, model: str, obj, timeout_ms=None, verb: str = "classify", headers=None):
        path = f"/v1/models/{model}:{verb}" + (f"?timeout_ms={timeout_ms}" if timeout_ms
                                               else "")
        return self.request("POST", path, json.dumps(obj).encode(),
                            {"Content-Type": JSON, **(headers or {})})

    def get_json(self, path: str):
        status, body, _ = self.request("GET", path)
        return status, json.loads(body)

    def metric(self, text_path: str, key: str) -> float:
        _, body, _ = self.request("GET", text_path)
        for line in body.decode().splitlines():
            if not line.startswith("#") and " " in line:
                k, v = line.rsplit(" ", 1)
                if k == key:
                    return float(v)
        return 0.0

    def worker_sum(self, key: str, n: int = 2) -> float:
        return sum(self.metric(f"/workers/{i}/metrics", key) for i in range(n))

    def wait_healthy(self, timeout_s: float = 30.0) -> dict:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status, health = self.get_json("/healthz")
            if status == 200 and health["status"] == "ok":
                return health
            time.sleep(0.1)
        raise AssertionError(f"fleet not healthy in {timeout_s} s: {health}")


def _fleet_cfg(weights: str) -> ServerConfig:
    return ServerConfig(
        host="127.0.0.1", port=0, decode_threads=2, startup_canary=False,
        # Short drain: berthang leaves wedged handlers inside the workers,
        # which the supervisor's SIGKILL after the budget evicts.
        drain_timeout_s=3.0,
        cache=CacheConfig(enabled=True, capacity=64),
        router=RouterConfig(enabled=True, workers=2, retry_max=2, hedge_ms=150.0,
                            health_interval_s=0.2, unhealthy_after=2,
                            respawn_initial_s=0.3, respawn_max_s=2.0),
        models=[_bert("bert", weights=weights), _bert("bertslow"), _bert("berthang"),
                _bert("bertlag"),
                _bert("berterr", batch_retry=False, retry_split=False, breaker_threshold=0),
                _bert("berttrip", batch_retry=False, retry_split=False, breaker_threshold=2,
                      breaker_retry_after_s=1.0)],
        faults=FaultsConfig(enabled=True, seed=7, rules=[
            FaultRuleConfig(kind="slow_compute", model="bertslow", delay_ms=600.0),
            FaultRuleConfig(kind="worker_hang", model="berthang"),
            FaultRuleConfig(kind="worker_slow", model="bertlag", delay_ms=300.0),
            FaultRuleConfig(kind="batch_error", model="berterr"),
            FaultRuleConfig(kind="batch_error", model="berttrip")]))


@pytest.fixture(scope="module")
def fleet(weights):
    f = Fleet(_fleet_cfg(weights))
    yield f
    f.close()


def test_router_predict_and_introspection(fleet):
    status, body, headers = fleet.post("bert", {"text": "hello world"})
    assert status == 200 and "top_k" in json.loads(body)
    assert len(headers["x-trace-id"]) == 32
    status, health = fleet.get_json("/healthz")
    assert status == 200 and health["status"] == "ok"
    status, stats = fleet.get_json("/stats")
    assert stats["workers"]["healthy"] == stats["workers"]["configured"] == 2
    assert {row["state"] for row in stats["workers"]["workers"]} == {"ready"}
    assert all(row["boot_s"] > 0 for row in stats["workers"]["workers"])
    assert stats["router"]["generations"]["bert"] >= 1
    assert stats["router"]["cuda_initialized"] is False
    assert fleet.metric("/metrics", 'worker_up{worker="0"}') == 1.0
    assert fleet.metric("/metrics", 'worker_up{worker="1"}') == 1.0
    # The workers really are separate processes serving real models.
    status, wstats = fleet.get_json("/workers/1/stats")
    assert status == 200 and "pipeline" in wstats and wstats["backend"]["device"] == "cpu"
    assert fleet.get_json("/workers/7/stats")[0] == 404
    status, models = fleet.get_json("/v1/models")
    assert status == 200 and set(models) >= {"bert", "berterr"}
    assert fleet.request("GET", "/")[1].startswith(b"<!doctype html>")
    assert fleet.request("GET", "/v1/models/bert:classify")[0] == 405


def test_answers_through_the_router_match_direct_server_and_reference(fleet, weights, jax_tree):
    """Byte-identical to the port's single-process server on the same npz,
    request by request (each a batch of its own), and the reference's top-5
    classes with probabilities within 1e-4."""
    cfg = ServerConfig(models=[_bert("bert", weights=weights)], decode_threads=2,
                       startup_canary=False)
    state = ServerState(cfg, device="cpu")
    state.build()
    bodies = [{"text": t} for t in TEXTS] + [{"texts": TEXTS[:2]}]

    async def direct():
        from tpuserve_torch.bench.client import ClientSession

        server = await start_server(state, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{state.serving_addresses[0][1]}/v1/models/bert:classify"
        try:
            async with ClientSession() as s:
                return [(await s.post(url, json.dumps(b).encode(), {"Content-Type": JSON})).body
                        for b in bodies]
        finally:
            await stop_server(state, server)

    want = asyncio.run(direct())
    got = []
    for b in bodies:
        status, body, _ = fleet.post("bert", b)
        assert status == 200
        got.append(body)
    assert got == want
    jm, tree = jax_tree
    port_model = build(_bert("bert"))
    for text, body in zip(TEXTS, got):
        item = port_model.host_decode(json.dumps({"text": text}).encode(), JSON)
        batch = port_model.assemble([item], (1, 16))
        logits = np.asarray(jm.module.apply(tree, *batch))[0]
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        ref = np.argsort(-probs, kind="stable")[:5]
        top = json.loads(body)["top_k"]
        assert [e["class"] for e in top] == ref.tolist(), text
        np.testing.assert_allclose([e["prob"] for e in top], probs[ref], atol=1e-4)


def test_router_cache_hit_and_single_execution(fleet):
    """The cache lives in the ROUTER: a byte-identical re-upload is answered
    without any worker executing it again."""
    body = {"text": "cache me once"}
    before = fleet.worker_sum('requests_total{model="bert"}')
    s1, b1, _ = fleet.post("bert", body)
    s2, b2, _ = fleet.post("bert", body)
    assert s1 == s2 == 200 and b1 == b2
    assert fleet.worker_sum('requests_total{model="bert"}') - before == 1
    assert fleet.get_json("/stats")[1]["cache"]["bert"]["hits"] >= 1


def test_deadline_expires_inside_worker(fleet):
    """The router stamps the absolute deadline at admission and forwards
    the remaining budget: 600 ms of injected compute inside a worker answers
    504 at ~its 250 ms deadline, not after the compute and not stretched by
    the hedge that fires meanwhile."""
    t0 = time.perf_counter()
    status, body, _ = fleet.post("bertslow", {"text": "slow"}, timeout_ms=250)
    elapsed = time.perf_counter() - t0
    assert status == 504, body
    assert 0.2 <= elapsed < 1.5, elapsed


def test_deadline_expires_on_wire_and_retry_never_extends(fleet):
    """Both workers SIGSTOPped: attempts connect but never answer, so the
    request expires on the wire; the hedge and retries stay within the
    budget and the answer lands at the stamped deadline (+ the grace)."""
    pids = [h.pid for h in fleet.state.supervisor.slots if h is not None]
    assert len(pids) == 2
    for pid in pids:
        os.kill(pid, signal.SIGSTOP)
    try:
        t0 = time.perf_counter()
        status, body, _ = fleet.post("bert", {"text": "on the wire"}, timeout_ms=400)
        elapsed = time.perf_counter() - t0
        assert status == 504, body
        assert 0.35 <= elapsed < 1.5, elapsed
    finally:
        for pid in pids:
            os.kill(pid, signal.SIGCONT)
    fleet.wait_healthy()


def test_no_double_execution_after_definitive_answer(fleet):
    """A worker's 500 is DEFINITIVE (the work executed and failed): relayed
    without a re-dispatch — one execution across both workers, no retry."""
    key = 'requests_total{model="berterr"}'
    before = fleet.worker_sum(key)
    retries = fleet.metric("/metrics", 'router_retries_total{model="berterr"}')
    status, body, _ = fleet.post("berterr", {"text": "fails once"})
    assert status == 500, body
    assert fleet.worker_sum(key) - before == 1
    assert fleet.metric("/metrics", 'router_retries_total{model="berterr"}') == retries


def test_worker_hang_hedged_then_504_at_deadline(fleet):
    """worker_hang wedges the handling worker; the hedge races a duplicate
    on the other after hedge_ms; with both wedged the request still 504s at
    its deadline, and one hedge is counted."""
    hedges = fleet.metric("/metrics", 'router_hedges_total{model="berthang"}')
    t0 = time.perf_counter()
    status, body, _ = fleet.post("berthang", {"text": "hang"}, timeout_ms=600)
    elapsed = time.perf_counter() - t0
    assert status == 504, body
    assert 0.55 <= elapsed < 2.0, elapsed
    assert fleet.metric("/metrics", 'router_hedges_total{model="berthang"}') == hedges + 1


def test_worker_slow_fault_delays_but_serves(fleet):
    t0 = time.perf_counter()
    status, body, _ = fleet.post("bertlag", {"text": "lag"}, timeout_ms=5000)
    assert status == 200, body
    assert time.perf_counter() - t0 >= 0.3


def test_router_breaker_sheds_with_live_probe_eta(fleet):
    """Router breaker at threshold 2: consecutive definitive 500s trip it;
    the shed 503 carries the half-open probe ETA as Retry-After, and one
    request per interval goes through as the probe."""
    for _ in range(3):
        status, body, _ = fleet.post("berttrip", {"text": "trip"})
        assert status in (500, 503), body
    status, body, headers = fleet.post("berttrip", {"text": "trip"})
    assert status == 503 and b"circuit open" in body
    assert int(headers["retry-after"]) >= 1
    assert json.loads(body)["trace_id"] == headers["x-trace-id"]
    assert fleet.state.breakers["berttrip"].state in ("open", "half_open")
    assert fleet.metric("/metrics", 'breaker_shed_total{model="berttrip"}') >= 1


def test_reload_fans_out_atomically(fleet):
    """``:reload`` reaches EVERY worker; success bumps the router's cache
    generation (the fleet-wide invalidation) and the fleet reports one
    version; the same weights answer the same bytes after."""
    s1, b1, _ = fleet.post("bert", {"text": "before the reload"})
    assert s1 == 200
    gen = fleet.state.generations["bert"]
    status, info, _ = fleet.request("POST", "/admin/models/bert:reload")
    info = json.loads(info)
    assert status == 200, info
    assert info["fleet_consistent"] is True and len(info["workers"]) == 2
    assert len({w["version"] for w in info["workers"].values()}) == 1
    assert fleet.state.generations["bert"] == gen + 1
    assert fleet.get_json("/stats")[1]["cache"]["bert"]["entries"] == 0
    status, vers = fleet.get_json("/admin/models/bert/versions")
    assert status == 200 and len({w["live_version"] for w in vers["workers"].values()}) == 1
    assert fleet.post("bert", {"text": "before the reload"})[1] == b1
    audit = fleet.get_json("/debug/audit")[1]["audit"]
    assert any(r["verb"] == "reload" and r["outcome"] == "ok" for r in audit)
    # A model the fleet does not serve: 404 before any fan-out.
    assert fleet.request("POST", "/admin/models/nope:reload")[0] == 404


def test_router_drain_sheds_with_retry_after(fleet):
    fleet.state.begin_drain()
    try:
        status, body, headers = fleet.post("bert", {"text": "draining"})
        assert status == 503 and b"draining" in body
        assert int(headers["retry-after"]) >= 1
        status, health = fleet.get_json("/healthz")
        assert status == 503 and health["status"] == "draining"
    finally:
        fleet.state.draining = False


def test_trace_propagates_across_router_worker_hop(fleet):
    """One trace id end to end: the response header, the router's
    /debug/slow, and a stitched /debug/trace whose tree crosses the process
    boundary (router spans pid 0, worker spans pid = worker id + 1, the
    worker's root parented under the router's attempt span)."""
    status, body, headers = fleet.post("bertlag", {"text": "traced"})
    assert status == 200, body
    tid = headers["x-trace-id"]
    status, dump = fleet.get_json("/debug/slow")
    assert tid in {rec["trace_id"] for rec in dump["slow"].get("bertlag", [])}
    status, body, _ = fleet.request("GET", f"/debug/trace?trace_id={tid}")
    assert status == 200
    evs = json.loads(body)["traceEvents"]
    spans = [e for e in evs if e.get("ph") == "X"]
    assert spans and all(e["args"]["trace_id"] == tid for e in spans)
    by_pid: dict = {}
    for e in spans:
        by_pid.setdefault(e["pid"], set()).add(e["name"])
    assert {"request", "attempt"} <= by_pid[0], by_pid
    worker_names = set().union(*(v for p, v in by_pid.items() if p >= 1))
    assert {"request", "body_read", "queue", "compute"} <= worker_names
    status, rec = fleet.get_json(f"/debug/trace?trace_id={tid}&format=record")
    attempts = {s["span_id"] for s in rec["spans"] if s["name"] == "attempt"}
    roots = [s for s in rec["spans"] if s["name"] == "request" and s["pid"] >= 1]
    assert roots and all(s["parent_id"] in attempts for s in roots)
    assert "router" in rec["sources"] and len(rec["sources"]) >= 2
    assert fleet.request("GET", "/debug/trace")[0] == 400


def test_router_error_bodies_carry_trace_id(fleet):
    """A router-side 404 and a worker-side 504 both carry trace_id in the
    body matching X-Trace-Id, and the relayed 504's id is the one the router
    stamped (the worker adopted it)."""
    status, body, headers = fleet.post("ghost", {"text": "x"})
    assert status == 404 and json.loads(body)["trace_id"] == headers["x-trace-id"]
    status, body, headers = fleet.post("bertslow", {"text": "late"}, timeout_ms=250)
    assert status == 504, body
    assert json.loads(body).get("trace_id") == headers["x-trace-id"]
    assert fleet.state.recorder.get(headers["x-trace-id"]) is not None
    status, body, _ = fleet.post("bert", {"text": "x"}, verb="classify",
                                 headers={"X-Trace-Id": "f" * 32})
    assert status == 200
    status, _, headers = fleet.request("POST", "/v1/models/bert:classify?stream=maybe",
                                       b"{}", {"Content-Type": JSON})
    assert status == 400


def test_worker_crash_degrades_then_respawns():
    """worker_crash exits a worker mid-request: the retry lands on the other
    worker, which crashes too, so the answer is a FAST 503 with Retry-After
    from the live respawn backoff (lost capacity, never a hang); the
    supervisor then respawns both back to health, counted per slot."""
    cfg = ServerConfig(
        host="127.0.0.1", port=0, decode_threads=2, startup_canary=False,
        drain_timeout_s=3.0,
        router=RouterConfig(enabled=True, workers=2, retry_max=2, health_interval_s=0.2,
                            unhealthy_after=2, respawn_initial_s=0.3, respawn_max_s=2.0),
        models=[_bert("bert"), _bert("bertboom")],
        faults=FaultsConfig(enabled=True, rules=[
            # One shot per PROCESS: the first bertboom request each worker
            # sees ends that worker.
            FaultRuleConfig(kind="worker_crash", model="bertboom", count=1)]))
    fleet = Fleet(cfg)
    try:
        t0 = time.perf_counter()
        status, body, headers = fleet.post("bertboom", {"text": "boom"})
        assert status == 503, body
        assert int(headers["retry-after"]) >= 1
        assert time.perf_counter() - t0 < 10.0
        deadline = time.monotonic() + 10.0
        while fleet.state.supervisor.deaths_total < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert fleet.state.supervisor.deaths_total >= 2
        fleet.wait_healthy(120.0)
        assert fleet.post("bert", {"text": "served again"})[0] == 200
        respawns = (fleet.metric("/metrics", 'worker_respawns_total{worker="0"}')
                    + fleet.metric("/metrics", 'worker_respawns_total{worker="1"}'))
        assert respawns >= 2
        # Each death left a postmortem naming its exit code, with the stderr
        # tail of the slot's capture file.
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            pms = fleet.get_json("/debug/postmortems")[1]["postmortems"]
            if len(pms) >= 2:
                break
            time.sleep(0.1)
        assert len(pms) >= 2 and all(p["exitcode"] == 17 for p in pms[:2])
        assert any("worker_crash" in (p.get("stderr_tail") or "") for p in pms)
        # ... and the worker's last black-box snapshot (written at its start).
        assert all(p["snapshot"]["worker_id"] == p["worker"] and "counters" in p["snapshot"]
                   for p in pms[:2])
    finally:
        fleet.close()
