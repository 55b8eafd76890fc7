"""The horizontal router tier (``tpuserve_torch.workerproc.peers``) against
the reference's (``tpuserve/workerproc/peers.py``), on the CPU.

- ``HashRing``: the owner of each of 10,000 keys equal to the reference's
  under memberships {0}, {0, 1}, {0, 1, 2} and {0, 2} (exact); determinism,
  balance, the consistent-hashing property (a leaving member moves only its
  own keys) and the empty ring, as the reference's units state them.
- The reference's scenarios (``tests/test_multirouter.py``) on real
  processes: a module-scoped fleet of two routers on one SO_REUSEPORT port
  (the primary on a thread of this process, the peer a spawned process)
  over two host agents of one CPU worker each, serving a narrow seeded
  BERT-flash (2 layers, d_model 32) on weights converted from the
  reference's seeded flax tree, with the result cache on. Two routers serve
  one port; answers through both are byte-identical to the port's direct
  server and hold the reference's top-5 (float32: logits atol 1e-4 as
  ``tests/test_torch_bert.py`` states, so probabilities within 1e-4); a
  re-upload through either router runs once, and concurrent misses through
  both coalesce into one execution; the owner's SIGKILL degrades to
  local-only with zero 5xx (``cache_peer_errors_total`` counts it), then
  the peer respawns into the ring; a reload syncs the generation to every
  router; a peer proxies the admin verbs and the fleet scrape to the
  primary. The peer's pid comes from the primary's roster. Every wait is
  bounded in code.
"""

import asyncio
import http.client
import json
import os
import signal
import time

import numpy as np
import pytest
import torch
from test_torch_router import (JSON, TEXTS, Fleet, _bert, jax_tree,  # noqa: F401 — fixtures
                               weights)

from tpuserve.workerproc import peers as jpeers
from tpuserve_torch.config import CacheConfig, RouterConfig, ServerConfig
from tpuserve_torch.models import build
from tpuserve_torch.server import ServerState, start_server, stop_server
from tpuserve_torch.workerproc import peers as tpeers

MEMBERSHIPS = [{0: "a"}, {0: "a", 1: "b"}, {0: "a", 1: "b", 2: "c"}, {0: "a", 2: "c"}]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    prev_env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the spawned processes read it at import
    yield
    torch.set_num_threads(prev)
    if prev_env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = prev_env


# ---------------------------------------------------------------------------
# HashRing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("members", MEMBERSHIPS, ids=lambda m: "+".join(map(str, m)))
def test_ring_owners_match_reference(members):
    port, ref = tpeers.HashRing(members), jpeers.HashRing(members)
    keys = [f"key{i}" for i in range(5000)] + [os.urandom(8).hex() for _ in range(5000)]
    assert [port.owner(k) for k in keys] == [ref.owner(k) for k in keys]


def test_ring_deterministic_balanced_and_consistent():
    ring = tpeers.HashRing({0: "a", 1: "b", 2: "c"})
    keys = [f"key{i}" for i in range(3000)]
    owners = [ring.owner(k)[0] for k in keys]
    assert owners == [tpeers.HashRing({0: "a", 1: "b", 2: "c"}).owner(k)[0] for k in keys]
    assert all(400 <= owners.count(r) <= 1800 for r in range(3))
    reduced = tpeers.HashRing({0: "a", 2: "c"})
    moved = 0
    for k, before in zip(keys, owners):
        after = reduced.owner(k)[0]
        if before == 1:
            moved += 1
            assert after in (0, 2)
        else:
            assert after == before, k
    assert moved > 0
    assert tpeers.HashRing({}).owner("x") is None


# ---------------------------------------------------------------------------
# Two routers on one port over two host domains
# ---------------------------------------------------------------------------

def _cfg(weights: str) -> ServerConfig:
    return ServerConfig(
        host="127.0.0.1", port=0, decode_threads=2, startup_canary=False,
        drain_timeout_s=3.0, watchdog_interval_s=0.2,
        cache=CacheConfig(enabled=True, capacity=256),
        router=RouterConfig(enabled=True, workers=1, hosts=2, routers=2, retry_max=2,
                            health_interval_s=0.2, unhealthy_after=2,
                            respawn_initial_s=0.3, respawn_max_s=2.0,
                            peer_sync_interval_s=0.2),
        models=[_bert("bert", weights=weights)])


def _peer_get(fleet, rid: int, path: str) -> tuple[int, bytes]:
    """GET ``path`` on router ``rid``'s own peer listener (the shared public
    port cannot address one router)."""
    port = (fleet.state.peer_port if rid == 0
            else fleet.state.peer_sup.peers[rid].peer_port)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _peer_stats(fleet, rid: int = 1) -> dict:
    return json.loads(_peer_get(fleet, rid, "/peer/stats")[1])


@pytest.fixture(scope="module")
def routers(weights):
    f = Fleet(_cfg(weights))
    # The peer's public listener opens once its ring is complete; wait for
    # it before any test spreads load over both routers.
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        try:
            if _peer_stats(f)["router"].get("ring", {}).get("size") == 2:
                break
        except (OSError, KeyError, ValueError):
            pass
        time.sleep(0.1)
    else:
        f.close()
        raise RuntimeError("the peer router never settled into the ring")
    yield f
    f.close()


def _on_loop(fleet, coro, timeout=60.0):
    """Run ``coro`` on the primary router's own event loop."""
    return asyncio.run_coroutine_threadsafe(coro, fleet._loop).result(timeout)


def _worker_requests(fleet) -> float:
    return fleet.worker_sum('requests_total{model="bert"}')


def _body_owned_by(fleet, rid: int, tag: str) -> bytes:
    state = fleet.state
    for i in range(200):
        body = json.dumps({"text": f"{tag} {i}"}).encode()
        if state.ring.owner(state.caches["bert"].key_for(("classify", JSON, body)))[0] == rid:
            return body
    raise AssertionError(f"no body owned by router {rid}")


def _dispatch(fleet, body: bytes):
    state = fleet.state
    return _on_loop(fleet, state._dispatch("bert", "classify", body, JSON,
                                           time.perf_counter() + 10.0))


def test_two_routers_serve_one_port(routers):
    state = routers.state
    assert len(state.ring.members) == 2
    status, body, _ = routers.post("bert", {"text": "two routers"})
    assert status == 200, body
    status, health = routers.get_json("/healthz")
    assert status == 200 and health["status"] == "ok", health
    assert health["routers"] == {"configured": 2, "in_ring": 2}
    pstats = _peer_stats(routers)
    assert pstats["router"]["router_id"] == 1 and pstats["router"]["is_primary"] is False
    assert pstats["router"]["cuda_initialized"] is False
    assert pstats["workers"]["view"] == "peer" and pstats["workers"]["healthy"] == 2
    assert {row["host"] for row in pstats["workers"]["workers"]} == {0, 1}
    stats = _peer_stats(routers, 0)  # the primary's
    assert stats["router"]["is_primary"] and stats["routers"]["peers"][0]["state"] == "up"
    assert stats["router"]["ring"]["size"] == 2
    assert b'router_up{router="1"} 1.0' in _peer_get(routers, 0, "/peer/metrics")[1]
    # Fresh connections land on both routers: each one's own router_id shows.
    seen = {routers.get_json("/healthz")[1]["router_id"] for _ in range(40)}
    assert seen == {0, 1}


def test_answers_through_both_routers_match_direct_server_and_reference(routers, weights,
                                                                         jax_tree):
    """Every request on a fresh connection (the kernel hands it to either
    router): byte-identical to the port's single-process server on the same
    npz, and the reference's top-5 within 1e-4."""
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
    for _ in range(2):  # once to the workers, once from the shards
        got = [routers.post("bert", b) for b in bodies]
        assert all(st == 200 for st, _, _ in got)
        assert [b for _, b, _ in got] == want
    jm, tree = jax_tree
    port_model = build(_bert("bert"))
    for text, body in zip(TEXTS, want):
        item = port_model.host_decode(json.dumps({"text": text}).encode(), JSON)
        logits = np.asarray(jm.module.apply(tree, *port_model.assemble([item], (1, 16))))[0]
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        ref = np.argsort(-probs, kind="stable")[:5]
        top = json.loads(body)["top_k"]
        assert [e["class"] for e in top] == ref.tolist(), text
        np.testing.assert_allclose([e["prob"] for e in top], probs[ref], atol=1e-4)


def test_reupload_through_any_router_single_execution(routers):
    """A peer-owned key through the PRIMARY's dispatch is forwarded
    (cache_peer_hops ticks), the peer's shard holds the one entry, and
    every later upload of the same bytes, through either router, hits it:
    one worker execution."""
    body = _body_owned_by(routers, 1, "re-upload")
    h = routers.state.handles["bert"]
    before, hops = _worker_requests(routers), h.peer_hops.value
    ans = _dispatch(routers, body)
    assert ans.status == 200 and h.peer_hops.value == hops + 1
    answers = {ans.body}
    for _ in range(4):
        status, got, _ = routers.request("POST", "/v1/models/bert:classify", body,
                                         {"Content-Type": JSON})
        assert status == 200
        answers.add(got)
    answers.add(_dispatch(routers, body).body)
    assert len(answers) == 1
    assert _worker_requests(routers) - before == 1


def test_concurrent_misses_across_routers_coalesce(routers):
    """N identical concurrent misses through both routers: one worker
    execution (the owner's single-flight leads for the tier)."""
    import concurrent.futures as cf

    body = _body_owned_by(routers, 1, "coalesce")
    before = _worker_requests(routers)

    def post(_):
        return routers.request("POST", "/v1/models/bert:classify", body,
                               {"Content-Type": JSON})[:2]

    with cf.ThreadPoolExecutor(6) as pool:
        futs = [pool.submit(post, i) for i in range(4)] \
            + [pool.submit(lambda: (200, _dispatch(routers, body).body)) for _ in range(2)]
        results = [f.result(60) for f in futs]
    assert {st for st, _ in results} == {200} and len({b for _, b in results}) == 1
    assert _worker_requests(routers) - before == 1


def test_peer_proxies_admin_and_fleet_scrape_to_the_primary(routers):
    """The peer's /peer/fleet/metrics and public admin reads are the
    primary's: its fleet scrape names every process, the peer's own
    registry included."""
    status, body = _peer_get(routers, 1, "/peer/fleet/stats")
    rollup = json.loads(body)
    assert status == 200, rollup
    status, body = _peer_get(routers, 1, "/peer/admin/bert/versions")
    assert status == 200 and len(json.loads(body)["workers"]) == 2
    assert set(rollup["sources"]) == {"router0", "router1", "worker0", "worker1"}
    assert rollup["stale"] == []
    status, text, _ = routers.request("GET", "/metrics/fleet")
    assert status == 200 and b'fleet_source_up{proc="router1"} 1' in text


def test_owner_kill_degrades_local_only_zero_5xx(routers):
    """The owner router's SIGKILL: peer-owned keys through the primary fail
    their hop, degrade to the primary's shard and answer 200 (failures
    counted, never surfaced); through the shared port nothing but 200s;
    then the peer respawns into the ring and serves hops again."""
    state = routers.state
    peer = state.peer_sup.peers[1]
    errors = state.handles["bert"].peer_errors.value
    os.kill(peer.pid, signal.SIGKILL)
    served = 0
    for i in range(200):
        body = json.dumps({"text": f"owner dead {i}"}).encode()
        owner = state.ring.owner(state.caches["bert"].key_for(("classify", JSON, body)))
        if owner is None or owner[0] != 1:
            continue  # the ring may have healed already: stop this leg
        ans = _dispatch(routers, body)
        assert ans.status == 200, (i, ans.status, ans.body)
        served += 1
        if served >= 4:
            break
    if served:
        assert state.handles["bert"].peer_errors.value > errors
    for i in range(8):
        assert routers.post("bert", {"text": f"shared port {i}"})[0] == 200
    deadline = time.monotonic() + 60.0
    new = None
    while time.monotonic() < deadline:
        new = state.peer_sup.peers.get(1)
        if new is not None and new.pid != peer.pid and new.proc.is_alive() \
                and len(state.ring.members) == 2:
            break
        time.sleep(0.1)
    assert new is not None and new.pid != peer.pid and len(state.ring.members) == 2
    assert state.metrics.counter("router_respawns_total{router=1}").value >= 1
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        try:
            if _peer_stats(routers)["router"].get("ring", {}).get("size") == 2:
                break
        except (OSError, ValueError):
            pass
        time.sleep(0.1)
    hops = state.handles["bert"].peer_hops.value
    assert _dispatch(routers, _body_owned_by(routers, 1, "respawned")).status == 200
    assert state.handles["bert"].peer_hops.value == hops + 1


def test_reload_syncs_generations_to_every_router(routers):
    """A :reload through the shared port (either router: a peer proxies it
    to the primary) bumps the generation on EVERY router."""
    state = routers.state
    gen = state.generations["bert"]
    status, info, _ = routers.request("POST", "/admin/models/bert:reload")
    assert status == 200, info
    assert sorted(json.loads(info)["per_host"]) == ["host0", "host1"]
    assert state.generations["bert"] == gen + 1
    deadline = time.monotonic() + 10.0
    pgen = None
    while time.monotonic() < deadline:
        pgen = _peer_stats(routers)["router"]["generations"]["bert"]
        if pgen == gen + 1:
            break
        time.sleep(0.1)
    assert pgen == gen + 1
