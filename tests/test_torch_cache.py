"""The port's result cache (``tpuserve_torch.cache``) against the reference's
(``tpuserve.cache``): each scenario of ``tests/test_cache.py`` run on both
packages with hand-driven futures, then the served path — both servers side
by side on the CPU, the toy model from the same weights, ``[cache]`` on.

Held exactly, on both packages: digests (the same hex string for the same
item), keys, hit/miss/coalesced/eviction/stale counters, entry counts,
pre-serialized bodies, error fan-out, and over HTTP the status codes and
cache counters of a repeat, of a client batch of identical items and of a
reload (a new version misses). Each server's cache hit answers with the
bytes of its own first answer; the two servers' top-k probabilities agree
within 1e-6 (float32 toy, two frameworks).
"""

import asyncio
import io
import json

import aiohttp
import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tpuserve import cache as jcache
from tpuserve import config as jconfig
from tpuserve import obs as jobs
from tpuserve.models import build as jax_build
from tpuserve.savedmodel import save_orbax
from tpuserve.server import ServerState as JaxServerState
from tpuserve.server import make_app
from tpuserve_torch import cache as tcache
from tpuserve_torch import config as tconfig
from tpuserve_torch import obs as tobs
from tpuserve_torch import savedmodel as sm
from tpuserve_torch.server import ServerState, start_server, stop_server

PKGS = {"jax": (jcache, jconfig, jobs), "port": (tcache, tconfig, tobs)}
NPY = {"Content-Type": "application/x-npy"}
MODEL = dict(name="toy", family="toy", batch_buckets=[1, 2, 4], deadline_ms=5.0,
             dtype="float32", num_classes=10, parallelism="single",
             request_timeout_ms=10_000.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_cache(pkg, version=1, **cfg_over):
    """Cache with a mutable version cell: bump live_version[0] to stand in
    for a lifecycle publish or rollback."""
    cmod, cfgmod, omod = PKGS[pkg]
    live_version = [version]
    metrics = omod.Metrics()
    cache = cmod.ModelCache("toy", cfgmod.CacheConfig(enabled=True, **cfg_over), metrics,
                            version_fn=lambda: live_version[0])
    return cache, metrics, live_version


def count(metrics, event):
    return metrics.counter(f"cache_{event}_total{{model=toy}}").value


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


ITEMS = [np.arange(192, dtype=np.uint8).reshape(8, 8, 3),
         np.arange(64, dtype=np.uint8), np.arange(64, dtype=np.uint8).reshape(8, 8),
         np.arange(64, dtype=np.uint8).view(np.int8), np.arange(16, dtype=np.float32),
         {"x": np.arange(4), "y": 1}, (np.arange(3), 1), [np.arange(3), 1], "1", 1,
         (np.zeros((4, 4), np.uint8), np.ones((2, 2), np.uint8)), b"raw", None, 2.5]


def test_item_digest_equals_the_reference():
    """Every kind of decoded item digests to the reference's hex string."""
    for it in ITEMS:
        assert tcache.item_digest(it) == jcache.item_digest(it)
    assert len({tcache.item_digest(it) for it in ITEMS}) == len(ITEMS)


@pytest.mark.parametrize("pkg", PKGS)
def test_item_digest_stable_and_sensitive(pkg):
    d = PKGS[pkg][0].item_digest
    a = np.arange(192, dtype=np.uint8).reshape(8, 8, 3)
    assert d(a) == d(a.copy()) and d(a[:, ::1]) == d(np.ascontiguousarray(a))
    b = np.arange(64, dtype=np.uint8)
    c = b.copy()
    c[0] += 1
    assert d(b) != d(c) and d(b) != d(b.reshape(8, 8)) and d(b) != d(b.view(np.int8))
    f = np.arange(16, dtype=np.float32)
    assert d({"x": f, "y": 1}) == d({"y": 1, "x": f})
    assert d((f, 1)) != d([f, 1]) and d("1") != d(1)


@pytest.mark.parametrize("pkg", PKGS)
def test_key_for_binds_live_version(pkg):
    cache, _, live_version = make_cache(pkg, version=3)
    a = np.arange(8, dtype=np.uint8)
    k3 = cache.key_for(a)
    live_version[0] = 4
    assert cache.key_for(a) != k3 and k3.startswith("3:")
    assert k3 == f"3:{jcache.item_digest(a)}"


@pytest.mark.parametrize("pkg", PKGS)
def test_put_get_and_hit_counting(pkg):
    cache, metrics, _ = make_cache(pkg)
    cache.put("k", {"top_k": [1, 2]})
    e = cache.get("k")
    assert e is not None and e.value == {"top_k": [1, 2]}
    assert cache.get("missing") is None
    assert (count(metrics, "hits"), count(metrics, "misses")) == (1, 0)


@pytest.mark.parametrize("pkg", PKGS)
def test_lru_eviction_prefers_stale_entries(pkg):
    cache, metrics, _ = make_cache(pkg, capacity=2)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") is not None  # "a" is now the most recent
    cache.put("c", 3)  # evicts "b"
    assert cache.get("b") is None
    assert cache.get("a") is not None and cache.get("c") is not None
    assert count(metrics, "evictions") == 1
    assert metrics.gauge("cache_entries{model=toy}").value == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_ttl_expiry(pkg):
    cache, _, _ = make_cache(pkg, ttl_s=10.0)
    cache.put("k", 1)
    assert cache.get("k") is not None
    cache._entries["k"] = PKGS[pkg][0].CacheEntry(1, None, cache._entries["k"].at - 11.0)
    assert cache.get("k") is None
    assert cache.stats()["entries"] == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_put_preserializes_json_body(pkg):
    cache, _, _ = make_cache(pkg)
    val = {"top_k": [{"class": 1, "prob": 0.5}]}
    cache.put("k", val)
    assert cache.get("k").body == json.dumps(val).encode()
    big, _, _ = make_cache(pkg, max_body_bytes=4)
    big.put("k", val)
    assert big.get("k").body is None
    cache.put("png", b"\x89PNG")
    assert cache.get("png").body is None and cache.get("png").value == b"\x89PNG"


@pytest.mark.parametrize("pkg", PKGS)
def test_single_flight_coalesces_identical_misses(pkg):
    async def go():
        cache, metrics, _ = make_cache(pkg)
        base = asyncio.get_running_loop().create_future()
        calls = []

        def submit():
            calls.append(1)
            return base

        waiters = [cache.submit_through("k", submit) for _ in range(4)]
        assert len(calls) == 1
        base.set_result({"top_k": [7]})
        assert await asyncio.gather(*waiters) == [{"top_k": [7]}] * 4
        assert (count(metrics, "misses"), count(metrics, "coalesced")) == (1, 3)
        assert cache.get("k").value == {"top_k": [7]}
        assert cache.stats()["inflight"] == 0

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_failed_flight_fans_error_and_populates_nothing(pkg):
    async def go():
        cache, metrics, _ = make_cache(pkg)
        base = asyncio.get_running_loop().create_future()
        waiters = [cache.submit_through("k", lambda: base) for _ in range(3)]
        base.set_exception(RuntimeError("poison batch"))
        for w in waiters:
            with pytest.raises(RuntimeError, match="poison batch"):
                await w
        assert cache.get("k") is None and cache.stats()["entries"] == 0
        base2 = asyncio.get_running_loop().create_future()
        w2 = cache.submit_through("k", lambda: base2)
        base2.set_result(1)
        assert await w2 == 1
        assert count(metrics, "misses") == 2

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_mid_flight_version_change_drops_result_from_cache(pkg):
    async def go():
        cache, metrics, live_version = make_cache(pkg, version=1)
        key = cache.key_for(np.arange(8, dtype=np.uint8))
        base = asyncio.get_running_loop().create_future()
        w = cache.submit_through(key, lambda: base)
        live_version[0] = 2
        base.set_result({"top_k": [1]})
        assert await w == {"top_k": [1]}
        assert cache.get(key) is None and cache.stats()["entries"] == 0
        assert count(metrics, "stale_drops") == 1

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_waiter_cancellation_never_cancels_the_flight(pkg):
    async def go():
        cache, _, _ = make_cache(pkg)
        base = asyncio.get_running_loop().create_future()
        w1 = cache.submit_through("k", lambda: base)
        w2 = cache.submit_through("k", lambda: base)
        w1.cancel()
        assert not base.cancelled()
        base.set_result(42)
        assert await w2 == 42 and cache.get("k").value == 42

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_submit_exception_propagates_with_nothing_registered(pkg):
    async def go():
        cache, metrics, _ = make_cache(pkg)

        def submit():
            raise RuntimeError("queue full")

        with pytest.raises(RuntimeError, match="queue full"):
            cache.submit_through("k", submit)
        assert cache.stats()["inflight"] == 0 and count(metrics, "misses") == 0

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_coalesce_disabled_every_miss_submits(pkg):
    async def go():
        cache, metrics, _ = make_cache(pkg, coalesce=False)
        loop = asyncio.get_running_loop()
        bases, calls = [], []

        def submit():
            calls.append(1)
            bases.append(loop.create_future())
            return bases[-1]

        w1, w2 = cache.submit_through("k", submit), cache.submit_through("k", submit)
        assert len(calls) == 2
        for b in bases:
            b.set_result(1)
        assert await asyncio.gather(w1, w2) == [1, 1]
        assert count(metrics, "coalesced") == 0

    run(go())


@pytest.mark.parametrize("counters, rate", [
    ({"hits": 0, "misses": 0, "coalesced": 0}, None),
    ({"hits": 3, "misses": 1, "coalesced": 0}, 0.75),
    ({"hits": 0, "misses": 1, "coalesced": 3}, 0.0)])
def test_hit_rate_definition(counters, rate):
    assert tcache.hit_rate(counters) == jcache.hit_rate(counters) == rate


@pytest.mark.parametrize("pkg", PKGS)
def test_counter_snapshot_roundtrip(pkg):
    cache, metrics, _ = make_cache(pkg)
    cache.put("k", 1)
    cache.get("k")
    assert PKGS[pkg][0].counter_snapshot(metrics, "toy") == \
        {"hits": 1.0, "misses": 0.0, "coalesced": 0.0}


# -- served: both servers side by side ----------------------------------------------

def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def image(seed: int = 0):
    return np.random.default_rng(seed).integers(0, 200, (8, 8, 3), dtype=np.uint8)


class Side:
    """One server (the JAX package's or the port's) with ``[cache]`` on,
    serving the toy from the JAX package's seed-1 tree."""

    def __init__(self, pkg: str, tmp_path, tree) -> None:
        self.pkg = pkg
        cfgm = jconfig if pkg == "jax" else tconfig
        tmp_path.mkdir(parents=True, exist_ok=True)
        self.ckpt = str(tmp_path / ("ckpt" if pkg == "jax" else "ckpt.npz"))
        if pkg == "jax":
            save_orbax(self.ckpt, tree)
        else:
            sm.save_npz(self.ckpt, tree)
        cfg = cfgm.ServerConfig(
            models=[cfgm.ModelConfig(**dict(MODEL, weights=self.ckpt))], decode_threads=2,
            cache=cfgm.CacheConfig(enabled=True, capacity=64))
        self.state = (JaxServerState(cfg) if pkg == "jax"
                      else ServerState(cfg, device="cpu"))
        self.state.build()

    async def __aenter__(self):
        if self.pkg == "jax":
            self.client = TestClient(TestServer(make_app(self.state)))
            await self.client.start_server()
        else:
            self.server = await start_server(self.state, "127.0.0.1", 0)
            port = self.state.serving_addresses[0][1]
            self.session = aiohttp.ClientSession(f"http://127.0.0.1:{port}")
        return self

    async def __aexit__(self, *exc):
        if self.pkg == "jax":
            await self.client.close()
        else:
            await self.session.close()
            await stop_server(self.state, self.server)

    async def post(self, path: str, data: bytes):
        http = self.client if self.pkg == "jax" else self.session
        async with http.post(path, data=data, headers=NPY) as r:
            return r.status, await r.read()

    def counters(self) -> dict:
        return {ev: self.state.metrics.counter(f"cache_{ev}_total{{model=toy}}").value
                for ev in ("hits", "misses", "coalesced", "evictions", "stale_drops")}


def test_served_cache_hit_coalesce_and_reload(tmp_path):
    """Over HTTP on both servers: the same image twice is one miss then a
    hit answering the same bytes; a client batch of 4 identical new images
    is 1 miss and 3 coalesced; after a reload (version 2) the first image
    misses again. Counters, statuses and /stats blocks equal."""
    jm = jax_build(jconfig.ModelConfig(**MODEL))
    tree = jax.device_get(jm.init_params(jax.random.key(1)))

    async def scenario(pkg) -> dict:
        side = Side(pkg, tmp_path / pkg, tree)
        seen = {}
        async with side:
            path = "/v1/models/toy:predict"
            st1, b1 = await side.post(path, npy(image(0)))
            st2, b2 = await side.post(path, npy(image(0)))
            seen["repeat"] = (st1, st2, b1 == b2, side.counters())
            st, body = await side.post(path, npy(np.stack([image(5)] * 4)))
            results = json.loads(body)["results"]
            seen["batch"] = (st, len(results), all(r == results[0] for r in results),
                             side.counters())
            http = side.client if pkg == "jax" else side.session
            async with http.post("/admin/models/toy:reload") as r:
                seen["reload"] = (r.status, (await r.json())["version"])
            st3, b3 = await side.post(path, npy(image(0)))
            seen["after_reload"] = (st3, side.counters())
            async with http.get("/stats") as r:
                stats = await r.json()
            seen["stats"] = {k: v for k, v in stats["cache"]["toy"].items()}
            seen["probs"] = [e["prob"] for e in json.loads(b1)["top_k"]]
            seen["classes"] = [e["class"] for e in json.loads(b1)["top_k"]]
        return seen

    jseen = asyncio.run(scenario("jax"))
    tseen = asyncio.run(scenario("port"))
    jprobs, tprobs = jseen.pop("probs"), tseen.pop("probs")
    np.testing.assert_allclose(tprobs, jprobs, atol=1e-6, rtol=0)
    assert tseen == jseen
    assert tseen["repeat"] == (200, 200, True, {"hits": 1, "misses": 1, "coalesced": 0,
                                                "evictions": 0, "stale_drops": 0})
    assert tseen["batch"][:3] == (200, 4, True)
    assert (tseen["batch"][3]["misses"], tseen["batch"][3]["coalesced"]) == (2, 3)
    assert tseen["reload"] == (200, 2)
    assert tseen["after_reload"][1]["misses"] == 3


def test_uncacheable_model_gets_no_cache():
    cfg = tconfig.ServerConfig(models=[tconfig.ModelConfig(**dict(MODEL, cacheable=False))],
                               cache=tconfig.CacheConfig(enabled=True))
    state = ServerState(cfg, device="cpu")
    state.build()

    async def go():
        server = await start_server(state, "127.0.0.1", 0)
        try:
            assert state.caches == {}
        finally:
            await stop_server(state, server)

    asyncio.run(go())
