"""The iteration-level generation engine (``tpuserve_torch.genserve``) beside
the reference's (``tpuserve/genserve``), scenario by scenario from
``tests/test_genserve.py``, on the CPU: each scenario runs on both packages
(``pkg``) with textgen at the reference tests' tiny options (1 layer, d 32,
vocab 512, float32) on the same weights — the reference runtime's seeded
tree, written as the port's ``.npz``.

What each holds, on both packages alike: slot-arena safety; short-after-long
finishes first; fold-in and early-exit counters; engine tokens equal the
locked-batch forward's and, across packages, the reference's tokens exactly
(greedy and temperature 0.7: the port's threefry draws the reference's
Gumbel noise bit for bit; float32 logits agree within 1e-4, and no step of
these inputs is a near tie); mid-generation deadline eviction; queued
expiry; zero new compiles (and captures) across churn, publish and
rollback; queue-full shed; a cancelled request frees its slot; a step
failure is contained; the watchdog revives a dead step loop; drain; the
staged canary (never touching the live state block); flash prefill equal
to dense; cache keys carry every sampling parameter; ``cacheable = false``;
the ``[genserve]`` TOML; and over HTTP: ``:generate`` through the engine, a
reload gated by the engine's staged canary, cache hits, ``?stream=true``
answered as a stream (never a plain body), and ``[genserve] enabled = false`` serving the same tokens as
locked batches through the batcher.
"""

import asyncio
import dataclasses
import http.client
import json
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tpuserve import batcher as jbatcher
from tpuserve import cache as jcache
from tpuserve import config as jconfig
from tpuserve import faults as jfaults
from tpuserve import genserve as jgenserve
from tpuserve import obs as jobs
from tpuserve.models import build as jax_build
from tpuserve.runtime import build_runtime as jax_build_runtime
from tpuserve_torch import batcher as tbatcher
from tpuserve_torch import cache as tcache
from tpuserve_torch import config as tconfig
from tpuserve_torch import faults as tfaults
from tpuserve_torch import genserve as tgenserve
from tpuserve_torch import obs as tobs
from tpuserve_torch import savedmodel as sm
from tpuserve_torch.bench import loadgen as tbench_loadgen
from tpuserve_torch.models import build as port_build
from tpuserve_torch.runtime import LIVE_BLOCK
from tpuserve_torch.runtime import build_runtime as port_build_runtime

PKGS = ("jax", "port")
TG_OPTS = dict(layers=1, d_model=32, heads=2, d_ff=64, vocab_size=512,
               prompt_len=16, max_new_tokens=64)
MODEL = dict(name="tg", family="textgen", batch_buckets=[1, 2, 4], dtype="float32",
             parallelism="single", max_queue=64, request_timeout_ms=60_000.0)
MODS = {"jax": SimpleNamespace(batcher=jbatcher, cache=jcache, config=jconfig,
                               faults=jfaults, genserve=jgenserve, obs=jobs),
        "port": SimpleNamespace(batcher=tbatcher, cache=tcache, config=tconfig,
                                faults=tfaults, genserve=tgenserve, obs=tobs)}


def tg_cfg(pkg: str, **over):
    base = dict(MODEL, options=dict(TG_OPTS))
    base.update(over)
    return MODS[pkg].config.ModelConfig(**base)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference runtime's seeded float32 tree, and the same tree as the
    port's .npz checkpoint."""
    jm = jax_build(tg_cfg("jax"))
    tree = jax.device_get(jax_build_runtime(jm, compile_forward=False).params_per_mesh[0])
    path = str(tmp_path_factory.mktemp("tg") / "tg.npz")
    sm.save_npz(path, tree)
    return tree, path


def build_side(pkg: str, weights, compile_forward: bool = False, **over):
    """(model, runtime) of one package on the shared weights."""
    if pkg == "jax":
        model = jax_build(tg_cfg("jax", **over))
        return model, jax_build_runtime(model, compile_forward=compile_forward)
    model = port_build(tg_cfg("port", weights=weights[1], **over))
    return model, port_build_runtime(model, device="cpu", compile_forward=compile_forward)


@pytest.fixture(scope="module")
def sides(weights):
    """Per package: (model, runtime) with the engine programs registered at
    4 slots (engines over it are cheap)."""
    out = {}
    for pkg in PKGS:
        model, rt = build_side(pkg, weights)
        g = MODS[pkg].genserve
        g.GenEngine(model, rt, MODS[pkg].obs.Metrics(),
                    MODS[pkg].config.GenserveConfig(slots=4)).compile()
        out[pkg] = (model, rt)
    return out


def make_engine(sides, pkg: str, slots: int = 4, **gc_over):
    model, rt = sides[pkg]
    mods = MODS[pkg]
    metrics = mods.obs.Metrics()
    eng = mods.genserve.GenEngine(model, rt, metrics,
                                  mods.config.GenserveConfig(slots=slots, **gc_over))
    eng.compile()  # reuses the runtime's registered programs
    return eng, metrics


def prompt_item(model, prompt="hello world", seed=0, max_new=8, temp=0.0):
    body = {"prompt": prompt, "seed": seed, "max_new_tokens": max_new}
    if temp:
        body["temperature"] = temp
    return model.host_decode(json.dumps(body).encode(), "application/json")


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def counter(metrics, name: str) -> float:
    return metrics.counter(f"{name}{{model=tg}}").value


def seeded_requests(n: int, seed: int) -> list[tuple]:
    """(prompt, seed, max_new, temperature) of ``n`` requests from one rng:
    prompts of 1-20 words, max_new 1-64, temperature 0 or 0.7."""
    rng = np.random.default_rng(seed)
    words = "the model serves text fast and slow with new old high low tokens".split()
    return [(" ".join(rng.choice(words, int(rng.integers(1, 21)))),
             int(rng.integers(-1000, 1000)), int(rng.integers(1, 65)),
             float(rng.choice([0.0, 0.7]))) for _ in range(n)]


# ---------------------------------------------------------------------------
# SlotArena: never double-hands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_slot_arena_never_double_hands(pkg):
    g = MODS[pkg].genserve
    a = g.SlotArena(2)
    s0 = a.acquire(g.SlotInfo(item=None, future=None))
    s1 = a.acquire(g.SlotInfo(item=None, future=None))
    assert {s0, s1} == {0, 1} and a.n_free == 0
    with pytest.raises(IndexError):
        a.acquire(g.SlotInfo(item=None, future=None))
    a.release(s0)
    with pytest.raises(g.SlotCorrupted, match="not active"):
        a.release(s0)  # double release
    a._free.append(s1)
    with pytest.raises(g.SlotCorrupted, match="double-hand"):
        a.acquire(g.SlotInfo(item=None, future=None))


@pytest.mark.parametrize("pkg", PKGS)
def test_slot_arena_release_all(pkg):
    g = MODS[pkg].genserve
    a = g.SlotArena(3)
    for i in range(3):
        a.acquire(g.SlotInfo(item=i, future=None))
    assert [i.item for i in a.release_all()] == [0, 1, 2]
    assert a.n_free == 3 and a.n_active == 0
    assert a.stats() == {"slots": 3, "active": 0, "free": 3, "acquires_total": 3}


# ---------------------------------------------------------------------------
# Scheduler invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_short_after_long_finishes_first(sides, pkg):
    model, _ = sides[pkg]
    eng, _m = make_engine(sides, pkg)

    async def go():
        await eng.start()
        order = []
        long_f = eng.submit(prompt_item(model, "long", seed=1, max_new=60))
        long_f.add_done_callback(lambda f: order.append("long"))
        await asyncio.sleep(0.02)  # the long one is mid-generation now
        short_f = eng.submit(prompt_item(model, "short", seed=2, max_new=2))
        short_f.add_done_callback(lambda f: order.append("short"))
        rl, rs = await asyncio.gather(long_f, short_f)
        await eng.stop()
        assert order == ["short", "long"], order
        assert rl["n_tokens"] == 60 and rs["n_tokens"] == 2

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_fold_in_and_early_exit_counters(sides, pkg):
    model, _ = sides[pkg]
    eng, m = make_engine(sides, pkg)

    async def go():
        await eng.start()
        long_f = eng.submit(prompt_item(model, "marathon", seed=3, max_new=60))
        await asyncio.sleep(0.02)
        shorts = [eng.submit(prompt_item(model, f"s{i}", seed=10 + i, max_new=2))
                  for i in range(3)]
        await asyncio.gather(long_f, *shorts)
        await eng.stop()

    run(go())
    assert counter(m, "gen_fold_ins_total") >= 3
    assert counter(m, "gen_early_exits_total") >= 3
    assert counter(m, "gen_iterations_total") > 0
    assert counter(m, "gen_units_total") == 66


@pytest.fixture(scope="module")
def reference_tokens(sides):
    """The reference's locked-batch tokens of 12 seeded requests (its jitted
    forward on the shared weights), one request per (1,) batch."""
    jm, jrt = sides["jax"]
    fwd = jax.jit(jm.forward)
    reqs = seeded_requests(12, seed=4)
    out = []
    for prompt, seed, max_new, temp in reqs:
        batch = jm.assemble([prompt_item(jm, prompt, seed, max_new, temp)], (1,))
        res = jax.device_get(fwd(jrt.params_per_mesh[0], batch))
        out.append(jm.host_postprocess(res, 1)[0]["tokens"])
    return reqs, out


@pytest.mark.parametrize("pkg", PKGS)
def test_engine_matches_locked_batch_tokens(sides, reference_tokens, pkg):
    """Engine path == the package's locked-batch forward, token for token,
    and both == the reference's tokens (12 seeded requests, mixed lengths,
    greedy and temperature 0.7, admitted together so they share steps)."""
    model, rt = sides[pkg]
    reqs, want = reference_tokens
    eng, _m = make_engine(sides, pkg)

    async def go():
        await eng.start()
        res = await asyncio.gather(*(eng.submit(prompt_item(model, *r)) for r in reqs))
        await eng.stop()
        return [r["tokens"] for r in res]

    assert run(go()) == want
    if pkg == "port":
        locked_rt = port_build_runtime(model, device="cpu")
        locked = []
        for r in reqs[:4]:
            out = locked_rt.fetch(locked_rt.run((4,), model.assemble([prompt_item(model, *r)],
                                                                     (4,))))
            locked.append(model.host_postprocess(out, 1)[0]["tokens"])
        assert locked == want[:4]


@pytest.mark.parametrize("pkg", PKGS)
def test_deadline_eviction_mid_generation(sides, pkg):
    """A deadline landing mid-generation 504s at the stamped instant (within
    one chaos-slowed 10 ms iteration) and frees the slot."""
    model, _ = sides[pkg]
    eng, m = make_engine(sides, pkg)
    eng.injector = MODS[pkg].faults.FaultInjector.single("slow_dispatch", delay_ms=10.0)

    async def go():
        await eng.start()
        t0 = time.perf_counter()
        doomed = eng.submit(prompt_item(model, "doomed", seed=6, max_new=60),
                            deadline_at=t0 + 0.08)
        with pytest.raises(MODS[pkg].batcher.DeadlineExceeded):
            await doomed
        elapsed = time.perf_counter() - t0
        assert 0.08 <= elapsed < 0.4, elapsed
        assert counter(m, "gen_evictions_total") == 1
        assert counter(m, "deadline_exceeded_total") == 1
        eng.injector = None
        ok = await eng.submit(prompt_item(model, "alive", seed=7, max_new=2))
        assert ok["n_tokens"] == 2
        await eng.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_queued_deadline_expires_without_admission(sides, pkg):
    model, _ = sides[pkg]
    eng, m = make_engine(sides, pkg)

    async def go():
        await eng.start()
        fut = eng.submit(prompt_item(model, "late", seed=8, max_new=4),
                         deadline_at=time.perf_counter() - 0.001)
        with pytest.raises(MODS[pkg].batcher.DeadlineExceeded, match="in queue"):
            await fut
        assert counter(m, "gen_admitted_total") == 0
        await eng.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_zero_recompiles_across_churn_and_reload(sides, pkg):
    """Admit/retire churn with mixed lengths, a publish AND a rollback
    mid-churn: runtime_compiles_total (and on the port captures_total)
    move by 0; the slot ledger balances."""
    model, rt = sides[pkg]
    eng, _m = make_engine(sides, pkg)
    c0 = rt.compiles_total
    cap0 = getattr(rt, "captures_total", 0)
    assert c0 >= 3  # insert/step/extract registered

    async def go():
        await eng.start()
        futs = [eng.submit(prompt_item(model, f"p{i}", seed=i, max_new=2 + (i % 9)))
                for i in range(8)]
        rt.publish(rt.stage_params())  # reload mid-churn
        futs += [eng.submit(prompt_item(model, f"q{i}", seed=100 + i, max_new=2 + (i % 5)))
                 for i in range(8)]
        rt.rollback()
        futs += [eng.submit(prompt_item(model, f"r{i}", seed=200 + i, max_new=3))
                 for i in range(4)]
        res = await asyncio.gather(*futs)
        await eng.stop()
        return res

    res = run(go())
    assert len(res) == 20 and all(r["n_tokens"] >= 1 for r in res)
    assert rt.compiles_total == c0, (rt.compiles_total, c0)
    assert getattr(rt, "captures_total", 0) == cap0
    assert eng.arena.n_active == 0 and eng.arena.n_free == eng.slots


@pytest.mark.parametrize("pkg", PKGS)
def test_queue_full_sheds(sides, pkg):
    model, _ = sides[pkg]
    eng, m = make_engine(sides, pkg)
    eng.cfg.max_queue = 2

    async def go():
        await eng.start()
        try:
            eng.submit(prompt_item(model, "a", max_new=2))
            eng.submit(prompt_item(model, "b", max_new=2))
            with pytest.raises(MODS[pkg].batcher.QueueFull):
                eng.submit(prompt_item(model, "c", max_new=2))
            assert counter(m, "shed_total") == 1
        finally:
            eng.cfg.max_queue = 64
            await eng.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_cancelled_request_frees_slot(sides, pkg):
    model, _ = sides[pkg]
    eng, _m = make_engine(sides, pkg)

    async def go():
        await eng.start()
        fut = eng.submit(prompt_item(model, "gone", seed=9, max_new=60))
        await asyncio.sleep(0.02)
        assert eng.arena.n_active >= 1
        fut.cancel()
        ok = await eng.submit(prompt_item(model, "here", seed=10, max_new=2))
        assert ok["n_tokens"] == 2
        for _ in range(50):
            if eng.arena.n_active == 0:
                break
            await asyncio.sleep(0.01)
        assert eng.arena.n_active == 0
        await eng.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_step_failure_contained_and_loop_survives(sides, pkg):
    model, _ = sides[pkg]
    eng, m = make_engine(sides, pkg)
    f = MODS[pkg].faults

    async def go():
        await eng.start()
        eng.injector = f.FaultInjector.single("batch_error", count=1)
        with pytest.raises(f.FaultInjected):
            await eng.submit(prompt_item(model, "boom", seed=11, max_new=8))
        assert counter(m, "batch_errors_total") == 1
        ok = await eng.submit(prompt_item(model, "fine", seed=12, max_new=3))
        assert ok["n_tokens"] == 3
        eng.injector = None
        await eng.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_watchdog_revives_dead_step_loop(sides, pkg):
    model, _ = sides[pkg]
    eng, _m = make_engine(sides, pkg)

    async def go():
        await eng.start()
        eng.injector = MODS[pkg].faults.FaultInjector.single("kill_group_loop", count=1)
        fut = eng.submit(prompt_item(model, "stalled", seed=13, max_new=2))
        for _ in range(100):
            if eng._loop_task.done():
                break
            await asyncio.sleep(0.01)
        assert eng._loop_task.done()
        eng.injector = None
        assert eng.revive_group_loops() == 1
        res = await asyncio.wait_for(fut, timeout=10)
        assert res["n_tokens"] == 2
        assert eng.revive_group_loops() == 0
        await eng.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_drain_waits_for_mid_generation_work(sides, pkg):
    model, _ = sides[pkg]
    eng, _m = make_engine(sides, pkg)

    async def go():
        await eng.start()
        fut = eng.submit(prompt_item(model, "draining", seed=14, max_new=20))
        await asyncio.sleep(0.02)
        ok = await eng.drain(asyncio.get_running_loop().time() + 30.0)
        assert ok and fut.done() and (await fut)["n_tokens"] == 20
        await eng.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_staged_canary_runs_short_generation(sides, pkg):
    """The lifecycle's staged-canary hook: a candidate proves itself on a
    real generation without compiling; on the port it runs on the scratch
    state block, and a live block mid-generation keeps every byte."""
    model, rt = sides[pkg]
    eng, _m = make_engine(sides, pkg)
    staged = rt.stage_params()
    eng.staged_canary_sync(staged)
    c0 = rt.compiles_total
    if pkg == "port":
        rt.run_program("insert", np.array([1]), prompt_item(model, "live lane", 5, 9),
                       block=LIVE_BLOCK)
        live = {k: t.clone() for k, t in rt.state_blocks[LIVE_BLOCK].items()}
    eng.staged_canary_sync(staged)
    assert rt.compiles_total == c0
    if pkg == "port":
        for k, t in rt.state_blocks[LIVE_BLOCK].items():
            assert torch.equal(t, live[k]), k
        rt.zero_state(LIVE_BLOCK)


@pytest.mark.parametrize("pkg", PKGS)
def test_flash_prefill_matches_dense(sides, weights, pkg):
    """attention = "flash" routes the prompt prefill through K1 (the port's
    plain version on the CPU; the reference's kernel in interpret mode):
    tokens equal the dense twin's on the same weights."""
    model_d, _ = sides[pkg]
    model_f, rt_f = build_side(pkg, weights, compile_forward=True,
                               options={**TG_OPTS, "attention": "flash"})
    _, rt_d = build_side(pkg, weights, compile_forward=True)
    item = prompt_item(model_d, "flash parity prompt", seed=21, max_new=9, temp=0.7)
    outs = [rt.fetch(rt.run((1,), m.assemble([item], (1,))))
            for m, rt in ((model_d, rt_d), (model_f, rt_f))]
    res = [m.host_postprocess(o, 1)[0] for m, o in zip((model_d, model_f), outs)]
    assert res[0]["tokens"] == res[1]["tokens"] and res[0]["n_tokens"] == 9


# ---------------------------------------------------------------------------
# Generative cache-key contract
# ---------------------------------------------------------------------------

def test_generation_cache_keys_include_sampling_params(sides):
    """Two prompts differing ONLY in seed / temperature / max_new_tokens
    digest to distinct keys; identical ones to the same key; and the port's
    digests equal the reference's."""
    digests = {}
    for pkg in PKGS:
        model, _ = sides[pkg]
        d = MODS[pkg].cache.item_digest
        digests[pkg] = [d(prompt_item(model, "same prompt", seed=1, max_new=8)),
                        d(prompt_item(model, "same prompt", seed=2, max_new=8)),
                        d(prompt_item(model, "same prompt", seed=1, max_new=9)),
                        d(prompt_item(model, "same prompt", seed=1, max_new=8, temp=0.7)),
                        d(prompt_item(model, "same prompt", seed=1, max_new=8))]
        assert len(set(digests[pkg][:4])) == 4 and digests[pkg][4] == digests[pkg][0]
    assert digests["port"] == digests["jax"]


def test_cacheable_false_skips_server_cache():
    from tpuserve_torch.server import ServerState

    cfg = tconfig.ServerConfig(
        decode_threads=2, startup_canary=False, cache=tconfig.CacheConfig(enabled=True),
        models=[tconfig.ModelConfig(name="toy", family="toy", batch_buckets=[1, 2],
                                    dtype="float32", num_classes=10, parallelism="single",
                                    cacheable=False)])
    state = ServerState(cfg, device="cpu")
    state.build()

    async def go():
        await state.start()
        try:
            assert state.caches == {}
        finally:
            await state.stop()

    run(go())


GENSERVE_TOML = """
[genserve]
enabled = true
slots = 6
admit_per_step = 2
kv_paging = true
kv_page_tokens = 8
prefill_chunk = 4

[[model]]
name = "tg"
family = "textgen"
cacheable = false
"""


def test_genserve_config_toml(tmp_path):
    p = tmp_path / "g.toml"
    p.write_text(GENSERVE_TOML)
    cfgs = {pkg: MODS[pkg].config.load_config(str(p)) for pkg in PKGS}
    for cfg in cfgs.values():
        assert cfg.genserve.enabled and cfg.genserve.slots == 6
        assert cfg.genserve.admit_per_step == 2
        assert cfg.models[0].cacheable is False
    assert dataclasses.asdict(cfgs["port"].genserve) == dataclasses.asdict(cfgs["jax"].genserve)
    assert tconfig.unported_settings(cfgs["port"]) == []
    for pkg in PKGS:
        with pytest.raises(ValueError, match="admit_per_step"):
            MODS[pkg].config.GenserveConfig(admit_per_step=-1)
    # Streaming's knobs are served, typed as the reference types them.
    p.write_text(GENSERVE_TOML.replace(
        "slots = 6", "slots = 6\nstream_queue = 8\nstream_heartbeat_s = 0.5\n"
                     "stream_drain_s = 2.0"))
    cfgs = {pkg: MODS[pkg].config.load_config(str(p)) for pkg in PKGS}
    assert dataclasses.asdict(cfgs["port"].genserve) == dataclasses.asdict(cfgs["jax"].genserve)
    assert cfgs["port"].genserve.stream_queue == 8
    assert tconfig.unported_settings(cfgs["port"]) == []
    for pkg in PKGS:
        with pytest.raises(ValueError, match="stream_queue"):
            MODS[pkg].config.GenserveConfig(stream_queue=0)


# ---------------------------------------------------------------------------
# HTTP front door through the engine (the port's server)
# ---------------------------------------------------------------------------

JSON_HDR = {"Content-Type": "application/json"}


class Served:
    """The port's server on an ephemeral port in a background loop."""

    def __init__(self, weights, genserve=None, **server_over) -> None:
        from tpuserve_torch.server import ServerState, start_server

        cfg = tconfig.ServerConfig(
            decode_threads=2,
            genserve=genserve or tconfig.GenserveConfig(enabled=True, slots=4),
            models=[tg_cfg("port", weights=weights[1])], **server_over)
        self.state = ServerState(cfg, device="cpu")
        self.state.build()
        self.loop = asyncio.new_event_loop()
        threading.Thread(target=self.loop.run_forever, daemon=True).start()
        self.srv = self.on_loop(start_server(self.state, "127.0.0.1", 0))
        self.port = self.state.serving_addresses[0][1]

    def on_loop(self, coro, timeout: float = 60.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def call(self, method: str, path: str, body=None) -> tuple[int, bytes, dict]:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            data = json.dumps(body).encode() if isinstance(body, dict) else body
            conn.request(method, path, body=data, headers=JSON_HDR)
            r = conn.getresponse()
            return r.status, r.read(), dict(r.getheaders())
        finally:
            conn.close()

    def close(self) -> None:
        from tpuserve_torch.server import stop_server

        self.on_loop(stop_server(self.state, self.srv))
        self.loop.call_soon_threadsafe(self.loop.stop)


@pytest.fixture
def served(weights):
    holder = []

    def make(**kw):
        holder.append(Served(weights, **kw))
        return holder[-1]

    yield make
    for s in holder:
        s.close()


def test_http_textgen_through_engine(served, reference_tokens):
    s = served()
    state = s.state
    st, body, hdrs = s.call("POST", "/v1/models/tg:generate",
                            {"prompt": "hello", "seed": 4, "max_new_tokens": 6})
    assert st == 200, body
    out = json.loads(body)
    assert out["n_tokens"] == 6 and len(out["tokens"]) == 6 and "X-Trace-Id" in hdrs
    # The reference's tokens over HTTP too (its locked forward, same weights).
    reqs, want = reference_tokens
    prompt, seed, max_new, temp = reqs[0]
    st, body, _ = s.call("POST", "/v1/models/tg:predict",
                         {"prompt": prompt, "seed": seed, "max_new_tokens": max_new,
                          "temperature": temp})
    assert st == 200 and json.loads(body)["tokens"] == want[0]
    # Engine-served: no forward bucket, only the three programs.
    rt = state.runtimes["tg"]
    assert rt.compile_forward is False
    assert {tuple(v["bucket"]) for v in rt.variants_summary()} == \
        {("extract", 4), ("insert", 4), ("step", 4)}
    stats = json.loads(s.call("GET", "/stats")[1])
    assert stats["genserve"]["tg"]["mode"] == "genserve"
    assert stats["pipeline"]["models"]["tg"]["mode"] == "genserve"
    metrics = s.call("GET", "/metrics")[1].decode()
    assert 'gen_iterations_total{model="tg"}' in metrics
    bad = s.call("POST", "/v1/models/tg:generate", {"prompt": "x", "max_new_tokens": 10_000})
    assert bad[0] == 400
    # A per-request deadline inside a chaos-slowed generation: fast 504.
    state.batchers["tg"].injector = tfaults.FaultInjector.single("slow_dispatch",
                                                                 delay_ms=10.0)
    try:
        slow = s.call("POST", "/v1/models/tg:generate?timeout_ms=50",
                      {"prompt": "slow", "seed": 1, "max_new_tokens": 64})
        assert slow[0] == 504, slow[1]
    finally:
        state.batchers["tg"].injector = None


def test_http_stream_flag_refused(served):
    """?stream=true is never answered as a plain body: it streams SSE (two
    token events and one done for 2 tokens); junk values are refused with
    a 400; stream=false answers the unary body."""
    s = served()
    st, body, hdrs = s.call("POST", "/v1/models/tg:generate?stream=true",
                            {"prompt": "hello", "max_new_tokens": 2})
    assert st == 200 and hdrs["Content-Type"] == "text/event-stream"
    assert hdrs["X-Tpuserve-Stream"] == "1"
    events = [e for e, _ in tbench_loadgen.SseParser().feed(body)]
    assert events == ["token", "token", "done"]
    assert s.call("POST", "/v1/models/tg:generate?stream=maybe", {"prompt": "x"})[0] == 400
    st, body, _ = s.call("POST", "/v1/models/tg:generate?stream=false",
                         {"prompt": "hello", "max_new_tokens": 2})
    assert st == 200 and json.loads(body)["n_tokens"] == 2


def test_http_reload_engine_staged_canary(served):
    """:reload on an engine-served model runs the engine's staged canary
    and publishes with zero new compiles; an injected regression rejects at
    the staged_canary gate with the old version serving."""
    s = served()
    state = s.state
    c0 = state.metrics.counter("runtime_compiles_total{model=tg}").value
    st, body, _ = s.call("POST", "/admin/models/tg:reload")
    assert st == 200, body
    assert json.loads(body)["version"] == 2
    assert state.metrics.counter("runtime_compiles_total{model=tg}").value == c0
    state.lifecycles["tg"].injector = tfaults.FaultInjector.single("reload_regressed",
                                                                   count=1)
    try:
        st, body, _ = s.call("POST", "/admin/models/tg:reload")
        assert st == 409 and json.loads(body)["stage"] == "staged_canary"
        ok = s.call("POST", "/v1/models/tg:generate",
                    {"prompt": "still here", "seed": 2, "max_new_tokens": 3})
        assert ok[0] == 200
        assert state.runtimes["tg"].version == 2
        st, body, _ = s.call("POST", "/admin/models/tg:rollback")
        assert st == 200 and json.loads(body)["version"] == 1
        assert state.metrics.counter("runtime_compiles_total{model=tg}").value == c0
    finally:
        state.lifecycles["tg"].injector = None


def test_http_cache_hits_generative(served):
    s = served(cache=tconfig.CacheConfig(enabled=True))
    body = {"prompt": "cache me", "seed": 7, "max_new_tokens": 4}
    r1 = s.call("POST", "/v1/models/tg:generate", body)
    r2 = s.call("POST", "/v1/models/tg:generate", body)
    assert r1[0] == r2[0] == 200 and r2[1] == r1[1]
    c = s.state.caches["tg"].stats()
    assert c["hits"] == 1 and c["misses"] == 1
    r3 = s.call("POST", "/v1/models/tg:generate", dict(body, seed=8))
    assert r3[0] == 200
    assert s.state.caches["tg"].stats()["misses"] == 2


def test_http_genserve_off_serves_locked_batches(served, reference_tokens):
    """[genserve] enabled = false: textgen serves as locked batches through
    the batcher, its forward buckets captured like every family's, with the
    reference's tokens."""
    s = served(genserve=tconfig.GenserveConfig(enabled=False))
    assert s.state.engines == {}
    reqs, want = reference_tokens
    for (prompt, seed, max_new, temp), tokens in list(zip(reqs, want))[:3]:
        st, body, _ = s.call("POST", "/v1/models/tg:generate",
                             {"prompt": prompt, "seed": seed, "max_new_tokens": max_new,
                              "temperature": temp})
        assert st == 200 and json.loads(body)["tokens"] == tokens
    stats = json.loads(s.call("GET", "/stats")[1])
    assert "genserve" not in stats
    assert stats["pipeline"]["models"]["tg"].get("mode") != "genserve"
    assert {tuple(v["bucket"]) for v in s.state.runtimes["tg"].variants_summary()} == \
        {(1,), (2,), (4,)}
