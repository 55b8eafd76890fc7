"""The paged KV cache and chunked prefill of the port's generation engine
beside the reference's, scenario by scenario from
``tests/test_genserve_paged.py``, on the CPU: each scenario on both packages
(``pkg``), textgen at the reference tests' tiny options (1 layer, d 32,
vocab 512, float32) on the same weights (the reference runtime's seeded
tree, as the port's ``.npz``).

Held on both alike: page-ledger safety; the config checks; paged tokens
identical to dense tokens (and, across packages, to the reference's paged
tokens, exactly — greedy and temperatures 0.3-1.0); zero new compiles
across page and slot churn, publish and rollback, with every page returned;
chunked prefill deterministic alone and amid decode load, and equal across
packages; chunked prefill never starving decode; the ``KVPressure`` shed
past one pool turnover of backlog; ``kv_clear_s``; and over HTTP the 503
with reason ``kv_pressure``, a Retry-After, and the ``/stats`` kv block and
page gauges.
"""

import asyncio
import json
import time

import pytest

from test_torch_genserve import MODS, PKGS, build_side, counter, prompt_item, run, weights  # noqa: F401
from tpuserve_torch import config as tconfig


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def paged_over(**over):
    base = dict(kv_paging=True, kv_page_tokens=8)
    base.update(over)
    return base


def engine_rt(pkg: str, weights, **gc):
    """(model, runtime) with the engine programs registered for ``gc``'s
    geometry (the pool size and chunk width are part of the state block)."""
    model, rt = build_side(pkg, weights)
    MODS[pkg].genserve.GenEngine(model, rt, MODS[pkg].obs.Metrics(),
                                 MODS[pkg].config.GenserveConfig(slots=4, **gc)).compile()
    return model, rt


@pytest.fixture(scope="module")
def dense(weights):
    return {pkg: engine_rt(pkg, weights) for pkg in PKGS}


@pytest.fixture(scope="module")
def paged(weights):
    return {pkg: engine_rt(pkg, weights, **paged_over()) for pkg in PKGS}


@pytest.fixture(scope="module")
def chunked(weights):
    return {pkg: engine_rt(pkg, weights, **paged_over(prefill_chunk=4)) for pkg in PKGS}


def make_engine(fix, pkg: str, slots: int = 4, **gc_over):
    model, rt = fix[pkg]
    mods = MODS[pkg]
    m = mods.obs.Metrics()
    eng = mods.genserve.GenEngine(model, rt, m, mods.config.GenserveConfig(slots=slots,
                                                                           **gc_over))
    eng.compile()
    return eng, m


# ---------------------------------------------------------------------------
# PageLedger: never double-hands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_page_ledger_never_double_hands(pkg):
    g = MODS[pkg].genserve
    led = g.PageLedger(4, 8)
    assert led.usable == 3 and led.n_free == 3
    assert led.acquire(0, 2) == [1, 2]
    assert led.acquire(1, 1) == [3] and led.n_free == 0
    with pytest.raises(IndexError, match="exhausted"):
        led.acquire(2, 1)
    with pytest.raises(g.PageCorrupted, match="double reservation"):
        led.acquire(0, 1)
    assert led.release(0) == [1, 2]
    with pytest.raises(g.PageCorrupted, match="holds no pages"):
        led.release(0)
    with pytest.raises(g.PageCorrupted):
        led.release(7)
    led._free.append(3)
    with pytest.raises(g.PageCorrupted, match="double-hand"):
        led.acquire(5, 1)


@pytest.mark.parametrize("pkg", PKGS)
def test_page_ledger_release_all_and_stats(pkg):
    g = MODS[pkg].genserve
    led = g.PageLedger(6, 16)
    led.acquire(0, 2)
    led.acquire(1, 3)
    s = led.stats()
    assert s["usable"] == 5 and s["reserved"] == 5 and s["free"] == 0
    assert s["utilization"] == 1.0 and s["acquires_total"] == 5
    assert led.snapshot() == {"free": 0, "reserved": 5, "usable": 5, "utilization": 1.0}
    assert led.release_all() == 5
    assert led.n_free == led.usable and led.n_reserved == 0
    with pytest.raises(ValueError):
        g.PageLedger(1, 8)
    with pytest.raises(ValueError):
        g.PageLedger(4, 0)


@pytest.mark.parametrize("pkg", PKGS)
def test_kv_config_validation(paged, pkg):
    c = MODS[pkg].config
    with pytest.raises(ValueError, match="kv_pages"):
        c.GenserveConfig(kv_pages=1)
    with pytest.raises(ValueError, match="kv_page_tokens"):
        c.GenserveConfig(kv_page_tokens=0)
    with pytest.raises(ValueError, match="prefill_chunk"):
        c.GenserveConfig(prefill_chunk=-1)
    model, rt = paged[pkg]
    with pytest.raises(ValueError, match="cover"):
        MODS[pkg].genserve.GenEngine(model, rt, MODS[pkg].obs.Metrics(),
                                     c.GenserveConfig(slots=4, **paged_over(kv_pages=5)))


# ---------------------------------------------------------------------------
# Parity
# ---------------------------------------------------------------------------

PROMPTS = [
    ("a", 1, 3, 0.0),
    ("the quick brown fox jumps over the lazy dog again and again", 2, 12, 0.7),
    ("short prompt", 3, 1, 0.0),
    ("one two three four five six seven eight nine ten eleven twelve "
     "thirteen fourteen fifteen sixteen", 4, 8, 0.3),
    ("hello", 5, 20, 1.0),
    ("mid size prompt with a few words", 6, 5, 0.0),
]


def drive(eng, model, prompts=PROMPTS):
    async def go():
        await eng.start()
        res = await asyncio.gather(*(eng.submit(prompt_item(model, *p)) for p in prompts))
        await eng.stop()
        return [r["tokens"] for r in res]

    return run(go())


@pytest.fixture(scope="module")
def paged_tokens(dense, paged):
    """Dense and paged engine tokens per package."""
    out = {}
    for pkg in PKGS:
        d_eng, _ = make_engine(dense, pkg)
        p_eng, _ = make_engine(paged, pkg, **paged_over())
        out[pkg] = (drive(d_eng, dense[pkg][0]), drive(p_eng, paged[pkg][0]), p_eng)
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_paged_matches_dense_token_identical(paged_tokens, pkg):
    """The whole-prompt paged prefill is the dense prefill with K/V stored
    in pages, and the paged decode the same attention through the block
    table: byte-identical tokens; every page came home."""
    dense_tok, paged_tok, p_eng = paged_tokens[pkg]
    assert dense_tok == paged_tok
    assert p_eng.pages.n_free == p_eng.pages.usable and p_eng.pages.n_reserved == 0


def test_paged_tokens_equal_the_reference(paged_tokens):
    assert paged_tokens["port"][1] == paged_tokens["jax"][1]


@pytest.mark.parametrize("pkg", PKGS)
def test_paged_zero_recompiles_across_churn_and_reload(paged, pkg):
    model, rt = paged[pkg]
    eng, _m = make_engine(paged, pkg, **paged_over())
    c0 = rt.compiles_total
    cap0 = getattr(rt, "captures_total", 0)
    assert c0 >= 3  # prefill/step/extract registered

    async def go():
        await eng.start()
        futs = [eng.submit(prompt_item(model, f"p{i} " + "w " * (i % 13), seed=i,
                                       max_new=1 + (i % 9))) for i in range(8)]
        rt.publish(rt.stage_params())
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
    assert rt.compiles_total == c0 and getattr(rt, "captures_total", 0) == cap0
    assert eng.arena.n_active == 0 and eng.arena.n_free == eng.slots
    assert eng.pages.n_reserved == 0 and eng.pages.n_free == eng.pages.usable


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------

LONG16 = ("one two three four five six seven eight nine ten eleven twelve "
          "thirteen fourteen fifteen sixteen")


@pytest.fixture(scope="module")
def chunked_runs(chunked):
    """Per package: the long prompt's tokens prefilled in 4-token chunks
    alone, and amid decode load."""
    out = {}
    for pkg in PKGS:
        model, _ = chunked[pkg]
        e_alone, _ = make_engine(chunked, pkg, **paged_over(prefill_chunk=4))
        e_load, _ = make_engine(chunked, pkg, **paged_over(prefill_chunk=4))
        alone = drive(e_alone, model, [(LONG16, 9, 8, 0.5)])[0]

        async def amid_load(eng=e_load, model=model):
            await eng.start()
            futs = [eng.submit(prompt_item(model, "short one", seed=i + 1, max_new=3))
                    for i in range(3)]
            long_f = eng.submit(prompt_item(model, LONG16, seed=9, max_new=8, temp=0.5))
            futs += [eng.submit(prompt_item(model, "another short", seed=i + 10, max_new=4))
                     for i in range(3)]
            res = await asyncio.gather(long_f, *futs)
            await eng.stop()
            return res[0]["tokens"]

        out[pkg] = (alone, run(amid_load()), e_alone, e_load)
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_chunked_prefill_deterministic_under_load(chunked_runs, pkg):
    alone, loaded, e_alone, e_load = chunked_runs[pkg]
    assert alone == loaded
    assert e_alone.pages.n_reserved == 0 and e_load.pages.n_reserved == 0


def test_chunked_tokens_equal_the_reference(chunked_runs):
    assert chunked_runs["port"][0] == chunked_runs["jax"][0]


@pytest.mark.parametrize("pkg", PKGS)
def test_chunked_prefill_never_starves_decode(chunked, pkg):
    model, _ = chunked[pkg]
    eng, m = make_engine(chunked, pkg, **paged_over(prefill_chunk=4))

    async def go():
        await eng.start()
        order = []
        long_f = eng.submit(prompt_item(model, LONG16, seed=1, max_new=8))
        long_f.add_done_callback(lambda f: order.append("long"))
        shorts = []
        for i in range(3):
            f = eng.submit(prompt_item(model, "hi", seed=10 + i, max_new=2))
            f.add_done_callback(lambda f, i=i: order.append(f"s{i}"))
            shorts.append(f)
        await asyncio.gather(long_f, *shorts)
        await eng.stop()
        return order

    order = run(go())
    assert order[-1] == "long", order
    assert set(order[:-1]) == {"s0", "s1", "s2"}
    assert counter(m, "gen_prefill_chunks_total") == pytest.approx(7)


# ---------------------------------------------------------------------------
# Page-pressure admission
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_pool(weights):
    """11 pages (10 usable, backlog bound 20): its own runtime, since the
    pool size is part of the state block."""
    return {pkg: engine_rt(pkg, weights, **paged_over(kv_pages=11)) for pkg in PKGS}


@pytest.mark.parametrize("pkg", PKGS)
def test_kv_pressure_sheds_beyond_backlog_bound(small_pool, pkg):
    model, _ = small_pool[pkg]
    eng, m = make_engine(small_pool, pkg, **paged_over(kv_pages=11))

    async def go():
        await eng.start()
        item = lambda s: prompt_item(model, "hold the pool please", seed=s,  # noqa: E731
                                     max_new=60)
        f1, f2 = eng.submit(item(1)), eng.submit(item(2))
        with pytest.raises(MODS[pkg].genserve.KVPressure, match="kv page pool exhausted"):
            eng.submit(item(3))  # projected 24 > 20
        with pytest.raises(MODS[pkg].batcher.QueueFull):  # a QueueFull subclass
            eng.submit(item(4))
        await asyncio.gather(f1, f2)
        await eng.stop()

    run(go())
    assert m.counter("sched_sheds_total{model=tg,reason=kv_pressure}").value == 2
    assert eng.pages.n_reserved == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_kv_clear_s(paged, pkg):
    """None while the pool is comfortable; a positive clear time once
    pressure and evidence exist; estimate_clear_s adds it."""
    eng, _ = make_engine(paged, pkg, **paged_over())
    assert eng.kv_clear_s() is None
    eng._ewma_step_ms = 10.0
    eng._ewma_iters = 5.0
    eng._ewma_pages = float(eng.pages.usable + 1)
    assert eng.kv_clear_s() == pytest.approx(0.05)
    assert eng.estimate_clear_s() is None  # nothing queued
    assert eng.predicted_service_s() == pytest.approx(0.05)


# ---------------------------------------------------------------------------
# HTTP: 503 + Retry-After + observability (the port's server)
# ---------------------------------------------------------------------------

def test_http_kv_pressure_503_and_stats(weights):
    from test_torch_genserve import Served

    s = Served(weights, genserve=tconfig.GenserveConfig(
        enabled=True, slots=4, kv_paging=True, kv_page_tokens=8, kv_pages=11))
    try:
        st, body, _ = s.call("POST", "/v1/models/tg:generate",
                             {"prompt": "warm", "seed": 1, "max_new_tokens": 2})
        assert st == 200, body
        eng = s.state.batchers["tg"]
        req = lambda sd: {"prompt": "hold the pool please", "seed": sd,  # noqa: E731
                          "max_new_tokens": 60}

        async def hold():
            items = [eng.model.host_decode(json.dumps(req(sd)).encode(), "application/json")
                     for sd in (1, 2)]
            return [eng.submit(it) for it in items]

        futs = s.on_loop(hold())
        st, body, hdrs = s.call("POST", "/v1/models/tg:generate", req(3))
        assert st == 503, body
        assert json.loads(body)["reason"] == "kv_pressure"
        assert int(hdrs["Retry-After"]) >= 1
        stats = json.loads(s.call("GET", "/stats")[1])
        kv = stats["genserve"]["tg"]["kv"]
        assert kv["pages"] == 11 and kv["page_tokens"] == 8 and kv["kv_bytes"] > 0
        assert stats["genserve"]["tg"]["per_replica"][0]["kv"]["usable"] == 10
        metrics = s.call("GET", "/metrics")[1].decode()
        for name in ('gen_kv_pages_total{model="tg"}', 'gen_kv_pages_free{model="tg"}',
                     'gen_kv_page_utilization{model="tg"}',
                     'sched_sheds_total{model="tg",reason="kv_pressure"}'):
            assert name in metrics, name

        async def settle():
            return await asyncio.gather(*futs)

        res = s.on_loop(settle(), timeout=120)
        assert [r["n_tokens"] for r in res] == [60, 60]
        deadline = time.monotonic() + 10
        while eng.pages.n_reserved and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.pages.n_reserved == 0
    finally:
        s.close()
