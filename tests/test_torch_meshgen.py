"""Generation on replicas (``genserve.GenEngineGroup`` over a replica-mode
runtime) beside the reference's ``tests/test_meshgen.py``, on the CPU, and
the fleet scheduler's chip budget by parallelism degree.

The JAX side runs on its conftest's 8 fake host devices, the port's with
``mesh.visible_devices`` patched to ``["cpu"] * 8``; textgen at the
reference tests' tiny options (1 layer, d 32, vocab 512, float32, paged KV)
on the same weights (the reference runtime's seeded tree, as the port's
``.npz``).

Exact: the group's tokens equal the port's single engine's and the
reference group's, greedy and sampled; under sustained mixed load every
replica steps (the ``per_replica`` rows and the ``gen_replica_*`` metric
rows); the staged canary fans to every replica and a failure names it;
``runtime_compiles_total`` counts replicas x programs at startup and does
not move across churn, publish and rollback; the chip budget counts a
replica@4 model as 4. The sharded decode (``tp = 2`` over 4 ranks, data 2
x model 2, paged KV) gives the single engine's tokens and the reference's
sharded decode's, and the locked batch the single runtime's; no compile
across churn, publish and rollback; beside a seq axis (the KV context over
it) the single engine's tokens again.
"""

import asyncio

import pytest

from test_torch_genserve import (MODS, PKGS, prompt_item, run, tg_cfg,  # noqa: F401
                                 weights)
from tpuserve.models import build as jax_build
from tpuserve.runtime import build_runtime as jax_build_runtime
from tpuserve_torch.models import build as port_build
from tpuserve_torch.parallel import mesh as meshlib
from tpuserve_torch.runtime import build_runtime as port_build_runtime

N_REP = 4
PROMPTS = [
    ("a", 1, 3, 0.0),
    ("the quick brown fox jumps over the lazy dog again and again", 2, 12, 0.7),
    ("short prompt", 3, 1, 0.0),
    ("one two three four five six seven eight nine ten eleven twelve", 4, 8, 0.3),
    ("hello", 5, 20, 1.0),
    ("mid size prompt with a few words", 6, 5, 0.0),
]


@pytest.fixture(scope="module", autouse=True)
def eight():
    mp = pytest.MonkeyPatch()
    mp.setattr(meshlib, "visible_devices", lambda *a: ["cpu"] * 8)
    yield
    mp.undo()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def paged(pkg):
    return MODS[pkg].config.GenserveConfig(slots=4, kv_paging=True, kv_page_tokens=8)


def side(pkg, weights, **over):
    """(model, runtime) of one package on the shared weights, engine-served."""
    mods = MODS[pkg]
    parallel = mods.config.ParallelConfig(n_chips=N_REP)
    if pkg == "jax":
        model = jax_build(tg_cfg("jax", **over))
        return model, jax_build_runtime(model, compile_forward=False, parallel=parallel)
    model = port_build(tg_cfg("port", weights=weights[1], **over))
    return model, port_build_runtime(model, device="cpu", compile_forward=False,
                                     parallel=parallel)


@pytest.fixture(scope="module")
def groups(weights):
    out = {}
    for pkg in PKGS:
        model, rt = side(pkg, weights, parallelism="replica")
        met = MODS[pkg].obs.Metrics()
        MODS[pkg].genserve.GenEngineGroup(model, rt, met, paged(pkg)).compile()
        out[pkg] = (model, rt, met)
    return out


@pytest.fixture(scope="module")
def single(weights):
    model, rt = side("port", weights)
    MODS["port"].genserve.GenEngine(model, rt, MODS["port"].obs.Metrics(),
                                    paged("port")).compile()
    return model, rt


async def drive(eng, model, prompts):
    await eng.start()
    futs = [eng.submit(prompt_item(model, p, seed=s, max_new=n, temp=t))
            for (p, s, n, t) in prompts]
    res = await asyncio.gather(*futs)
    await eng.stop()
    return [list(r["tokens"]) for r in res]


def group(fix, pkg):
    model, rt, met = fix[pkg]
    grp = MODS[pkg].genserve.GenEngineGroup(model, rt, met, paged(pkg))
    grp.compile()
    return grp


@pytest.mark.parametrize("pkg", PKGS)
def test_replica_signature_and_compiles(groups, pkg):
    model, rt, _ = groups[pkg]
    assert rt.parallel_signature == f"replica@{N_REP}"
    assert rt.n_chips == rt.n_replicas == N_REP
    # Replicas x programs (paged: prefill, step, extract) at startup.
    assert rt.compiles_total == N_REP * 3
    assert rt.compiles_total == groups["jax" if pkg == "port" else "port"][1].compiles_total


def test_replica_group_parity_with_single_and_reference(groups, single):
    s_model, s_rt = single
    s_eng = MODS["port"].genserve.GenEngine(s_model, s_rt, MODS["port"].obs.Metrics(),
                                            paged("port"))
    s_eng.compile()
    base = run(drive(s_eng, s_model, PROMPTS[:4]))
    out = {pkg: run(drive(group(groups, pkg), groups[pkg][0], PROMPTS[:4]))
           for pkg in PKGS}
    assert out["port"] == base == out["jax"], out


def test_replica_group_balanced_under_sustained_mixed_load(groups):
    """Least-loaded placement keeps every replica generating: each
    replica's steps and units are nonzero on the per_replica rows and the
    gen_replica_* metric rows; the rows' units decompose the total; no
    compile across the run."""
    model, rt, met = groups["port"]
    grp = group(groups, "port")
    assert len(grp.engines) == N_REP and grp.slots == 4 * N_REP
    c0 = rt.compiles_total

    async def load():
        await grp.start()
        futs = [grp.submit(prompt_item(model, f"prompt number {i}", seed=i,
                                       max_new=4 + i % 9, temp=(0.0, 0.4, 0.9)[i % 3]))
                for i in range(24)]
        res = await asyncio.gather(*futs)
        ok = await grp.drain(asyncio.get_running_loop().time() + 10)
        await grp.stop()
        return res, ok

    res, ok = run(load())
    assert ok and len(res) == 24
    rows = grp.pipeline_stats()["per_replica"]
    assert [r["replica"] for r in rows] == list(range(N_REP))
    assert all(r["steps_total"] > 0 and r["units_total"] > 0 for r in rows), rows
    assert all(r["kv"]["free"] == r["kv"]["usable"] for r in rows), rows
    for i in range(N_REP):
        assert met.counter(f"gen_replica_steps_total{{model=tg,replica={i}}}").value > 0
    assert sum(r["units_total"] for r in rows) == sum(
        met.counter(f"gen_replica_units_total{{model=tg,replica={i}}}").value
        for i in range(N_REP))
    assert rt.compiles_total == c0


def test_replica_group_canary_fanout(groups):
    model, rt, _ = groups["port"]
    grp = group(groups, "port")
    c0 = rt.compiles_total
    grp.staged_canary_sync(rt.stage_params())
    assert rt.compiles_total == c0
    with pytest.raises(ValueError, match=r"staged canary failed on replica 0"):
        grp.staged_canary_sync({"not": "a-param-tree"})


def test_replica_group_zero_recompiles_across_reload(groups):
    model, rt, _ = groups["port"]
    grp = group(groups, "port")
    c0 = rt.compiles_total

    async def churn():
        await grp.start()
        await asyncio.gather(*[grp.submit(prompt_item(model, f"pre {i}", seed=i, max_new=5))
                               for i in range(8)])
        rt.publish(rt.stage_params())
        await asyncio.gather(*[grp.submit(prompt_item(model, f"post {i}", seed=i,
                                                      max_new=5, temp=0.6))
                               for i in range(8)])
        rt.rollback()
        await asyncio.gather(*[grp.submit(prompt_item(model, f"back {i}", seed=i, max_new=4))
                               for i in range(4)])
        await grp.stop()

    run(churn())
    assert rt.compiles_total == c0


# -- the sharded decode (tp = 2 over 4 ranks: data 2 x model 2) ------------------

@pytest.fixture(scope="module")
def sharded(weights):
    out = {}
    for pkg in PKGS:
        model, rt = side(pkg, weights, parallelism="sharded", tp=2)
        MODS[pkg].genserve.GenEngine(model, rt, MODS[pkg].obs.Metrics(), paged(pkg)).compile()
        out[pkg] = (model, rt)
    return out


def engine(fix, pkg):
    model, rt = fix[pkg]
    eng = MODS[pkg].genserve.GenEngine(model, rt, MODS[pkg].obs.Metrics(), paged(pkg))
    eng.compile()
    return eng


def test_sharded_signature_and_geometry(sharded):
    for pkg in PKGS:
        _, rt = sharded[pkg]
        assert rt.parallel_signature == "sharded@d2"
        assert (rt.n_chips, rt.n_replicas) == (4, 1)
    rt = sharded["port"][1]
    # Each model rank holds its heads' columns (d 32, 2 heads over 2 ranks).
    assert [r.layers[0].wq.shape[1] for r in rt.module.ranks] == [16, 16]


def test_sharded_matches_single_and_reference_token_identical(sharded, single):
    """Tensor-parallel decode with paged KV: the same tokens as the single
    engine and as the reference's sharded decode, greedy and sampled, and
    both page ledgers balanced after the drain."""
    s_model, s_rt = single
    s_eng = MODS["port"].genserve.GenEngine(s_model, s_rt, MODS["port"].obs.Metrics(),
                                            paged("port"))
    s_eng.compile()
    base = run(drive(s_eng, s_model, PROMPTS))
    engines = {pkg: engine(sharded, pkg) for pkg in PKGS}
    out = {pkg: run(drive(engines[pkg], sharded[pkg][0], PROMPTS)) for pkg in PKGS}
    assert out["port"] == base == out["jax"], out
    eng = engines["port"]
    assert eng.pages.n_free == eng.pages.usable and eng.pages.n_reserved == 0


def test_sharded_zero_recompiles_across_churn_and_reload(sharded):
    model, rt = sharded["port"]
    eng = engine(sharded, "port")
    c0 = rt.compiles_total

    async def churn():
        await eng.start()
        await asyncio.gather(*[eng.submit(prompt_item(model, f"wave one {i}", seed=i,
                                                      max_new=4 + i % 5)) for i in range(8)])
        rt.publish(rt.stage_params())
        await asyncio.gather(*[eng.submit(prompt_item(model, f"wave two {i}", seed=10 + i,
                                                      max_new=3 + i % 7, temp=0.5))
                               for i in range(8)])
        rt.rollback()
        await asyncio.gather(*[eng.submit(prompt_item(model, f"wave three {i}", seed=20 + i,
                                                      max_new=6)) for i in range(4)])
        await eng.stop()

    run(churn())
    assert rt.compiles_total == c0
    assert eng.arena.n_free == eng.slots and eng.pages.n_free == eng.pages.usable


def test_sharded_locked_batch_matches_single(weights, single):
    """[genserve] off: the locked batch's forward over the model ranks gives
    the single runtime's tokens."""
    s_model, _ = single
    kw = dict(compile_forward=True)
    model = port_build(tg_cfg("port", weights=weights[1], parallelism="sharded", tp=2))
    rt = port_build_runtime(model, device="cpu", parallel=MODS["port"].config.ParallelConfig(
        n_chips=2), **kw)
    one = port_build(tg_cfg("port", weights=weights[1]))
    rt1 = port_build_runtime(one, device="cpu", **kw)
    items = [prompt_item(model, p, seed=s, max_new=n, temp=t) for p, s, n, t in PROMPTS[:4]]
    batch = model.assemble(items, (4,))
    a, b = (r.fetch(r.run((4,), batch)) for r in (rt, rt1))
    assert a["tokens"].tobytes() == b["tokens"].tobytes()


def test_sharded_decode_refusals(weights, single):
    """tp must divide the heads, as in the reference. A seq axis (refused
    until the KV context on "seq" was ported) serves: sp = 2 beside tp = 2
    gives the single engine's tokens (tests/test_torch_mesh_axes.py holds it
    to the reference's sharded engine)."""
    with pytest.raises(ValueError, match="must divide heads"):
        port_build(tg_cfg("port", parallelism="sharded", tp=4))
    model, rt = side("port", weights, parallelism="sharded", tp=2, sp=2)
    assert dict(rt.mesh.shape) == {"data": 1, "model": 2, "seq": 2}
    s_model, s_rt = single
    s_eng = MODS["port"].genserve.GenEngine(s_model, s_rt, MODS["port"].obs.Metrics(),
                                            paged("port"))
    s_eng.compile()
    eng = MODS["port"].genserve.GenEngine(model, rt, MODS["port"].obs.Metrics(), paged("port"))
    eng.compile()
    assert run(drive(eng, model, PROMPTS[:3])) == run(drive(s_eng, s_model, PROMPTS[:3]))


# -- the fleet scheduler's chip budget -------------------------------------------------

class FakeRuntime:
    def __init__(self, n_chips=1, signature="single"):
        self.n_chips = n_chips
        self.parallel_signature = signature
        self.released = 0

    def release_params(self):
        self.released += 1


class StubBatcher:
    def __init__(self, pending=0):
        self.pending = pending
        self.device_time_cb = None

    def estimate_clear_s(self):
        return None

    def predicted_service_s(self, n_items=1):
        return None


def model_cfg(pkg, name, **over):
    base = dict(family="toy", batch_buckets=[1], deadline_ms=5.0, dtype="float32",
                num_classes=10, parallelism="single", request_timeout_ms=10_000.0,
                wire_size=8)
    base.update(over)
    return MODS[pkg].config.ModelConfig(name=name, **base)


def make_sched(pkg, **cfg_over):
    from tpuserve.scheduler import FleetScheduler as JaxFleet
    from tpuserve_torch.scheduler import FleetScheduler

    cls = JaxFleet if pkg == "jax" else FleetScheduler
    return cls(MODS[pkg].config.SchedulerConfig(enabled=True, **cfg_over), MODS[pkg].obs.Metrics())


async def noop_warm():
    return {"version": 1}


@pytest.mark.parametrize("pkg", PKGS)
def test_chip_budget_degrees_and_stats(pkg):
    sched = make_sched(pkg, chip_budget=8)
    sched.register("wide", StubBatcher(), model_cfg(pkg, "wide", parallelism="replica"),
                   runtime=FakeRuntime(4, "replica@4"))
    sched.register("narrow", StubBatcher(), model_cfg(pkg, "narrow"),
                   runtime=FakeRuntime(1, "single"))
    sched.register("bare", StubBatcher(), model_cfg(pkg, "bare"))
    assert sched.chips_in_use() == 6
    s = sched.stats()
    assert s["chip_budget"] == 8 and s["chips_in_use"] == 6
    assert s["models"]["wide"]["parallel"] == {"signature": "replica@4", "degree": 4}
    assert s["models"]["bare"]["parallel"] == {"signature": "single", "degree": 1}


@pytest.mark.parametrize("pkg", PKGS)
def test_chip_budget_sheds_and_demotes_by_degree(pkg):
    async def go():
        sched = make_sched(pkg, chip_budget=4)
        sched.register("resident", StubBatcher(),
                       model_cfg(pkg, "resident", parallelism="replica"),
                       runtime=FakeRuntime(4, "replica@4"))
        sched.register("cold2", StubBatcher(), model_cfg(pkg, "cold2", cold_start=True),
                       runtime=FakeRuntime(2, "sharded@d1"), warm_fn=noop_warm, cold=True)
        shed = sched.check_admission("cold2", "interactive")
        assert (shed.status, shed.reason) == (503, "chip_budget")
        assert "needs 2 chip(s)" in shed.message
        with pytest.raises(ValueError, match="chip budget"):
            await sched.warm("cold2")

        sched = make_sched(pkg, chip_budget=4)
        idle_rt = FakeRuntime(4, "replica@4")
        sched.register("idle", StubBatcher(pending=0),
                       model_cfg(pkg, "idle", parallelism="replica", cold_start=True),
                       runtime=idle_rt)
        sched.register("cold2", StubBatcher(), model_cfg(pkg, "cold2", cold_start=True),
                       runtime=FakeRuntime(2, "sharded@d1"), warm_fn=noop_warm, cold=True)
        shed = sched.check_admission("cold2", "interactive")
        assert shed.reason == "model_warming" and sched.state_of("idle") == "cold"
        assert idle_rt.released == 1
        assert (await sched.warm("cold2"))["state"] == "warm"
        assert sched.chips_in_use() == 2

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(go())
    finally:
        loop.close()
