"""The mesh modes of the port's runtime, batcher, lifecycle and server
(``parallelism`` "sharded", "replica" and "pipeline", ``tp``, ``[parallel]``)
against the JAX package, on the CPU.

The JAX side runs on its conftest's 8 fake host devices; the port's with
``mesh.visible_devices`` patched to ``["cpu"] * 8`` (eight ranks sharing the
CPU, single-controller). Both serve the JAX package's seeded tree (the
port reads it from a ``.npz``).

Tolerances: BERT float32 answers, probabilities atol 1e-5 and top-k indices
identical (``tests/test_torch_bert.py``'s float32 bar, logits atol 1e-4,
carried to the softmax); a replica's answer equals single mode's bytes, and
so does a sharded toy batch's (each data rank's rows through the same
forward: measured bit-equal on this CPU). Exact: signatures, counts,
``/stats`` keys and the replica picks.
"""

import asyncio
import io
import json

import jax
import numpy as np
import pytest
import torch

from tpuserve import config as jconfig
from tpuserve.models import build as jax_build
from tpuserve.runtime import build_runtime as jax_build_runtime
from tpuserve.server import ServerState as JaxServerState
from tpuserve_torch import config as tconfig
from tpuserve_torch import savedmodel
from tpuserve_torch.batcher import ModelBatcher
from tpuserve_torch.models import build
from tpuserve_torch.obs import Metrics
from tpuserve_torch.parallel import mesh as meshlib
from tpuserve_torch.runtime import ReplicaRuntime, build_runtime

N_DEV = 8
BERT = dict(layers=4, d_model=32, heads=4, d_ff=64, vocab_size=512, attention="dense")
TEXTS = ["hello world", "Serve this text, please!", "a b c d e f", "mesh modes"]


@pytest.fixture(autouse=True)
def eight(monkeypatch):
    monkeypatch.setattr(meshlib, "visible_devices", lambda *a: ["cpu"] * N_DEV)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bert_kw(**over) -> dict:
    base = dict(name="bert", family="bert", batch_buckets=[4], seq_buckets=[16],
                dtype="float32", num_classes=4, parallelism="single",
                request_timeout_ms=30_000.0, options=dict(BERT))
    base.update(over)
    return base


@pytest.fixture(scope="module")
def bert_tree():
    return jax.device_get(jax_build(jconfig.ModelConfig(**bert_kw())).load_params())


@pytest.fixture(scope="module")
def bert_npz(bert_tree, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bert") / "bert.npz")
    savedmodel.save_npz(path, bert_tree)
    return path


def bert_batch(model):
    items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
             for t in TEXTS]
    return model.assemble(items, (4, 16))


def port_bert(npz, n_chips=0, **over):
    model = build(tconfig.ModelConfig(**bert_kw(weights=npz, **over)))
    return model, build_runtime(model, device="cpu",
                                parallel=tconfig.ParallelConfig(n_chips=n_chips))


MODES = {
    "sharded-d2": (dict(parallelism="sharded"), 2, "sharded@d2"),
    "tp2": (dict(parallelism="sharded", tp=2), 2, "sharded@d1"),
    "tp2-d2": (dict(parallelism="sharded", tp=2), 4, "sharded@d2"),
    "pipeline-2": (dict(parallelism="pipeline", pp=2), 0, "pipeline@2"),
    "pipeline-4": (dict(parallelism="pipeline", pp=4), 0, "pipeline@4"),
    "replica-2": (dict(parallelism="replica"), 2, "replica@2"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bert_mode_matches_reference(mode, bert_tree, bert_npz):
    over, n_chips, signature = MODES[mode]
    jm = jax_build(jconfig.ModelConfig(**bert_kw(**over)))
    jm.load_params = lambda: bert_tree
    jrt = jax_build_runtime(jm, parallel=jconfig.ParallelConfig(n_chips=n_chips))
    model, rt = port_bert(bert_npz, n_chips, **over)
    assert rt.parallel_signature == jrt.parallel_signature == signature
    assert (rt.n_chips, rt.n_replicas) == (jrt.n_chips, jrt.n_replicas)
    assert rt.compiles_total == jrt.compiles_total
    b = bert_batch(model)
    for replica in range(rt.n_replicas):
        ref = jrt.fetch(jrt.run((4, 16), b, replica=replica))
        out = rt.fetch(rt.run((4, 16), b, replica=replica))
        np.testing.assert_allclose(out["probs"], np.asarray(ref["probs"]), atol=1e-5)
        np.testing.assert_array_equal(out["indices"], np.asarray(ref["indices"]))
    assert rt.replica_batches() == [1.0] * rt.n_replicas


@pytest.mark.parametrize("over", [dict(parallelism="replica"),
                                  dict(parallelism="sharded", tp=2),
                                  dict(parallelism="pipeline", pp=2)])
def test_flash_modes_against_single(over, bert_npz):
    """attention = "flash" (K1's plain version on the CPU) in every mode:
    each replica gives single mode's bytes; tensor parallelism and the
    pipeline hold single mode's answers at the float32 bar."""
    flash = dict(BERT, attention="flash")
    model, single = port_bert(bert_npz, options=flash)
    b = bert_batch(model)
    base = single.fetch(single.run((4, 16), b))
    _, rt = port_bert(bert_npz, 2, options=flash, **over)
    for replica in range(rt.n_replicas):
        out = rt.fetch(rt.run((4, 16), b, replica=replica))
        if over["parallelism"] == "replica":
            assert out["probs"].tobytes() == base["probs"].tobytes()
        np.testing.assert_allclose(out["probs"], base["probs"], atol=1e-5)
        np.testing.assert_array_equal(out["indices"], base["indices"])


def test_sharded_buckets_align_to_the_data_axis(bert_npz):
    _, rt = port_bert(bert_npz, 4, parallelism="sharded", batch_buckets=[1, 3, 4])
    jrt_cfg = jconfig.ModelConfig(**bert_kw(parallelism="sharded", batch_buckets=[1, 3, 4]))
    jax_build_runtime(jax_build(jrt_cfg), parallel=jconfig.ParallelConfig(n_chips=4))
    assert rt.cfg.batch_buckets == jrt_cfg.batch_buckets == [4]


# -- toy: replica and sharded --------------------------------------------------------

def toy_kw(**over) -> dict:
    base = dict(name="toy", family="toy", batch_buckets=[1, 2], deadline_ms=2.0,
                dtype="float32", num_classes=10, parallelism="replica",
                request_timeout_ms=30_000.0, max_queue=4096)
    base.update(over)
    return base


def toy(**over):
    model = build(tconfig.ModelConfig(**toy_kw(**over)))
    return model, build_runtime(model, device="cpu")


def images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (8, 8, 3), np.uint8) for _ in range(n)]


def test_sharded_batch_bytes_equal_replica_mode():
    """The reference's standing-failure check, on the port: a batch split
    over 8 data ranks answers the bytes each replica gives for it."""
    model, rt_rep = toy(batch_buckets=[N_DEV])
    _, rt_sh = toy(parallelism="sharded", batch_buckets=[N_DEV])
    assert rt_sh.mesh.shape["data"] == N_DEV and rt_sh.parallel_signature == "sharded@d8"
    batch = model.assemble(images(N_DEV, 7), (N_DEV,))
    out_sh = rt_sh.fetch(rt_sh.run((N_DEV,), batch))
    for replica in range(rt_rep.n_replicas):
        out = rt_rep.fetch(rt_rep.run((N_DEV,), batch, replica=replica))
        assert out["probs"].tobytes() == out_sh["probs"].tobytes()
        assert out["indices"].tobytes() == out_sh["indices"].tobytes()


def test_n_chips_bounds_and_refusals():
    model, rt = toy(batch_buckets=[1])
    assert isinstance(rt, ReplicaRuntime) and rt.n_replicas == rt.n_chips == N_DEV
    two = build(tconfig.ModelConfig(**toy_kw(batch_buckets=[1])))
    assert build_runtime(two, device="cpu",
                         parallel=tconfig.ParallelConfig(n_chips=2)).n_replicas == 2
    with pytest.raises(ValueError, match="n_chips=9 but only 8"):
        build_runtime(two, device="cpu", parallel=tconfig.ParallelConfig(n_chips=9))
    with pytest.raises(ValueError, match="n_chips=9 but only 8"):
        jax_build_runtime(jax_build(jconfig.ModelConfig(**toy_kw(batch_buckets=[1]))),
                          parallel=jconfig.ParallelConfig(n_chips=9))
    # The reference's: pipeline needs a family that pipelines its depth.
    with pytest.raises(ValueError, match="homogeneous block stack"):
        toy(parallelism="pipeline")


def test_mesh_over_several_cards_is_refused(monkeypatch):
    """One CUDA graph cannot span cards: a sharded mesh over two is refused
    by name (ROADMAP item 10); replicas, one per card, are not."""
    monkeypatch.setattr(meshlib, "visible_devices", lambda *a: ["cuda:0", "cuda:1"])
    model = build(tconfig.ModelConfig(**toy_kw(parallelism="sharded")))
    with pytest.raises(NotImplementedError, match="item 10"):
        build_runtime(model, device="cpu")


SD_TINY = dict(steps=3, guidance=5.0, vocab_size=512, text_layers=1, text_d_model=32,
               text_heads=2, unet_ch=16, unet_mults=[1, 2], unet_res=1,
               unet_attn_levels=[0], unet_heads=2, vae_ch=16, vae_mults=[1, 2])


def test_sd15_replicas_answer_single_bytes():
    """SD 1.5 (tiny widths, float32) on 2 replicas: each replica's locked
    batch gives the single runtime's PNG bytes, and a GenEngineGroup the
    single engine's images."""
    from tpuserve_torch.config import GenserveConfig
    from tpuserve_torch.genserve import GenEngine, GenEngineGroup

    def side(par, engine):
        model = build(tconfig.ModelConfig(name="sd", family="sd15", batch_buckets=[1, 2],
                                          dtype="float32", parallelism=par, image_size=32,
                                          options=dict(SD_TINY)))
        return model, build_runtime(model, device="cpu", compile_forward=not engine,
                                    parallel=tconfig.ParallelConfig(n_chips=2))

    def items(model):
        return [model.host_decode(json.dumps({"prompt": p, "seed": i}).encode(),
                                  "application/json")
                for i, p in enumerate(["a red cat", "a blue dog"])]

    model, single = side("single", False)
    _, rep = side("replica", False)
    batch = model.assemble(items(model), (2,))
    base = single.fetch(single.run((2,), batch))
    for replica in range(2):
        out = rep.fetch(rep.run((2,), batch, replica=replica))
        assert all(out[k].tobytes() == base[k].tobytes() for k in base)

    async def drive(eng, m):
        await eng.start()
        res = await asyncio.gather(*[eng.submit(it) for it in items(m)])
        await eng.stop()
        return res

    m1, r1 = side("single", True)
    one = GenEngine(m1, r1, Metrics(), GenserveConfig(slots=2))
    one.compile()
    m2, r2 = side("replica", True)
    group = GenEngineGroup(m2, r2, Metrics(), GenserveConfig(slots=2))
    group.compile()
    assert asyncio.run(drive(group, m2)) == asyncio.run(drive(one, m1))


def test_generative_family_on_a_split_mesh_is_refused():
    """SD 1.5 serves on a one-device mesh; its programs on a split one are
    ROADMAP item 9b (textgen's are ported: tests/test_torch_meshgen.py)."""
    model = build(tconfig.ModelConfig(name="sd", family="sd15", parallelism="sharded",
                                      dtype="float32", image_size=32, options=dict(SD_TINY)))
    with pytest.raises(NotImplementedError, match="item 9b"):
        build_runtime(model, device="cpu", parallel=tconfig.ParallelConfig(n_chips=2),
                      compile_forward=False)


def test_pick_replica_least_loaded_and_tie_rotation_as_reference():
    _, rt = toy(batch_buckets=[1])
    jrt = jax_build_runtime(jax_build(jconfig.ModelConfig(**toy_kw(batch_buckets=[1]))))
    loads = [3] * N_DEV
    loads[5] = 0
    assert rt.pick_replica(loads) == jrt.pick_replica(loads) == 5
    seq = [[0] * N_DEV, [1, 0, 0, 1, 1, 1, 1, 1], [2] * N_DEV, None, [0] * N_DEV]
    assert [rt.pick_replica(lo) for lo in seq] == [jrt.pick_replica(lo) for lo in seq]
    assert len({rt.pick_replica([0] * N_DEV) for _ in range(N_DEV)}) > 1


def test_variant_key_parallelism_composes_with_quantize():
    """As the reference's: the signature, the label, replicas x buckets
    compiles, none across stage/publish/rollback."""
    kw = toy_kw(batch_buckets=[1], quantize="int8", quantize_min_size=16)
    model = build(tconfig.ModelConfig(**kw))
    rt = build_runtime(model, device="cpu")
    jrt = jax_build_runtime(jax_build(jconfig.ModelConfig(**kw)))
    assert rt.parallel_signature == jrt.parallel_signature == f"replica@{N_DEV}"
    assert rt.variant_key((1,)).label == jrt.variant_key((1,)).label \
        == f"1/float32/int8/replica@{N_DEV}"
    before = rt.compiles_total
    assert before == jrt.compiles_total == len(model.buckets()) * N_DEV
    rt.publish(rt.stage_params())
    rt.rollback()
    assert rt.ensure_compiled() == 0 and rt.compiles_total == before
    assert rt.describe()["variants"][0]["replicas"] == N_DEV


# -- the batcher ----------------------------------------------------------------------

class _FakeStagedRuntime:
    """n-replica runtime stub: pick_replica pinned, so the test controls the
    first choice."""

    device = torch.device("cpu")

    def __init__(self, n: int, first: int) -> None:
        self.n_replicas = n
        self._first = first
        self.h2d_sync = False

    def pick_replica(self, loads=None) -> int:
        return self._first

    def replica_batches(self):
        return [0.0] * self.n_replicas


def test_acquire_staging_falls_back_least_loaded_not_index_order():
    model = build(tconfig.ModelConfig(**toy_kw(batch_buckets=[1])))

    async def go():
        b = ModelBatcher(model, _FakeStagedRuntime(3, first=0), Metrics())
        await b.start()
        try:
            assert len(b._staging) == 3
            while b._staging[0].try_acquire() is not None:
                pass
            b._staging[1].try_acquire()
            replica, slot = await b._acquire_staging([])
            assert replica == 2  # least loaded, not the next index
            b._release_staging(replica, slot)
        finally:
            await b.stop()

    asyncio.run(go())


def test_every_replica_receives_batches_under_sustained_load():
    metrics = Metrics()
    model = build(tconfig.ModelConfig(**toy_kw(batch_buckets=[1])))
    rt = build_runtime(model, device="cpu", metrics=metrics)

    async def go():
        b = ModelBatcher(model, rt, metrics)
        await b.start()
        assert b._admission_cap == b.depth * N_DEV + b.pipeline_cfg.assemble_ahead
        try:
            results = await asyncio.gather(*[b.submit(it) for it in images(12 * N_DEV)])
            assert len(results) == 12 * N_DEV and all(r["top_k"] for r in results)
            return b.pipeline_stats()
        finally:
            await b.stop()

    stats = asyncio.run(go())
    batches = rt.replica_batches()
    assert len(batches) == N_DEV and all(v > 0 for v in batches), batches
    assert [r["replica"] for r in stats["per_replica"]] == list(range(N_DEV))
    for i in range(N_DEV):
        assert metrics.gauge(f"replica_inflight{{model=toy,replica={i}}}").value == 0
        assert metrics.counter(f"device_seconds_total{{model=toy,replica={i}}}").value > 0


def _scaled_npz(model, factor, path):
    tree = model.to_jax_params(model.init_params(0))
    savedmodel.save_npz(path, {k: v * factor for k, v in tree.items()})
    return path


def test_publish_rollback_under_load_never_serves_torn_versions(tmp_path):
    """A burst over every replica races a publish, then a rollback: every
    answer is exactly v1's or v2's, and after each switch every replica
    answers the new version."""
    model = build(tconfig.ModelConfig(**toy_kw(batch_buckets=[1])))
    rt = build_runtime(model, device="cpu")
    item = images(1, 3)[0]

    def probs(r):
        return [e["prob"] for e in r["top_k"]]

    async def go():
        b = ModelBatcher(model, rt, Metrics())
        await b.start()
        try:
            v1 = probs(await b.submit(item.copy()))
            model.cfg.weights = _scaled_npz(model, 1.5, str(tmp_path / "v2.npz"))
            staged = rt.stage_params()

            async def burst(n):
                return [probs(r) for r in await asyncio.gather(
                    *[b.submit(item.copy()) for _ in range(n)])]

            task = asyncio.ensure_future(burst(6 * N_DEV))
            await asyncio.sleep(0.01)
            rt.publish(staged)
            mixed = await task
            v2 = probs(await b.submit(item.copy()))
            assert v1 != v2
            assert all(p in (v1, v2) for p in mixed)
            for _ in range(2 * N_DEV):
                assert probs(await b.submit(item.copy())) == v2
            task = asyncio.ensure_future(burst(6 * N_DEV))
            await asyncio.sleep(0.01)
            rt.rollback()
            mixed = await task
            assert all(p in (v1, v2) for p in mixed)
            for _ in range(2 * N_DEV):
                assert probs(await b.submit(item.copy())) == v1
        finally:
            await b.stop()

    asyncio.run(go())
    assert all(v > 0 for v in rt.replica_batches())


def test_staged_canary_proves_every_replica():
    """A candidate poisoned on the last replica alone fails the staged
    canary naming that replica; a clean one passes on all."""
    from tpuserve_torch.config import LifecycleConfig
    from tpuserve_torch.lifecycle import ModelLifecycle

    model = build(tconfig.ModelConfig(**toy_kw(batch_buckets=[1])))
    rt = build_runtime(model, device="cpu")
    lc = ModelLifecycle("toy", rt, model, LifecycleConfig(), Metrics())
    staged = rt.stage_params()
    lc._staged_canary_sync(staged)
    poisoned = rt.n_replicas - 1
    with torch.inference_mode():
        for t in rt.replicas[poisoned].slots[staged.slot].tensors.values():
            if t.is_floating_point():
                t.fill_(float("nan"))
    with pytest.raises(ValueError, match=f"replica {poisoned}"):
        lc._staged_canary_sync(staged)


# -- the server --------------------------------------------------------------------------

def npy_bytes(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_server_parallel_mode_overrides_models():
    for cfgm, state_cls, kw in ((jconfig, JaxServerState, {}),
                                (tconfig, None, {"device": "cpu"})):
        cfg = cfgm.ServerConfig(
            models=[cfgm.ModelConfig(**toy_kw(parallelism="single", batch_buckets=[1]))],
            parallel=cfgm.ParallelConfig(mode="replica"), decode_threads=2,
            startup_canary=False)
        if state_cls is None:
            from tpuserve_torch.server import ServerState as state_cls
        state = state_cls(cfg, **kw)
        state.build()
        rt = state.runtimes["toy"]
        assert rt.mode == "replica" and rt.n_replicas == N_DEV
        assert cfg.models[0].parallelism == "replica"


def test_stats_parallel_topology_and_per_replica_over_http():
    """/stats' parallel block, per-replica rows and topology block, and the
    per-replica metrics, over HTTP on the port's server; keys equal the
    reference's (its own run of the same config)."""
    import aiohttp
    from aiohttp.test_utils import TestClient, TestServer

    from tpuserve.server import make_app
    from tpuserve_torch.server import ServerState, start_server, stop_server

    async def drive(client):
        rng = np.random.default_rng(5)
        for _ in range(4 * N_DEV):
            async with client.post("/v1/models/toy:classify",
                                   data=npy_bytes(rng.integers(0, 255, (8, 8, 3), np.uint8)),
                                   headers={"Content-Type": "application/x-npy"}) as r:
                assert r.status == 200
        async with client.get("/stats") as r:
            stats = await r.json()
        async with client.get("/metrics") as r:
            text = await r.text()
        async with client.get("/v1/models") as r:
            models = await r.json()
        return stats, text, models

    out = {}
    for pkg, cfgm in (("jax", jconfig), ("port", tconfig)):
        cfg = cfgm.ServerConfig(models=[cfgm.ModelConfig(**toy_kw(batch_buckets=[1]))],
                                decode_threads=2, startup_canary=False)

        async def go(pkg=pkg, cfg=cfg):
            if pkg == "jax":
                state = JaxServerState(cfg)
                state.build()
                client = TestClient(TestServer(make_app(state)))
                await client.start_server()
                try:
                    return await drive(client)
                finally:
                    await client.close()
            state = ServerState(cfg, device="cpu")
            state.build()
            server = await start_server(state, "127.0.0.1", 0)
            port = state.serving_addresses[0][1]
            try:
                async with aiohttp.ClientSession(f"http://127.0.0.1:{port}") as client:
                    return await drive(client)
            finally:
                await stop_server(state, server)

        out[pkg] = asyncio.run(go())
    (jstats, jtext, jmodels), (stats, text, models) = out["jax"], out["port"]
    par, jpar = stats["parallel"]["toy"], jstats["parallel"]["toy"]
    assert set(par) == set(jpar)
    for k in ("mode", "signature", "n_chips", "replicas"):
        assert par[k] == jpar[k], k
    assert len(par["replica_batches_total"]) == N_DEV and sum(par["replica_batches_total"]) > 0
    assert par["batches_per_chip"] == pytest.approx(sum(par["replica_batches_total"]) / N_DEV)
    rows = stats["pipeline"]["models"]["toy"]["per_replica"]
    jrows = jstats["pipeline"]["models"]["toy"]["per_replica"]
    assert [r["replica"] for r in rows] == list(range(N_DEV))
    assert [set(r) for r in rows] == [set(r) for r in jrows]
    assert all(0.0 <= r["occupancy"] <= 1.0 for r in rows)
    assert set(stats["topology"]) == set(jstats["topology"])
    assert stats["topology"] | {"global_devices": 0, "local_devices": 0} == {
        "process_index": 0, "process_count": 1, "global_devices": 0, "local_devices": 0,
        "platform": "cpu", "worker_id": None, "distributed": False}
    for name in ("replica_batches_total", "replica_inflight"):
        assert f'{name}{{model="toy",replica="0"}}' in text
        assert f'{name}{{model="toy",replica="0"}}' in jtext
    assert models["toy"]["n_chips"] == jmodels["toy"]["n_chips"] == N_DEV
    assert models["toy"]["parallel"] == jmodels["toy"]["parallel"] == f"replica@{N_DEV}"


# -- the fleet's chip budget ----------------------------------------------------------------

def test_chip_budget_counts_a_replica_runtime_by_its_degree():
    from tpuserve_torch.config import SchedulerConfig
    from tpuserve_torch.scheduler import FleetScheduler

    class StubBatcher:
        pending = 0
        device_time_cb = None

        def estimate_clear_s(self):
            return None

        def predicted_service_s(self, n_items=1):
            return None

    model, rt = toy(batch_buckets=[1])
    sched = FleetScheduler(SchedulerConfig(enabled=True, chip_budget=10), Metrics())
    sched.register("wide", StubBatcher(), model.cfg, runtime=rt)
    single = build(tconfig.ModelConfig(**toy_kw(name="one", parallelism="single",
                                                batch_buckets=[1])))
    sched.register("one", StubBatcher(), single.cfg,
                   runtime=build_runtime(single, device="cpu"))
    assert sched.chips_in_use() == N_DEV + 1
    assert sched.stats()["models"]["wide"]["parallel"] == {
        "signature": f"replica@{N_DEV}", "degree": N_DEV}
