"""Deferred-readback pool (``tpuserve_torch.deferred``) against the reference
(``tpuserve/deferred.py``): every case of ``tests/test_deferred.py`` on the
port's pool, its workers spawned on the CPU with the toy family, plus the
reference's int8 recycle case (``tests/test_quantize.py``). Where a case
needs no worker, the two packages run side by side: the request-timeout
floor, ``_PinnedShm``'s deferred unlink and the deferred keys' defaults and
validation.

Workers are spawned processes (each imports torch: seconds of CPU), so
the module shares one prewarmed pool and keeps the epochs small; the cases
that kill workers run last.
"""

import asyncio
import threading
import time
from multiprocessing import shared_memory

import numpy as np
import pytest

from tpuserve import config as jconfig
from tpuserve.deferred import DeferredPool as JaxDeferredPool
from tpuserve.deferred import _PinnedShm as JaxPinnedShm
from tpuserve.models import build as jax_build
from tpuserve_torch import config as tconfig
from tpuserve_torch.config import ModelConfig
from tpuserve_torch.deferred import DeferredPool, _PinnedShm
from tpuserve_torch.models import build

RELAY_KEYS = ("session_mode", "relay_workers", "relay_epoch_images", "relay_epoch_ms",
              "relay_slots")


def make_kwargs(**over) -> dict:
    base = dict(
        name="toy", family="toy", batch_buckets=[2, 4], deadline_ms=10.0,
        dtype="float32", num_classes=10, parallelism="single",
        session_mode="recycle", relay_workers=2, relay_slots=2,
        relay_epoch_images=8, relay_epoch_ms=400.0,
        request_timeout_ms=30_000.0,
    )
    base.update(over)
    return base


def make_cfg(**over) -> ModelConfig:
    return ModelConfig(**make_kwargs(**over))


def make_pool(cfg: ModelConfig, **kw) -> DeferredPool:
    return DeferredPool(cfg, "", build(cfg), device="cpu", **kw)


def batch(n: int, seed: int | None = None) -> tuple:
    """The toy host batch (a one-array tuple) of n rows; n must be the
    bucket it is enqueued under."""
    rng = np.random.default_rng(n if seed is None else seed)
    return (rng.integers(0, 255, (n, 8, 8, 3), dtype=np.uint8),)


@pytest.fixture(scope="module")
def pool_env():
    """One prewarmed 2-worker pool and its event loop, shared by the module
    (spawn cost); the cases that kill workers run last."""
    pool = make_pool(make_cfg())
    pool.prewarm()
    loop = asyncio.new_event_loop()
    loop.run_until_complete(pool.start())
    yield loop, pool
    loop.run_until_complete(pool.stop())
    loop.close()


# -- no worker: side by side with the reference -------------------------------------

def test_timeout_floor_applied():
    kw = make_kwargs(request_timeout_ms=100.0, relay_epoch_ms=200.0)
    cfg, jcfg = ModelConfig(**kw), jconfig.ModelConfig(**kw)
    DeferredPool(cfg, "", build(cfg), device="cpu")
    JaxDeferredPool(jcfg, "", jax_build(jcfg))
    assert cfg.request_timeout_ms == jcfg.request_timeout_ms == pytest.approx(2 * 200.0 + 1000.0)
    # At or above the floor, both leave it alone.
    kw = make_kwargs(request_timeout_ms=5000.0, relay_epoch_ms=2000.0)
    cfg, jcfg = ModelConfig(**kw), jconfig.ModelConfig(**kw)
    DeferredPool(cfg, "", build(cfg), device="cpu")
    JaxDeferredPool(jcfg, "", jax_build(jcfg))
    assert cfg.request_timeout_ms == jcfg.request_timeout_ms == 5000.0


@pytest.mark.parametrize("cls", [_PinnedShm, JaxPinnedShm], ids=["port", "reference"])
def test_pinned_shm_defers_unlink_past_inflight_write(cls):
    """close() during an in-flight write must NOT invalidate the buffer; the
    unlink happens at unpin, and later pins are refused."""
    shm = cls(1 << 20)
    name = shm.name
    errors: list[BaseException] = []
    copy_started = threading.Event()

    def writer():
        try:
            assert shm.pin()
            copy_started.set()
            view = np.frombuffer(shm.buf, dtype=np.uint8, count=1 << 20)
            for _ in range(50):
                view[:] = 7
                time.sleep(0.002)
            del view
            shm.unpin()
        except BaseException as e:  # noqa: BLE001 — reported to the test
            errors.append(e)

    t = threading.Thread(target=writer)
    t.start()
    copy_started.wait(5)
    shm.close()  # the epoch readback closes mid-copy
    assert not errors
    t.join(10)
    assert not errors, errors
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)
    assert shm.pin() is False


def test_deferred_keys_typed_with_the_reference_defaults_and_checks(tmp_path):
    port, ref = tconfig.ModelConfig(name="m"), jconfig.ModelConfig(name="m")
    assert {k: getattr(port, k) for k in RELAY_KEYS} == {k: getattr(ref, k) for k in RELAY_KEYS} \
        == {"session_mode": "direct", "relay_workers": 2, "relay_epoch_images": 4096,
            "relay_epoch_ms": 2000.0, "relay_slots": 4}
    # cold_start with recycle: refused by both, with the same words.
    with pytest.raises(ValueError) as p_err:
        tconfig.ModelConfig(name="m", cold_start=True, session_mode="recycle")
    with pytest.raises(ValueError) as j_err:
        jconfig.ModelConfig(name="m", cold_start=True, session_mode="recycle")
    assert str(p_err.value) == str(j_err.value)
    # The recycle example and a --set override parse the same in both and
    # refuse nothing in the port.
    path = "examples/bert_flash_recycle.toml"
    over = ["model.bert.relay_epoch_ms=500.0", "model.bert.relay_slots=2"]
    cfg, jcfg = tconfig.load_config(path, over), jconfig.load_config(path, over)
    assert tconfig.unported_settings(cfg) == []
    assert {k: getattr(cfg.models[0], k) for k in RELAY_KEYS} == \
        {k: getattr(jcfg.models[0], k) for k in RELAY_KEYS} == \
        {"session_mode": "recycle", "relay_workers": 2, "relay_epoch_images": 4096,
         "relay_epoch_ms": 500.0, "relay_slots": 2}
    assert "session_mode" not in tconfig._MODEL_UNPORTED
    assert tconfig._FAULT_KINDS_UNPORTED == {}


def test_oversized_batch_refused_before_a_slot_is_taken():
    pool = make_pool(make_cfg(batch_buckets=[2]))
    with pytest.raises(ValueError, match="shm slot holds"):
        asyncio.run(pool.enqueue((4,), batch(4)))
    assert pool._workers == []  # nothing spawned, nothing taken


# -- the reference's cases on the port's pool ------------------------------------------

def test_epoch_rotation_and_results(pool_env):
    loop, pool = pool_env

    async def go():
        # 3 batches of 4 rows: rows 0-7 fill worker A's 8-row epoch budget;
        # batch 3 forces rotation to worker B. All resolve with real results.
        futs = [await pool.enqueue((4,), batch(4)) for _ in range(3)]
        outs = await asyncio.wait_for(asyncio.gather(*futs), timeout=60)
        for out in outs:
            assert out["probs"].shape == (4, 3)
            assert np.all(out["probs"][:, 0] >= out["probs"][:, 1])
        assert pool.stats["epochs"] >= 1
        assert pool.stats["rows_total"] == 12

    loop.run_until_complete(go())


def test_epoch_deadline_fires_without_fill(pool_env):
    loop, pool = pool_env

    async def go():
        # One small batch, epoch far from full: the relay_epoch_ms timer must
        # retire the worker and resolve the future anyway.
        fut = await pool.enqueue((2,), batch(2))
        out = await asyncio.wait_for(fut, timeout=60)
        assert out["indices"].shape == (2, 3)

    loop.run_until_complete(go())


def test_pool_answers_equal_the_in_process_runtime(pool_env):
    """The rows a worker reads back at its epoch's end equal the port's
    in-process runtime on the same batch and (seeded) weights."""
    from tpuserve_torch.runtime import build_runtime

    loop, pool = pool_env
    rt = build_runtime(build(make_cfg()), device="cpu")
    b2, b4 = batch(2, seed=11), batch(4, seed=12)

    async def go():
        f2 = await pool.enqueue((2,), b2)
        f4 = await pool.enqueue((4,), b4)
        return await asyncio.wait_for(asyncio.gather(f2, f4), timeout=60)

    for got, (bucket, b) in zip(loop.run_until_complete(go()), (((2,), b2), ((4,), b4))):
        want = rt.fetch(rt.run(bucket, b))
        np.testing.assert_array_equal(got["indices"], want["indices"])
        np.testing.assert_allclose(got["probs"], want["probs"], rtol=0, atol=1e-6)


def test_worker_death_contained(pool_env):
    loop, pool = pool_env

    async def go():
        fut = await pool.enqueue((2,), batch(2))
        w = pool._active
        assert w is not None
        w.proc.kill()  # simulate OOM/preemption mid-epoch
        with pytest.raises(RuntimeError, match="died"):
            await asyncio.wait_for(fut, timeout=60)
        # The pool recovers: the next enqueue lands on a fresh worker.
        fut2 = await pool.enqueue((2,), batch(2))
        out = await asyncio.wait_for(fut2, timeout=120)
        assert out["indices"].shape == (2, 3)

    loop.run_until_complete(go())


def test_clean_shutdown_resolves_pending():
    """stop() must wait for the epoch readback: pending futures resolve with
    results, not 'worker died'."""
    pool = make_pool(make_cfg(relay_workers=2, relay_epoch_ms=5_000.0))
    pool.prewarm()
    loop = asyncio.new_event_loop()

    async def go():
        await pool.start()
        fut = await pool.enqueue((2,), batch(2))
        t0 = time.perf_counter()
        await pool.stop()  # epoch nowhere near done: stop retires + waits
        assert time.perf_counter() - t0 < 5.0  # the readback, not the 5 s epoch
        assert fut.done() and fut.exception() is None
        assert fut.result()["indices"].shape == (2, 3)
        assert not any(w.proc.is_alive() for w in pool._workers)  # reaped

    loop.run_until_complete(go())
    loop.close()


def test_results_during_slot_copy_reroutes_batch(monkeypatch):
    """The epoch deadline retires the active worker and its results (->
    w.close()) land WHILE enqueue's slot copy is still running in the
    executor. The batch must be re-routed to a live worker and resolve with
    results — no ValueError, no 500."""
    pool = make_pool(make_cfg(relay_workers=2, relay_epoch_images=8, relay_epoch_ms=150.0))
    orig_write = DeferredPool._write_slot
    slow_from: dict = {"t": None}

    def slow_write(self, w, slot, host_batch):
        # Slow only writes after the first batch has armed the epoch timer,
        # so the retire + results for batch 1 land mid-copy of batch 2.
        if slow_from["t"] is not None:
            time.sleep(0.6)
        return orig_write(self, w, slot, host_batch)

    monkeypatch.setattr(DeferredPool, "_write_slot", slow_write)
    pool.prewarm()
    loop = asyncio.new_event_loop()
    loop.run_until_complete(pool.start())
    try:
        async def go():
            fut1 = await pool.enqueue((4,), batch(4, seed=1))
            slow_from["t"] = time.perf_counter()
            w1 = pool._active
            fut2 = await pool.enqueue((4,), batch(4, seed=2))
            out1, out2 = await asyncio.wait_for(asyncio.gather(fut1, fut2), timeout=120)
            assert out1["probs"].shape == (4, 3)
            assert out2["probs"].shape == (4, 3)
            # The interleave happened: worker 1 was retired by the deadline
            # while batch 2 was being written.
            assert w1.retired

        loop.run_until_complete(go())
    finally:
        loop.run_until_complete(pool.stop())
        loop.close()


def test_warm_pool_replenishes_in_background():
    """Activation consumes warm workers; the pool tops itself back up in the
    background, so later rotations find a prewarmed successor (stats:
    workers_prespawned moves)."""
    pool = make_pool(make_cfg(relay_workers=2, relay_epoch_images=4, relay_epoch_ms=5_000.0))
    pool.prewarm()
    loop = asyncio.new_event_loop()
    loop.run_until_complete(pool.start())
    try:
        async def go():
            futs = []
            # 4 epochs of one full 4-row batch each: the 2 prewarmed workers
            # cover the first two; the rest need replenished spares.
            for i in range(4):
                futs.append(await pool.enqueue((4,), batch(4, seed=i)))
            outs = await asyncio.wait_for(asyncio.gather(*futs), timeout=120)
            assert len(outs) == 4
            for _ in range(200):
                if pool.stats["workers_prespawned"] >= 2:
                    break
                await asyncio.sleep(0.1)
            assert pool.stats["workers_prespawned"] >= 2, pool.stats
            assert pool.stats["epochs"] == 4
            assert [b["wid"] for b in pool.describe()["worker_boots"]][:4] == [0, 1, 2, 3]

        loop.run_until_complete(go())
    finally:
        loop.run_until_complete(pool.stop())
        loop.close()


def test_recycle_mode_with_int8_weights():
    """The worker's runtime quantizes as the in-process one does: int8
    weights serve finite probabilities (tests/test_quantize.py's case)."""
    cfg = make_cfg(batch_buckets=[2], relay_workers=1, relay_slots=2,
                   relay_epoch_images=4, relay_epoch_ms=300.0,
                   quantize="int8", quantize_min_size=1024)
    pool = make_pool(cfg)
    assert pool.n_workers == 2  # relay_workers below 2 still warms two
    pool.prewarm()
    loop = asyncio.new_event_loop()
    loop.run_until_complete(pool.start())
    try:
        imgs = np.random.default_rng(5).integers(0, 255, (2, 8, 8, 3), np.uint8)
        out = loop.run_until_complete(pool.run_deferred((2,), (imgs,)))
        assert np.isfinite(out["probs"]).all()
        assert pool.describe()["quantize"] == "int8"
    finally:
        loop.run_until_complete(pool.stop())
        loop.close()
