"""Deferred (recycle) mode behind the port's batcher and server, against the
reference: ``tests/test_deferred.py``'s HTTP case and
``tests/test_faults.py``'s worker-death case on the port, the admin verbs'
409s byte for byte beside the reference's handlers, the batcher's deferred
branch (admission released at enqueue, ``mode == "deferred"``), a pool-only
server that never initializes CUDA in its own process, and the pool's
answers against the reference's in-process forward on the same seeded
weights.

Tolerances: the pool against the reference forward, as the port's parity
tests state them: the toy model probabilities atol 1e-6 with identical
indices (``tests/test_torch_vision.py``); 2-layer BERT-flash in float32
probabilities atol 1e-5 with identical indices (``tests/test_torch_bert.py``,
the flash kernel's plain version on the CPU on the port's side, the Pallas
kernel in interpret mode on the reference's).

Workers are spawned processes on the CPU (each imports torch: seconds).
"""

import asyncio
import http.client
import json
import threading
import types

import jax
import numpy as np
import pytest
import torch

from tpuserve.config import ModelConfig as JaxModelConfig
from tpuserve.models import build as jax_build
from tpuserve_torch import savedmodel
from tpuserve_torch.batcher import ModelBatcher
from tpuserve_torch.config import ModelConfig, ServerConfig, load_config
from tpuserve_torch.deferred import DeferredPool
from tpuserve_torch.faults import FaultInjector
from tpuserve_torch.models import build
from tpuserve_torch.obs import Metrics
from tpuserve_torch.runtime import backend_info
from tpuserve_torch.server import ServerState, start_server, stop_server

RECYCLE_TOML = """
decode_threads = 2

[[model]]
name = "toy"
family = "toy"
batch_buckets = [2]
deadline_ms = 5.0
dtype = "float32"
num_classes = 10
parallelism = "single"
request_timeout_ms = 60000.0
session_mode = "recycle"
relay_workers = 2
relay_slots = 2
relay_epoch_images = 4
relay_epoch_ms = 300.0
"""

TEXTS = ["hello world", "Serve this text, please!", "a b c d e f g"]
BERT_TINY = dict(layers=2, d_model=32, heads=2, d_ff=64, vocab_size=512, attention="flash")


def toy_kwargs(**over) -> dict:
    base = dict(name="toy", family="toy", batch_buckets=[1, 2], deadline_ms=5.0,
                dtype="float32", num_classes=10, parallelism="single",
                request_timeout_ms=30_000.0, session_mode="recycle", relay_workers=2,
                relay_epoch_images=64, relay_epoch_ms=300.0)
    base.update(over)
    return base


def item(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 200, (8, 8, 3), dtype=np.uint8)


def call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def npy(arr) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A recycle-mode toy model served from a TOML file on the CPU, built
    and served with ``torch.cuda._lazy_init`` recording every call (the
    workers are other processes). Yields (port, state, lazy-init calls)."""
    calls: list = []
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda, "_lazy_init", lambda: calls.append("lazy_init"))
    path = tmp_path_factory.mktemp("recycle") / "recycle.toml"
    path.write_text(RECYCLE_TOML)
    cfg = load_config(str(path))
    state = ServerState(cfg, device="cpu")
    state.build()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    srv = asyncio.run_coroutine_threadsafe(start_server(state, "127.0.0.1", 0), loop).result(120)
    try:
        yield state.serving_addresses[0][1], state, calls
    finally:
        asyncio.run_coroutine_threadsafe(stop_server(state, srv), loop).result(120)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
        mp.undo()


def test_recycle_serves_over_http_from_toml(served):
    """Recycle mode is launchable from a TOML config and serves end to end."""
    port, state, _ = served
    assert state.cfg.models[0].session_mode == "recycle"
    assert isinstance(state.runtimes["toy"], DeferredPool)
    status, body = call(port, "POST", "/v1/models/toy:predict", npy(item()),
                        {"Content-Type": "application/x-npy"})
    assert status == 200, body
    assert len(json.loads(body)["top_k"]) == 3
    inv = json.loads(call(port, "GET", "/v1/models")[1])["toy"]
    assert inv["mode"] == "recycle" and inv["device"] == "cpu"
    assert inv["stats"]["epochs"] >= 1 and len(inv["worker_boots"]) >= 2
    stats = json.loads(call(port, "GET", "/stats")[1])
    assert stats["pipeline"]["models"]["toy"]["mode"] == "deferred"
    assert "toy" not in stats["lifecycle"] and "toy" not in stats.get("roofline", {})


def test_admin_verbs_answer_the_reference_409s(served):
    """No lifecycle in recycle mode: the reference's 409s, byte for byte;
    an unknown model is 404 in both."""
    from aiohttp import web
    from aiohttp.test_utils import make_mocked_request

    from tpuserve import server as jserver

    port, _, _ = served
    app = web.Application()
    app[jserver.STATE_KEY] = types.SimpleNamespace(runtimes={"toy": object()}, lifecycles={},
                                                   audit=None)
    cases = [(jserver.handle_reload, "POST", "/admin/models/{}:reload"),
             (jserver.handle_rollback, "POST", "/admin/models/{}:rollback"),
             (jserver.handle_versions, "GET", "/admin/models/{}/versions")]
    for handler, method, path in cases:
        for name, status in (("toy", 409), ("nope", 404)):
            req = make_mocked_request(method, path.format(name), match_info={"name": name},
                                      app=app)
            ref = asyncio.run(handler(req))
            got = call(port, method, path.format(name))
            assert (got[0], json.loads(got[1])) == (ref.status, json.loads(ref.body)) \
                and ref.status == status, path
            assert got[1] == ref.body, path


def test_pool_only_server_never_initializes_cuda(served, monkeypatch):
    """A server whose every model is recycle-mode builds, serves and
    reports /stats without one call that would initialize CUDA in its own
    process; with the card as its default device it keeps it unresolved
    and hands it to its workers."""
    port, _, calls = served
    assert call(port, "POST", "/v1/models/toy:predict", npy(item(3)),
                {"Content-Type": "application/x-npy"})[0] == 200
    stats = json.loads(call(port, "GET", "/stats")[1])
    assert stats["cuda_initialized"] is False and stats["backend"]["cuda_initialized"] is False
    assert calls == []
    # The default device: CUDA present (patched), never initialized here.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = load_config(None)
    cfg.models = [ModelConfig(**toy_kwargs())]
    state = ServerState(cfg)
    assert state.device == torch.device("cuda") and state.device.index is None
    assert backend_info(state.device)["cuda_initialized"] is False
    assert calls == []
    # A direct model would initialize it: the check has teeth.
    cfg.models = [ModelConfig(**toy_kwargs(session_mode="direct"))]
    with pytest.raises(Exception):  # noqa: B017 — the CPU build has no CUDA device
        ServerState(cfg)
    assert calls == ["lazy_init"]
    calls.clear()


def test_kernel_counts_sum_the_workers_epochs(served):
    """/stats kernels adds each pool's reported K1/K2 launches to this
    process's; /debug/kernels:reset zeroes both."""
    port, state, _ = served
    pool = state.runtimes["toy"]
    pool.kernels = {"flash_attention": 24, "by_shape": {"2x8x2x16": 24},
                    "flash_attention_stats": 0}
    k = json.loads(call(port, "GET", "/stats")[1])["kernels"]
    assert k["flash_attention"] == {"launches": 24, "by_shape": {"2x8x2x16": 24}}
    status, body = call(port, "POST", "/debug/kernels:reset")
    assert status == 200
    assert json.loads(body)["kernels"]["flash_attention"] == {"launches": 0, "by_shape": {}}
    assert pool.kernels["flash_attention"] == 0


def _pool_batcher(cfg: ModelConfig, injector=None):
    model = build(cfg)
    pool = DeferredPool(cfg, "", model, device="cpu", injector=injector)
    pool.prewarm()
    metrics = Metrics()
    return model, pool, metrics, ModelBatcher(model, pool, metrics)


def test_batcher_releases_admission_at_enqueue():
    """With max_inflight = 1, two batches sit on one worker before the first
    resolves: admission is given back when enqueue returns, not at the
    epoch's readback."""
    _, pool, _, b = _pool_batcher(ModelConfig(**toy_kwargs(
        batch_buckets=[1], max_inflight=1, relay_epoch_ms=1500.0)))

    async def go():
        await pool.start()
        await b.start()
        assert b.pipeline_stats()["mode"] == "deferred"
        assert b.pipeline_stats()["admission"] == 1
        f1 = b.submit(item(1))
        await asyncio.sleep(0.3)
        f2 = b.submit(item(2))
        for _ in range(100):
            if pool._active is not None and len(pool._active.pending) == 2:
                break
            await asyncio.sleep(0.02)
        assert pool._active is not None and len(pool._active.pending) == 2
        assert not f1.done()
        r1, r2 = await asyncio.wait_for(asyncio.gather(f1, f2), timeout=60)
        assert "top_k" in r1 and "top_k" in r2
        stats = b.pipeline_stats()
        assert stats["inflight_peak"] == 2 and stats["inflight"] == 0
        assert not {"depth", "arena", "staging_in_use"} & set(stats)
        assert b._inflight._value == 1  # released once per batch
        await b.stop()
        await pool.stop()

    asyncio.run(go())


def test_deferred_worker_death_retried_and_swept():
    """worker_death kills the active worker at an enqueue: the batch it held
    fails, the batcher's retry re-runs it on the replacement, and the
    watchdog's sweep reaps the dead handle (tests/test_faults.py's case)."""
    _, pool, metrics, b = _pool_batcher(
        ModelConfig(**toy_kwargs()), injector=FaultInjector.single("worker_death", count=1))

    async def go():
        await pool.start()
        await b.start()
        # The first request lands on worker A; the second enqueue kills A,
        # failing the first batch's future -> the batcher retries it onto
        # the replacement worker. Both clients still get results.
        f1 = b.submit(item())
        await asyncio.sleep(0.05)
        f2 = b.submit(item())
        r1, r2 = await asyncio.wait_for(asyncio.gather(f1, f2), timeout=60)
        assert "top_k" in r1 and "top_k" in r2
        assert metrics.counter("batch_retries_total{model=toy}").value >= 1
        assert pool.injector.snapshot()[0]["fired"] == 1
        pool.watchdog_sweep()  # reaps the killed worker's handle
        assert all(w.proc.is_alive() or w.retired or not w.pending for w in pool._workers)
        assert all(w.proc.is_alive() or w.said_bye for w in pool._workers)
        assert b._inflight._value == b._admission_cap  # the retry released nothing twice
        await b.stop()
        await pool.stop()

    asyncio.run(go())


@pytest.mark.parametrize("family", ["toy", "bert_flash"])
def test_pool_matches_reference_forward(family, tmp_path):
    """The worker's epoch rows against the reference's in-process forward on
    the same seeded weights (the reference's tree, as a .npz checkpoint the
    worker loads)."""
    if family == "toy":
        kw = dict(name="toy", family="toy", batch_buckets=[4], dtype="float32",
                  num_classes=10, parallelism="single")
        rng = np.random.default_rng(7)
        items = [rng.integers(0, 255, (8, 8, 3), dtype=np.uint8) for _ in range(3)]
        bucket, atol, valid = (4,), 1e-6, 3  # row 3 is padding: tied zeros
    else:
        kw = dict(name="bert", family="bert", batch_buckets=[4], seq_buckets=[16],
                  dtype="float32", num_classes=4, parallelism="single",
                  options=dict(BERT_TINY))
        items, bucket, atol, valid = None, (4, 16), 1e-5, 3
    jm = jax_build(JaxModelConfig(**kw))
    tree = jax.device_get(jm.init_params(jax.random.key(0)))
    ckpt = str(tmp_path / f"{family}.npz")
    savedmodel.save_npz(ckpt, tree)
    cfg = ModelConfig(**kw, weights=ckpt, session_mode="recycle", relay_epoch_ms=300.0)
    model = build(cfg)
    if items is None:
        items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
                 for t in TEXTS]
    host = model.assemble(items, bucket)
    want = jax.device_get(jm.forward(tree, host if family != "toy" else host[0]))
    pool = DeferredPool(cfg, "", model, device="cpu")
    pool.prewarm()

    async def go():
        await pool.start()
        try:
            return await asyncio.wait_for(pool.run_deferred(bucket, host), timeout=120)
        finally:
            await pool.stop()

    got = asyncio.run(go())
    np.testing.assert_array_equal(got["indices"][:valid], np.asarray(want["indices"])[:valid])
    np.testing.assert_allclose(got["probs"], np.asarray(want["probs"]), rtol=0, atol=atol)


def test_one_worker_death_counts_each_failed_batch_against_the_breaker():
    """A death fails every batch of its epoch at once and, as in the
    reference's batcher, each failed dispatch counts against the breaker:
    three batches on the dead worker open a breaker of threshold 3. The
    retries still answer all three, and the first that succeeds closes it."""
    from tpuserve_torch.faults import CircuitBreaker

    cfg = ModelConfig(**toy_kwargs(batch_buckets=[1], max_inflight=4, relay_epoch_ms=2000.0))
    model, pool, metrics, _ = _pool_batcher(cfg)
    br = CircuitBreaker("toy", 3, metrics)
    b = ModelBatcher(model, pool, metrics, breaker=br)

    async def go():
        await pool.start()
        await b.start()
        futs = []
        for i in range(3):
            futs.append(b.submit(item(i)))
            await asyncio.sleep(0.2)
        w = pool._active
        assert w is not None and len(w.pending) == 3
        w.proc.kill()
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=90)
        assert all("top_k" in r for r in results)
        assert metrics.counter("batch_retries_total{model=toy}").value == 3
        assert metrics.counter("batch_errors_total{model=toy}").value == 3
        assert br.describe()["opened_total"] == 1
        assert br.describe()["state"] == "closed"
        await b.stop()
        await pool.stop()

    asyncio.run(go())
