"""The port's batcher (``tpuserve_torch.batcher``) against the reference's
(``tpuserve.batcher``): each scenario of ``tests/test_batcher.py`` replayed on
both packages, on the CPU, with the toy model served from the same weights
(the JAX package's seed-0 tree; the port reads it from a ``.npz``).

Held exactly, on both packages: flush counts, fill ratios, QueueFull and
DeadlineExceeded, the retry, poison and breaker counters, AIMD targets,
batch-duration EWMAs and flush headrooms from injected durations and
deadlines. Held within 1e-6: the two packages' top-k probabilities for the
same items (float32 toy, two frameworks); class indices exactly. Timing
scenarios (the light-load flush, the saturated fill, the deadline that
expires behind a slow dispatch, the headroom flush) run at wider timings
than the reference's (seconds where it has tens of milliseconds), so
parallel test workers cannot break them; the ones timed against the
device run on the port only (the reference's own test covers its side).
"""

import asyncio
import concurrent.futures as cf
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from tpuserve import batcher as jbatcher
from tpuserve import config as jconfig
from tpuserve import faults as jfaults
from tpuserve import obs as jobs
from tpuserve.models import build as jax_build
from tpuserve.runtime import build_runtime as jax_build_runtime
from tpuserve_torch import batcher as tbatcher
from tpuserve_torch import config as tconfig
from tpuserve_torch import faults as tfaults
from tpuserve_torch import obs as tobs
from tpuserve_torch import savedmodel as sm
from tpuserve_torch.models import build as torch_build
from tpuserve_torch.runtime import build_runtime as torch_build_runtime

PKGS = ("jax", "port")
MODEL = dict(name="toy", family="toy", batch_buckets=[1, 2, 4], deadline_ms=30.0,
             dtype="float32", num_classes=10, parallelism="single", max_queue=16)
PROB_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    """Per package: (model, runtime, package modules), the toy built once
    from the JAX package's seed-0 tree."""
    jm = jax_build(jconfig.ModelConfig(**MODEL))
    tree = jax.device_get(jm.init_params(jax.random.key(0)))
    npz = str(tmp_path_factory.mktemp("toy") / "toy.npz")
    sm.save_npz(npz, tree)
    tm = torch_build(tconfig.ModelConfig(**MODEL, weights=npz))
    return {
        "jax": (jm, jax_build_runtime(jm), (jbatcher, jconfig, jfaults, jobs)),
        "port": (tm, torch_build_runtime(tm, device="cpu"),
                 (tbatcher, tconfig, tfaults, tobs)),
    }


def make_batcher(env, adaptive=None, model=None, **cfg_over):
    """A fresh batcher on the shared runtime; the model config is reset to
    MODEL's values (plus the reference's defaults) before the overrides."""
    m, rt, (bmod, cmod, _, omod) = env
    defaults = cmod.ModelConfig(**MODEL)
    for f in ("deadline_ms", "max_queue", "max_inflight", "batch_retry", "retry_split"):
        setattr(m.cfg, f, getattr(defaults, f))
    for k, v in cfg_over.items():
        setattr(m.cfg, k, v)
    metrics = omod.Metrics()
    acfg = adaptive if adaptive is not None else cmod.AdaptiveConfig()
    model = model if model is not None else m
    if bmod is jbatcher:
        b = bmod.ModelBatcher(model, rt, metrics, cf.ThreadPoolExecutor(max_workers=2),
                              adaptive_cfg=acfg)
    else:
        b = bmod.ModelBatcher(model, rt, metrics, adaptive_cfg=acfg)
    return b, metrics


def injector(env, kind, **kw):
    return env[2][2].FaultInjector.single(kind, **kw)


def counter(metrics, name):
    return metrics.counter(f"{name}{{model=toy}}").value


def item(seed: int = 0):
    return np.random.default_rng(seed).integers(0, 255, (8, 8, 3), dtype=np.uint8)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_flush_on_full(envs, pkg):
    async def go():
        b, metrics = make_batcher(envs[pkg], deadline_ms=10_000.0)
        await b.start()
        res = await asyncio.wait_for(asyncio.gather(*[b.submit(item()) for _ in range(4)]), 10)
        await b.stop()
        assert len(res) == 4 and all("top_k" in r for r in res)
        assert counter(metrics, "batches_total") == 1

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("n, fill", [(1, 1.0), (3, 0.75)])
def test_flush_on_deadline_pads_to_bucket(envs, pkg, n, fill):
    """One request flushes at the deadline into bucket 1 (fill 1.0); three
    pad to bucket 4 (fill 0.75)."""
    async def go():
        b, metrics = make_batcher(envs[pkg], adaptive=envs[pkg][2][1].AdaptiveConfig(
            enabled=False), deadline_ms=25.0)
        await b.start()
        res = await asyncio.wait_for(asyncio.gather(*[b.submit(item()) for _ in range(n)]), 10)
        await b.stop()
        assert len(res) == n
        assert metrics.gauge("batch_fill_ratio{model=toy}").value == fill

    run(go())


def test_same_top_k_on_both_packages(envs):
    """The same items through both batchers: class indices equal, top-k
    probabilities within 1e-6."""
    async def go(pkg):
        b, _ = make_batcher(envs[pkg], deadline_ms=10_000.0)
        await b.start()
        res = await asyncio.wait_for(
            asyncio.gather(*[b.submit(item(s)) for s in range(4)]), 10)
        await b.stop()
        return res

    jres, tres = run(go("jax")), run(go("port"))
    for j, t in zip(jres, tres):
        assert [e["class"] for e in j["top_k"]] == [e["class"] for e in t["top_k"]]
        np.testing.assert_allclose([e["prob"] for e in t["top_k"]],
                                   [e["prob"] for e in j["top_k"]], atol=PROB_TOL, rtol=0)


@pytest.mark.parametrize("pkg", PKGS)
def test_fault_containment(envs, pkg):
    """A batch_error that fires on every dispatch: the retry and the
    one-item bisection fail too, the future carries the fault, and the
    batcher keeps serving once it stops."""
    async def go():
        env = envs[pkg]
        b, metrics = make_batcher(env, deadline_ms=20.0)
        await b.start()
        b.injector = injector(env, "batch_error", metrics=metrics)
        with pytest.raises(env[2][2].FaultInjected, match="injected fault"):
            await asyncio.wait_for(b.submit(item()), 10)
        counts = {n: counter(metrics, n) for n in (
            "batch_errors_total", "batch_retries_total", "batch_retry_failures_total",
            "poison_items_total")}
        assert counts == {"batch_errors_total": 1, "batch_retries_total": 1,
                          "batch_retry_failures_total": 1, "poison_items_total": 1}
        b.injector = None
        assert "top_k" in await asyncio.wait_for(b.submit(item()), 10)
        await b.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("retry", [True, False])
def test_transient_fault(envs, pkg, retry):
    """A fault that fires once: absorbed by the one-shot retry (the client
    sees a result), or, with batch_retry off, failing the batch's future."""
    async def go():
        env = envs[pkg]
        b, metrics = make_batcher(env, deadline_ms=20.0, batch_retry=retry)
        await b.start()
        b.injector = injector(env, "batch_error", count=1, metrics=metrics)
        fut = b.submit(item())
        if retry:
            assert "top_k" in await asyncio.wait_for(fut, 10)
        else:
            with pytest.raises(env[2][2].FaultInjected):
                await asyncio.wait_for(fut, 10)
        assert counter(metrics, "batch_errors_total") == 1
        assert counter(metrics, "batch_retries_total") == (1 if retry else 0)
        assert counter(metrics, "batch_retry_failures_total") == 0
        await b.stop()

    run(go())


class _PoisonModel:
    """Delegating wrapper whose assemble raises when a poison item (an
    all-255 image) is in the batch (the reference's test wrapper)."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def assemble(self, items, bucket):
        if any(int(np.min(it)) == 255 for it in items):
            raise RuntimeError("poison item in batch")
        return self._inner.assemble(items, bucket)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("split", [True, False])
def test_poison_item_isolated_by_split_retry(envs, pkg, split):
    """With retry_split, one poison item in a full batch fails only its own
    future; without it, the retry fails the whole batch."""
    async def go():
        env = envs[pkg]
        b, metrics = make_batcher(env, model=_PoisonModel(env[0]), deadline_ms=10_000.0,
                                  retry_split=split)
        await b.start()
        assert b.arena is None  # a wrapper overriding assemble skips the arena
        good = [b.submit(item(s)) for s in range(3)]
        poison = b.submit(np.full((8, 8, 3), 255, dtype=np.uint8))
        results = await asyncio.wait_for(
            asyncio.gather(*good, poison, return_exceptions=True), 30)
        await b.stop()
        assert isinstance(results[3], RuntimeError) and "poison" in str(results[3])
        if split:
            assert all("top_k" in r for r in results[:3])
        else:
            assert all(isinstance(r, RuntimeError) for r in results[:3])
        assert counter(metrics, "poison_items_total") == (1 if split else 0)
        assert counter(metrics, "batch_retries_total") == 1
        # Whole batch, retry, then (split) halves [a, b] ok and [c, p]
        # failing, then c ok and p failing: 2 failures after the first.
        assert counter(metrics, "batch_retry_failures_total") == (3 if split else 1)

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_load_shedding(envs, pkg):
    async def go():
        env = envs[pkg]
        b, metrics = make_batcher(env, max_queue=2, deadline_ms=10_000.0)
        await b.start()
        f1, f2 = b.submit(item()), b.submit(item())
        await asyncio.sleep(0.05)  # the group loop runs; the batch is not full
        with pytest.raises(env[2][0].QueueFull):
            b.submit(item())
        assert counter(metrics, "shed_total") == 1
        f1.cancel(), f2.cancel()
        await b.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_submit_before_start_raises(envs, pkg):
    b, _ = make_batcher(envs[pkg])
    with pytest.raises(RuntimeError, match="not started"):
        b.submit(item())


@pytest.mark.parametrize("pkg", PKGS)
def test_stop_fails_queued_futures(envs, pkg):
    async def go():
        b, _ = make_batcher(envs[pkg], deadline_ms=10_000.0)
        await b.start()
        futs = [b.submit(item()) for _ in range(2)]
        await b.stop()
        for f in futs:
            assert f.done()
            assert f.cancelled() or isinstance(f.exception(), RuntimeError)

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_cancelled_requests_skipped(envs, pkg):
    async def go():
        b, _ = make_batcher(envs[pkg], deadline_ms=40.0)
        await b.start()
        f1, f2 = b.submit(item()), b.submit(item())
        f1.cancel()
        assert "top_k" in await asyncio.wait_for(f2, 10)
        await b.stop()

    run(go())


def test_deadline_expired_in_queue_fails_fast(envs):
    """A request whose 200 ms deadline passes while it waits behind a 2 s
    dispatch stall fails AT its deadline with DeadlineExceeded, never
    dispatched; the stalled request and later ones still serve."""
    async def go():
        env = envs["port"]
        b, metrics = make_batcher(env, deadline_ms=20.0, max_inflight=1)
        await b.start()
        try:
            b.injector = injector(env, "slow_dispatch", delay_ms=2000.0, count=1)
            slow = b.submit(item())
            await asyncio.sleep(0.1)  # dispatched, slot held
            t0 = time.perf_counter()
            doomed = b.submit(item(), deadline_at=t0 + 0.2)
            with pytest.raises(tbatcher.DeadlineExceeded, match="deadline expired"):
                await asyncio.wait_for(doomed, 10)
            assert time.perf_counter() - t0 < 1.5  # at the deadline, not at slot free
            assert counter(metrics, "deadline_exceeded_total") == 1
            assert "top_k" in await asyncio.wait_for(slow, 10)
            assert "top_k" in await asyncio.wait_for(b.submit(item()), 10)
            assert b.pending == 0
        finally:
            await b.stop()

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_generous_deadline_dispatches_normally(envs, pkg):
    async def go():
        b, metrics = make_batcher(envs[pkg], deadline_ms=20.0)
        await b.start()
        fut = b.submit(item(), deadline_at=time.perf_counter() + 30.0)
        assert "top_k" in await asyncio.wait_for(fut, 10)
        assert counter(metrics, "deadline_exceeded_total") == 0
        await b.stop()

    run(go())


# -- the adaptive flush: AIMD target, EWMA, headroom -----------------------------

def _aimd_trace(env) -> list:
    b, metrics = make_batcher(env, adaptive=env[2][1].AdaptiveConfig(increase=1.0,
                                                                      decrease=0.5))
    g = None
    steps = [(2.0, 2, 2, False, True), (4.0, 4, 4, False, True), (1.0, 1, 1, False, False),
             (4.0, 1, 4, True, False), (1.2, 1, 2, True, False), (2.0, 1, 2, False, False),
             (3.0, 3, 3, False, True), (2.5, 2, 3, True, False)]
    out = []
    for tgt, n, target_n, timer, pressure in steps:
        b._aimd_update(g, tgt, n=n, target_n=target_n, timer_flush=timer, pressure=pressure)
        out.append((b._targets[g], metrics.gauge("adaptive_target_batch{model=toy}").value))
    return out


def test_aimd_grows_on_pressure_shrinks_on_timer(envs):
    """The same AIMD updates give the same targets and gauge values on both
    packages; the reference's expected sawtooth is held too."""
    jt, tt = _aimd_trace(envs["jax"]), _aimd_trace(envs["port"])
    assert tt == jt
    assert [t for t, _ in tt][:6] == [3.0, 4.0, 1.0, 2.0, 1.0, 2.0]


def _ewma_trace(env, durations) -> list:
    b, metrics = make_batcher(env, adaptive=env[2][1].AdaptiveConfig(ewma_alpha=0.3))
    out = []
    for bucket, ms in durations:
        b._observe_batch_duration(bucket, ms)
        out.append((dict(b._ewma_ms), metrics.gauge("batch_duration_ewma_ms{model=toy}").value,
                    b.predicted_service_s(1), b.predicted_service_s(3)))
    return out


def test_batch_duration_ewma_tracks_observations(envs):
    durations = [((4,), 10.0), ((4,), 20.0), ((1,), 2.0), ((4,), 7.5), ((2,), 4.25),
                 ((1,), 3.0)]
    jt, tt = _ewma_trace(envs["jax"], durations), _ewma_trace(envs["port"], durations)
    assert tt == jt
    assert tt[1][0][(4,)] == pytest.approx(13.0)  # 10 + 0.3 * (20 - 10)


def _headroom(env, deadlines, ewma) -> list:
    b, _ = make_batcher(env, adaptive=env[2][1].AdaptiveConfig(slack_ms=2.0))
    b._ewma_ms.update(ewma)

    async def go():
        loop = asyncio.get_running_loop()
        reqs = [env[2][0]._Request(item=item(), group=None, future=loop.create_future(),
                                   enqueued_at=0.0, deadline_at=d) for d in deadlines]
        return [b._flush_headroom(reqs[:k]) for k in range(1, len(reqs) + 1)]

    return run(go())


def test_flush_headroom_from_earliest_deadline(envs):
    """The earliest member deadline less EWMA(bucket) + slack; +inf with no
    deadline; held on injected deadlines and EWMAs."""
    deadlines = [None, 100.0, 99.5, None]
    ewma = {(2,): 8.0, (4,): 12.0}
    jh, th = _headroom(envs["jax"], deadlines, ewma), _headroom(envs["port"], deadlines, ewma)
    assert th == jh
    assert th[0] == float("inf")
    assert th[1] == pytest.approx(100.0 - 0.010)
    assert th[2] == pytest.approx(99.5 - 0.014)


def test_estimate_clear_and_retry_after(envs):
    """Queue-clear estimates from injected EWMAs, and the [1, 30] s clamp of
    the Retry-After hint, equal on both packages."""
    def trace(env):
        b, _ = make_batcher(env)
        b._ewma_ms.update({(1,): 2.0, (4,): 10.0})
        out = [b.estimate_clear_s()]
        for pending in (1, 100, 4000, 100_000):
            b._pending = pending
            est = b.estimate_clear_s()
            out.append((est, env[2][0].clamp_retry_after_s(est)))
        return out

    assert trace(envs["port"]) == trace(envs["jax"])
    assert tbatcher.clamp_retry_after_s(None) is None


def test_adaptive_light_load_flushes_before_max_wait(envs):
    """After timer flushes shrink the target to 1, lone requests flush at
    once instead of waiting out deadline_ms: p50 under half the fixed-timer
    baseline measured in the same test."""
    env = envs["port"]

    async def sequential_p50(b) -> float:
        lats = []
        for _ in range(5):
            t0 = time.perf_counter()
            await asyncio.wait_for(b.submit(item()), 10)
            lats.append(time.perf_counter() - t0)
        return sorted(lats)[len(lats) // 2]

    async def go():
        b, _ = make_batcher(env, adaptive=tconfig.AdaptiveConfig(enabled=False),
                            deadline_ms=300.0)
        await b.start()
        fixed_p50 = await sequential_p50(b)
        await b.stop()
        assert fixed_p50 >= 0.290, fixed_p50
        b, metrics = make_batcher(env, adaptive=tconfig.AdaptiveConfig(decrease=0.25),
                                  deadline_ms=300.0)
        await b.start()
        await sequential_p50(b)  # the first lone flushes shrink the target 4 -> 1
        assert b._targets[None] == 1.0
        adaptive_p50 = await sequential_p50(b)
        await b.stop()
        assert adaptive_p50 < fixed_p50 / 2, (adaptive_p50, fixed_p50)
        assert metrics.gauge("adaptive_target_batch{model=toy}").value == 1.0

    run(go())


def test_adaptive_saturated_load_fills_buckets(envs):
    """With the queue never empty the target stays at the largest bucket and
    every batch fills: 32 items in 8 batches of 4. The precondition holds by
    construction: all 32 items are queued before the group loop first runs,
    and the max-wait timer (30 s) cannot expire while the loop works through
    them, so no flush is timer-driven. (At 50 ms, as in the reference's test,
    the items at the back of the queue outlived the timer behind the
    admission slots whenever parallel test workers slowed the forwards, and
    the timer flushes shrank the target to 1 or 2.) A timer-driven flush
    under a full queue, and its effect on the target, is held only by the
    reference's twin of this test in tests/test_batcher.py."""
    async def go():
        b, metrics = make_batcher(envs["port"], deadline_ms=30_000.0, max_queue=64)
        await b.start()
        futs = [b.submit(item()) for _ in range(32)]
        assert b._pending == 32  # queued before the group loop takes a batch
        await asyncio.wait_for(asyncio.gather(*futs), 30)
        await b.stop()
        assert counter(metrics, "items_total") == 32
        assert counter(metrics, "batches_total") == 8
        assert b._targets[None] == 4.0

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_adaptive_deadline_headroom_preempts_accumulation(envs, pkg):
    """A lone request whose deadline leaves less headroom than EWMA + slack
    flushes then, not at the 30 s max-wait timer. The slack (500 ms) leaves
    the flushed batch room to reach the device before its deadline when
    parallel test workers load the host (the reference's test takes 2 ms
    of slack and a 150 ms deadline)."""
    async def go():
        env = envs[pkg]
        b, metrics = make_batcher(env, adaptive=env[2][1].AdaptiveConfig(
            initial_target=4, slack_ms=500.0), deadline_ms=30_000.0)
        await b.start()
        # Seeds the duration model (flushed by its own headroom bound).
        await asyncio.wait_for(b.submit(item(), deadline_at=time.perf_counter() + 1.0), 10)
        b._targets[None] = 4.0
        t0 = time.perf_counter()
        res = await asyncio.wait_for(b.submit(item(), deadline_at=t0 + 1.0), 10)
        took = time.perf_counter() - t0
        await b.stop()
        assert "top_k" in res and took < 5.0, took
        assert counter(metrics, "deadline_exceeded_total") == 0

    run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_breaker_fed_by_dispatch_outcomes(envs, pkg):
    """Dispatch failures feed the model's breaker (each failed attempt of a
    batch counts once, the retry's included); a success closes it."""
    async def go():
        env = envs[pkg]
        b, metrics = make_batcher(env, deadline_ms=5.0, batch_retry=False)
        br = env[2][2].CircuitBreaker("toy", threshold=3, metrics=metrics)
        b.breaker = br
        await b.start()
        b.injector = injector(env, "batch_error", metrics=metrics)
        for _ in range(3):
            with pytest.raises(env[2][2].FaultInjected):
                await asyncio.wait_for(b.submit(item()), 10)
        assert br.describe() == {"state": "open", "threshold": 3, "consecutive_errors": 3,
                                 "opened_total": 1, "shed_total": 0}
        assert metrics.gauge("breaker_state{model=toy}").value == 2.0
        b.injector = None
        assert "top_k" in await asyncio.wait_for(b.submit(item()), 10)
        assert br.state == "closed"
        await b.stop()

    run(go())


def test_start_pins_every_bucket_arena(envs):
    """``start`` makes every bucket's arena slots, so the first batch of a
    bucket allocates nothing on the request path (the first-request fault
    of the ResNet-50 path); the config's arena_slots sizes them."""
    async def go():
        m, rt, _ = envs["port"]
        b = tbatcher.ModelBatcher(m, rt, tobs.Metrics(),
                                  pipeline_cfg=tconfig.PipelineConfig(arena_slots=3))
        await b.start()
        stats = b.arena.stats()
        assert stats["buckets"] == {str([n]): {"pooled": 3, "free": 3} for n in (1, 2, 4)}
        allocs = []
        real = b.arena._alloc
        b.arena._alloc = lambda bucket: allocs.append(bucket) or real(bucket)
        res = await asyncio.wait_for(asyncio.gather(*[b.submit(item()) for _ in range(3)]), 10)
        assert len(res) == 3 and allocs == []
        assert b.arena.stats()["overflow_total"] == 0
        await b.stop()

    run(go())


def test_config_parity_adaptive_and_retry_fields():
    """The new typed fields carry the reference's defaults and checks."""
    for cls in ("AdaptiveConfig", "CacheConfig"):
        assert dataclasses.asdict(getattr(tconfig, cls)()) == \
            dataclasses.asdict(getattr(jconfig, cls)())
    for f in ("batch_retry", "retry_split", "breaker_threshold", "breaker_retry_after_s",
              "cacheable"):
        assert getattr(tconfig.ModelConfig(name="m"), f) == getattr(jconfig.ModelConfig(name="m"), f)
    for bad in (dict(min_target=0), dict(decrease=0.0), dict(ewma_alpha=2.0), dict(slack_ms=-1)):
        with pytest.raises(ValueError) as jerr:
            jconfig.AdaptiveConfig(**bad)
        with pytest.raises(ValueError) as terr:
            tconfig.AdaptiveConfig(**bad)
        assert str(terr.value) == str(jerr.value)
