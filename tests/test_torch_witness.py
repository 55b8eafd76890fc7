"""The lock-order witness (``tpuserve_torch.analysis.witness``) against the
reference's (``tpuserve/analysis/witness.py``): each scenario of
``tests/test_witness.py`` runs through both packages' witnesses, and the
outcomes are held EXACTLY equal — which acquisitions raise and with which
violation class, the recorded violations' kinds, the graph's edges and
counts, the wrappers' lock semantics, and the env-driven constructors of
each package's ``utils.locks``. Then the port's toy server runs in process
on the CPU with ``TPUSERVE_LOCK_WITNESS=1``: a few requests, and ``/stats``
``robustness.lock_witness`` shows witnessed locks, acquisitions and no
violation (the pass is not vacuous).
"""

import asyncio
import io
import json
import threading

import numpy as np
import pytest

from tpuserve.analysis import witness as jwitness
from tpuserve.utils import locks as jlocks
from tpuserve_torch.analysis import witness as twitness
from tpuserve_torch.utils import locks as tlocks

PKGS = {"jax": (jwitness, jlocks), "port": (twitness, tlocks)}


@pytest.fixture(autouse=True)
def _forced_witness():
    for w, _ in PKGS.values():
        w.force(True)
        w.reset()
    yield
    for w, _ in PKGS.values():
        w.reset()
        w.force(None)


def both(scenario) -> dict:
    """``scenario(witness module, locks module)`` on each package."""
    return {pkg: scenario(w, locks) for pkg, (w, locks) in PKGS.items()}


def _raises(fn, exc) -> str | None:
    """The exception class name ``fn`` raised (an ``exc``), or None."""
    try:
        fn()
    except exc as e:
        return type(e).__name__
    return None


def ab_ba(w, _locks):
    a, b = w.WitnessLock("wit_a"), w.WitnessLock("wit_b")
    with a:
        with b:
            pass
    with b:
        raised = _raises(a.acquire, w.WitnessViolation)
    msg = w.snapshot()["violations"][0]["message"]
    return raised, "wit_a" in msg and "wit_b" in msg, [v["kind"] for v in w.snapshot()["violations"]]


def across_threads(w, _locks):
    a, b = w.WitnessLock("xt_a"), w.WitnessLock("xt_b")

    def worker():
        with a:
            with b:
                pass

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    with b:
        return _raises(a.acquire, w.WitnessViolation)


def same_site_node(w, _locks):
    pool1, pool2 = w.WitnessLock("pool"), w.WitnessLock("pool")
    other = w.WitnessLock("other")
    with pool1:
        with other:
            pass
    with other:
        return _raises(pool2.acquire, w.WitnessViolation), w.snapshot()["locks"]


def consistent_order(w, _locks):
    a, b = w.WitnessLock("ok_a"), w.WitnessLock("ok_b")
    for _ in range(3):
        with a:
            with b:
                pass
    snap = w.snapshot()
    return snap["violations"], snap["edges"], snap["acquisitions"]


def real_lock(w, _locks):
    lock = w.WitnessLock("mutex")
    return (lock.acquire(), lock.locked(), lock.acquire(blocking=False),
            lock.release(), lock.locked())


def held_across_await(w, _locks):
    lock = w.WitnessLock("held")

    async def bad():
        with lock:
            await asyncio.sleep(0)

    async def main():
        w.install()
        try:
            await asyncio.get_running_loop().create_task(bad())
        except w.WitnessViolation as e:
            return type(e).__name__, "held" in str(e), lock.locked()
        return None

    return asyncio.run(main())


def release_before_await(w, _locks):
    lock = w.WitnessLock("brief")

    async def good():
        with lock:
            x = 41
        await asyncio.sleep(0)
        return x + 1

    async def boom():
        await asyncio.sleep(0)
        raise ValueError("boom")

    async def hang():
        await asyncio.sleep(30)

    async def main():
        w.install()
        loop = asyncio.get_running_loop()
        value = await loop.create_task(good())
        err = None
        try:
            await loop.create_task(boom())
        except ValueError as e:
            err = str(e)
        task = loop.create_task(hang())
        await asyncio.sleep(0)
        task.cancel()
        cancelled = False
        try:
            await task
        except asyncio.CancelledError:
            cancelled = True
        return value, err, cancelled

    return asyncio.run(main()), w.snapshot()["violations"]


def async_lock_order(w, _locks):
    async def main():
        w.install()
        a, b = w.WitnessAsyncLock("aio_a"), w.WitnessAsyncLock("aio_b")
        async with a:
            await asyncio.sleep(0)  # legal for asyncio locks
            async with b:
                pass
        async with b:
            try:
                async with a:
                    pass
            except w.WitnessViolation as e:
                return type(e).__name__
        return None

    return asyncio.run(main())


CASES = [
    (ab_ba, ("LockOrderViolation", True, ["lock_order"])),
    (across_threads, "LockOrderViolation"),
    (same_site_node, ("LockOrderViolation", ["other", "pool"])),
    (consistent_order, ([], [["ok_a", "ok_b", 3]], 6)),
    (real_lock, (True, True, False, None, False)),
    (held_across_await, ("LockHeldAcrossAwait", True, False)),
    (release_before_await, ((42, "boom", True), [])),
    (async_lock_order, "LockOrderViolation"),
]


@pytest.mark.parametrize("scenario, expected", CASES, ids=[c[0].__name__ for c in CASES])
def test_witness_scenarios_equal_the_reference(scenario, expected):
    """Exact: the outcome tuples of both witnesses, and the expected one."""
    out = both(scenario)
    assert out["port"] == out["jax"] == expected


def test_violation_messages_equal_the_reference():
    """The port builds its site stacks from the live frames (no source-line
    lookups); the messages, sites included, are the reference's."""
    def messages(w, _locks):
        a, b = w.WitnessLock("msg_a"), w.WitnessLock("msg_b")
        with a:
            with b:
                pass
        with b:
            _raises(a.acquire, w.WitnessViolation)
        lock = w.WitnessLock("msg_held")

        async def bad():
            with lock:
                await asyncio.sleep(0)

        async def main():
            w.install()
            try:
                await asyncio.get_running_loop().create_task(bad())
            except w.WitnessViolation:
                pass

        asyncio.run(main())
        return [(v["kind"], v["message"], v["stack"]) for v in w.snapshot()["violations"]]

    out = both(messages)
    assert out["port"] == out["jax"]
    assert [k for k, _, _ in out["port"]] == ["lock_order", "held_across_await"]
    assert "(acquired at " in out["port"][1][1]


def test_new_lock_respects_env(monkeypatch):
    """Each package's ``new_lock``/``new_async_lock`` returns its witness
    wrapper under TPUSERVE_LOCK_WITNESS=1 and a raw lock without it."""
    def scenario(w, locks):
        w.force(None)  # the environment variable decides
        monkeypatch.setenv("TPUSERVE_LOCK_WITNESS", "1")
        on = (type(locks.new_lock("env_t")) is w.WitnessLock,
              type(locks.new_async_lock("env_a")) is w.WitnessAsyncLock)
        monkeypatch.delenv("TPUSERVE_LOCK_WITNESS")
        off = (isinstance(locks.new_lock("env_t2"), w.WitnessLock),
               isinstance(locks.new_async_lock("env_a2"), w.WitnessAsyncLock))
        return on, off

    out = both(scenario)
    assert out["port"] == out["jax"] == ((True, True), (False, False))


def test_port_toy_server_clean_under_witness(monkeypatch):
    """The port's server built with ``TPUSERVE_LOCK_WITNESS=1`` (every lock
    of ``utils.locks`` a witness wrapper, the task factory installed on the
    main loop) serves requests over HTTP: ``/stats``
    ``robustness.lock_witness`` lists witnessed locks and acquisitions with
    no violation, and no ``retrace_witness`` block (that witness is off)."""
    from tpuserve_torch.bench.client import ClientSession
    from tpuserve_torch.config import ModelConfig, ServerConfig
    from tpuserve_torch.server import ServerState, start_server, stop_server

    twitness.force(None)
    monkeypatch.setenv("TPUSERVE_LOCK_WITNESS", "1")
    monkeypatch.delenv("TPUSERVE_RETRACE_WITNESS", raising=False)
    cfg = ServerConfig(
        decode_threads=2, startup_canary=True,
        models=[ModelConfig(name="toy", family="toy", batch_buckets=[1, 2],
                            deadline_ms=2.0, dtype="float32", num_classes=10,
                            parallelism="single", wire_size=8,
                            request_timeout_ms=10_000.0)])
    state = ServerState(cfg, device="cpu")
    state.build()
    buf = io.BytesIO()
    np.save(buf, np.zeros((8, 8, 3), dtype=np.uint8))

    async def go():
        server = await start_server(state, host="127.0.0.1", port=0)
        base = "http://127.0.0.1:%d" % state.serving_addresses[0][1]
        session = ClientSession()
        try:
            statuses = []
            for _ in range(3):
                r = await session.request("POST", base + "/v1/models/toy:predict",
                                          data=buf.getvalue(),
                                          headers={"Content-Type": "application/x-npy"})
                statuses.append(r.status)
            stats = json.loads((await session.request("GET", base + "/stats")).body)
        finally:
            await session.close()
            await stop_server(state, server)
        return statuses, stats["robustness"]

    statuses, rob = asyncio.run(go())
    assert statuses == [200, 200, 200]
    lock = rob["lock_witness"]
    assert lock["violations"] == []
    assert lock["acquisitions"] > 0 and "obs.Metrics" in lock["locks"], lock
    assert "retrace_witness" not in rob
    assert twitness.snapshot()["violations"] == []
