"""Deferred-readback execution pool, ported from ``tpuserve/deferred.py``.

The reference built this mode for a relay link in front of its TPU, where a
dependent device-to-host read cost ~190 ms a batch: a server that read its
results after every batch was latency-bound whatever the chip's speed. Its
answer was to make the read rare:

- **Worker processes** each own one device context. A worker builds the
  model, then serves an *epoch* of batches append-only: every forward's
  outputs are copied into an accumulator that stays on the device, with no
  device-to-host traffic during the epoch.
- At **retirement** the worker makes ONE bulk read of the accumulator,
  ships the rows back over shared memory and exits. A prewarmed successor
  is serving by then.
- The **pool** (in the server's process) routes batches to the active
  worker over shared-memory slots, rotates workers on a row and deadline
  budget, and resolves each batch's future when its worker's rows arrive.

An H100 has no such link, so this mode buys no speed here: it is served
because the reference serves it. ``session_mode = "direct"`` stays the
default; "recycle" trades result latency (bounded by ``relay_epoch_ms``)
for one read per epoch. The batcher's API is the same in both modes.

On the card, a worker is a process started with ``spawn`` (CUDA cannot
run in a forked child): it builds its runtime on the device the pool names
(``build_runtime(model, device=..., n_slots=1)``: one parameter slot and
one CUDA graph per bucket, since a worker runs no lifecycle), after
pointing the kernels' build at the server's ``compilation_cache_dir``.
Each batch is copied from its shared-memory slot by the runtime's ``h2d``
(on the card a synchronous copy into pinned memory, then the device copy;
on the CPU the slot's views are copied first, since ``torch.from_numpy``
aliases them), so the slot is free once ``h2d`` returns and the worker acks
it then. The bucket's graph replays, and each output is appended with
``acc[k][off:off + b].copy_(out[k])`` on the replay's stream. At
``retire`` the worker synchronizes the device and copies each accumulator
to the host once (``read_s``), and reports the K1/K2 launches its process
made over the epoch; the pool sums them into the server's ``/stats``
``kernels``.

Protocol (the pipe carries control, shared memory carries data):

    pool (server process)                 worker process (one device context)
    ---------------------                 -----------------------------------
    spawn  ───────────────────────────▶   build the model, capture the buckets,
                                          allocate the accumulator
    ◀─ {"op": "ready"} ────────────────
    write batch planes into a shm slot
    ── {"op": "batch", slot, off} ────▶   views of the slot, h2d, replay,
                                          append at off
    ◀─ {"op": "ack", slot} ────────────   (slot reusable)
    ── {"op": "retire"} ──────────────▶   acc.cpu()  <- the one read
    ◀─ {"op": "results", shm, shapes} ─   rows in a results shm it created
    scatter rows to the batch futures
    ── {"op": "bye"} ─────────────────▶   unlink the results shm, exit

A worker that fails sends ``{"op": "died"}`` (or its pipe closes); its
pending futures fail, the batcher's retry re-runs them on a live worker,
and the watchdog's sweep reaps the handle. One death fails every batch of
the epoch at once, and each counts against the model's circuit breaker.

Lock and thread ownership (three lock families on purpose):

- **Event-loop-owned, no lock**: ``_active``, each worker's ``pending`` /
  ``rows_used`` / ``first_batch_t`` / ``retired`` / ``reader_started``,
  ``stats``, ``kernels``, ``_spawning``, ``_bg_tasks``. Mutated only from
  coroutines or loop callbacks (``_on_msg`` arrives via
  ``call_soon_threadsafe``).
- **``_lock`` (asyncio.Lock, loop only)**: serializes ``enqueue`` end to
  end — slot pop, shm write (hopped to the executor WHILE the lock stays
  held, which is legal for an asyncio lock and why it is not a threading
  lock), epoch bookkeeping and the batch send.
- **``_roster_lock`` (threading, microseconds)**: guards the worker roster
  — ``_workers``, ``_warm``, ``_next_wid``, ``boots`` — which both the loop
  (``_next_warm`` via ``_ensure_active``, ``watchdog_sweep``) and executor
  threads (``_dry_acquire`` / ``_spawn_blocking``) mutate. Never held
  across anything slow.
- **``_spawn_mutex`` (threading, seconds)**: serializes worker spawns
  (concurrent ``Process.start()`` from two threads races pipe fds). Taken
  only on executor threads, never on the loop; it may nest
  ``_roster_lock`` inside it (spawn -> roster is the one sanctioned order),
  never the reverse.
- **``_PinnedShm``'s own lock (threading)**: pin/unpin/close accounting,
  taken from both the loop (close at retirement) and slot-writer threads.
"""

from __future__ import annotations

import asyncio
import logging
import multiprocessing as mp
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from multiprocessing import shared_memory

import numpy as np

from tpuserve_torch.config import ModelConfig
from tpuserve_torch.hostpipe import SlotPool, SlotsClosed
from tpuserve_torch.utils.locks import new_async_lock, new_lock

log = logging.getLogger("tpuserve_torch.deferred")

# Worker boots kept for describe() (boot time and memory of each).
_BOOTS_KEPT = 16


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------

def _worker_main(mcfg: ModelConfig, cache_dir: str, device: str, conn,
                 batch_shm_name: str, slot_bytes: int, cap_rows: int) -> None:
    """Worker entry (the spawn target): one device context, one epoch of
    batches, one readback."""
    try:
        _worker_run(mcfg, cache_dir, device, conn, batch_shm_name, slot_bytes, cap_rows)
    except Exception as e:  # noqa: BLE001 — report any death to the pool
        try:
            conn.send({"op": "died", "error": f"{type(e).__name__}: {e}"})
        except Exception:  # noqa: BLE001 — the pool may be gone already
            pass
    finally:
        try:
            conn.close()
        except Exception:  # noqa: BLE001
            pass


def _worker_run(mcfg, cache_dir, device, conn, batch_shm_name, slot_bytes, cap_rows) -> None:
    t_start = time.perf_counter()
    import torch

    from tpuserve_torch.models import build
    from tpuserve_torch.ops import _build
    from tpuserve_torch.ops import flash_attention as fa
    from tpuserve_torch.runtime import build_runtime

    if cache_dir:
        _build.set_build_dir(cache_dir)
    model = build(mcfg)
    rt = build_runtime(model, device=device, n_slots=1)
    cuda = rt.device.type == "cuda"
    # The outputs' rows (shapes past the batch dim) are bucket-independent:
    # one call of the first bucket gives each output's row shape and dtype.
    b0 = tuple(model.buckets()[0])
    probe = rt.dispatch(b0, rt.h2d(b0, rt._zeros(b0)))
    with torch.inference_mode():
        acc = {k: torch.zeros((cap_rows,) + tuple(v.shape[1:]), dtype=v.dtype,
                              device=rt.device) for k, v in probe.items()}
    del probe
    if cuda:
        torch.cuda.synchronize(rt.device)
    # The epoch's kernel counts start at its first batch.
    fa.reset_launches()

    batch_shm = shared_memory.SharedMemory(name=batch_shm_name)
    sigs = {tuple(b): model.input_signature(tuple(b)) for b in model.buckets()}
    conn.send({"op": "ready", "pid": os.getpid(),
               "boot_s": time.perf_counter() - t_start,
               "memory_reserved_bytes": (torch.cuda.memory_reserved(rt.device)
                                         if cuda else 0)})

    results_shm = None
    try:
        while True:
            msg = conn.recv()
            op = msg["op"]
            if op == "batch":
                bucket = tuple(msg["bucket"])
                slot, off = msg["slot"], msg["off"]
                views = _views_from_slot(batch_shm.buf, slot * slot_bytes, sigs[bucket])
                if not cuda:
                    # torch.from_numpy aliases the slot: copy it before the
                    # ack lets the pool overwrite it.
                    views = tuple(np.array(v) for v in views)
                # On the card h2d pins each view with a synchronous host
                # copy, so nothing reads the slot once it returns.
                dev = rt.h2d(bucket, views)
                # Release the views NOW: a lingering exported pointer makes
                # batch_shm.close() raise BufferError at retirement.
                del views
                out = rt.dispatch(bucket, dev)
                with torch.inference_mode():
                    for k, a in acc.items():
                        a[off:off + bucket[0]].copy_(out[k])
                del dev, out
                conn.send({"op": "ack", "slot": slot})
            elif op == "retire":
                if cuda:
                    torch.cuda.synchronize(rt.device)
                t0 = time.perf_counter()
                host = [(k, a.cpu().numpy()) for k, a in acc.items()]  # THE readback
                read_s = time.perf_counter() - t0
                total = sum(h.nbytes for _, h in host)
                results_shm = shared_memory.SharedMemory(create=True, size=max(1, total))
                offb = 0
                shapes = []
                for k, h in host:
                    flat = np.frombuffer(results_shm.buf, dtype=np.uint8,
                                         count=h.nbytes, offset=offb)
                    flat[:] = h.reshape(-1).view(np.uint8)
                    shapes.append((k, h.shape, str(h.dtype), offb))
                    offb += h.nbytes
                    del flat  # an exported pointer would break results_shm.close()
                kernels = {"flash_attention": fa.launches,
                           "by_shape": {"x".join(map(str, s)): n
                                        for s, n in sorted(fa.shape_launches.items())},
                           "flash_attention_stats": fa.stats_launches}
                conn.send({"op": "results", "shm": results_shm.name, "shapes": shapes,
                           "read_s": read_s, "kernels": kernels})
                conn.recv()  # "bye": the pool has copied the rows out
                return
            elif op == "bye":
                return
    finally:
        batch_shm.close()
        if results_shm is not None:
            results_shm.close()
            results_shm.unlink()


def _views_from_slot(buf, base: int, sig) -> tuple:
    """Zero-copy numpy views into a shm slot, laid out input after input."""
    views = []
    off = base
    for spec in sig:
        count = int(np.prod(spec.shape))
        views.append(np.frombuffer(buf, dtype=spec.dtype, count=count,
                                   offset=off).reshape(spec.shape))
        off += count * np.dtype(spec.dtype).itemsize
    return tuple(views)


# ---------------------------------------------------------------------------
# Pool (server process)
# ---------------------------------------------------------------------------

@dataclass
class _PendingBatch:
    off: int
    bucket: tuple
    future: asyncio.Future = field(repr=False)


class _PinnedShm:
    """SharedMemory whose close+unlink defers while slot writes are in flight.

    ``_write_slot`` runs on an executor thread; the epoch readback (and the
    worker-died path) run on the event loop and end in ``_Worker.close()``.
    Without a pin, close() unlinks the segment mid-copy and the writer's
    ``np.frombuffer(buf, ...)`` dies with "buffer is smaller than requested
    size": a 500 on an innocent request at an epoch rotation under load.
    Writers pin before touching ``buf``; close() only marks intent while pins
    are held, and the last unpin performs the deferred release. A pin after
    close was requested fails, telling the writer to route the batch to a
    live worker instead.
    """

    def __init__(self, size: int) -> None:
        self._shm = shared_memory.SharedMemory(create=True, size=size)
        self._lock = new_lock("deferred.pinned_shm")
        self._writes = 0
        self._close_requested = False
        self._released = False

    @property
    def name(self) -> str:
        return self._shm.name

    @property
    def buf(self):
        return self._shm.buf

    def pin(self) -> bool:
        """Claim the segment for one write; False once close was requested."""
        with self._lock:
            if self._close_requested:
                return False
            self._writes += 1
            return True

    def unpin(self) -> None:
        with self._lock:
            self._writes -= 1
            release = self._close_requested and self._writes == 0 and not self._released
            if release:
                self._released = True
        if release:
            self._release()

    def close(self) -> None:
        """Release now, or defer to the last unpin if a write is in flight."""
        with self._lock:
            self._close_requested = True
            release = self._writes == 0 and not self._released
            if release:
                self._released = True
        if release:
            self._release()

    def _release(self) -> None:
        try:
            self._shm.close()
            self._shm.unlink()
        except Exception:  # noqa: BLE001 — idempotent cleanup
            pass


class _Worker:
    """The pool's handle on one worker process."""

    def __init__(self, mcfg: ModelConfig, cache_dir: str, device: str, slot_bytes: int,
                 n_slots: int, cap_rows: int, wid: int) -> None:
        self.wid = wid
        self.rows_used = 0
        self.first_batch_t: float | None = None
        self.pending: list[_PendingBatch] = []
        # The same bounded async slot pool the batcher's pipeline uses, here
        # tracking this worker's shm batch slots. Retirement or death closes
        # it, waking any waiter with SlotsClosed.
        self.slots = SlotPool(n_slots)
        self.is_ready = False
        self.retired = False
        self.reader_started = False
        # True once the pool sent "bye": the worker exits on its own and
        # unlinks its results segment; close() must not kill it mid-unlink.
        self.said_bye = False
        self.boot: dict = {}
        self.batch_shm = _PinnedShm(slot_bytes * n_slots)
        # spawn, always: CUDA cannot run in a forked child.
        ctx = mp.get_context("spawn")
        self.conn, child_conn = ctx.Pipe()
        self.t_spawn = time.perf_counter()
        self.proc = ctx.Process(
            target=_worker_main,
            args=(mcfg, cache_dir, device, child_conn, self.batch_shm.name,
                  slot_bytes, cap_rows),
            daemon=True, name=f"tpuserve-torch-deferred-{wid}")
        self.proc.start()
        child_conn.close()

    def close(self) -> None:
        self.batch_shm.close()  # defers the unlink past any in-flight slot write
        if self.proc.is_alive() and not self.said_bye:
            self.proc.terminate()


class DeferredPool:
    """Routes batches to session-recycling workers; resolves futures at the
    epoch readback. One pool per recycle-mode model. ``device`` is what
    every worker builds its runtime on: ``"cuda"`` (the current CUDA device
    of a fresh process: ``cuda:0``) or ``"cpu"``; this process never touches
    it."""

    def __init__(self, mcfg: ModelConfig, cache_dir: str, model, device: str = "cuda",
                 injector=None) -> None:
        self.mcfg = mcfg
        self.cache_dir = cache_dir
        self.model = model
        self.device = str(device)
        # Deterministic chaos (tpuserve_torch.faults.FaultInjector); None in
        # production. Kind "worker_death" kills the active worker at enqueue,
        # exercising the died path, the batcher's retry and the watchdog.
        self.injector = injector
        # A request's latency in recycle mode ~= its worker's remaining
        # epoch; a timeout below the epoch would 504 most traffic. Keep it
        # >= 2x the epoch + readback headroom.
        floor_ms = 2.0 * mcfg.relay_epoch_ms + 1000.0
        if mcfg.request_timeout_ms < floor_ms:
            log.warning(
                "recycle mode: request_timeout_ms %.0f < epoch-safe floor %.0f; raising it",
                mcfg.request_timeout_ms, floor_ms)
            mcfg.request_timeout_ms = floor_ms
        self.n_workers = max(2, mcfg.relay_workers)
        self.n_slots = mcfg.relay_slots
        self.cap_rows = mcfg.relay_epoch_images
        self.epoch_s = mcfg.relay_epoch_ms / 1e3
        sig = model.input_signature(model.bucket_for(max(mcfg.batch_buckets)))
        self.slot_bytes = sum(int(np.prod(s.shape)) * np.dtype(s.dtype).itemsize for s in sig)
        self._workers: list[_Worker] = []
        self._active: _Worker | None = None
        self._warm: list[_Worker] = []
        self._next_wid = 0
        self._loop: asyncio.AbstractEventLoop | None = None
        self._lock: asyncio.Lock | None = None
        self._spawning = 0  # background replenish spawns in flight
        self._stopping = False
        self._bg_tasks: set = set()
        # Serializes worker spawns across executor threads: concurrent
        # Process.start() from two threads races pipe fds. Slow (seconds);
        # executor threads only, never taken on the event loop.
        self._spawn_mutex = new_lock("deferred.spawn")
        # Guards the worker roster (_workers/_warm/_next_wid/boots), which
        # both the loop and replenish threads mutate. Microsecond holds.
        self._roster_lock = new_lock("deferred.roster")
        self.stats = {"epochs": 0, "read_s_total": 0.0, "worker_respawns": 0,
                      "workers_prespawned": 0, "rows_total": 0}
        # Each ready worker's boot (spawn to ready, s) and memory_reserved.
        self.boots: deque[dict] = deque(maxlen=_BOOTS_KEPT)
        # K1/K2 launches the retired workers reported, summed.
        self.kernels = _zero_kernels()

    # -- lifecycle -----------------------------------------------------------
    def prewarm(self, n: int | None = None) -> None:
        """Start n workers before serving. The first is warmed alone, so it
        builds the kernels where the rest then load them."""
        n = n or self.n_workers
        first = self._spawn()
        self._wait_ready_sync(first)
        with self._roster_lock:
            self._warm.append(first)
        rest = [self._spawn() for _ in range(n - 1)]
        for w in rest:
            self._wait_ready_sync(w)
            with self._roster_lock:
                self._warm.append(w)

    def _spawn(self) -> _Worker:
        """Start a worker process. NOT added to ``_warm`` here: a warming
        worker visible in ``_warm`` would be popped by ``_next_warm`` on the
        event loop, judged dead (``is_ready`` False) and closed, unlinking
        its batch shm under the still-starting child. Callers append to
        ``_warm`` only after the ready handshake."""
        with self._roster_lock:
            wid = self._next_wid
            self._next_wid += 1
        w = _Worker(self.mcfg, self.cache_dir, self.device, self.slot_bytes, self.n_slots,
                    self.cap_rows, wid)
        with self._roster_lock:
            self._workers.append(w)
        return w

    def _spawn_ready(self) -> _Worker:
        """Spawn + ready handshake + register warm; on failure, close the
        half-built worker (unlinking its batch shm) before re-raising, so a
        retrying replenisher does not accumulate leaked segments."""
        w = self._spawn()
        try:
            self._wait_ready_sync(w)
        except Exception:
            with self._roster_lock:
                if w in self._workers:
                    self._workers.remove(w)
            w.close()
            raise
        with self._roster_lock:
            self._warm.append(w)
        return w

    def _wait_ready_sync(self, w: _Worker, timeout: float = 900.0) -> None:
        if w.conn.poll(timeout):
            try:
                msg = w.conn.recv()
            except EOFError:
                raise RuntimeError(f"worker {w.wid} exited before it was ready "
                                   f"(exit code {w.proc.exitcode})") from None
            if msg.get("op") == "ready":
                w.is_ready = True
                w.boot = {"wid": w.wid, "pid": msg.get("pid"),
                          "boot_s": round(time.perf_counter() - w.t_spawn, 3),
                          "memory_reserved_bytes": msg.get("memory_reserved_bytes", 0)}
                with self._roster_lock:
                    self.boots.append(w.boot)
                return
            raise RuntimeError(f"worker {w.wid} failed at warmup: {msg}")
        raise TimeoutError(f"worker {w.wid} not ready after {timeout}s")

    def _next_warm(self) -> _Worker | None:
        """Pop the next live warm worker. Called from the loop
        (_ensure_active) AND from replenish threads (_dry_acquire): every pop
        goes through the roster lock; the close() of a dead candidate
        happens outside it."""
        while True:
            with self._roster_lock:
                if not self._warm:
                    return None
                w = self._warm.pop(0)
            if w.is_ready and w.proc.is_alive():
                return w
            w.close()

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._lock = new_async_lock("deferred.enqueue")
        for w in self._workers:
            self._start_reader(w)

    def _start_reader(self, w: _Worker) -> None:
        if w.reader_started:  # two readers on one pipe corrupt messages
            return
        w.reader_started = True
        threading.Thread(target=self._reader, args=(w,), daemon=True,
                         name=f"deferred-r{w.wid}").start()

    def _reader(self, w: _Worker) -> None:
        """Blocking pipe reader (one thread per worker, mostly idle)."""
        try:
            while True:
                msg = w.conn.recv()
                self._notify(w, msg)
                if msg["op"] in ("results", "died"):
                    return
        except (EOFError, OSError):
            self._notify(w, {"op": "died", "error": "pipe closed"})

    def _notify(self, w: _Worker, msg: dict) -> None:
        """Hand a worker message to the event loop; tolerate a closed loop
        (readers race server shutdown)."""
        try:
            self._loop.call_soon_threadsafe(self._on_msg, w, msg)
        except RuntimeError:
            pass  # the event loop is closed; the shutdown path owns cleanup

    # -- serving -------------------------------------------------------------
    async def enqueue(self, bucket: tuple, host_batch: tuple) -> asyncio.Future:
        """Write one assembled batch (the tuple of host arrays) to the
        active worker and return a Future of its output dict (numpy rows),
        resolved at that worker's epoch readback. Blocks only for a free shm
        slot (backpressure)."""
        # Validate the size BEFORE taking a slot: raising after the pop would
        # leak the slot, and n_slots oversized batches on a fresh worker (no
        # epoch timer armed yet) would deadlock every later enqueue.
        self._check_size(host_batch)
        if (self.injector is not None and self._active is not None
                and self._active.proc.is_alive()
                and self.injector.fire("worker_death", self.model.name)):
            log.warning("chaos: killing active worker %d", self._active.wid)
            self._active.proc.kill()  # the reader sees EOF -> the died path
        async with self._lock:
            while True:
                w = await self._ensure_active(bucket)
                try:
                    slot = await self._take_slot(w)
                except _WorkerGone:
                    continue
                # The shm memcpy runs on the executor so the event loop stays
                # responsive; the pool lock stays held so enqueues serialize.
                # The await is an interleave window: _epoch_deadline is a bare
                # call_later callback (no lock) and can retire w mid-copy, and
                # a batch message sent to a retiring worker would be read by
                # its retire branch as the "bye" handshake. The copy pins the
                # worker's shm so a readback-side close() mid-copy defers the
                # unlink; a False return or a retired worker re-routes.
                try:
                    wrote = await self._loop.run_in_executor(
                        None, self._write_slot, w, slot, host_batch)
                except Exception:
                    # A failed write must not leak the popped slot: the
                    # worker is still serving other batches.
                    w.slots.release(slot)
                    raise
                if not wrote or w.retired or not w.proc.is_alive():
                    continue
                break
            off = w.rows_used
            w.rows_used += bucket[0]
            self.stats["rows_total"] += bucket[0]
            if w.first_batch_t is None:
                w.first_batch_t = time.perf_counter()
                self._loop.call_later(self.epoch_s, self._epoch_deadline, w)
            fut = self._loop.create_future()
            w.pending.append(_PendingBatch(off, bucket, fut))
            w.conn.send({"op": "batch", "slot": slot, "off": off, "bucket": list(bucket)})
        return fut

    async def run_deferred(self, bucket: tuple, host_batch: tuple) -> dict:
        """Enqueue + await the epoch readback (convenience for tests)."""
        return await (await self.enqueue(bucket, host_batch))

    async def _ensure_active(self, bucket: tuple) -> _Worker:
        w = self._active
        if w is not None and not w.retired and w.proc.is_alive() \
                and w.rows_used + bucket[0] <= self.cap_rows:
            return w
        if w is not None and not w.retired and w.proc.is_alive():
            self._retire(w)
        self._active = self._next_warm()
        if self._active is None:
            # The pool ran dry: acquire on a thread (slow; the background
            # replenisher below normally prevents this). _dry_acquire checks
            # the warm list again under the spawn mutex, so a replenish that
            # lands while we wait is used instead of a second spawn.
            self.stats["worker_respawns"] += 1
            self._active = await self._loop.run_in_executor(None, self._dry_acquire)
            self._start_reader(self._active)
        self._maybe_replenish()
        return self._active

    def _dry_acquire(self) -> _Worker:
        """Executor-thread path when no warm worker exists: wait for the
        spawn mutex, prefer a just-replenished warm worker, else spawn."""
        with self._spawn_mutex:
            w = self._next_warm()
            if w is None:
                w = self._spawn_ready()
                with self._roster_lock:
                    self._warm.remove(w)
            return w

    def _maybe_replenish(self) -> None:
        """Top the warm pool back up in the BACKGROUND after an activation
        consumed a worker, so the next rotation finds a prewarmed successor
        instead of stalling on a synchronous spawn."""
        target = max(1, self.n_workers - 1)  # spares beyond the active one
        with self._roster_lock:
            warm = list(self._warm)
        alive_warm = sum(1 for w in warm if w.is_ready and w.proc.is_alive())
        if self._stopping or alive_warm + self._spawning >= target:
            return
        self._spawning += 1

        async def _bg() -> None:
            try:
                w = await self._loop.run_in_executor(None, self._spawn_blocking)
                if self._stopping:
                    w.close()
                    return
                self._start_reader(w)  # stays in _warm until activated
                self.stats["workers_prespawned"] += 1
            except Exception:  # noqa: BLE001 — the next activation falls back
                if not self._stopping:  # stop() closes a worker still booting
                    log.exception("background worker replenish failed")
            finally:
                self._spawning -= 1

        task = self._loop.create_task(_bg())
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    def _spawn_blocking(self) -> _Worker:
        with self._spawn_mutex:
            return self._spawn_ready()

    async def _take_slot(self, w: _Worker) -> int:
        try:
            slot = await w.slots.acquire()
        except SlotsClosed:
            raise _WorkerGone() from None
        if w.retired or not w.proc.is_alive():
            w.slots.release(slot)
            raise _WorkerGone()
        return slot

    def _check_size(self, host_batch: tuple) -> None:
        total = sum(np.asarray(a).nbytes for a in host_batch)
        if total > self.slot_bytes:
            raise ValueError(
                f"batch totals {total} B but a shm slot holds {self.slot_bytes} B "
                "(sized for the largest configured bucket); enqueue batches padded "
                "to a configured bucket")

    def _write_slot(self, w: _Worker, slot: int, host_batch: tuple) -> bool:
        """Copy the batch into the worker's shm slot (executor thread).

        Returns False, without raising, when the worker's shm is already
        closing (its epoch readback or death landed first); the caller
        re-routes the batch to a live worker. The pin keeps the segment
        mapped for the copy even if close() is requested mid-copy."""
        self._check_size(host_batch)
        if not w.batch_shm.pin():
            return False
        try:
            # No ValueError catch: with the pin held the buffer cannot be
            # invalidated mid-copy, so an exception is a real bug that must
            # surface as a failed request, not re-route forever.
            off = slot * self.slot_bytes
            for leaf in host_batch:
                b = np.ascontiguousarray(leaf)
                view = np.frombuffer(w.batch_shm.buf, dtype=np.uint8, count=b.nbytes,
                                     offset=off)
                view[:] = b.reshape(-1).view(np.uint8)
                del view  # an exported pointer would break the segment's close()
                off += b.nbytes
        finally:
            w.batch_shm.unpin()
        return True

    def _epoch_deadline(self, w: _Worker) -> None:
        if not w.retired and w.proc.is_alive() and w.pending:
            self._retire(w)
            if self._active is w:
                self._active = None

    def _retire(self, w: _Worker) -> None:
        w.retired = True
        try:
            w.conn.send({"op": "retire"})
        except (BrokenPipeError, OSError):
            pass
        w.slots.close()  # waiters re-route to a live worker (_WorkerGone)

    # -- worker messages (event loop) ----------------------------------------
    def _on_msg(self, w: _Worker, msg: dict) -> None:
        op = msg["op"]
        if op == "ack":
            w.slots.release(msg["slot"])
        elif op == "results":
            self._scatter_results(w, msg)
        elif op == "died":
            log.error("worker %d died: %s", w.wid, msg.get("error"))
            err = RuntimeError(f"worker {w.wid} died: {msg.get('error')}")
            for pb in w.pending:
                if not pb.future.done():
                    pb.future.set_exception(err)
            w.pending.clear()
            if self._active is w:
                self._active = None
            w.slots.close()
            w.close()

    def _scatter_results(self, w: _Worker, msg: dict) -> None:
        shm = shared_memory.SharedMemory(name=msg["shm"])
        try:
            outs = {}
            for key, shape, dtype, offb in msg["shapes"]:
                n = int(np.prod(shape))
                outs[key] = np.frombuffer(shm.buf, dtype=np.dtype(dtype), count=n,
                                          offset=offb).reshape(shape).copy()
        finally:
            shm.close()
        self.stats["epochs"] += 1
        self.stats["read_s_total"] += msg.get("read_s", 0.0)
        _add_kernels(self.kernels, msg.get("kernels", {}))
        for pb in w.pending:
            if pb.future.done():
                continue
            pb.future.set_result({k: v[pb.off:pb.off + pb.bucket[0]] for k, v in outs.items()})
        w.pending.clear()
        try:
            w.conn.send({"op": "bye"})
            w.said_bye = True
        except (BrokenPipeError, OSError):
            pass
        w.close()

    # -- admin ---------------------------------------------------------------
    def kernel_counts(self) -> dict:
        """The K1/K2 launches of every epoch read back since the last reset,
        in the server's ``/stats`` ``kernels`` form."""
        k = self.kernels
        return {"flash_attention": {"launches": k["flash_attention"],
                                    "by_shape": dict(sorted(k["by_shape"].items()))},
                "flash_attention_stats": {"launches": k["flash_attention_stats"]}}

    def reset_kernel_counts(self) -> None:
        self.kernels = _zero_kernels()

    def describe(self) -> dict:
        with self._roster_lock:
            workers, n_warm, boots = list(self._workers), len(self._warm), list(self.boots)
        return {
            "model": self.model.name,
            "family": self.mcfg.family,
            "mode": "recycle",
            "dtype": self.mcfg.dtype,
            "quantize": self.mcfg.quantize,
            "weights": self.mcfg.weights,
            "labels": self.mcfg.labels,
            "options": dict(self.mcfg.options),
            "device": self.device,
            "workers_alive": len([w for w in workers if w.proc.is_alive()]),
            "warm": n_warm,
            "epoch_images": self.cap_rows,
            "epoch_ms": self.mcfg.relay_epoch_ms,
            "buckets": [list(b) for b in self.model.buckets()],
            "stats": dict(self.stats),
            "worker_boots": boots,
        }

    def watchdog_sweep(self) -> int:
        """Watchdog hook (event loop): reap dead worker handles and top the
        warm pool up in the background.

        The per-worker reader threads normally deliver the "died" message;
        this is the backstop for a worker that dies without the reader
        noticing, and the bookkeeping that prunes exited workers from
        ``_workers``. Returns how many UN-retired workers were found dead —
        real failures; a retired worker exiting is its normal end."""
        died = 0
        with self._roster_lock:
            workers = list(self._workers)
        for w in workers:
            if w.proc.is_alive():
                continue
            with self._roster_lock:
                was_warm = w in self._warm
            if not w.retired and (w.pending or was_warm or w is self._active):
                died += 1
                self._on_msg(w, {"op": "died", "error": "watchdog: process not alive"})
            if not w.pending:
                with self._roster_lock:
                    if w in self._warm:
                        self._warm.remove(w)
                    if w in self._workers:
                        self._workers.remove(w)
                if self._active is w:
                    self._active = None
                w.close()
                w.proc.join(0)  # reap the exited process
        if not self._stopping and self._loop is not None:
            self._maybe_replenish()
        return died

    def retire_active(self) -> None:
        """Retire early every worker holding in-flight batches (fast, sync).

        Called at the start of server shutdown so batch futures resolve in
        readback time instead of at the epoch deadline; safe to call more
        than once."""
        with self._roster_lock:
            workers = list(self._workers)
        for w in workers:
            if w.proc.is_alive() and not w.retired and w.pending:
                self._retire(w)
                if self._active is w:
                    self._active = None

    def close(self) -> None:
        """Close every worker now and reap the processes (blocking): the end
        of ``stop``, or all of it for a pool that never served (the command
        line's ``warmup``)."""
        self._stopping = True
        with self._roster_lock:
            workers = list(self._workers)
        for w in workers:
            w.close()
        _reap([w.proc for w in workers])

    async def stop(self) -> None:
        """Retire the workers with in-flight batches and wait (bounded) for
        their epoch readback, so pending requests resolve with results, not
        'worker died'; then close every worker and reap the processes."""
        self._stopping = True  # in-flight background spawns close themselves
        self.retire_active()
        with self._roster_lock:
            workers = list(self._workers)
        if self._loop is not None:
            waiting = [w for w in workers if w.pending]
            deadline = self._loop.time() + max(5.0, 2.0 * self.epoch_s)
            while waiting and self._loop.time() < deadline:
                await asyncio.sleep(0.05)
                waiting = [w for w in waiting if w.pending]
        err = RuntimeError("deferred pool stopped before epoch readback")
        with self._roster_lock:
            workers = list(self._workers)
        for w in workers:
            for pb in w.pending:
                if not pb.future.done():
                    pb.future.set_exception(err)
            w.pending.clear()
        await asyncio.get_running_loop().run_in_executor(None, self.close)


class _WorkerGone(Exception):
    """The active worker retired or died while a batch waited for a slot."""


def _zero_kernels() -> dict:
    return {"flash_attention": 0, "by_shape": {}, "flash_attention_stats": 0}


def _add_kernels(total: dict, k: dict) -> None:
    total["flash_attention"] += k.get("flash_attention", 0)
    total["flash_attention_stats"] += k.get("flash_attention_stats", 0)
    for shape, n in k.get("by_shape", {}).items():
        total["by_shape"][shape] = total["by_shape"].get(shape, 0) + n


def _reap(procs: list, timeout_s: float = 5.0) -> None:
    """Join the workers' processes; a worker past the bound (one that took
    "bye" but has not exited) is terminated."""
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.terminate()
            p.join(1.0)
