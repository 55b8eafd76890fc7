"""Worker supervision: spawn, health-check, reap, respawn with backoff;
ported from ``tpuserve/workerproc/supervisor.py``.

The supervisor owns N worker slots. Each slot holds one worker process (a
full loopback-bound server of the port, ``tpuserve_torch.workerproc.
worker``) or is empty while a respawn is pending. Three loops keep the
fleet honest:

- **Process liveness** — ``sweep()`` is registered with the router's
  Watchdog: a slot whose process exited any way other than a supervisor
  stop is reaped and scheduled for respawn, counted in
  ``watchdog_restarts_total{model=_router,component=worker}``.
- **HTTP health** — an async probe loop GETs each worker's ``/healthz`` on
  ``health_interval_s``; ``unhealthy_after`` consecutive bad probes route
  traffic around a live-but-wedged worker without killing it.
- **Respawn with exponential backoff** — a dead slot respawns after
  ``min(respawn_max_s, respawn_initial_s * respawn_multiplier^fails)``; a
  successful boot resets the slot's failure count, and
  ``respawn_eta_s()`` gives the router an honest ``Retry-After`` when no
  worker is healthy.

Processes are started with the ``spawn`` method only: a process that has
initialized CUDA cannot fork a child that uses it, and the supervisor's
process (the router's) never touches CUDA itself. On the card, while the
kernels of this source tree are not built yet (no library in
``compilation_cache_dir`` or ``build/kernels``), worker 0 boots alone and
the rest after it, so one worker runs ``nvcc`` and the others load the
built library; once it is built, every worker boots at once.

Thread/loop ownership: every roster field is mutated on the event loop
only; the blocking parts of a spawn (``Process.start`` and the ready-pipe
handshake) run on executor threads and hand the finished handle back.

Workers are daemonic: if the router process itself is SIGKILLed, the
children are torn down with it instead of being orphaned on loopback ports.
"""

from __future__ import annotations

import asyncio
import logging
import multiprocessing as mp
import time
from pathlib import Path

from tpuserve_torch.bench.client import ClientSession
from tpuserve_torch.config import ServerConfig
from tpuserve_torch.obs import Metrics
from tpuserve_torch.ops import _build
from tpuserve_torch.workerproc.worker import worker_config, worker_main

log = logging.getLogger("tpuserve_torch.workerproc")


class WorkerHandle:
    """Supervisor-side handle for one live worker process."""

    __slots__ = ("wid", "proc", "conn", "port", "pid", "base_url",
                 "healthy", "health_fails", "inflight", "picked_seq",
                 "started_at", "boot_s")

    def __init__(self, wid: int, proc, conn, port: int, pid: int, host: str,
                 boot_s: float = 0.0) -> None:
        self.wid = wid
        self.proc = proc
        self.conn = conn
        self.port = port
        self.pid = pid
        self.base_url = f"http://{host}:{port}"
        # Healthy until probed otherwise: the ready handshake proves the
        # listener is up, a stronger signal than one HTTP probe.
        self.healthy = True
        self.health_fails = 0
        self.inflight = 0
        self.picked_seq = 0
        self.started_at = time.monotonic()
        # Spawn to ready handshake: the respawn budget a drill allows is
        # this plus the backoff.
        self.boot_s = boot_s

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


def spawn_worker_blocking(wcfg: ServerConfig, wid: int, device: str,
                          spawn_timeout_s: float):
    """Spawn one worker process on ``device`` and wait for its ready
    handshake. Blocking (Process.start + the pipe poll): call from an
    executor thread. Returns ``(proc, parent_conn, port, pid)``; raises on
    a boot failure with the child killed and the pipe closed."""
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=worker_main, args=(wcfg, wid, device, child),
                       daemon=True, name=f"tpuserve-torch-worker-{wid}")
    proc.start()
    child.close()
    try:
        if not parent.poll(spawn_timeout_s):
            raise TimeoutError(f"worker {wid} not ready after {spawn_timeout_s:.0f}s")
        msg = parent.recv()
        if msg.get("op") != "ready":
            raise RuntimeError(f"worker {wid} failed at boot: {msg}")
    except BaseException:
        if proc.is_alive():
            proc.kill()
        proc.join(5.0)
        parent.close()
        raise
    return proc, parent, int(msg["port"]), int(msg.get("pid", proc.pid))


def kernels_built(cfg: ServerConfig) -> bool:
    """Are the kernels of this source tree built where the workers load them
    from? (No nvcc runs here: the library's name is a digest of the
    sources.)"""
    build_dir = (Path(cfg.compilation_cache_dir) if cfg.compilation_cache_dir
                 else _build.BUILD_DIR)
    return (build_dir / _build.library_path("flash_attention").name).exists()


class WorkerSupervisor:
    """Owns the worker fleet for one router process.

    ``device`` is what every worker serves on: ``"cuda"`` (the current CUDA
    device, shared by all of them) or ``"cpu"``. ``postmortems``: with the
    router's event plane on, every reaped worker death is folded into a
    forensics record — exit code and signal, the slot's stderr-capture
    tail, its last black-box snapshot — on an executor thread."""

    def __init__(self, cfg: ServerConfig, metrics: Metrics, device: str = "cuda",
                 postmortems=None) -> None:
        self.cfg = cfg
        self.rcfg = cfg.router
        self.metrics = metrics
        self.device = device
        self.postmortems = postmortems
        self.n = cfg.router.workers
        # Derived once, so every respawn serves an identical config (and a
        # recycle-mode model is refused at construction, not mid-respawn).
        self._worker_cfgs = [worker_config(cfg, i) for i in range(self.n)]
        self.slots: list[WorkerHandle | None] = [None] * self.n
        self._fails = [0] * self.n          # consecutive failed boots
        self._next_up_at = [0.0] * self.n   # respawn ETA (monotonic)
        self._respawning: set[int] = set()
        self._bg: set[asyncio.Task] = set()
        self._health_task: asyncio.Task | None = None
        self._session: ClientSession | None = None  # health probes
        self._stopping = False
        self._pick_seq = 0
        self.deaths_total = 0
        # Prebound per-slot metrics (never formatted per probe or pick).
        self._g_up = [metrics.worker_up_gauge(i) for i in range(self.n)]
        self._g_backoff = [metrics.worker_backoff_gauge(i) for i in range(self.n)]
        self._g_inflight = [metrics.worker_inflight_gauge(i) for i in range(self.n)]
        self._c_respawns = [metrics.worker_respawns_counter(i) for i in range(self.n)]

    # -- lifecycle -----------------------------------------------------------
    def kernels_built(self) -> bool:
        return kernels_built(self.cfg)

    async def start(self) -> None:
        """Spawn the fleet and start the health loop. On the card with the
        kernels not built yet, worker 0 boots alone first, so it builds them
        and the rest (and every respawn) load the built library."""
        loop = asyncio.get_running_loop()
        self._session = ClientSession(limit=0, timeout_s=self.rcfg.health_timeout_ms / 1e3)
        rest = range(self.n)
        if self.n > 1 and self.device != "cpu" and not self.kernels_built():
            self.slots[0] = await loop.run_in_executor(None, self._spawn_blocking, 0)
            self._g_up[0].set(1.0)
            rest = range(1, self.n)
        spawned = await asyncio.gather(
            *(loop.run_in_executor(None, self._spawn_blocking, i) for i in rest))
        for h in spawned:
            self.slots[h.wid] = h
            self._g_up[h.wid].set(1.0)
        self._health_task = loop.create_task(self._health_loop())
        log.info("worker fleet up on %s: %s", self.device,
                 [f"{h.wid}@{h.port}" for h in self.slots if h])

    def _spawn_blocking(self, wid: int) -> WorkerHandle:
        """Spawn one worker and wait for its ready handshake (executor
        thread: Process.start and the pipe poll both block)."""
        t0 = time.monotonic()
        proc, parent, port, pid = spawn_worker_blocking(
            self._worker_cfgs[wid], wid, self.device, self.rcfg.spawn_timeout_s)
        if self._stopping:
            # The supervisor stopped while this spawn was in flight (nobody
            # will adopt the handle): tear the fresh worker down instead of
            # orphaning a live server on a loopback port.
            proc.kill()
            proc.join(5.0)
            parent.close()
            raise RuntimeError(f"supervisor stopping; discarded worker {wid}")
        return WorkerHandle(wid, proc, parent, port, pid, self.cfg.worker.host,
                            boot_s=time.monotonic() - t0)

    async def stop(self, drain: bool = True) -> None:
        """SIGTERM the fleet and wait for graceful exits (each worker runs
        its own accepted-work drain), then SIGKILL stragglers. The router
        calls this AFTER it stopped admitting and its relays resolved, so
        the cross-process drain drops no accepted request."""
        self._stopping = True
        if self._health_task is not None:
            self._health_task.cancel()
            try:
                await self._health_task
            except asyncio.CancelledError:
                pass
            self._health_task = None
        for t in list(self._bg):
            t.cancel()
        if self._bg:
            await asyncio.gather(*self._bg, return_exceptions=True)
        live = [h for h in self.slots if h is not None and h.proc.is_alive()]
        for h in live:
            h.proc.terminate()
        budget = self.cfg.drain_timeout_s if drain else 2.0
        deadline = time.monotonic() + budget
        while any(h.proc.is_alive() for h in live) and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        killed = 0
        for h in live:
            if h.proc.is_alive():
                h.proc.kill()
                killed += 1
        if killed:
            log.warning("%d worker(s) outlived the %.1fs drain budget and were killed",
                        killed, budget)
        await asyncio.get_running_loop().run_in_executor(None, self._join_all, live)
        for i, h in enumerate(self.slots):
            if h is not None:
                h.close()
            self._g_up[i].set(0.0)
        if self._session is not None:
            await self._session.close()
            self._session = None

    @staticmethod
    def _join_all(handles: list[WorkerHandle]) -> None:
        for h in handles:
            h.proc.join(10.0)

    # -- liveness / health ---------------------------------------------------
    def sweep(self) -> int:
        """Watchdog hook (event loop, non-blocking): reap worker slots whose
        process exited and schedule their backoff respawns. Returns how many
        newly dead workers were found."""
        if self._stopping:
            return 0
        died = 0
        for i, h in enumerate(self.slots):
            if h is not None and not h.proc.is_alive():
                died += 1
                self._on_dead(i, h, f"process exited (code {h.proc.exitcode})")
        return died

    def _on_dead(self, wid: int, h: WorkerHandle, why: str) -> None:
        log.error("worker %d (pid %d) died: %s", wid, h.pid, why)
        self.deaths_total += 1
        self._schedule_postmortem(wid, h)
        h.close()
        self.slots[wid] = None
        self._g_up[wid].set(0.0)
        self._g_inflight[wid].set(0.0)
        self._schedule_respawn(wid)

    def _schedule_postmortem(self, wid: int, h: WorkerHandle) -> None:
        """Fold the dead worker's black box into a postmortem record on an
        executor thread (the file reads must not block the loop). The
        capture races the respawn's boot banner by the whole backoff
        window, so the tail it reads is the dead incarnation's."""
        if self.postmortems is None:
            return
        ecfg = self._worker_cfgs[wid].events
        exitcode = h.proc.exitcode
        loop = asyncio.get_running_loop()

        async def _capture() -> None:
            await loop.run_in_executor(None, lambda: self.postmortems.capture_blocking(
                "worker", f"worker{wid}", h.pid, exitcode,
                stderr_path=ecfg.stderr_path or None,
                snapshot_path=ecfg.snapshot_path or None, worker=wid))

        self._track(loop.create_task(_capture()))

    def _track(self, t: asyncio.Task) -> None:
        self._bg.add(t)
        t.add_done_callback(self._bg.discard)

    def _schedule_respawn(self, wid: int) -> None:
        if self._stopping or wid in self._respawning:
            return
        self._respawning.add(wid)
        self._track(asyncio.get_running_loop().create_task(self._respawn(wid)))

    async def _respawn(self, wid: int) -> None:
        """Respawn one slot with exponential backoff until it boots or the
        supervisor stops; a successful boot resets the slot's failures."""
        loop = asyncio.get_running_loop()
        try:
            while not self._stopping:
                delay = min(self.rcfg.respawn_max_s,
                            self.rcfg.respawn_initial_s
                            * self.rcfg.respawn_multiplier ** self._fails[wid])
                self._g_backoff[wid].set(delay)
                self._next_up_at[wid] = time.monotonic() + delay
                await asyncio.sleep(delay)
                if self._stopping:
                    return
                try:
                    h = await loop.run_in_executor(None, self._spawn_blocking, wid)
                except Exception:
                    self._fails[wid] += 1
                    log.exception("worker %d respawn failed (consecutive failures: %d)",
                                  wid, self._fails[wid])
                    continue
                self.slots[wid] = h
                self._fails[wid] = 0
                self._g_backoff[wid].set(0.0)
                self._g_up[wid].set(1.0)
                self._c_respawns[wid].inc()
                log.info("worker %d respawned (pid %d, port %d)", wid, h.pid, h.port)
                return
        finally:
            self._respawning.discard(wid)

    async def _health_loop(self) -> None:
        while True:
            await asyncio.sleep(self.rcfg.health_interval_s)
            try:
                await self._probe_all()
            except asyncio.CancelledError:
                raise
            except Exception:  # one bad cycle must not end health checking
                log.exception("worker health probe cycle failed")

    async def _probe_all(self) -> None:
        # Liveness first (no HTTP needed to notice a corpse), then the
        # probes concurrently, so one slow worker cannot stale the rest.
        for i, h in enumerate(self.slots):
            if h is not None and not h.proc.is_alive():
                self._on_dead(i, h, f"process exited (code {h.proc.exitcode})")
        await asyncio.gather(*(self._probe(h) for h in self.slots if h is not None))

    async def _probe(self, h: WorkerHandle) -> None:
        try:
            ok = (await self._session.get(f"{h.base_url}/healthz")).status == 200
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — refused, reset, timeout all count
            ok = False
        if ok:
            if not h.healthy:
                log.info("worker %d healthy again", h.wid)
            h.health_fails = 0
            h.healthy = True
        else:
            h.health_fails += 1
            if h.healthy and h.health_fails >= self.rcfg.unhealthy_after:
                log.warning("worker %d unhealthy after %d failed probes: routing around it",
                            h.wid, h.health_fails)
                h.healthy = False
        self._g_up[h.wid].set(1.0 if h.healthy else 0.0)

    # -- routing -------------------------------------------------------------
    def healthy_workers(self) -> list[WorkerHandle]:
        return [h for h in self.slots if h is not None and h.healthy]

    def live_workers(self) -> list[WorkerHandle]:
        """Every slot with a live process: admin fan-outs must reach
        unhealthy-but-alive workers too, or the fleet's versions diverge."""
        return [h for h in self.slots if h is not None and h.proc.is_alive()]

    def worker_by_id(self, wid: int) -> WorkerHandle | None:
        if not 0 <= wid < self.n:
            return None
        return self.slots[wid]

    def down_domains(self) -> list[str]:
        """Slots currently dead or respawning: a fleet-wide reload refuses
        while any exists (a respawn boots the original config and would
        diverge from a freshly published version)."""
        return [f"worker{i}" for i, h in enumerate(self.slots)
                if h is None or not h.proc.is_alive()]

    def host_of(self, h: WorkerHandle) -> int | None:
        return None  # a flat fleet has no host domains

    def note_transport_failure(self, h: WorkerHandle) -> None:
        pass  # no host breaker without hosts: the health probes route around

    def note_success(self, h: WorkerHandle) -> None:
        pass

    def pick(self, exclude: "set[int] | frozenset[int]" = frozenset(),
             exclude_hosts: "set[int] | frozenset[int]" = frozenset()) -> WorkerHandle | None:
        """Least-loaded healthy worker not in ``exclude``; ties break to the
        least recently picked, so equal load round-robins. A flat fleet has
        no host domains, so ``exclude_hosts`` excludes nothing."""
        best: WorkerHandle | None = None
        for h in self.slots:
            if h is None or not h.healthy or h.wid in exclude:
                continue
            if best is None or (h.inflight, h.picked_seq) < (best.inflight, best.picked_seq):
                best = h
        if best is not None:
            self._pick_seq += 1
            best.picked_seq = self._pick_seq
        return best

    def track_inflight(self, h: WorkerHandle, delta: int) -> None:
        h.inflight += delta
        self._g_inflight[h.wid].set(h.inflight)

    def respawn_eta_s(self) -> float:
        """Soonest respawn ETA across dead slots (the Retry-After basis when
        no worker is healthy); the health interval when none is respawning
        (the soonest a wedged-but-alive worker can be probed healthy)."""
        now = time.monotonic()
        etas = [max(0.0, self._next_up_at[i] - now) for i in self._respawning]
        return min(etas) if etas else self.rcfg.health_interval_s

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        """The /stats ``workers`` block."""
        now = time.monotonic()
        rows = []
        for i in range(self.n):
            h = self.slots[i]
            if h is None:
                rows.append({
                    "worker": i,
                    "state": "respawning" if i in self._respawning else "down",
                    "consecutive_boot_failures": self._fails[i],
                    "respawn_eta_s": round(max(0.0, self._next_up_at[i] - now), 3),
                    "respawns_total": self._c_respawns[i].value,
                })
            else:
                rows.append({
                    "worker": i,
                    "state": "ready" if h.healthy else "unhealthy",
                    "pid": h.pid,
                    "port": h.port,
                    "inflight": h.inflight,
                    "health_fails": h.health_fails,
                    "uptime_s": round(now - h.started_at, 1),
                    "boot_s": round(h.boot_s, 3),
                    "respawns_total": self._c_respawns[i].value,
                })
        return {"configured": self.n, "healthy": len(self.healthy_workers()),
                "deaths_total": self.deaths_total, "device": self.device, "workers": rows}
