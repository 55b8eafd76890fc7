"""Host failure domains, ported from ``tpuserve/workerproc/hosts.py``.

The flat supervisor contains failures at the PROCESS level: one worker
dies, the router routes around it. This module adds the level above, the
MACHINE. Workers are grouped into named hosts (``[router] hosts``); locally
each host is a **host agent**: a supervisor process in its own session and
process group that spawns and owns its share of the worker fleet, so one
``killpg(SIGKILL)`` takes out the whole failure domain at once (agent and
every worker), as a machine losing power would.

Division of labour:

- **Host agent** (``host_main``): synchronous, single-threaded, free of any
  device. It spawns its workers with the flat supervisor's ready-pipe
  handshake (``spawn_worker_blocking``) on the device the router names,
  respawns a dead worker with exponential backoff (a worker crash is a
  HOST-local event: the router only learns the new port), reports
  ``worker_up`` / ``worker_down`` over the pipe, answers ``scale``, and
  drains its fleet on SIGTERM or on pipe EOF (the router vanished: it does
  not serve as an orphan).
- **HostSupervisor** (router side): supervises AGENTS. A process-liveness
  sweep rides the Watchdog (a dead host is killpg'd to finish off any
  straggler worker, then respawned with exponential backoff, ``host_up`` /
  ``host_respawns_total``); HTTP health probes go straight at every worker
  (the data plane never crosses the agent); a **host breaker** routes a
  whole host around after a few consecutive relay transport failures
  against its workers, in milliseconds rather than a probe cycle.
  ``respawn_eta_s`` feeds the router's Retry-After with the least respawn
  ETA across everything dead. It keeps ``WorkerSupervisor``'s routing
  surface, so the router treats the two alike.

On the card with the kernels of this source tree not built yet, host 0
boots alone first (its agent boots its workers one after another, so its
first worker runs ``nvcc`` alone) and the other hosts after it; once the
library is built, every host boots at once.

Thread and loop ownership mirror the flat supervisor: roster state is
mutated on the router's event loop only; blocking pipe reads and spawns run
on executor threads and hand their results back to the loop. The agent is
single-threaded.
"""

from __future__ import annotations

import asyncio
import logging
import multiprocessing as mp
import os
import signal
import time

from tpuserve_torch.bench.client import ClientSession
from tpuserve_torch.config import ServerConfig
from tpuserve_torch.obs import Metrics
from tpuserve_torch.telemetry.events import (read_snapshot, read_tail, redirect_stderr,
                                             resolve_blackbox_dir)
from tpuserve_torch.workerproc.supervisor import kernels_built, spawn_worker_blocking
from tpuserve_torch.workerproc.worker import worker_config

log = logging.getLogger("tpuserve_torch.workerproc")

_EOF = object()


def host_name(hid: int) -> str:
    return f"host{hid}"


# ---------------------------------------------------------------------------
# Host agent (runs in its own process and process group)
# ---------------------------------------------------------------------------

class _AgentSlot:
    """One worker slot inside the host agent."""

    __slots__ = ("wid", "cfg", "proc", "conn", "port", "pid", "boot_s",
                 "fails", "next_at", "stopping", "stop_at")

    def __init__(self, wid: int, cfg) -> None:
        self.wid = wid
        self.cfg = cfg
        self.proc = None
        self.conn = None
        self.port = 0
        self.pid = 0
        self.boot_s = 0.0
        self.fails = 0
        self.next_at = 0.0  # monotonic respawn ETA while down
        # Scale-down drain in progress: the slot was told to stop on
        # purpose, so its exit is NOT a death.
        self.stopping = False
        self.stop_at = 0.0  # monotonic SIGKILL deadline while stopping


def host_main(host_id: int, wids: list[int], wcfgs: list[ServerConfig],
              opts: dict, conn) -> None:
    """Host-agent process entry (the multiprocessing spawn target).

    ``wids`` / ``wcfgs`` are this host's worker ids and their derived
    configs (the router derives them once, as the flat supervisor does).
    ``opts`` carries the device, the spawn, backoff and drain knobs.
    ``conn`` is the control pipe: the ready handshake goes up,
    worker_up / worker_down events follow, and EOF coming down means the
    router died: drain and exit rather than serve as an orphan fleet."""
    # The agent's own stderr goes to its per-host capture file: an agent
    # dying with its whole domain leaves its last words where the router's
    # postmortem reader finds them.
    redirect_stderr(opts.get("stderr_path"),
                    f"{host_name(host_id)} boot pid {os.getpid()} ts {time.time():.3f}")
    # Own session = own process group = one addressable failure domain:
    # killpg(pgid, SIGKILL) takes the agent and its workers down in one
    # syscall, as the machine losing power would.
    try:
        os.setsid()
    except OSError:
        pass  # already a session leader (unusual but not fatal)

    stop_flag = {"stop": False}

    def _sigterm(signum, frame):  # noqa: ARG001 — signal handler shape
        stop_flag["stop"] = True

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # the router's ^C drains us

    slots = [_AgentSlot(wid, cfg) for wid, cfg in zip(wids, wcfgs)]
    # Active slot count: slots at index >= active stay cold until a "scale"
    # op raises it (capacity held in reserve at no cost).
    active = max(1, min(len(slots), int(opts.get("active", len(slots)))))

    def _spawn(slot: _AgentSlot) -> None:
        t0 = time.monotonic()
        slot.proc, slot.conn, slot.port, slot.pid = spawn_worker_blocking(
            slot.cfg, slot.wid, opts["device"], opts["spawn_timeout_s"])
        slot.boot_s = time.monotonic() - t0
        slot.fails = 0
        slot.next_at = 0.0
        slot.stopping = False

    try:
        for slot in slots[:active]:
            _spawn(slot)
    except Exception as e:  # noqa: BLE001 — report any boot death upward
        for slot in slots:
            if slot.proc is not None and slot.proc.is_alive():
                slot.proc.kill()
        try:
            conn.send({"op": "died", "host": host_id, "error": f"{type(e).__name__}: {e}"})
        finally:
            conn.close()
        raise

    conn.send({"op": "ready", "host": host_id, "pgid": os.getpgrp(), "pid": os.getpid(),
               "active": active,
               "workers": [{"wid": s.wid, "port": s.port, "pid": s.pid, "boot_s": s.boot_s}
                           for s in slots[:active]]})

    def _send(msg: dict) -> bool:
        try:
            conn.send(msg)
            return True
        except (BrokenPipeError, OSError):
            return False

    def _backoff(fails: int) -> float:
        return min(opts["respawn_max_s"],
                   opts["respawn_initial_s"] * opts["respawn_multiplier"] ** fails)

    router_gone = False
    while not stop_flag["stop"] and not router_gone:
        now = time.monotonic()
        for idx, slot in enumerate(slots):
            if slot.proc is not None and not slot.proc.is_alive():
                code = slot.proc.exitcode
                slot.proc.join(0)
                slot.proc = None
                if slot.conn is not None:
                    try:
                        slot.conn.close()
                    except OSError:
                        pass
                    slot.conn = None
                if slot.stopping:
                    # A scale-down drain finished: an intentional exit, not
                    # a death (no postmortem, no respawn clock).
                    slot.stopping = False
                    router_gone |= not _send({"op": "worker_scaled_down", "wid": slot.wid,
                                              "exitcode": code})
                    continue
                # The worker died, a HOST-local failure: tell the router (it
                # stops routing here at once) and schedule the respawn.
                delay = _backoff(slot.fails)
                slot.next_at = now + delay
                # The agent folds the black box into the message itself: on
                # a deployment of many machines the capture files live on
                # THIS one, so the evidence crosses the pipe.
                ecfg = slot.cfg.events
                router_gone |= not _send(
                    {"op": "worker_down", "wid": slot.wid, "exitcode": code, "eta_s": delay,
                     "pid": slot.pid,
                     "stderr_tail": read_tail(ecfg.stderr_path or None, ecfg.stderr_tail_bytes),
                     "snapshot": read_snapshot(ecfg.snapshot_path or None)})
            elif slot.stopping and slot.proc is not None and now >= slot.stop_at:
                slot.proc.kill()  # the drain budget is spent: finish the scale-down
            elif slot.proc is None and not slot.stopping and idx < active \
                    and now >= slot.next_at:
                try:
                    _spawn(slot)
                except Exception:  # noqa: BLE001 — the boot failed: back off
                    slot.fails += 1
                    slot.next_at = time.monotonic() + _backoff(slot.fails)
                else:
                    router_gone |= not _send({"op": "worker_up", "wid": slot.wid,
                                              "port": slot.port, "pid": slot.pid,
                                              "boot_s": slot.boot_s})
        try:
            if conn.poll(0.2):
                msg = conn.recv()
                op = msg.get("op")
                if op == "stop":
                    break
                if op == "scale":
                    # Adjust the active slot count live: surplus slots drain
                    # (SIGTERM, bounded, then the SIGKILL above); re-activated
                    # slots take the respawn branch.
                    active = max(1, min(len(slots), int(msg["active"])))
                    now = time.monotonic()
                    for idx, slot in enumerate(slots):
                        if idx >= active and slot.proc is not None and not slot.stopping:
                            slot.proc.terminate()
                            slot.stopping = True
                            slot.stop_at = now + opts["drain_timeout_s"]
                        elif idx >= active and slot.proc is None:
                            router_gone |= not _send({"op": "worker_scaled_down",
                                                      "wid": slot.wid, "exitcode": None})
                        elif idx < active and slot.proc is None and not slot.stopping:
                            slot.next_at = 0.0  # activate at the next pass
        except (EOFError, OSError):
            router_gone = True

    # Drain: SIGTERM the fleet (each worker flushes its accepted work),
    # bounded wait, SIGKILL stragglers: the flat supervisor's stop() one
    # level down.
    live = [s for s in slots if s.proc is not None and s.proc.is_alive()]
    for slot in live:
        slot.proc.terminate()
    deadline = time.monotonic() + opts["drain_timeout_s"]
    while any(s.proc.is_alive() for s in live) and time.monotonic() < deadline:
        time.sleep(0.05)
    for slot in live:
        if slot.proc.is_alive():
            slot.proc.kill()
        slot.proc.join(10.0)
    try:
        conn.close()
    except OSError:
        pass


# ---------------------------------------------------------------------------
# Router-side supervision of host agents
# ---------------------------------------------------------------------------

class WorkerRef:
    """Router-side view of one worker living under a host agent: the relay
    surface of ``WorkerHandle`` (wid, base_url, healthy, inflight,
    picked_seq, host) without owning the process (the agent does)."""

    __slots__ = ("wid", "host", "port", "pid", "base_url", "healthy", "health_fails",
                 "inflight", "picked_seq", "started_at", "up", "boot_s")

    def __init__(self, wid: int, host: int, port: int, pid: int, bind_host: str,
                 boot_s: float = 0.0) -> None:
        self.wid = wid
        self.host = host
        self.port = port
        self.pid = pid
        self.base_url = f"http://{bind_host}:{port}"
        self.healthy = True
        self.health_fails = 0
        self.inflight = 0
        self.picked_seq = 0
        self.started_at = time.monotonic()
        self.up = True
        # The agent's spawn to ready handshake of this worker.
        self.boot_s = boot_s


class HostHandle:
    """One live host agent."""

    __slots__ = ("hid", "proc", "conn", "pgid", "pid", "workers", "started_at", "boot_s")

    def __init__(self, hid: int, proc, conn, pgid: int, pid: int, boot_s: float = 0.0) -> None:
        self.hid = hid
        self.proc = proc
        self.conn = conn
        self.pgid = pgid
        self.pid = pid
        self.workers: dict[int, WorkerRef] = {}
        self.started_at = time.monotonic()
        # Agent spawn to its ready handshake (every active worker booted):
        # the re-absorb budget a drill allows is this plus the backoff.
        self.boot_s = boot_s

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


def _poll_recv(conn, timeout: float):
    """One blocking pipe read step (executor thread): a message, None on
    timeout, _EOF when the other end is gone."""
    try:
        if conn.poll(timeout):
            return conn.recv()
        return None
    except (EOFError, OSError):
        return _EOF


class HostSupervisor:
    """Owns the host-agent fleet for the primary router process. The routing
    surface of WorkerSupervisor (pick, healthy_workers, live_workers,
    track_inflight, respawn_eta_s, sweep, stats), one failure domain up.
    ``device`` is what every worker serves on (``"cuda"`` or ``"cpu"``); it
    reaches the workers through their agents."""

    def __init__(self, cfg: ServerConfig, metrics: Metrics, device: str = "cuda",
                 postmortems=None) -> None:
        self.cfg = cfg
        self.rcfg = cfg.router
        self.metrics = metrics
        self.device = device
        self.postmortems = postmortems
        self.n_hosts = cfg.router.hosts
        self.per_host = cfg.router.workers
        self.n = self.n_hosts * self.per_host
        # Derived once, so every respawn (host or worker) serves an identical
        # config; a recycle-mode model is refused here, at construction.
        self._worker_cfgs = [worker_config(cfg, i) for i in range(self.n)]
        self.hosts: list[HostHandle | None] = [None] * self.n_hosts
        # wid -> last known ref (kept across down and up, so /stats can show
        # a down row and the inflight gauges drain cleanly).
        self._refs: dict[int, WorkerRef] = {}
        self._fails = [0] * self.n_hosts
        self._next_up_at = [0.0] * self.n_hosts
        self._respawning: set[int] = set()
        # Per-host ACTIVE slot target (a respawned host resumes its scaled
        # level) and the wids scaled out on purpose: capacity down on
        # purpose is neither a failure domain (down_domains) nor a death.
        self._active = [cfg.router.active_workers or self.per_host] * self.n_hosts
        self._scaled_down: set[int] = set()
        self._bg: set[asyncio.Task] = set()
        self._health_task: asyncio.Task | None = None
        self._session: ClientSession | None = None  # health probes
        self._stopping = False
        self._pick_seq = 0
        self.deaths_total = 0        # worker-level deaths (host kills included)
        self.host_deaths_total = 0
        # Host breaker: consecutive relay TRANSPORT failures per host trip
        # it; picks shed until the cooldown, then it half-opens.
        self._hb_fails = [0] * self.n_hosts
        self._hb_until = [0.0] * self.n_hosts
        # Prebound metrics (never formatted per probe or pick).
        self._g_worker_up = [metrics.worker_up_gauge(i) for i in range(self.n)]
        self._g_worker_inflight = [metrics.worker_inflight_gauge(i) for i in range(self.n)]
        self._c_worker_respawns = [metrics.worker_respawns_counter(i) for i in range(self.n)]
        self._g_host_up = [metrics.host_up_gauge(i) for i in range(self.n_hosts)]
        self._g_host_backoff = [metrics.host_backoff_gauge(i) for i in range(self.n_hosts)]
        self._g_host_breaker = [metrics.host_breaker_gauge(i) for i in range(self.n_hosts)]
        self._c_host_respawns = [metrics.host_respawns_counter(i) for i in range(self.n_hosts)]

    def _host_wids(self, hid: int) -> list[int]:
        return list(range(hid * self.per_host, (hid + 1) * self.per_host))

    def _track(self, t: asyncio.Task) -> None:
        self._bg.add(t)
        t.add_done_callback(self._bg.discard)

    # -- lifecycle -----------------------------------------------------------
    def kernels_built(self) -> bool:
        return kernels_built(self.cfg)

    async def start(self) -> None:
        """Spawn every host agent (each boots its workers) and start the
        health loop. On the card with the kernels not built yet, host 0
        boots alone first, so one worker builds them and the rest (and every
        respawn) load the built library."""
        loop = asyncio.get_running_loop()
        self._session = ClientSession(limit=0, timeout_s=self.rcfg.health_timeout_ms / 1e3)
        rest = range(self.n_hosts)
        first = []
        if self.n > 1 and self.device != "cpu" and not self.kernels_built():
            first = [await loop.run_in_executor(None, self._spawn_host_blocking, 0)]
            rest = range(1, self.n_hosts)
        spawned = first + list(await asyncio.gather(
            *(loop.run_in_executor(None, self._spawn_host_blocking, hid) for hid in rest)))
        for h in spawned:
            self._adopt_host(h)
        self._health_task = loop.create_task(self._health_loop())
        log.info("host fleet up on %s: %s", self.device,
                 [f"{host_name(h.hid)}(pgid {h.pgid}): {sorted(h.workers)}" for h in spawned])

    def _spawn_host_blocking(self, hid: int) -> HostHandle:
        """Spawn one host agent and wait for its ready handshake (executor
        thread). The agent is NOT daemonic: a daemonic process cannot have
        children, and spawning the workers is its whole job; it exits on
        pipe EOF instead when the router dies."""
        wids = self._host_wids(hid)
        opts = {
            "device": self.device,
            "spawn_timeout_s": self.rcfg.spawn_timeout_s,
            "respawn_initial_s": self.rcfg.respawn_initial_s,
            "respawn_max_s": self.rcfg.respawn_max_s,
            "respawn_multiplier": self.rcfg.respawn_multiplier,
            "drain_timeout_s": self.cfg.drain_timeout_s,
            "active": self._active[hid],
        }
        if self.cfg.events.enabled:
            # The agent's stderr capture, a file per host beside the
            # workers': a killpg'd domain leaves the agent's last words.
            opts["stderr_path"] = os.path.join(resolve_blackbox_dir(self.cfg.events),
                                               f"{host_name(hid)}.stderr")
        t0 = time.monotonic()
        ctx = mp.get_context("spawn")
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=host_main,
                           args=(hid, wids, [self._worker_cfgs[w] for w in wids], opts, child),
                           daemon=False, name=f"tpuserve-torch-{host_name(hid)}")
        proc.start()
        child.close()
        try:
            if not parent.poll(self.rcfg.spawn_timeout_s):
                raise TimeoutError(f"{host_name(hid)} not ready after "
                                   f"{self.rcfg.spawn_timeout_s:.0f}s")
            msg = parent.recv()
            if msg.get("op") != "ready":
                raise RuntimeError(f"{host_name(hid)} failed at boot: {msg}")
        except BaseException:
            if proc.is_alive():
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    proc.kill()
            proc.join(5.0)
            parent.close()
            raise
        if self._stopping:
            try:
                os.killpg(int(msg["pgid"]), signal.SIGKILL)
            except (OSError, ProcessLookupError):
                proc.kill()
            proc.join(5.0)
            parent.close()
            raise RuntimeError(f"supervisor stopping; discarded {host_name(hid)}")
        h = HostHandle(hid, proc, parent, int(msg["pgid"]), int(msg.get("pid", proc.pid)),
                       boot_s=time.monotonic() - t0)
        for row in msg["workers"]:
            h.workers[int(row["wid"])] = WorkerRef(
                int(row["wid"]), hid, int(row["port"]), int(row["pid"]), self.cfg.worker.host,
                boot_s=float(row.get("boot_s", 0.0)))
        return h

    def _adopt_host(self, h: HostHandle) -> None:
        """Event loop: install a freshly booted host and its worker refs."""
        self.hosts[h.hid] = h
        self._g_host_up[h.hid].set(1.0)
        self._g_host_backoff[h.hid].set(0.0)
        self._hb_fails[h.hid] = 0
        self._hb_until[h.hid] = 0.0
        self._g_host_breaker[h.hid].set(0.0)
        for wid, ref in h.workers.items():
            self._refs[wid] = ref
            self._g_worker_up[wid].set(1.0)
            self._g_worker_inflight[wid].set(0.0)
        for wid in self._host_wids(h.hid):
            # Slots the agent booted cold (active < per_host) are scaled
            # down, not dead.
            if wid not in h.workers:
                self._scaled_down.add(wid)
        self._track(asyncio.get_running_loop().create_task(self._pipe_loop(h)))

    async def stop(self, drain: bool = True) -> None:
        """SIGTERM every host agent (each drains its own workers), bounded
        wait, then killpg stragglers: the whole domain, never the agent
        alone."""
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
        live = [h for h in self.hosts if h is not None and h.proc.is_alive()]
        for h in live:
            h.proc.terminate()
        budget = (self.cfg.drain_timeout_s if drain else 2.0) + 2.0
        deadline = time.monotonic() + budget
        while any(h.proc.is_alive() for h in live) and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        for h in live:
            if h.proc.is_alive():
                try:
                    os.killpg(h.pgid, signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    h.proc.kill()
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: [h.proc.join(10.0) for h in live])
        for hid, h in enumerate(self.hosts):
            if h is not None:
                h.close()
            self._g_host_up[hid].set(0.0)
        for wid in range(self.n):
            self._g_worker_up[wid].set(0.0)
        if self._session is not None:
            await self._session.close()
            self._session = None

    # -- pipe events ---------------------------------------------------------
    async def _pipe_loop(self, h: HostHandle) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopping and self.hosts[h.hid] is h:
            msg = await loop.run_in_executor(None, _poll_recv, h.conn, 0.25)
            if msg is _EOF:
                return  # the agent is gone; the liveness sweep reaps the host
            if msg is None or self.hosts[h.hid] is not h:
                continue
            op = msg.get("op")
            if op == "worker_down":
                self._on_worker_down(h, int(msg["wid"]), msg)
            elif op == "worker_up":
                self._on_worker_up(h, int(msg["wid"]), int(msg["port"]), int(msg["pid"]),
                                   float(msg.get("boot_s", 0.0)))
            elif op == "worker_scaled_down":
                self._on_worker_scaled_down(h, int(msg["wid"]))

    def _on_worker_down(self, h: HostHandle, wid: int, msg: dict) -> None:
        log.warning("%s: worker %d died (exit %s); agent respawning in %.1fs",
                    host_name(h.hid), wid, msg.get("exitcode"), msg.get("eta_s", 0.0))
        self.deaths_total += 1
        ref = h.workers.get(wid)
        if ref is not None:
            ref.up = False
            ref.healthy = False
        self._g_worker_up[wid].set(0.0)
        self._g_worker_inflight[wid].set(0.0)
        if self.postmortems is not None:
            # The agent folded the black box into the message (tail and
            # snapshot read on ITS machine): bookkeeping only, safe here.
            self.postmortems.add(
                "worker", f"worker{wid}", msg.get("pid", ref.pid if ref is not None else None),
                msg.get("exitcode"), stderr_tail=msg.get("stderr_tail"),
                snapshot=msg.get("snapshot"), worker=wid, host=h.hid,
                respawn_eta_s=msg.get("eta_s"))

    def _on_worker_up(self, h: HostHandle, wid: int, port: int, pid: int,
                      boot_s: float = 0.0) -> None:
        ref = WorkerRef(wid, h.hid, port, pid, self.cfg.worker.host, boot_s=boot_s)
        h.workers[wid] = ref
        self._refs[wid] = ref
        self._scaled_down.discard(wid)
        self._c_worker_respawns[wid].inc()
        self._g_worker_up[wid].set(1.0)
        log.info("%s: worker %d respawned (pid %d, port %d)", host_name(h.hid), wid, pid, port)

    def _on_worker_scaled_down(self, h: HostHandle, wid: int) -> None:
        """A scale-down drain completed: capacity released on purpose, not
        a death (no deaths_total, no postmortem)."""
        ref = h.workers.get(wid)
        if ref is not None:
            ref.up = False
            ref.healthy = False
        self._scaled_down.add(wid)
        self._g_worker_up[wid].set(0.0)
        self._g_worker_inflight[wid].set(0.0)
        log.info("%s: worker %d scaled down", host_name(h.hid), wid)

    # -- scaling -------------------------------------------------------------
    def active_slots(self, hid: int) -> int:
        """One host domain's active worker-slot target."""
        return self._active[hid]

    def scale_domain(self, hid: int, active: int) -> dict:
        """Set one host domain's active worker-slot target. Raises
        ValueError on a bad target, RuntimeError when the host is down (its
        respawn honours the previous target)."""
        if not 0 <= hid < self.n_hosts:
            raise ValueError(f"no host domain {hid} (hosts: {self.n_hosts})")
        if not 1 <= active <= self.per_host:
            raise ValueError(f"active must be in [1, {self.per_host}], got {active}")
        h = self.hosts[hid]
        if h is None or not h.proc.is_alive():
            raise RuntimeError(f"{host_name(hid)} is down")
        before = self._active[hid]
        self._active[hid] = active
        h.conn.send({"op": "scale", "active": active})
        return {"host": hid, "active_before": before, "active": active,
                "max_slots": self.per_host}

    def scale_state(self) -> list[dict]:
        """Per domain: live state, active and max slots, healthy count and
        summed in-flight relays."""
        out = []
        for hid in range(self.n_hosts):
            h = self.hosts[hid]
            up = h is not None and h.proc.is_alive()
            healthy = inflight = 0
            if up:
                for ref in h.workers.values():
                    if ref.up and ref.healthy:
                        healthy += 1
                        inflight += ref.inflight
            out.append({"host": hid, "up": up, "active": self._active[hid],
                        "max_slots": self.per_host, "healthy": healthy, "inflight": inflight})
        return out

    # -- liveness / health ---------------------------------------------------
    def sweep(self) -> int:
        """Watchdog hook (event loop, non-blocking): reap host slots whose
        AGENT died and schedule their backoff respawns. A dead agent's
        process group is killpg'd first, so no straggler worker outlives
        its failure domain."""
        if self._stopping:
            return 0
        died = 0
        for hid, h in enumerate(self.hosts):
            if h is not None and not h.proc.is_alive():
                died += 1
                self._on_host_dead(hid, h, f"agent exited (code {h.proc.exitcode})")
        return died

    def _on_host_dead(self, hid: int, h: HostHandle, why: str) -> None:
        log.error("%s (pgid %d) is DOWN: %s — %d worker(s) lost with it", host_name(hid),
                  h.pgid, why, sum(1 for r in h.workers.values() if r.up))
        try:
            os.killpg(h.pgid, signal.SIGKILL)  # no orphan half-domain
        except (OSError, ProcessLookupError):
            pass
        self._schedule_host_postmortem(hid, h)
        self.host_deaths_total += 1
        for ref in h.workers.values():
            if ref.up:
                self.deaths_total += 1
            ref.up = False
            ref.healthy = False
            self._g_worker_up[ref.wid].set(0.0)
            self._g_worker_inflight[ref.wid].set(0.0)
        h.close()
        self.hosts[hid] = None
        self._g_host_up[hid].set(0.0)
        self._schedule_respawn(hid)

    def _schedule_host_postmortem(self, hid: int, h: HostHandle) -> None:
        """Fold a dead DOMAIN into one postmortem record: the agent's exit
        code or signal and stderr tail, plus every lost worker's last
        black-box snapshot (an agent killed wholesale cannot report them
        over the pipe, so the router reads the slot files itself). File IO
        on an executor thread."""
        if self.postmortems is None:
            return
        exitcode = h.proc.exitcode
        agent_pid = h.pid
        worker_rows = [(r.wid, r.pid, self._worker_cfgs[r.wid].events.snapshot_path)
                       for r in h.workers.values()]
        stderr_path = (os.path.join(resolve_blackbox_dir(self.cfg.events),
                                    f"{host_name(hid)}.stderr")
                       if self.cfg.events.enabled else None)
        loop = asyncio.get_running_loop()

        def _collect() -> None:
            workers = [{"worker": wid, "pid": pid, "snapshot": read_snapshot(snap or None)}
                       for wid, pid, snap in worker_rows]
            self.postmortems.capture_blocking(
                "host", host_name(hid), agent_pid, exitcode, stderr_path=stderr_path,
                host=hid, workers=workers, workers_lost=len(worker_rows))

        async def _capture() -> None:
            await loop.run_in_executor(None, _collect)

        self._track(loop.create_task(_capture()))

    def _schedule_respawn(self, hid: int) -> None:
        if self._stopping or hid in self._respawning:
            return
        self._respawning.add(hid)
        self._track(asyncio.get_running_loop().create_task(self._respawn(hid)))

    async def _respawn(self, hid: int) -> None:
        loop = asyncio.get_running_loop()
        try:
            while not self._stopping:
                delay = min(self.rcfg.respawn_max_s,
                            self.rcfg.respawn_initial_s
                            * self.rcfg.respawn_multiplier ** self._fails[hid])
                self._g_host_backoff[hid].set(delay)
                self._next_up_at[hid] = time.monotonic() + delay
                await asyncio.sleep(delay)
                if self._stopping:
                    return
                try:
                    h = await loop.run_in_executor(None, self._spawn_host_blocking, hid)
                except Exception:
                    self._fails[hid] += 1
                    log.exception("%s respawn failed (consecutive failures: %d)",
                                  host_name(hid), self._fails[hid])
                    continue
                self._fails[hid] = 0
                self._g_host_backoff[hid].set(0.0)
                self._c_host_respawns[hid].inc()
                self._adopt_host(h)
                log.info("%s respawned (pgid %d, workers %s)", host_name(hid), h.pgid,
                         sorted(h.workers))
                return
        finally:
            self._respawning.discard(hid)

    async def _health_loop(self) -> None:
        while True:
            await asyncio.sleep(self.rcfg.health_interval_s)
            try:
                for hid, h in enumerate(self.hosts):
                    if h is not None and not h.proc.is_alive():
                        self._on_host_dead(hid, h, f"agent exited (code {h.proc.exitcode})")
                await asyncio.gather(*(self._probe(r) for r in self._live_refs()))
            except asyncio.CancelledError:
                raise
            except Exception:  # one bad cycle must not end health checking
                log.exception("host health probe cycle failed")

    async def _probe(self, ref: WorkerRef) -> None:
        try:
            ok = (await self._session.get(f"{ref.base_url}/healthz")).status == 200
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — refused, reset, timeout all count
            ok = False
        if ok:
            if not ref.healthy:
                log.info("worker %d healthy again", ref.wid)
            ref.health_fails = 0
            ref.healthy = True
        else:
            ref.health_fails += 1
            if ref.healthy and ref.health_fails >= self.rcfg.unhealthy_after:
                log.warning("worker %d unhealthy after %d failed probes: routing around it",
                            ref.wid, ref.health_fails)
                ref.healthy = False
        self._g_worker_up[ref.wid].set(1.0 if ref.up and ref.healthy else 0.0)

    # -- host breaker --------------------------------------------------------
    def host_tripped(self, hid: int) -> bool:
        return time.monotonic() < self._hb_until[hid]

    def note_transport_failure(self, ref) -> None:
        """A relay saw connection refused or reset from one of this host's
        workers. ``host_breaker_threshold`` consecutive ones trip the host
        breaker: every worker of the host sheds from pick() for the
        cooldown, then it half-opens (the next pick is the probe). This
        routes around a freshly SIGKILLed machine in milliseconds; health
        probes take a cycle, refused connections do not."""
        if self.rcfg.host_breaker_threshold <= 0:
            return
        hid = getattr(ref, "host", None)
        if hid is None:
            return
        self._hb_fails[hid] += 1
        if self._hb_fails[hid] >= self.rcfg.host_breaker_threshold:
            if not self.host_tripped(hid):
                log.warning("%s breaker OPEN after %d consecutive transport failures; "
                            "shedding picks for %.1fs", host_name(hid), self._hb_fails[hid],
                            self.rcfg.host_breaker_cooldown_s)
            self._hb_until[hid] = time.monotonic() + self.rcfg.host_breaker_cooldown_s
            self._g_host_breaker[hid].set(1.0)

    def note_success(self, ref) -> None:
        hid = getattr(ref, "host", None)
        if hid is None or self._hb_fails[hid] == 0:
            return
        self._hb_fails[hid] = 0
        self._hb_until[hid] = 0.0
        self._g_host_breaker[hid].set(0.0)

    # -- routing -------------------------------------------------------------
    def _live_refs(self):
        for h in self.hosts:
            # Between a killpg and the next sweep a freshly dead host's refs
            # must not count as live for admin fan-outs (the flat supervisor
            # makes the same per-call liveness check).
            if h is None or not h.proc.is_alive():
                continue
            for ref in h.workers.values():
                if ref.up:
                    yield ref

    def healthy_workers(self) -> list[WorkerRef]:
        return [r for r in self._live_refs() if r.healthy]

    def live_workers(self) -> list[WorkerRef]:
        """Every worker on a live host, unhealthy ones included: the admin
        fan-out set."""
        return list(self._live_refs())

    def worker_by_id(self, wid: int) -> WorkerRef | None:
        ref = self._refs.get(wid)
        if ref is None or not ref.up:
            return None
        h = self.hosts[ref.host]
        if h is None or h.workers.get(wid) is not ref:
            return None
        return ref

    def host_of(self, ref) -> int | None:
        return getattr(ref, "host", None)

    def down_domains(self) -> list[str]:
        """Dead or respawning failure domains: whole hosts, plus workers a
        host agent is still re-booting. A fleet reload refuses while any
        exists: a respawn serves the BOOT config and would diverge from a
        freshly published version."""
        out = [host_name(hid) for hid, h in enumerate(self.hosts)
               if h is None or not h.proc.is_alive()]
        for h in self.hosts:
            if h is None:
                continue
            # Scaled-down slots are cold on purpose, not a recovering domain:
            # they never block a reload.
            out.extend(f"{host_name(h.hid)}:worker{r.wid}" for r in h.workers.values()
                       if not r.up and r.wid not in self._scaled_down)
        return out

    def pick(self, exclude: "set[int] | frozenset[int]" = frozenset(),
             exclude_hosts: "set[int] | frozenset[int]" = frozenset()) -> WorkerRef | None:
        """Least-loaded healthy worker on an untripped host, skipping the
        ``exclude`` wids and the ``exclude_hosts`` domains (the hedge rule:
        a hedge and its primary never share a failure domain)."""
        best: WorkerRef | None = None
        for h in self.hosts:
            if h is None or h.hid in exclude_hosts or self.host_tripped(h.hid):
                continue
            for ref in h.workers.values():
                if not ref.up or not ref.healthy or ref.wid in exclude:
                    continue
                if best is None or (ref.inflight, ref.picked_seq) < (best.inflight,
                                                                     best.picked_seq):
                    best = ref
        if best is not None:
            self._pick_seq += 1
            best.picked_seq = self._pick_seq
        return best

    def track_inflight(self, ref: WorkerRef, delta: int) -> None:
        ref.inflight += delta
        self._g_worker_inflight[ref.wid].set(ref.inflight)

    def respawn_eta_s(self) -> float:
        """The least respawn ETA across the respawning hosts (the big
        capacity): the Retry-After basis when no worker is healthy; the
        health interval when no host is respawning."""
        now = time.monotonic()
        etas = [max(0.0, self._next_up_at[hid] - now) for hid in self._respawning]
        if etas:
            return min(etas)
        return self.rcfg.health_interval_s

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        """The /stats ``workers`` block, host-sharded."""
        now = time.monotonic()
        host_rows = []
        worker_rows = []
        for hid in range(self.n_hosts):
            h = self.hosts[hid]
            if h is None:
                host_rows.append({
                    "host": hid, "name": host_name(hid),
                    "state": "respawning" if hid in self._respawning else "down",
                    "consecutive_boot_failures": self._fails[hid],
                    "respawn_eta_s": round(max(0.0, self._next_up_at[hid] - now), 3),
                    "respawns_total": self._c_host_respawns[hid].value,
                })
                for wid in self._host_wids(hid):
                    worker_rows.append({"worker": wid, "host": hid, "state": "down"})
                continue
            rows = []
            for wid in self._host_wids(hid):
                ref = h.workers.get(wid)
                if ref is None or not ref.up:
                    row = {"worker": wid, "host": hid,
                           "state": "scaled_down" if wid in self._scaled_down else "down"}
                else:
                    row = {
                        "worker": wid, "host": hid,
                        "state": "ready" if ref.healthy else "unhealthy",
                        "pid": ref.pid, "port": ref.port,
                        "inflight": ref.inflight,
                        "health_fails": ref.health_fails,
                        "uptime_s": round(now - ref.started_at, 1),
                        "boot_s": round(ref.boot_s, 3),
                    }
                rows.append(row)
                worker_rows.append(row)
            host_rows.append({
                "host": hid, "name": host_name(hid),
                "state": "tripped" if self.host_tripped(hid) else "up",
                "pgid": h.pgid, "pid": h.pid,
                "uptime_s": round(now - h.started_at, 1),
                "boot_s": round(h.boot_s, 3),
                "active_slots": self._active[hid],
                "respawns_total": self._c_host_respawns[hid].value,
                "workers": rows,
            })
        return {
            "configured": self.n,
            "healthy": len(self.healthy_workers()),
            "deaths_total": self.deaths_total,
            "hosts_configured": self.n_hosts,
            "hosts_up": sum(1 for h in self.hosts if h is not None and h.proc.is_alive()),
            "host_deaths_total": self.host_deaths_total,
            "device": self.device,
            "hosts": host_rows,
            "workers": worker_rows,
        }
