"""The horizontal router tier, ported from ``tpuserve/workerproc/peers.py``:
N router processes, one port, one result cache sharded by consistent hash.

One router process is one SIGKILL away from zero availability however many
workers it fronts. This module makes the router tier itself horizontal:

- **SO_REUSEPORT fan-in**: every router binds the SAME serving port with
  ``SO_REUSEPORT``; the kernel spreads connections, a load balancer needs
  one address, and a dead router stops receiving new connections while its
  siblings keep serving.
- **Consistent-hash cache sharding** (``HashRing``): every cache key has
  ONE owning router. A router holding a miss for a key it does not own
  forwards the request to the owner's peer listener over loopback HTTP, so
  the owner's cache and single-flight lead the computation: N identical
  concurrent misses through N routers cost ONE worker execution, and a
  byte-identical re-upload hits whichever router the kernel handed it to.
  An unreachable owner **degrades to local-only**, counted in
  ``cache_peer_errors_total`` and never surfaced: a router death costs
  shard locality, not availability.
- **Peer supervision**: router 0 (the primary) owns the worker or host
  supervisor and supervises the peer router processes with the workers'
  exponential respawn backoff (``router_up``, ``router_respawns_total``); a
  respawned peer syncs the topology again and rejoins the ring.
- **Topology sync** (``TopologyClient``): peers poll the primary's
  ``/peer/state`` for the worker addresses, the ring's membership and the
  cache generations; a fleet reload also pushes an invalidation to every
  live peer, so no router serves a stale generation longer than one sync
  interval even when the push is lost. The same sync carries the primary
  autopilot's shed-on-burn set, which every peer adopts, so the whole tier
  sheds together.
- **Tenant identity**: the ingress router resolves the client's
  ``X-Api-Key`` once and forwards the resolved tenant as ``X-Tenant``
  (``TENANT_HEADER``) on a cache-shard hop, so the owner charges the right
  cache partition without authenticating again. The peer listener is
  loopback-only: the header cannot be forged from outside.

Every router process is free of any device: it imports torch (through the
port's server module) and never initializes CUDA. Peer hops, the topology
sync and the fleet scrape speak HTTP through the port's own client
(``tpuserve_torch.bench.client``), and every listener is the port's own
asyncio server.

Ownership: every structure here is mutated on its router's event loop only
(blocking spawns and pipe reads run on executors). The ring is immutable
once built; a membership change builds a new one.
"""

from __future__ import annotations

import asyncio
import bisect
import hashlib
import logging
import multiprocessing as mp
import os
import time

from tpuserve_torch.config import ServerConfig
from tpuserve_torch.obs import Metrics
from tpuserve_torch.telemetry.events import redirect_stderr, resolve_blackbox_dir
from tpuserve_torch.workerproc.hosts import _EOF, WorkerRef, _poll_recv

log = logging.getLogger("tpuserve_torch.workerproc")

_VNODES = 64
# The resolved tenant on a peer hop (never the API key).
TENANT_HEADER = "X-Tenant"


def _point(data: str) -> int:
    return int.from_bytes(hashlib.blake2b(data.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring over router ids. ``vnodes`` virtual points per
    member keep the key space balanced; a membership change moves only the
    keys next to the joining or leaving member's points (what makes a
    router respawn cheap: the survivors' shards stay put)."""

    def __init__(self, members: dict[int, str], vnodes: int = _VNODES) -> None:
        self.members = dict(members)
        self._points: list[tuple[int, int]] = sorted(
            (_point(f"router{rid}:{v}"), rid) for rid in self.members for v in range(vnodes))

    def owner(self, key: str) -> tuple[int, str] | None:
        """(router id, peer url) owning ``key``; None on an empty ring."""
        if not self._points:
            return None
        h = _point(key)
        i = bisect.bisect_left(self._points, (h, -1)) % len(self._points)
        rid = self._points[i][1]
        return rid, self.members[rid]


# ---------------------------------------------------------------------------
# A peer's view of the worker fleet (synced from the primary)
# ---------------------------------------------------------------------------

class PassiveWorkerView:
    """A peer router's view of the worker fleet: addresses and health
    synced from the primary's ``/peer/state``, refined by transport failures
    seen here. The routing surface of the real supervisors without owning
    a process: the primary supervises."""

    def __init__(self, cfg: ServerConfig, metrics: Metrics) -> None:
        self.cfg = cfg
        self.rcfg = cfg.router
        self.metrics = metrics
        self.n = cfg.router.workers * (cfg.router.hosts or 1)
        self._refs: dict[int, WorkerRef] = {}
        self._local_bad: set[int] = set()
        self._pick_seq = 0
        self.deaths_total = 0
        self.synced_at = 0.0

    def update(self, rows: list[dict]) -> None:
        """Apply one topology snapshot. Badness seen here is wiped: the
        primary's health probes are the authority, and a snapshot is at most
        one sync interval old."""
        seen = set()
        for row in rows:
            wid = int(row["wid"])
            seen.add(wid)
            ref = self._refs.get(wid)
            if ref is None or ref.base_url != row["url"]:
                ref = WorkerRef(wid, row.get("host"), 0, int(row.get("pid", 0)), "127.0.0.1")
                ref.base_url = row["url"]
                self._refs[wid] = ref
            ref.up = True
            ref.healthy = bool(row.get("healthy", True))
        for wid, ref in self._refs.items():
            if wid not in seen:
                ref.up = False
                ref.healthy = False
        self._local_bad.clear()
        self.synced_at = time.monotonic()

    # -- routing surface -----------------------------------------------------
    def healthy_workers(self) -> list[WorkerRef]:
        return [r for r in self._refs.values() if r.up and r.healthy]

    def live_workers(self) -> list[WorkerRef]:
        return [r for r in self._refs.values() if r.up]

    def worker_by_id(self, wid: int) -> WorkerRef | None:
        ref = self._refs.get(wid)
        return ref if ref is not None and ref.up else None

    def host_of(self, ref) -> int | None:
        return getattr(ref, "host", None)

    def down_domains(self) -> list[str]:
        return []  # admin fan-outs run on the primary, never here

    def note_transport_failure(self, ref) -> None:
        """Mark a worker bad here until the next topology sync: no relaying
        at a corpse for the rest of the sync interval."""
        ref.healthy = False
        self._local_bad.add(ref.wid)

    def note_success(self, ref) -> None:
        if ref.wid in self._local_bad:
            self._local_bad.discard(ref.wid)
            ref.healthy = True

    def pick(self, exclude: "set[int] | frozenset[int]" = frozenset(),
             exclude_hosts: "set[int] | frozenset[int]" = frozenset()) -> WorkerRef | None:
        best: WorkerRef | None = None
        for ref in self._refs.values():
            if not ref.up or not ref.healthy or ref.wid in exclude:
                continue
            if ref.host is not None and ref.host in exclude_hosts:
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

    def respawn_eta_s(self) -> float:
        return self.rcfg.health_interval_s

    def sweep(self) -> int:
        return 0

    def stats(self) -> dict:
        return {
            "configured": self.n,
            "healthy": len(self.healthy_workers()),
            "deaths_total": self.deaths_total,
            "view": "peer",
            "synced_age_s": round(time.monotonic() - self.synced_at, 3)
            if self.synced_at else None,
            "workers": [{
                "worker": r.wid, "host": r.host,
                "state": ("ready" if r.healthy else "unhealthy") if r.up else "down",
                "inflight": r.inflight,
            } for r in sorted(self._refs.values(), key=lambda r: r.wid)],
        }


# ---------------------------------------------------------------------------
# Topology sync (peer side)
# ---------------------------------------------------------------------------

class TopologyClient:
    """Polls the primary's ``/peer/state`` and applies it to a peer's
    RouterState (worker view, hash ring, cache generations)."""

    def __init__(self, state, primary_peer_url: str, interval_s: float) -> None:
        self.state = state
        self.url = primary_peer_url.rstrip("/")
        self.interval_s = interval_s
        self._task: asyncio.Task | None = None
        self._c_errors = state.metrics.counter("peer_sync_errors_total")
        self._c_syncs = state.metrics.counter("peer_syncs_total")

    async def start(self, boot_timeout_s: float = 30.0) -> None:
        """The boot sync, then the poll task. Called AFTER the ready
        handshake: the sync is retried until the ring it sees is COMPLETE
        (this router and all ``[router] routers`` members), so a peer never
        opens its public listener with a ring that would mis-shard keys (the
        primary adopts peers as their handshakes land; a sibling still
        booting keeps the ring short for a moment). On timeout with ANY
        topology it proceeds degraded (the poll heals the membership); with
        none at all it raises (the primary respawns it)."""
        state = self.state
        want = state.rcfg.routers
        deadline = time.monotonic() + boot_timeout_s
        while True:
            try:
                await self.sync()
                ring = state.ring
                if ring is not None and state.router_id in ring.members \
                        and len(ring.members) >= want:
                    break
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the primary is not up yet
                pass
            if time.monotonic() >= deadline:
                if state.ring is None:
                    raise RuntimeError(f"router {state.router_id}: no topology from "
                                       f"{self.url} within {boot_timeout_s:.0f}s")
                log.warning("router %d: boot ring incomplete (%d/%d members); serving "
                            "degraded until the poll sync heals it", state.router_id,
                            len(state.ring.members), want)
                break
            await asyncio.sleep(0.1)
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.sync()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — keep the last known topology
                self._c_errors.inc()

    async def sync(self) -> None:
        r = await self.state._session.get(f"{self.url}/peer/state", timeout_s=2.0)
        if r.status != 200:
            raise RuntimeError(f"/peer/state answered {r.status}")
        self.state.apply_topology(r.json())
        self._c_syncs.inc()

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


# ---------------------------------------------------------------------------
# The peer router process, and its supervision by the primary
# ---------------------------------------------------------------------------

def peer_main(cfg: ServerConfig, router_id: int, public_host: str, public_port: int,
              primary_peer_url: str, conn, stderr_path: str = "") -> None:
    """Peer-router process entry (the multiprocessing spawn target). Free of
    any device like every router: it builds no model and owns no worker;
    it binds the shared public port with SO_REUSEPORT, owns its cache shard
    and relays to the worker addresses it syncs from the primary.
    ``stderr_path`` captures this process's stderr for the primary's
    postmortem reader."""
    from tpuserve_torch.server import configure_logging

    redirect_stderr(stderr_path, f"router {router_id} boot pid {os.getpid()} "
                                 f"ts {time.time():.3f}")
    configure_logging(cfg)
    log.info("peer router %d: starting (pid %d)", router_id, os.getpid())
    try:
        asyncio.run(_peer_serve(cfg, router_id, public_host, public_port, primary_peer_url,
                                conn))
    except Exception as e:  # noqa: BLE001 — report any death upward
        try:
            conn.send({"op": "died", "error": f"{type(e).__name__}: {e}"})
        except (BrokenPipeError, OSError):
            pass
        raise
    finally:
        try:
            conn.close()
        except OSError:
            pass


async def _peer_serve(cfg: ServerConfig, router_id: int, public_host: str, public_port: int,
                      primary_peer_url: str, conn) -> None:
    import signal

    from tpuserve_torch.workerproc.router import (RouterState, bind_public_socket, listen_on,
                                                  stop_router)

    state = RouterState(cfg, router_id=router_id, primary_peer_url=primary_peer_url)
    await state.start()  # session and peer listener (no public serving yet)

    # Handshake FIRST: the primary adds this router to the ring once it
    # knows the peer port. Then sync until the ring is complete, and only
    # then open the public listener: a peer never takes public traffic with
    # a ring that would mis-shard keys.
    conn.send({"op": "ready", "peer_port": state.peer_port, "pid": os.getpid()})
    # Peer handshakes are fast (no model builds): a ring still incomplete
    # after 30 s means a sibling died at boot; serve degraded and let the
    # poll sync heal the membership when it respawns.
    try:
        await state.topo.start(boot_timeout_s=min(30.0, cfg.router.spawn_timeout_s))
        sock = bind_public_socket(public_host, public_port)
    except BaseException:
        await state.stop()
        raise
    server = await listen_on(state, sock)
    state.serving_addresses = [s.getsockname()[:2] for s in server.sockets]
    log.info("peer router %d serving on %s:%d (peer port %d, ring %s)", router_id,
             public_host, public_port, state.peer_port,
             sorted(state.ring.members) if state.ring else None)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            pass

    async def _watch_parent() -> None:
        # The primary vanished (pipe EOF) or asked us to stop: drain and
        # exit rather than keep a half-fleet serving with no supervisor.
        while True:
            msg = await loop.run_in_executor(None, _poll_recv, conn, 0.25)
            if msg is _EOF or (msg is not None and msg.get("op") == "stop"):
                stop.set()
                return

    watcher = loop.create_task(_watch_parent())
    try:
        await stop.wait()
        await state.drain()
    finally:
        watcher.cancel()
        await asyncio.gather(watcher, return_exceptions=True)
        await stop_router(state, server)


class PeerHandle:
    """The primary's handle on one live peer router process."""

    __slots__ = ("rid", "proc", "conn", "peer_port", "peer_url", "pid", "started_at")

    def __init__(self, rid: int, proc, conn, peer_port: int, pid: int) -> None:
        self.rid = rid
        self.proc = proc
        self.conn = conn
        self.peer_port = peer_port
        self.peer_url = f"http://127.0.0.1:{peer_port}"
        self.pid = pid
        self.started_at = time.monotonic()

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


class PeerRouterSupervisor:
    """Spawns and supervises the N-1 peer router processes (router 0 is the
    caller): the worker supervisor's liveness sweep and exponential-backoff
    respawn; ``on_change`` fires on every membership change, so the primary
    rebuilds its ring."""

    def __init__(self, cfg: ServerConfig, metrics: Metrics, on_change,
                 postmortems=None) -> None:
        self.cfg = cfg
        self.rcfg = cfg.router
        self.metrics = metrics
        self.on_change = on_change
        self.postmortems = postmortems
        self.rids = list(range(1, cfg.router.routers))
        self.peers: dict[int, PeerHandle] = {}
        self._fails = {rid: 0 for rid in self.rids}
        self._next_up_at = {rid: 0.0 for rid in self.rids}
        self._respawning: set[int] = set()
        self._bg: set[asyncio.Task] = set()
        self._stopping = False
        self.deaths_total = 0
        self._public: tuple[str, int] | None = None
        self._primary_peer_url: str | None = None
        self._g_up = {rid: metrics.router_up_gauge(rid) for rid in self.rids}
        self._c_respawns = {rid: metrics.router_respawns_counter(rid) for rid in self.rids}

    def _track(self, t: asyncio.Task) -> None:
        self._bg.add(t)
        t.add_done_callback(self._bg.discard)

    async def start(self, public_host: str, public_port: int, primary_peer_url: str) -> None:
        self._public = (public_host, public_port)
        self._primary_peer_url = primary_peer_url
        loop = asyncio.get_running_loop()
        spawned = await asyncio.gather(
            *(loop.run_in_executor(None, self._spawn_blocking, rid) for rid in self.rids))
        for h in spawned:
            self.peers[h.rid] = h
            self._g_up[h.rid].set(1.0)
        if spawned:
            self.on_change()
        log.info("peer routers up: %s", [f"{h.rid}@{h.peer_port}" for h in spawned])

    def _peer_stderr_path(self, rid: int) -> str:
        """The peer router's stderr capture file; "" with the event plane
        off."""
        if not self.cfg.events.enabled:
            return ""
        return os.path.join(resolve_blackbox_dir(self.cfg.events), f"router{rid}.stderr")

    def _spawn_blocking(self, rid: int) -> PeerHandle:
        ctx = mp.get_context("spawn")
        parent, child = ctx.Pipe()
        host, port = self._public
        proc = ctx.Process(target=peer_main,
                           args=(self.cfg, rid, host, port, self._primary_peer_url, child,
                                 self._peer_stderr_path(rid)),
                           daemon=True, name=f"tpuserve-torch-router-{rid}")
        proc.start()
        child.close()
        try:
            if not parent.poll(self.rcfg.spawn_timeout_s):
                raise TimeoutError(f"peer router {rid} not ready after "
                                   f"{self.rcfg.spawn_timeout_s:.0f}s")
            msg = parent.recv()
            if msg.get("op") != "ready":
                raise RuntimeError(f"peer router {rid} failed at boot: {msg}")
        except BaseException:
            if proc.is_alive():
                proc.kill()
            proc.join(5.0)
            parent.close()
            raise
        if self._stopping:
            proc.kill()
            proc.join(5.0)
            parent.close()
            raise RuntimeError(f"supervisor stopping; discarded peer router {rid}")
        return PeerHandle(rid, proc, parent, int(msg["peer_port"]),
                          int(msg.get("pid", proc.pid)))

    def members(self) -> dict[int, str]:
        """The live ring members among the peers (the primary adds itself)."""
        return {rid: h.peer_url for rid, h in self.peers.items() if h.proc.is_alive()}

    def sweep(self) -> int:
        """Watchdog hook: reap dead peer routers, drop them from the ring,
        respawn them with backoff."""
        if self._stopping:
            return 0
        died = 0
        for rid in list(self.peers):
            h = self.peers[rid]
            if not h.proc.is_alive():
                died += 1
                log.error("peer router %d (pid %d) died (code %s)", rid, h.pid,
                          h.proc.exitcode)
                self.deaths_total += 1
                self._schedule_postmortem(rid, h)
                h.close()
                del self.peers[rid]
                self._g_up[rid].set(0.0)
                self.on_change()
                self._schedule_respawn(rid)
        return died

    def _schedule_postmortem(self, rid: int, h: PeerHandle) -> None:
        """A dead peer router gets a dead worker's forensics: exit code or
        signal and its stderr tail (peers write no black-box snapshot: they
        own no model)."""
        if self.postmortems is None:
            return
        exitcode = h.proc.exitcode
        stderr_path = self._peer_stderr_path(rid) or None
        loop = asyncio.get_running_loop()

        async def _capture() -> None:
            await loop.run_in_executor(None, lambda: self.postmortems.capture_blocking(
                "router", f"router{rid}", h.pid, exitcode, stderr_path=stderr_path,
                router=rid))

        self._track(loop.create_task(_capture()))

    def _schedule_respawn(self, rid: int) -> None:
        if self._stopping or rid in self._respawning:
            return
        self._respawning.add(rid)
        self._track(asyncio.get_running_loop().create_task(self._respawn(rid)))

    async def _respawn(self, rid: int) -> None:
        loop = asyncio.get_running_loop()
        try:
            while not self._stopping:
                delay = min(self.rcfg.respawn_max_s,
                            self.rcfg.respawn_initial_s
                            * self.rcfg.respawn_multiplier ** self._fails[rid])
                self._next_up_at[rid] = time.monotonic() + delay
                await asyncio.sleep(delay)
                if self._stopping:
                    return
                try:
                    h = await loop.run_in_executor(None, self._spawn_blocking, rid)
                except Exception:
                    self._fails[rid] += 1
                    log.exception("peer router %d respawn failed (consecutive failures: %d)",
                                  rid, self._fails[rid])
                    continue
                self.peers[rid] = h
                self._fails[rid] = 0
                self._g_up[rid].set(1.0)
                self._c_respawns[rid].inc()
                self.on_change()
                log.info("peer router %d respawned (pid %d, peer port %d)", rid, h.pid,
                         h.peer_port)
                return
        finally:
            self._respawning.discard(rid)

    async def stop(self) -> None:
        self._stopping = True
        for t in list(self._bg):
            t.cancel()
        if self._bg:
            await asyncio.gather(*self._bg, return_exceptions=True)
        live = [h for h in self.peers.values() if h.proc.is_alive()]
        for h in live:
            h.proc.terminate()
        deadline = time.monotonic() + self.cfg.drain_timeout_s + 2.0
        while any(h.proc.is_alive() for h in live) and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        for h in live:
            if h.proc.is_alive():
                h.proc.kill()
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: [h.proc.join(10.0) for h in live])
        for rid, h in list(self.peers.items()):
            h.close()
            self._g_up[rid].set(0.0)

    def stats(self) -> dict:
        now = time.monotonic()
        rows = []
        for rid in self.rids:
            h = self.peers.get(rid)
            if h is None or not h.proc.is_alive():
                rows.append({
                    "router": rid,
                    "state": "respawning" if rid in self._respawning else "down",
                    "respawn_eta_s": round(max(0.0, self._next_up_at[rid] - now), 3),
                    "respawns_total": self._c_respawns[rid].value,
                })
            else:
                rows.append({
                    "router": rid, "state": "up", "pid": h.pid, "peer_port": h.peer_port,
                    "uptime_s": round(now - h.started_at, 1),
                    "respawns_total": self._c_respawns[rid].value,
                })
        return {"configured": len(self.rids) + 1, "deaths_total": self.deaths_total,
                "peers": rows}
