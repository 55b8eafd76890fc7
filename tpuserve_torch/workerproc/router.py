"""Router tier: the HTTP front door over N worker processes, ported from
``tpuserve/workerproc/router.py``.

The router owns everything that must survive a worker death: HTTP/JSON,
admission and per-request deadline stamping, the content-addressed result
cache with single-flight coalescing (hoisted above the process boundary so
a cached answer outlives the worker that computed it), and per-model
circuit breakers. It never touches a device: it imports torch (through the
port's server module) but never initializes CUDA, so a worker taking its
runtime down cannot take the front door with it, and the workers it spawns
(with the ``spawn`` method) own their CUDA contexts.

Its front door is the port's own asyncio HTTP/1.1 server
(``tpuserve_torch.server``: ``Request``, ``Response``, ``StreamResponse``,
``_serve_connection``); its relay client is the port's stdlib
``ClientSession`` (``tpuserve_torch.bench.client``) with a keep-alive pool
per worker and a connect timeout.

Relay semantics:

- **Deadline stamping** — the absolute deadline is stamped once at
  admission; every forward carries ``X-Timeout-Ms`` = the budget REMAINING
  at dispatch, so the worker re-stamps the same absolute instant on its own
  clock. No retry or hedge ever extends it.
- **Retry** — transport failures (connection refused or reset, a worker
  dying mid-request) re-dispatch to a different healthy worker, up to
  ``retry_max`` times within the deadline. A DEFINITIVE worker answer
  (anything but a 503-not-admitted) is never re-dispatched: a 500 means the
  work already executed and failed, and re-running it would double-execute.
- **Hedging** — with ``hedge_ms > 0`` an attempt silent that long gets a
  duplicate on another worker; the first definitive answer wins and the
  loser is cancelled.
- **Degradation** — with no healthy worker, requests shed fast with 503 +
  ``Retry-After`` from the supervisor's live respawn ETA; breaker 503s
  carry the half-open probe ETA.
- **Drain** — SIGTERM: stop admitting (503 + Retry-After), wait for the
  relays in flight (streams get ``stream_drain_s``, then a "drain" error
  terminal), and only then SIGTERM the workers, each of which drains its
  own accepted work.
- **Streams** — ``?stream=true`` rides the forward; a worker answering
  with ``X-Tpuserve-Stream: 1`` commits the attempt at its headers (no
  retry or hedge after that: tokens may have reached the client), and the
  relay forwards the body chunk by chunk, ending it with a well-formed
  error terminal when the worker dies, goes idle past
  ``stream_idle_timeout_ms`` or outlives the drain budget.
- **Tracing** — the router mints each request's trace id; every attempt
  crosses as ``X-Trace-Id`` + ``X-Parent-Span``, so retried and hedged
  attempts are sibling spans with the worker's tree under each;
  ``/debug/trace?trace_id=`` stitches router and worker records (worker
  spans carry pid = worker id + 1).
- **Host failure domains** — with ``[router] hosts > 0`` the primary's
  supervisor is a ``HostSupervisor`` (``hosts.py``): a hedge never lands
  on its primary's host, relay transport failures feed the host breaker,
  and ``:reload`` refuses 409 with per-host outcomes while a domain is down.
- **Peer routers** — with ``[router] routers > 1`` router 0 (the primary)
  binds the serving socket with SO_REUSEPORT, spawns and supervises the
  peer routers (``peers.py``) that bind the same port, and every router
  shards the result cache by consistent hash: a miss whose key another
  router owns is forwarded to that router's loopback peer listener and
  degrades to the local shard when the owner cannot be reached (counted in
  ``cache_peer_errors_total``, never surfaced). A peer proxies the admin
  verbs, the audit trail, the postmortems and the fleet scrape to the
  primary, which owns the fleet.

Routes: ``POST /v1/models/{name}:{predict,classify,detect,generate}``;
``GET /healthz``, ``/metrics``, ``/stats`` (with the supervisor's
``workers`` block and the workers' kernel counts summed), ``/v1/models``,
``/``, ``/stats/history``, ``/alerts``, ``/debug/{trace,slow,events,
postmortems,audit}``; ``GET /workers/{wid}/{metrics,stats,healthz}``,
``/workers/{wid}/stats/history`` and ``/workers/{wid}/debug/events`` (a
proxy to one worker's own page); ``POST /admin/models/{name}:reload`` and
``:rollback`` (atomic fan-outs), ``GET /admin/models/{name}/versions``,
``POST /admin/hosts/{hid}:scale?active=N``; ``POST /debug/kernels:reset``
(fanned out); ``GET /metrics/fleet`` and ``/stats/fleet`` (the fleet
scrape, ``tpuserve_torch.telemetry.fleet``). The peer listener (loopback)
serves ``/peer/state``, ``/peer/invalidate``, ``/peer/models/{name}:{verb}``,
``/peer/admin/...``, ``/peer/stats``, ``/peer/healthz``, ``/peer/metrics``,
``/peer/fleet/{metrics,stats}`` and ``/peer/debug/{audit,postmortems}``.
The autopilot and tenants (ROADMAP.md item 11b) answer with their refusal.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import json
import logging
import math
import os
import signal
import socket
import time
from urllib.parse import urlencode

import torch

from tpuserve_torch import frame
from tpuserve_torch.bench.client import ClientError, ClientSession, ClientTimeout
from tpuserve_torch.cache import ModelCache
from tpuserve_torch.config import ServerConfig, SloConfig
from tpuserve_torch.faults import CircuitBreaker, Watchdog
from tpuserve_torch.obs import (FlightRecorder, Metrics, TraceContext,
                                exposition_content_type, spans_to_chrome)
from tpuserve_torch.server import (_INDEX_HTML, _MAX_HEAD, _VERBS, Connections, Request,
                                   Response, StreamResponse, _err, _listen, _requested_stream,
                                   _requested_timeout_ms, _serve_connection, _text,
                                   json_response)
from tpuserve_torch.telemetry import events as events_mod
from tpuserve_torch.telemetry.events import AuditLog, EventLog, PostmortemLog
from tpuserve_torch.telemetry.fleet import merge_expositions, parse_exposition
from tpuserve_torch.telemetry.slo import SloEngine
from tpuserve_torch.telemetry.store import MetricSampler, TimeSeriesStore, quantile_from_counts
from tpuserve_torch.workerproc.hosts import HostSupervisor, host_name
from tpuserve_torch.workerproc.peers import (HashRing, PassiveWorkerView, PeerRouterSupervisor,
                                             TopologyClient)
from tpuserve_torch.workerproc.supervisor import WorkerHandle, WorkerSupervisor

log = logging.getLogger("tpuserve_torch.workerproc")

# The router's own wait runs this much past a request's deadline, so the
# worker's precise 504 (at the instant) never races it.
_DEADLINE_GRACE_S = 0.25

# Response header a worker stamps on a committed stream: its presence is
# the router's first-byte latch (retries and hedges stop being legal).
_STREAM_HEADER = "x-tpuserve-stream"

# Routes of the reference's router this slice does not serve: each answers
# with its refusal (the reference answers them 409 while disabled).
_REFUSED = {
    "/debug/autopilot": (409, "[autopilot] is disabled; no controller runs "
                              "(not yet ported: ROADMAP.md item 11b)"),
    "/tenants": (409, "[tenants] is disabled; no tenant ledger is kept "
                      "(not yet ported: ROADMAP.md item 11b)"),
}


class NoHealthyWorker(Exception):
    """Every worker slot is dead or unhealthy; ``eta_s`` is the live respawn
    backoff ETA (-> 503 + Retry-After)."""

    def __init__(self, eta_s: float) -> None:
        super().__init__("no healthy worker")
        self.eta_s = eta_s


class RelayDeadline(Exception):
    """The request's absolute deadline expired while relaying (-> 504)."""


class UpstreamFailed(Exception):
    """Transport failures exhausted the retry budget (-> 503, retryable: the
    work was never definitively executed)."""


class _Answer:
    """One complete worker response (body fully read — never torn)."""

    __slots__ = ("status", "content_type", "body", "retry_after")

    def __init__(self, status: int, content_type: str, body: bytes,
                 retry_after: str | None) -> None:
        self.status = status
        self.content_type = content_type
        self.body = body
        self.retry_after = retry_after

    def to_response(self) -> Response:
        headers = {"Retry-After": self.retry_after} if self.retry_after else {}
        return Response(self.status, self.body, content_type=self.content_type,
                        headers=headers)


class _RelayedError(Exception):
    """A non-200 relay outcome crossing the cache's single-flight machinery
    (errors fan out to coalesced waiters but never populate)."""

    def __init__(self, ans: _Answer) -> None:
        super().__init__(f"upstream answered {ans.status}")
        self.ans = ans


class _StreamAnswer:
    """A streaming worker response claimed at its headers, body unread: the
    relay forwards it chunk by chunk. Owns the open upstream response and
    the worker's inflight count until ``close()``; closing with the body
    unread closes the upstream connection, which is the worker's
    client-disconnect signal (its engine frees the slot)."""

    __slots__ = ("status", "content_type", "resp", "worker", "_state", "_closed")

    def __init__(self, status: int, content_type: str, resp, worker: WorkerHandle,
                 state: "RouterState") -> None:
        self.status = status
        self.content_type = content_type
        self.resp = resp
        self.worker = worker
        self._state = state
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.resp.release()
        self._state.supervisor.track_inflight(self.worker, -1)


class RouterHandles:
    """Per-model hot-path metric handles, prebound once."""

    __slots__ = ("mcfg", "requests", "retries", "hedges", "timeouts", "latency",
                 "streams", "first_unit", "peer_hops", "peer_errors", "peer_serves")

    def __init__(self, name: str, mcfg, metrics: Metrics) -> None:
        self.mcfg = mcfg
        self.requests = metrics.router_counter(name, "requests")
        self.retries = metrics.router_counter(name, "retries")
        self.hedges = metrics.router_counter(name, "hedges")
        self.timeouts = metrics.router_counter(name, "timeouts")
        self.latency = metrics.histogram(f"router_latency_ms{{model={name}}}")
        # Committed streams relayed, and the client-observed first-byte
        # latency (the "<model>:first_unit" SLO's input at this tier).
        self.streams = metrics.router_counter(name, "streams")
        self.first_unit = metrics.histogram(f"router_first_unit_ms{{model={name}}}")
        # Sharded-cache peer hops: forwards to a key's owning router, hops
        # that failed transport (and degraded to the local shard), and
        # requests this router served on a peer's behalf.
        self.peer_hops = metrics.counter(f"cache_peer_hops_total{{model={name}}}")
        self.peer_errors = metrics.counter(f"cache_peer_errors_total{{model={name}}}")
        self.peer_serves = metrics.counter(f"cache_peer_serves_total{{model={name}}}")


def _content_type(raw: str | None) -> str:
    return (raw or "application/json").split(";", 1)[0].strip()


class RouterState:
    """Everything a running router process owns. ``device`` is what the
    workers serve on: ``"cuda"`` (the default: the current CUDA device) or
    another torch device string, ``"cpu"`` included; this process never
    touches it.

    ``router_id`` 0 (the default) is the PRIMARY: it owns the worker or
    host supervisor and, with ``[router] routers > 1``, the peer-router
    supervisor. A peer router (``router_id >= 1``, spawned by the primary
    through ``peers.py``) owns no process: it syncs the worker topology and
    the ring's membership from the primary's peer listener
    (``primary_peer_url``) and serves the same public port."""

    def __init__(self, cfg: ServerConfig, device: str = "cuda", router_id: int = 0,
                 primary_peer_url: str | None = None) -> None:
        self.cfg = cfg
        self.rcfg = cfg.router
        self.router_id = router_id
        self.is_primary = router_id == 0
        self.metrics = Metrics(cfg.trace_capacity, exemplars=cfg.trace.exemplars)
        # The front door's view of slow and errored requests (root + attempt
        # spans, pid 0); /debug/trace?trace_id= stitches the workers' in.
        self.recorder = FlightRecorder(
            slow_n=cfg.trace.slow_n, error_capacity=cfg.trace.error_capacity,
            always_record_errors=cfg.trace.always_record_errors, metrics=self.metrics)
        # Event plane: the router's postmortem ledger is the fleet's (its
        # supervisor reaps every worker).
        self.events: EventLog | None = None
        self.audit: AuditLog | None = None
        self.postmortems: PostmortemLog | None = None
        if cfg.events.enabled:
            ecfg = cfg.events
            self.events = EventLog(self.metrics, ecfg.capacity, jsonl_path=ecfg.jsonl_path)
            self.audit = AuditLog(self.metrics, ecfg.audit_capacity, events=self.events)
            self.postmortems = PostmortemLog(
                self.metrics, ecfg.postmortem_capacity,
                tail_bytes=ecfg.stderr_tail_bytes, events=self.events)
            events_mod.install_bridge(self.events, ecfg.bridge_level)
            events_mod.set_active(self.events)
        if not self.is_primary:
            # A peer router: a passive worker view synced from the primary.
            self.supervisor = PassiveWorkerView(cfg, self.metrics)
        elif cfg.router.hosts > 0:
            # Host failure domains: workers grouped under host agents, each
            # agent one SIGKILL-able process group.
            self.supervisor = HostSupervisor(cfg, self.metrics, device=device,
                                             postmortems=self.postmortems)
        else:
            self.supervisor = WorkerSupervisor(cfg, self.metrics, device=device,
                                               postmortems=self.postmortems)
        self.device = device
        self.watchdog = Watchdog(cfg.watchdog_interval_s, self.metrics)
        # The consistent-hash ring over every live router's peer listener:
        # None until membership is known (one router keeps it None: always
        # local).
        self.ring: HashRing | None = None
        self.peer_port: int | None = None
        self.peer_url: str | None = None
        self._peer_server: asyncio.AbstractServer | None = None
        self._peer_conns: Connections | None = None
        # (host, port) of the shared public listener: serve_router_async
        # binds the SO_REUSEPORT socket BEFORE start(), so the peers spawned
        # there join it.
        self.public_addr: tuple[str, int] | None = None
        self.peer_sup = (PeerRouterSupervisor(cfg, self.metrics, self._rebuild_ring,
                                              postmortems=self.postmortems)
                         if self.is_primary and cfg.router.routers > 1 else None)
        self.topo = (TopologyClient(self, primary_peer_url, cfg.router.peer_sync_interval_s)
                     if not self.is_primary else None)
        self.handles: dict[str, RouterHandles] = {}
        self.breakers: dict[str, CircuitBreaker] = {}
        self.caches: dict[str, ModelCache] = {}
        # Per-model config generation: bumped on every successful reload or
        # rollback fan-out and baked into every cache key, so a fleet-wide
        # publish atomically invalidates all older entries.
        self.generations: dict[str, int] = {}
        # Last machine-readable shed reason each model's workers answered
        # (503/504 JSON with a "reason"), carried on this router's breaker
        # 503s.
        self.last_shed_reason: dict[str, str] = {}
        # Next allowed breaker probe per model (time.monotonic): while a
        # breaker is open one request per breaker_retry_after_s goes through
        # as the recovery probe; the rest shed with the probe ETA.
        self._probe_at: dict[str, float] = {}
        self.draining = False
        self._inflight = 0
        # When set (time.monotonic), in-flight streams end with a "drain"
        # error terminal: a long generation must not pin a drain.
        self._stream_kill_at: float | None = None
        self.serving_addresses: list = []
        self.connections: Connections | None = None
        self._session: ClientSession | None = None
        # Telemetry at the router tier: history over the router's registry
        # and the SLO engine over router_latency_ms{model=}, the latency the
        # CLIENT sees (queue, retries and hedges included).
        self.store: TimeSeriesStore | None = None
        self.sampler: MetricSampler | None = None
        self.slo: SloEngine | None = None
        if cfg.telemetry.enabled:
            tcfg = cfg.telemetry
            self.store = TimeSeriesStore(
                self.metrics, capacity=int(tcfg.history_s / tcfg.sample_interval_s))
            self.slo = SloEngine(self.metrics, self.store, tcfg.burn_windows_s,
                                 metric_fmt="router_latency_ms{{model={name}}}")
            self.sampler = MetricSampler(self.store, tcfg.sample_interval_s,
                                         hooks=[self.slo.tick])
            for mcfg in cfg.models:
                self.slo.register(mcfg.name, mcfg.slo)
                if mcfg.slo.first_unit_ms > 0:
                    self.slo.register(
                        f"{mcfg.name}:first_unit",
                        SloConfig(latency_ms=mcfg.slo.first_unit_ms,
                                  availability=mcfg.slo.availability,
                                  burn_alert=mcfg.slo.burn_alert),
                        metric=f"router_first_unit_ms{{model={mcfg.name}}}")
        self.fleet_scrapes = self.metrics.counter("fleet_scrapes_total")
        self.fleet_scrape_errors = self.metrics.counter("fleet_scrape_errors_total")
        for mcfg in cfg.models:
            name = mcfg.name
            self.handles[name] = RouterHandles(name, mcfg, self.metrics)
            self.breakers[name] = CircuitBreaker(
                name, mcfg.breaker_threshold, self.metrics,
                retry_after_s=mcfg.breaker_retry_after_s)
            self.generations[name] = 1
            # The wire-level key digests the raw body, so only models whose
            # results are a pure function of the body may populate it.
            if cfg.cache.enabled and mcfg.cacheable:
                self.caches[name] = ModelCache(
                    name, cfg.cache, self.metrics,
                    version_fn=functools.partial(self.generations.get, name, 0))

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> None:
        self._session = ClientSession(limit=0, timeout_s=120.0,
                                      connect_timeout_s=self.rcfg.connect_timeout_ms / 1e3)
        self.connections = Connections()
        if self.sampler is not None:
            self.sampler.start()
        if not self.is_primary:
            # A peer router: bind the peer listener (cache hops land here).
            # Its topology sync runs after the ready handshake (peers.py):
            # the primary puts a peer in the ring only once it knows the
            # peer port.
            await self._start_peer_listener()
            return
        await self.supervisor.start()
        # The process-liveness sweep rides the watchdog: a reaped worker (or
        # whole host) lands in
        # watchdog_restarts_total{model=_router,component=worker|host}.
        self.watchdog.register("_router", "host" if self.rcfg.hosts > 0 else "worker",
                               self.supervisor.sweep)
        if self.rcfg.routers > 1:
            await self._start_peer_listener()
        if self.peer_sup is not None:
            if self.public_addr is None:
                raise RuntimeError("[router] routers > 1 needs the shared public address "
                                   "bound before start(): set state.public_addr "
                                   "(serve_router_async binds the SO_REUSEPORT socket)")
            await self.peer_sup.start(self.public_addr[0], self.public_addr[1], self.peer_url)
            self.watchdog.register("_router", "router", self.peer_sup.sweep)
            self._rebuild_ring()
        self.watchdog.start()

    async def _start_peer_listener(self) -> None:
        """Bind this router's loopback control plane: the /peer/state
        topology, /peer/models (sharded-cache hops from sibling routers) and
        the primary's /peer/admin fan-out entry."""
        self._peer_conns = Connections()
        port = self.rcfg.peer_port if self.is_primary and self.rcfg.peer_port else 0
        self._peer_server = await _listen(PeerApp(self), self._peer_conns, None, "127.0.0.1",
                                          port, False)
        self.peer_port = self._peer_server.sockets[0].getsockname()[1]
        self.peer_url = f"http://127.0.0.1:{self.peer_port}"

    def _rebuild_ring(self) -> None:
        """Primary: rebuild the hash ring from itself and the live peers (at
        start and on every peer death or respawn). Peers rebuild theirs from
        /peer/state."""
        members = {self.router_id: self.peer_url}
        if self.peer_sup is not None:
            members.update(self.peer_sup.members())
        self.ring = HashRing(members)

    def apply_topology(self, data: dict) -> None:
        """Peer side: adopt one /peer/state snapshot: worker addresses, ring
        membership and cache generations (a generation bump clears the
        local shard, the poll half of the reload invalidation)."""
        self.supervisor.update(data.get("workers") or [])
        members = {int(r["router"]): r["peer_url"] for r in (data.get("ring") or [])}
        if members and (self.ring is None or members != self.ring.members):
            self.ring = HashRing(members)
        for name, gen in (data.get("generations") or {}).items():
            self._set_generation(name, int(gen))

    def _set_generation(self, name: str, gen: int) -> None:
        """Adopt the primary's generation of ``name``; a change clears this
        router's shard."""
        if name in self.generations and self.generations[name] != gen:
            self.generations[name] = gen
            cache = self.caches.get(name)
            if cache is not None:
                cache.clear()

    def peer_state(self) -> dict:
        """The /peer/state body a peer syncs from (the primary's authority)."""
        sup = self.supervisor
        workers = [{"wid": w.wid, "host": sup.host_of(w), "url": w.base_url,
                    "healthy": w.healthy} for w in sup.live_workers()]
        if self.ring is not None:
            ring = [{"router": rid, "peer_url": url}
                    for rid, url in sorted(self.ring.members.items())]
        else:
            ring = [{"router": self.router_id, "peer_url": self.peer_url}]
        return {"ring": ring, "workers": workers, "generations": dict(self.generations),
                "draining": self.draining}

    def begin_drain(self) -> None:
        self.draining = True

    async def drain(self) -> bool:
        """SIGTERM steps 1 and 2: stop the revival machinery (the watchdog
        must not respawn a worker this drain is about to SIGTERM), stop
        admitting, then wait for every relay in flight within the budget."""
        t0 = time.perf_counter()
        await self.watchdog.stop()
        await self._stop_sampler()
        self.begin_drain()
        self._stream_kill_at = time.monotonic() + self.rcfg.stream_drain_s
        deadline = time.monotonic() + self.cfg.drain_timeout_s
        while self._inflight > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        drained = self._inflight == 0
        if self.audit is not None:
            self.audit.record("drain", "server", "ok" if drained else "budget_expired",
                              duration_ms=(time.perf_counter() - t0) * 1e3,
                              router_id=self.router_id,
                              drain_timeout_s=self.cfg.drain_timeout_s)
        return drained

    async def stop(self) -> None:
        await self.watchdog.stop()
        await self._stop_sampler()
        if self.topo is not None:
            await self.topo.stop()
        if self.peer_sup is not None:
            # Peer routers first: they drain their own relays on SIGTERM,
            # and must do so while the workers still answer.
            await self.peer_sup.stop()
        if self.is_primary:
            # Workers drain their accepted batches on SIGTERM; with the
            # router drained first there is nothing in flight to lose.
            await self.supervisor.stop(drain=True)
        if self._peer_server is not None:
            self._peer_server.close()
            await self._peer_conns.close(2.0)
            await self._peer_server.wait_closed()
            self._peer_server = None
        if self._session is not None:
            await self._session.close()
            self._session = None
        if self.events is not None:
            self.events.close()

    async def _stop_sampler(self) -> None:
        if self.sampler is not None:
            await asyncio.get_running_loop().run_in_executor(None, self.sampler.stop)

    # -- shed hints ----------------------------------------------------------
    def no_worker_retry_after(self) -> int:
        return max(1, math.ceil(self.supervisor.respawn_eta_s()))

    def shed_retry_after(self) -> int:
        return max(1, math.ceil(self.cfg.shed_retry_after_s))

    # -- relay ---------------------------------------------------------------
    async def _attempt(self, w: WorkerHandle, name: str, verb: str, body: bytes,
                       ctype: str, deadline_at: float, ctx: TraceContext | None = None,
                       stream: bool = False,
                       committed: "list[_StreamAnswer] | None" = None,
                       ) -> "_Answer | _StreamAnswer":
        """One request/response against one worker. A unary body is read
        whole before returning, so a relayed response is never torn: a
        worker dying mid-body is a transport error (and a retry), not a
        truncated 200. With ``stream`` a worker answering with the stream
        header commits this attempt at the HEADERS: the open response is
        handed up as a _StreamAnswer (registered in ``committed`` first, so
        the relay can close a losing one). The trace id crosses as
        ``X-Trace-Id`` and this attempt's span id as ``X-Parent-Span``."""
        remaining = deadline_at - time.perf_counter()
        headers = {"X-Timeout-Ms": f"{max(1.0, remaining * 1e3):.0f}"}
        span_id = None
        if ctx is not None:
            span_id = ctx.new_span_id()
            headers["X-Trace-Id"] = ctx.trace_id
            headers["X-Parent-Span"] = span_id
        if ctype:
            headers["Content-Type"] = ctype
        url = f"{w.base_url}/v1/models/{name}:{verb}" + ("?stream=true" if stream else "")
        self.supervisor.track_inflight(w, +1)
        w0 = time.time()
        outcome: "int | str" = "transport_error"
        handed_off = False
        budget = max(0.001, remaining + _DEADLINE_GRACE_S)
        t_end = time.perf_counter() + budget
        try:
            r = await self._session.open("POST", url, body, headers, timeout_s=budget)
            try:
                if r.headers.get(_STREAM_HEADER) == "1":
                    outcome = r.status
                    handed_off = True
                    sa = _StreamAnswer(r.status, _content_type(r.headers.get(
                        "content-type", "text/event-stream")), r, w, self)
                    if committed is not None:
                        committed.append(sa)
                    return sa
                raw = await asyncio.wait_for(r.read(),
                                             max(0.001, t_end - time.perf_counter()))
                outcome = r.status
                return _Answer(r.status, _content_type(r.headers.get("content-type")),
                               raw, r.headers.get("retry-after"))
            finally:
                if not handed_off:
                    r.release()
        finally:
            if not handed_off:
                self.supervisor.track_inflight(w, -1)
            if ctx is not None:
                ctx.span("attempt", w0, time.time(), span_id=span_id, tid=name,
                         worker=w.wid, status=outcome,
                         **({"streamed": True} if handed_off else {}))

    async def _relay(self, name: str, verb: str, body: bytes, ctype: str,
                     deadline_at: float, ctx: TraceContext | None = None,
                     stream: bool = False) -> "_Answer | _StreamAnswer":
        """Dispatch to the least-loaded healthy worker with retry and
        hedging under the absolute deadline. Returns the first definitive
        answer; raises NoHealthyWorker / RelayDeadline / UpstreamFailed. A
        _StreamAnswer is definitive the instant it exists; any LOSING stream
        commitment (a hedge that also committed) is closed on the way out."""
        h = self.handles[name]
        tasks: dict[asyncio.Task, WorkerHandle] = {}
        tried: set[int] = set()
        retries_left = self.rcfg.retry_max
        hedges_left = 1 if self.rcfg.hedge_ms > 0 else 0
        last_503: _Answer | None = None
        last_exc: Exception | None = None
        committed: list[_StreamAnswer] = []
        winner: _StreamAnswer | None = None
        loop = asyncio.get_running_loop()

        def remaining() -> float:
            return deadline_at - time.perf_counter()

        def launch(hedge: bool = False) -> bool:
            exclude_hosts: set[int] = set()
            if hedge:
                # A hedge covers a wedged or dying FAILURE DOMAIN: beside
                # its primary, one host death would kill both copies, so
                # the hosts of the attempts in flight are excluded (no
                # fallback: with every other host busy or down, no hedge).
                for w2 in tasks.values():
                    hid = self.supervisor.host_of(w2)
                    if hid is not None:
                        exclude_hosts.add(hid)
            w = self.supervisor.pick(exclude=tried, exclude_hosts=exclude_hosts)
            if w is None and tried and not hedge:
                # Every healthy worker was tried: allow a re-dispatch (the
                # failure may have been transient and the fleet down to one).
                w = self.supervisor.pick()
            if w is None:
                return False
            tried.add(w.wid)
            t = loop.create_task(self._attempt(w, name, verb, body, ctype, deadline_at,
                                               ctx, stream, committed))
            tasks[t] = w
            return True

        def can_hedge() -> bool:
            return (hedges_left > 0 and len(tasks) == 1
                    and len(self.supervisor.healthy_workers()) > 1)

        try:
            if not launch():
                raise NoHealthyWorker(self.supervisor.respawn_eta_s())
            while True:
                rem = remaining()
                if rem <= -_DEADLINE_GRACE_S:
                    raise RelayDeadline()
                wait_s = rem + _DEADLINE_GRACE_S
                if can_hedge():
                    wait_s = min(wait_s, self.rcfg.hedge_ms / 1e3)
                done, _ = await asyncio.wait(set(tasks), timeout=max(0.0, wait_s),
                                             return_when=asyncio.FIRST_COMPLETED)
                if not done:
                    if can_hedge() and remaining() > 0:
                        # The primary is silent past hedge_ms: race a
                        # duplicate on another worker; the first definitive
                        # answer wins below.
                        if launch(hedge=True):
                            hedges_left -= 1
                            h.hedges.inc()
                        else:
                            hedges_left = 0
                        continue
                    if remaining() <= -_DEADLINE_GRACE_S:
                        raise RelayDeadline()
                    continue
                for t in done:
                    w_done = tasks.pop(t)
                    if t.cancelled():
                        continue
                    exc = t.exception()
                    if exc is None:
                        ans = t.result()
                        self.supervisor.note_success(w_done)
                        if ans.status != 503:
                            # Definitive: the worker admitted and answered
                            # (200, 4xx, 500, 504). NEVER re-dispatched.
                            if isinstance(ans, _StreamAnswer):
                                winner = ans
                            return ans
                        # 503 = not admitted (draining, its own breaker):
                        # the work never ran, another worker may take it.
                        last_503 = ans
                    elif isinstance(exc, (ClientError, TimeoutError, OSError)):
                        if isinstance(exc, (ClientTimeout, TimeoutError)):
                            if remaining() <= 0:
                                raise RelayDeadline() from exc
                        else:
                            # Refused or reset: the "this machine just died"
                            # signal feeds the host breaker, so a dead host
                            # is routed around in milliseconds.
                            self.supervisor.note_transport_failure(w_done)
                        last_exc = exc
                    else:
                        raise exc  # a programming error: surface it
                    if remaining() > 0 and retries_left > 0 and launch():
                        retries_left -= 1
                        h.retries.inc()
                if not tasks:
                    if last_503 is not None:
                        return last_503
                    raise UpstreamFailed() from last_exc
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()
            for sa in committed:
                if sa is not winner:
                    sa.close()

    async def relay_cacheable(self, name: str, verb: str, body: bytes, ctype: str,
                              deadline_at: float, ctx: TraceContext | None = None) -> tuple:
        """The cache-value form of _relay: ``(content_type, body)`` for a 200
        (what the single-flight leader populates); _RelayedError for any
        other definitive answer (fans out to coalesced waiters, populates
        nothing)."""
        ans = await self._relay(name, verb, body, ctype, deadline_at, ctx)
        if ans.status == 200:
            return (ans.content_type, ans.body)
        raise _RelayedError(ans)

    def note_shed_reason(self, name: str, ans: _Answer) -> None:
        """Remember the machine-readable shed reason a worker answered (a
        503/504 JSON body with a ``reason``), carried on this router's own
        breaker 503s."""
        if ans.status not in (503, 504) or not ans.body:
            return
        try:
            reason = json.loads(ans.body).get("reason")
        except (ValueError, AttributeError):
            return
        if isinstance(reason, str):
            self.last_shed_reason[name] = reason

    async def _dispatch(self, name: str, verb: str, body: bytes, ctype: str,
                        deadline_at: float, ctx: TraceContext | None = None,
                        stream: bool = False) -> "_Answer | _StreamAnswer":
        """Cache and single-flight in front of the relay, sharded across the
        router tier. The key is content-addressed at the WIRE level (verb,
        content type, body: the router has no models to decode with) and
        carries the model's generation, so a fleet reload invalidates
        atomically. With N routers the ring names ONE owner per key: a
        non-owner forwards the request to the owner's peer listener, so the
        owner's cache and single-flight lead for the whole tier; an
        unreachable owner degrades to the local shard (counted), never to an
        error. Streams bypass the cache, the coalescing and the hop: a
        stream is a live connection, and coalescing one would hand one
        client's tokens to another."""
        cache = self.caches.get(name)
        if cache is None or stream:
            return await self._relay(name, verb, body, ctype, deadline_at, ctx, stream=stream)
        key = cache.key_for((verb, ctype, body))
        if self.ring is not None:
            owner = self.ring.owner(key)
            if owner is not None and owner[0] != self.router_id:
                ans = await self._peer_forward(owner, name, verb, body, ctype, deadline_at,
                                               ctx)
                if ans is not None:
                    return ans
                # The owner is unreachable: the local shard serves until it
                # respawns; coalescing within this router still holds, and
                # the client sees nothing.
        return await self._dispatch_local(cache, key, name, verb, body, ctype, deadline_at,
                                          ctx)

    async def _peer_forward(self, owner: tuple[int, str], name: str, verb: str, body: bytes,
                            ctype: str, deadline_at: float,
                            ctx: TraceContext | None) -> _Answer | None:
        """Forward one request to the owning router's peer listener: its
        complete answer, or None on a transport failure (counted in
        cache_peer_errors_total; the caller degrades to the local shard)."""
        h = self.handles[name]
        remaining = deadline_at - time.perf_counter()
        headers = {"X-Timeout-Ms": f"{max(1.0, remaining * 1e3):.0f}"}
        if ctype:
            headers["Content-Type"] = ctype
        span_id = None
        if ctx is not None:
            span_id = ctx.new_span_id()
            headers["X-Trace-Id"] = ctx.trace_id
            headers["X-Parent-Span"] = span_id
        h.peer_hops.inc()
        w0 = time.time()
        outcome: "int | str" = "transport_error"
        try:
            r = await self._session.post(f"{owner[1]}/peer/models/{name}:{verb}", body,
                                         headers,
                                         timeout_s=max(0.001, remaining + _DEADLINE_GRACE_S))
            outcome = r.status
            return _Answer(r.status, _content_type(r.headers.get("content-type")), r.body,
                           r.headers.get("retry-after"))
        except (ClientError, TimeoutError, OSError):
            h.peer_errors.inc()
            return None
        finally:
            if ctx is not None:
                ctx.span("peer_hop", w0, time.time(), span_id=span_id, tid=name,
                         owner_router=owner[0], status=outcome)

    async def _dispatch_local(self, cache: ModelCache, key: str, name: str, verb: str,
                              body: bytes, ctype: str, deadline_at: float,
                              ctx: TraceContext | None = None) -> _Answer:
        """This router's own cache shard: a hit at once, else single-flight
        into the worker relay."""
        entry = cache.get(key)
        if entry is not None:
            ct, raw = entry.value
            if ctx is not None:
                now = time.time()
                ctx.span("cache_hit", now, now, tid=name)
            return _Answer(200, ct, raw, None)
        loop = asyncio.get_running_loop()
        fut = cache.submit_through(key, lambda: loop.create_task(self.relay_cacheable(
            name, verb, body, ctype, deadline_at, ctx)), ctx=ctx)
        # A coalesced waiter honours ITS deadline; cancelling a waiter never
        # cancels the leader's flight.
        try:
            ct, raw = await asyncio.wait_for(
                fut, max(0.0, deadline_at - time.perf_counter()) + _DEADLINE_GRACE_S)
        except _RelayedError as e:
            return e.ans
        return _Answer(200, ct, raw, None)

    async def peer_relay(self, req: Request, name: str, verb: str) -> Response:
        """``POST /peer/models/{name}:{verb}``: a sibling router forwarded a
        request whose cache key THIS router owns. Served through the LOCAL
        shard (hit, single-flight, worker relay), never forwarded again: the
        origin did the admission and shed checks and owns the breaker, and a
        ring disagreement during a membership change must end here, not
        loop."""
        h = self.handles.get(name)
        if h is None:
            return _err(404, f"unknown model {name!r}")
        ctx = TraceContext.from_headers(req.headers, pid=0)
        t_start = time.perf_counter()
        body = await req.read()
        ctype = req.headers.get("content-type", "")
        try:
            timeout_ms = _requested_timeout_ms(req, req.content_type)
        except ValueError as e:
            return _err(400, str(e), trace_id=ctx.trace_id)
        timeout_s = (timeout_ms if timeout_ms is not None else h.mcfg.request_timeout_ms) / 1e3
        deadline_at = t_start + timeout_s
        h.peer_serves.inc()
        self._inflight += 1
        wall0 = time.time()
        try:
            cache = self.caches.get(name)
            if cache is None:
                ans = await self._relay(name, verb, body, ctype, deadline_at, ctx)
            else:
                ans = await self._dispatch_local(cache, cache.key_for((verb, ctype, body)),
                                                 name, verb, body, ctype, deadline_at, ctx)
        except NoHealthyWorker as e:
            return _err(503, "no healthy worker; capacity respawning",
                        retry_after=max(1, math.ceil(e.eta_s)), trace_id=ctx.trace_id)
        except (RelayDeadline, asyncio.TimeoutError):
            return _err(504, f"request deadline ({timeout_s * 1e3:.0f} ms) exceeded",
                        trace_id=ctx.trace_id)
        except UpstreamFailed:
            return _err(503, "workers unreachable; retry",
                        retry_after=self.no_worker_retry_after(), trace_id=ctx.trace_id)
        finally:
            self._inflight -= 1
            ctx.root_span("peer_serve", wall0, wall0 + time.perf_counter() - t_start, tid=name)
        resp = ans.to_response()
        resp.headers["X-Trace-Id"] = ctx.trace_id
        return resp

    # -- admin fan-out -------------------------------------------------------
    async def _admin_call(self, w: WorkerHandle, method: str,
                          path: str) -> tuple[int, int, dict]:
        try:
            r = await self._session.request(method, f"{w.base_url}{path}", timeout_s=120.0)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — the worker died mid-admin
            return w.wid, 0, {"error": f"{type(e).__name__}: {e}"}
        try:
            body = r.json()
        except ValueError:
            body = {"error": r.body[:512].decode("utf-8", "replace")}
        return w.wid, r.status, body if isinstance(body, dict) else {"body": body}

    def _per_host_outcomes(self, per_worker: dict) -> dict | None:
        """Per-worker admin outcomes grouped by failure domain (host mode
        only): the operator's view of a partial fan-out."""
        if self.rcfg.hosts <= 0:
            return None
        out: dict[str, dict] = {}
        for wid, row in per_worker.items():
            out.setdefault(host_name(int(wid) // self.rcfg.workers), {})[wid] = row
        return out

    def _audit_fanout(self, verb: str, name: str, status: int, body: dict,
                      t0: float) -> None:
        """Fold one admin fan-out into the audit trail: outcome, duration,
        the post-action generation and the per-host (or per-worker)
        statuses."""
        if self.audit is None:
            return
        outcome = ("ok" if status == 200 else "rejected" if status in (409, 503)
                   else "error")
        fields: dict = {"status": status, "generation": self.generations.get(name)}
        if "version" in body:
            fields["version"] = body["version"]
        if body.get("down"):
            fields["down"] = body["down"]
        per_host = body.get("per_host")
        if per_host is not None:
            # A per-domain rollup, not the whole per-worker bodies: the
            # record stays small enough to keep 256 of.
            fields["per_host"] = {host: {wid: row.get("status") for wid, row in rows.items()}
                                  for host, rows in per_host.items()}
        elif body.get("workers"):
            fields["per_worker"] = {str(wid): row.get("status")
                                    for wid, row in body["workers"].items()}
        if body.get("rolled_back_workers"):
            fields["rolled_back_workers"] = list(body["rolled_back_workers"])
        self.audit.record(verb, name, outcome,
                          duration_ms=(time.perf_counter() - t0) * 1e3, **fields)

    async def _bump_generation(self, name: str) -> None:
        """Invalidate ``name``'s cached answers fleet-wide: bump its
        generation here, then push it to every live peer router (best
        effort: the peers' topology sync is the backstop, so a lost push
        costs at most one peer_sync_interval_s of stale shard)."""
        self.generations[name] = self.generations.get(name, 1) + 1
        cache = self.caches.get(name)
        if cache is not None:
            cache.clear()
        if self.peer_sup is None:
            return
        data = json.dumps({"model": name, "generation": self.generations[name]}).encode()

        async def push(url: str) -> None:
            with contextlib.suppress(ClientError, TimeoutError, OSError):
                await self._session.post(f"{url}/peer/invalidate", data,
                                         {"Content-Type": "application/json"}, timeout_s=2.0)

        await asyncio.gather(*(push(url) for url in self.peer_sup.members().values()))

    async def fanout_reload(self, name: str) -> tuple[int, dict]:
        """Atomic fleet reload: POST ``:reload`` to every live worker; if any
        fails its gates, roll the succeeded ones back so the fleet never
        serves mixed versions. Success bumps the cache generation. Every
        outcome, refusal included, lands in the audit trail."""
        t0 = time.perf_counter()
        status, body = await self._fanout_reload(name)
        self._audit_fanout("reload", name, status, body, t0)
        return status, body

    async def _fanout_reload(self, name: str) -> tuple[int, dict]:
        workers = self.supervisor.live_workers()
        if not workers:
            return 503, {"error": "no live worker to reload", "workers": {}}
        # A dead or respawning slot boots the ORIGINAL config and would
        # diverge from the new version: refuse up front, touching nobody.
        down = self.supervisor.down_domains()
        if down:
            body = {"error": f"fleet degraded ({', '.join(down)} down/respawning); "
                             "reload refused — a respawning domain boots the "
                             "original config and would diverge from the new version",
                    "down": down, "workers": {}}
            per_host = self._per_host_outcomes({w.wid: {"status": "skipped"} for w in workers})
            if per_host is not None:
                body["per_host"] = per_host
            return 409, body
        results = await asyncio.gather(
            *(self._admin_call(w, "POST", f"/admin/models/{name}:reload") for w in workers))
        per_worker = {wid: {"status": status, **body} for wid, status, body in results}
        per_host = self._per_host_outcomes(per_worker)
        if all(status == 200 for _, status, _ in results):
            await self._bump_generation(name)
            versions = {body.get("version") for _, _, body in results}
            out = {"workers": per_worker, "version": results[0][2].get("version"),
                   "fleet_consistent": len(versions) == 1}
            if per_host is not None:
                out["per_host"] = per_host
            return 200, out
        # Partial failure: restore the workers that DID publish, so the fleet
        # stays on one version (all-or-nothing).
        succeeded = [w for w, (_, status, _) in zip(workers, results) if status == 200]
        rolled_back = {}
        if succeeded:
            rb = await asyncio.gather(
                *(self._admin_call(w, "POST", f"/admin/models/{name}:rollback")
                  for w in succeeded))
            rolled_back = {wid: status for wid, status, _ in rb}
        # A worker that published and then rolled back on its own (the
        # post-publish canary) means bad weights briefly served: 500 so
        # operators page; a clean pre-publish rejection everywhere is 409.
        any_rb = any(body.get("rolled_back") for _, _, body in results)
        out = {"error": "reload rejected by at least one worker; fleet kept on one version",
               "workers": per_worker, "rolled_back_workers": rolled_back}
        if per_host is not None:
            out["per_host"] = per_host
        return (500 if (any_rb or succeeded) else 409), out

    async def fanout_simple(self, name: str, op: str) -> tuple[int, dict]:
        """Fan-out of ``:rollback`` (every live worker restores the same
        retained version; audited) and ``/versions`` (a read)."""
        t0 = time.perf_counter()
        workers = self.supervisor.live_workers()
        if not workers:
            status, body = 503, {"error": "no live worker", "workers": {}}
        else:
            method, path = (("POST", f"/admin/models/{name}:rollback") if op == "rollback"
                            else ("GET", f"/admin/models/{name}/versions"))
            results = await asyncio.gather(*(self._admin_call(w, method, path)
                                             for w in workers))
            ok = all(s == 200 for _, s, _ in results)
            if ok and op == "rollback":
                await self._bump_generation(name)
            status = 200 if ok else 409
            body = {"workers": {wid: {"status": s, **b} for wid, s, b in results}}
        if op == "rollback":
            self._audit_fanout("rollback", name, status, body, t0)
        return status, body

    async def worker_kernel_counts(self) -> dict:
        """K1/K2 launch counts of every live worker (its ``/stats``
        ``kernels``) and their sums over the fleet."""
        workers = self.supervisor.live_workers()
        results = await asyncio.gather(*(self._admin_call(w, "GET", "/stats")
                                         for w in workers))
        per = {str(wid): body["kernels"] for wid, status, body in results
               if status == 200 and "kernels" in body}
        total = {"flash_attention": {"launches": 0, "by_shape": {}},
                 "flash_attention_stats": {"launches": 0}}
        for k in per.values():
            total["flash_attention"]["launches"] += k["flash_attention"]["launches"]
            shapes = total["flash_attention"]["by_shape"]
            for shape, n in k["flash_attention"].get("by_shape", {}).items():
                shapes[shape] = shapes.get(shape, 0) + n
            total["flash_attention_stats"]["launches"] += k["flash_attention_stats"]["launches"]
        return dict(total, workers=per)

    # -- fleet scrape --------------------------------------------------------
    async def _scrape_one(self, proc: str, url: str) -> tuple[str, str | None]:
        """One source's /metrics; None = stale (counted, never an error up
        the stack: a dead host is data)."""
        try:
            r = await self._session.get(url, timeout_s=self.cfg.telemetry.fleet_timeout_ms / 1e3)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — stale-marked, never 5xx
            self.fleet_scrape_errors.inc()
            return proc, None
        if r.status != 200:
            self.fleet_scrape_errors.inc()
            return proc, None
        return proc, r.body.decode("utf-8", "replace")

    async def scrape_fleet(self) -> list[tuple[str, str | None]]:
        """Every process's exposition, stale-marked where unreachable: this
        router, every CONFIGURED worker slot (a dead host's workers scrape
        as stale) and, on the primary, every configured peer router."""
        self.fleet_scrapes.inc()
        jobs: list = []
        sources: list[tuple[str, str | None]] = [
            (f"router{self.router_id}", self.metrics.render_prometheus())]
        for wid in range(self.supervisor.n):
            w = self.supervisor.worker_by_id(wid)
            if w is None:
                sources.append((f"worker{wid}", None))
            else:
                jobs.append(self._scrape_one(f"worker{wid}", f"{w.base_url}/metrics"))
        if self.is_primary and self.peer_sup is not None:
            members = self.peer_sup.members()
            for rid in range(1, self.rcfg.routers):
                url = members.get(rid)
                if url is None:
                    sources.append((f"router{rid}", None))
                else:
                    jobs.append(self._scrape_one(f"router{rid}", f"{url}/peer/metrics"))
        if jobs:
            sources.extend(await asyncio.gather(*jobs))
        return sources

    def fleet_rollup(self, sources: list[tuple[str, str | None]], merged: str) -> dict:
        """The /stats/fleet body: per-source liveness, the down failure
        domains, and per-model fleet-summed serving counters with true fleet
        latency quantiles from the bucket-merged histogram."""
        per_model: dict[str, dict] = {
            n: {"requests_total": 0.0, "items_total": 0.0, "batches_total": 0.0,
                "deadline_exceeded_total": 0.0} for n in self.handles}
        hist: dict[str, dict[float, float]] = {}
        for base, labels, value in parse_exposition(merged)["samples"]:
            if base == "latency_ms_bucket" and 'phase="total"' in labels:
                for n in per_model:
                    if f'model="{n}"' in labels:
                        le = next((p[3:].strip('"') for p in labels.split(",")
                                   if p.startswith("le=")), None)
                        if le is not None:
                            hist.setdefault(n, {})[float("inf") if le == "+Inf"
                                                   else float(le)] = value
                continue
            if base not in ("requests_total", "items_total", "batches_total",
                            "deadline_exceeded_total"):
                continue
            for n, row in per_model.items():
                if f'model="{n}"' in labels:
                    row[base] += value
        for n, buckets in hist.items():
            bounds = sorted(b for b in buckets if math.isfinite(b))
            cum = [buckets[b] for b in bounds] + [buckets.get(float("inf"), 0.0)]
            # Cumulative counts to per-bucket deltas for the quantile math.
            deltas = [cum[0]] + [max(0.0, cum[i] - cum[i - 1]) for i in range(1, len(cum))]
            for q, key in ((0.5, "fleet_latency_p50_ms"), (0.99, "fleet_latency_p99_ms")):
                v = quantile_from_counts(bounds, deltas, q)
                per_model[n][key] = round(v, 3) if v is not None and math.isfinite(v) else None
        return {
            "sources": {proc: "up" if text is not None else "stale" for proc, text in sources},
            "stale": sorted(p for p, t in sources if t is None),
            "down_domains": self.supervisor.down_domains(),
            "models": per_model,
            "scrapes_total": int(self.fleet_scrapes.value),
            "scrape_errors_total": int(self.fleet_scrape_errors.value),
        }

    async def fleet_metrics(self, req: Request) -> Response:
        """``GET /metrics/fleet``: ONE merged exposition for the whole fleet
        (counters summed, gauges labelled ``proc=``, histograms merged
        bucket by bucket). Unreachable sources are stale-marked; a dead host
        never makes this 5xx. Peers proxy to the primary, which owns the
        scrape."""
        if not self.is_primary:
            return await self._proxy_to_primary("GET", "/peer/fleet/metrics")
        text = merge_expositions(await self.scrape_fleet())
        return Response(200, text.encode("utf-8"),
                        content_type=exposition_content_type(req.headers.get("accept")))

    async def fleet_stats(self, req: Request) -> Response:
        """``GET /stats/fleet``: the JSON rollup of the same scrape."""
        if not self.is_primary:
            return await self._proxy_to_primary("GET", "/peer/fleet/stats")
        sources = await self.scrape_fleet()
        return json_response(self.fleet_rollup(sources, merge_expositions(sources)))

    async def _proxy_to_primary(self, method: str, path: str) -> Response:
        """A peer never fans admin out itself: the PRIMARY owns the
        generation counter, the all-or-nothing reload and the fleet's
        ledgers, so one router serializes fleet transitions. Proxied over
        the primary's peer listener (the shared public port cannot address
        the primary)."""
        if self.topo is None:
            return _err(503, "no primary to proxy the admin fan-out to")
        try:
            r = await self._session.request(method, f"{self.topo.url}{path}", timeout_s=180.0)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — the primary died mid-admin
            return _err(503, "primary router unreachable for admin fan-out: "
                             f"{type(e).__name__}: {e}")
        return Response(r.status, r.body,
                        content_type=r.headers.get("content-type", "application/json"))

    # -- HTTP ----------------------------------------------------------------
    async def handle(self, req: Request, ingest=None) -> "Response | StreamResponse":
        """Route one request (the front door's ``_serve_connection`` calls
        this, as it calls ServerState.handle)."""
        path = req.path
        if path.startswith("/v1/models/") and ":" in path:
            name, _, verb = path[len("/v1/models/"):].rpartition(":")
            if verb in _VERBS and name and "/" not in name:
                if req.method != "POST":
                    resp = _text(405)
                    resp.headers["Allow"] = "POST"
                    return resp
                return await self.predict(req, name, verb)
        await req.read()
        if path.startswith("/admin/"):
            return await self.admin(req, path[len("/admin/"):])
        if path.startswith("/workers/"):
            return await self.worker_proxy(req, path[len("/workers/"):])
        if path in _REFUSED:
            status, message = _REFUSED[path]
            return _err(status, message)
        routes = {
            "/": ("GET", self.index),
            "/healthz": ("GET", self.healthz),
            "/metrics": ("GET", self.metrics_text),
            "/stats": ("GET", self.stats),
            "/stats/history": ("GET", self.stats_history),
            "/metrics/fleet": ("GET", self.fleet_metrics),
            "/stats/fleet": ("GET", self.fleet_stats),
            "/alerts": ("GET", self.alerts),
            "/v1/models": ("GET", self.models_json),
            "/debug/kernels:reset": ("POST", self.reset_kernel_counts),
            "/debug/trace": ("GET", self.debug_trace),
            "/debug/slow": ("GET", self.debug_slow),
            "/debug/events": ("GET", self.debug_events),
            "/debug/audit": ("GET", self.debug_audit),
            "/debug/postmortems": ("GET", self.debug_postmortems),
        }
        route = routes.get(path)
        if route is None:
            return _text(404)
        method, fn = route
        if req.method != method and not (method == "GET" and req.method == "HEAD"):
            resp = _text(405)
            resp.headers["Allow"] = method
            return resp
        resp = fn(req)
        return await resp if asyncio.iscoroutine(resp) else resp

    async def predict(self, req: Request, name: str, verb: str) -> "Response | StreamResponse":
        """Mint the request's trace context (adopting a well-formed
        ``X-Trace-Id``), relay, then stamp ``X-Trace-Id`` on every response,
        record the root span and offer the trace to the flight recorder."""
        ctx = TraceContext.from_headers(req.headers, pid=0)
        wall0 = time.time()
        t0 = time.perf_counter()
        resp = await self._predict_relayed(req, name, verb, ctx)
        dur_s = time.perf_counter() - t0
        ctx.root_span("request", wall0, wall0 + dur_s, tid=name, status=resp.status)
        resp.headers.setdefault("X-Trace-Id", ctx.trace_id)
        # A stream scores by first byte and worst stall, not wall time.
        score_ms = getattr(resp, "stream_score_ms", None)
        kinds = self.recorder.finish(ctx, name, resp.status,
                                     score_ms if score_ms is not None else dur_s * 1e3)
        if self.events is not None:
            if resp.status >= 400:
                self.events.emit("error" if resp.status >= 500 else "warning", "router",
                                 "request_error", model=name, trace_id=ctx.trace_id,
                                 status=resp.status, duration_ms=round(dur_s * 1e3, 3))
            elif "slow" in kinds:
                self.events.emit("info", "router", "slow_request", model=name,
                                 trace_id=ctx.trace_id, status=resp.status,
                                 duration_ms=round(dur_s * 1e3, 3))
        return resp

    async def _predict_relayed(self, req: Request, name: str, verb: str,
                               ctx: TraceContext) -> "Response | StreamResponse":
        trace_id = ctx.trace_id
        h = self.handles.get(name)
        if h is None:
            return _err(404, f"unknown model {name!r}", trace_id=trace_id)
        # Shed checks BEFORE the body read: a draining router, a tripped
        # breaker or an empty fleet answers at once with a live Retry-After.
        if self.draining:
            return _err(503, "router draining; retry against another replica",
                        retry_after=self.shed_retry_after(), trace_id=trace_id)
        breaker = self.breakers[name]
        if not breaker.allow():
            now = time.monotonic()
            probe_at = self._probe_at.get(name, 0.0)
            if now < probe_at:
                breaker.on_shed()
                return _err(503, f"circuit open for model {name!r}; recovery probe in "
                                 "progress", retry_after=max(1, math.ceil(probe_at - now)),
                            reason=self.last_shed_reason.get(name), trace_id=trace_id)
            # This request IS the recovery probe: open -> half_open; its
            # outcome closes or re-opens the breaker.
            breaker.probe()
            self._probe_at[name] = now + h.mcfg.breaker_retry_after_s
        if not self.supervisor.healthy_workers():
            return _err(503, "no healthy worker; capacity respawning",
                        retry_after=self.no_worker_retry_after(), trace_id=trace_id)
        h.requests.inc()
        t_start = time.perf_counter()
        w_read = time.time()
        body = await req.read()
        ctx.span("body_read", w_read, time.time(), tid=name, bytes=len(body))
        try:
            timeout_ms = _requested_timeout_ms(req, req.content_type)
            # The worker's validator: a typo'd ?stream= 400s here, never
            # silently serving unary.
            want_stream = _requested_stream(req)
        except ValueError as e:
            return _err(400, str(e), trace_id=trace_id)
        timeout_s = (timeout_ms if timeout_ms is not None else h.mcfg.request_timeout_ms) / 1e3
        deadline_at = t_start + timeout_s
        ctype = req.headers.get("content-type", "")

        self._inflight += 1
        try:
            ans = await self._dispatch(name, verb, body, ctype, deadline_at, ctx, want_stream)
        except NoHealthyWorker as e:
            breaker.record_failure()
            return _err(503, "no healthy worker; capacity respawning",
                        retry_after=max(1, math.ceil(e.eta_s)), trace_id=trace_id)
        except (RelayDeadline, asyncio.TimeoutError):
            h.timeouts.inc()
            return _err(504, f"request deadline ({timeout_s * 1e3:.0f} ms) exceeded",
                        trace_id=trace_id)
        except UpstreamFailed:
            breaker.record_failure()
            return _err(503, "workers unreachable; retry",
                        retry_after=self.no_worker_retry_after(), trace_id=trace_id)
        finally:
            self._inflight -= 1

        if isinstance(ans, _StreamAnswer):
            # The latch fired. No await between the decrement above and this
            # increment, so drain's inflight poll never misses the stream.
            breaker.record_success()
            self._inflight += 1
            try:
                return await self._forward_stream(req, name, h, ans, ctx, t_start, deadline_at)
            finally:
                self._inflight -= 1
        if ans.status == 200:
            breaker.record_success()
        elif ans.status >= 500:
            breaker.record_failure()
        self.note_shed_reason(name, ans)
        h.latency.observe((time.perf_counter() - t_start) * 1e3, trace_id=trace_id)
        return ans.to_response()

    async def _forward_stream(self, req: Request, name: str, h: RouterHandles,
                              ans: _StreamAnswer, ctx: TraceContext, t_start: float,
                              deadline_at: float) -> StreamResponse:
        """Relay one committed stream. From here every failure ends the
        CLIENT's stream with a well-formed error terminal, never a
        re-dispatch: a worker dying mid-stream ("upstream_error"), a stall
        past ``stream_idle_timeout_ms`` ("idle_timeout", or
        "deadline_exceeded" past the absolute deadline), the router's drain
        budget ("drain"). A client that goes away closes the upstream, the
        worker's signal to free the slot."""
        h.streams.inc()
        w = ans.worker
        resp = StreamResponse(req, ans.content_type, {"X-Tpuserve-Stream": "1",
                                                      "X-Trace-Id": ctx.trace_id})
        idle_s = self.rcfg.stream_idle_timeout_ms / 1e3
        first_unit_ms: float | None = None
        last_chunk: float | None = None
        max_gap_ms = 0.0
        reason = "done"
        failure: str | None = None  # set -> append our own error terminal
        bytes_out = 0
        w0 = time.time()
        try:
            try:
                await resp.prepare()
            except ConnectionError:
                reason = "client_disconnect"
            else:
                it = ans.resp.iter_any().__aiter__()
                while True:
                    if self._stream_kill_at is not None \
                            and time.monotonic() >= self._stream_kill_at:
                        reason, failure = "drain", "router draining; stream budget spent"
                        break
                    wait_s = idle_s if idle_s > 0 else None
                    if self._stream_kill_at is not None:
                        till_kill = max(0.0, self._stream_kill_at - time.monotonic())
                        wait_s = till_kill if wait_s is None else min(wait_s, till_kill)
                    try:
                        chunk = await asyncio.wait_for(it.__anext__(), timeout=wait_s)
                    except StopAsyncIteration:
                        # Clean upstream EOF: the worker wrote the terminal
                        # as its last bytes, already relayed.
                        break
                    except asyncio.TimeoutError:
                        if self._stream_kill_at is not None \
                                and time.monotonic() >= self._stream_kill_at:
                            continue  # the drain check at the loop top fires
                        if deadline_at - time.perf_counter() <= 0:
                            reason = "deadline_exceeded"
                            failure = "absolute deadline exceeded mid-stream"
                        else:
                            reason = "idle_timeout"
                            failure = f"no bytes from worker {w.wid} for {idle_s:g}s"
                        self.supervisor.note_transport_failure(w)
                        self.breakers[name].record_failure()
                        break
                    except ClientError as e:
                        reason = "upstream_error"
                        failure = f"worker {w.wid} died mid-stream: {e}"
                        self.supervisor.note_transport_failure(w)
                        self.breakers[name].record_failure()
                        break
                    now = time.perf_counter()
                    if first_unit_ms is None:
                        first_unit_ms = (now - t_start) * 1e3
                        h.first_unit.observe(first_unit_ms, trace_id=ctx.trace_id)
                    elif last_chunk is not None:
                        max_gap_ms = max(max_gap_ms, (now - last_chunk) * 1e3)
                    last_chunk = now
                    bytes_out += len(chunk)
                    try:
                        await resp.write(chunk)
                    except ConnectionError:
                        reason, failure = "client_disconnect", None
                        break
                if failure is not None:
                    with contextlib.suppress(ConnectionError):
                        await resp.write(_stream_error_bytes(ans.content_type, reason,
                                                             failure))
        finally:
            ans.close()
        self.metrics.router_stream_terminated_counter(name, reason).inc()
        ctx.span("stream_relay", w0, time.time(), tid=name, worker=w.wid, reason=reason,
                 bytes=bytes_out,
                 first_unit_ms=round(first_unit_ms, 3) if first_unit_ms is not None else None,
                 max_gap_ms=round(max_gap_ms, 3))
        if self.events is not None and reason != "done":
            self.events.emit("warning", "router", "stream_terminated", model=name,
                             trace_id=ctx.trace_id, reason=reason, worker=w.wid,
                             bytes=bytes_out)
        resp.stream_score_ms = max(first_unit_ms or 0.0, max_gap_ms)
        if reason != "client_disconnect":
            with contextlib.suppress(ConnectionError):
                await resp.write_eof()
        return resp

    # -- admin and proxy routes ----------------------------------------------
    async def admin(self, req: Request, rest: str) -> Response:
        if rest.startswith("hosts/"):
            return await self.scale_host(req, rest[len("hosts/"):])
        if not rest.startswith("models/"):
            return _text(404)
        rest = rest[len("models/"):]
        if rest.endswith("/versions"):
            name, op, method = rest[:-len("/versions")], "versions", "GET"
        else:
            name, _, op = rest.rpartition(":")
            method = "POST"
        if not name or "/" in name or op not in ("reload", "rollback", "versions"):
            return _text(404)
        if req.method != method and not (method == "GET" and req.method == "HEAD"):
            resp = _text(405)
            resp.headers["Allow"] = method
            return resp
        if name not in self.handles:
            return _err(404, f"unknown model {name!r}")
        if not self.is_primary:
            return await self._proxy_to_primary(
                method, f"/peer/admin/{name}/versions" if op == "versions"
                else f"/peer/admin/{name}:{op}")
        if op == "reload":
            status, body = await self.fanout_reload(name)
        else:
            status, body = await self.fanout_simple(name, op)
        return json_response(body, status=status)

    async def scale_host(self, req: Request, rest: str) -> Response:
        """``POST /admin/hosts/{hid}:scale?active=N``: set one host domain's
        active worker-slot target (audited; serialized through the primary
        like every fleet transition)."""
        hid_s, _, op = rest.rpartition(":")
        if op != "scale" or not hid_s or "/" in hid_s:
            return _text(404)
        if req.method != "POST":
            resp = _text(405)
            resp.headers["Allow"] = "POST"
            return resp
        try:
            events_mod.reject_unknown_query(req.query, {"active"})
        except ValueError as e:
            return _err(400, str(e))
        try:
            hid = int(hid_s)
            active = int(req.query["active"])
        except KeyError:
            return _err(400, "?active=<slots> is required")
        except ValueError:
            return _err(400, "host id and active must be integers")
        if not self.is_primary:
            return await self._proxy_to_primary(
                "POST", f"/peer/admin/hosts/{hid}:scale?active={active}")
        if not hasattr(self.supervisor, "scale_domain"):
            return _err(409, "[router] hosts = 0: there are no host domains to scale")
        t0 = time.perf_counter()
        try:
            out = self.supervisor.scale_domain(hid, active)
        except ValueError as e:
            return _err(400, str(e))
        except RuntimeError as e:
            if self.audit is not None:
                self.audit.record("scale", f"host:{hid}", "rejected",
                                  duration_ms=(time.perf_counter() - t0) * 1e3, active=active,
                                  error=str(e))
            return _err(409, str(e))
        if self.audit is not None:
            self.audit.record("scale", f"host:{hid}", "ok",
                              duration_ms=(time.perf_counter() - t0) * 1e3, **out)
        return json_response(out)

    async def worker_proxy(self, req: Request, rest: str) -> Response:
        """``GET /workers/{wid}/{metrics|stats|healthz}``,
        ``/workers/{wid}/stats/history`` and ``/workers/{wid}/debug/events``
        (query included): one worker's own page (workers bind loopback)."""
        wid_s, _, page = rest.partition("/")
        if page not in ("metrics", "stats", "healthz", "stats/history", "debug/events"):
            return _err(404, f"unknown worker page {page!r}")
        if req.method not in ("GET", "HEAD"):
            resp = _text(405)
            resp.headers["Allow"] = "GET"
            return resp
        try:
            wid = int(wid_s)
        except ValueError:
            return _err(400, "worker id must be an integer")
        if not 0 <= wid < self.supervisor.n:
            return _err(404, f"no worker slot {wid}")
        w = self.supervisor.worker_by_id(wid)
        if w is None:
            return _err(503, f"worker {wid} is down (respawning)")
        url = f"{w.base_url}/{page}" + (f"?{urlencode(req.query)}" if req.query else "")
        try:
            r = await self._session.request("GET", url, timeout_s=10.0)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            return _err(503, f"worker {wid} unreachable: {e}")
        return Response(r.status, r.body,
                        content_type=r.headers.get("content-type", "text/plain"))

    # -- introspection routes ------------------------------------------------
    def index(self, req: Request) -> Response:
        return Response(200, _INDEX_HTML.encode("utf-8"),
                        content_type="text/html; charset=utf-8")

    def healthz(self, req: Request) -> Response:
        """503 only when this router can serve nothing (draining, or no
        healthy worker anywhere); lost hosts, dead peer routers and missing
        workers answer 200 "degraded": lost capacity is not downtime, and a
        load balancer that pulls a degraded router turns a capacity
        incident into an availability one."""
        sup = self.supervisor.stats()
        if self.draining:
            return json_response({"status": "draining", "router_id": self.router_id,
                                  "workers": sup}, status=503)
        healthy = sup["healthy"]
        if healthy == 0:
            return json_response({"status": "no_workers", "router_id": self.router_id,
                                  "workers": sup}, status=503,
                                 headers={"Retry-After": str(self.no_worker_retry_after())})
        degraded = healthy < sup["configured"]
        body: dict = {"router_id": self.router_id}
        if "hosts_configured" in sup:
            body["hosts"] = {"configured": sup["hosts_configured"], "up": sup["hosts_up"]}
            degraded = degraded or sup["hosts_up"] < sup["hosts_configured"]
        if self.ring is not None:
            body["routers"] = {"configured": self.rcfg.routers,
                               "in_ring": len(self.ring.members)}
            if self.is_primary:
                degraded = degraded or len(self.ring.members) < self.rcfg.routers
        body["status"] = "degraded" if degraded else "ok"
        body["workers"] = sup
        return json_response(body)

    def metrics_text(self, req: Request) -> Response:
        return Response(200, self.metrics.render_prometheus().encode("utf-8"),
                        content_type=exposition_content_type(req.headers.get("accept")))

    async def stats(self, req: Request) -> Response:
        out = self.metrics.summary()
        out["robustness"] = {
            "draining": self.draining,
            "breakers": {n: br.describe() for n, br in self.breakers.items()},
        }
        out["workers"] = self.supervisor.stats()
        out["router"] = {"router_id": self.router_id, "is_primary": self.is_primary,
                         "generations": dict(self.generations),
                         "retry_max": self.rcfg.retry_max, "hedge_ms": self.rcfg.hedge_ms,
                         # The front tier holds no CUDA context.
                         "pid": os.getpid(),
                         "cuda_initialized": torch.cuda.is_initialized()}
        if self.ring is not None:
            out["router"]["ring"] = {"members": {str(rid): url for rid, url
                                                 in sorted(self.ring.members.items())},
                                     "size": len(self.ring.members)}
        if self.peer_sup is not None:
            out["routers"] = self.peer_sup.stats()
        out["topology"] = {"router_id": self.router_id,
                           "routers_configured": self.rcfg.routers,
                           "hosts_configured": self.rcfg.hosts,
                           "workers_per_domain": self.rcfg.workers}
        out["trace"] = self.recorder.stats()
        if self.events is not None:
            out["events"] = {**self.events.stats(), "audit": self.audit.stats(),
                             "postmortems": self.postmortems.stats()}
        if self.store is not None:
            out["telemetry"] = {**self.store.stats(),
                                "sample_interval_s": self.cfg.telemetry.sample_interval_s}
        if self.slo is not None:
            alerts = self.slo.alerts()
            if alerts["models"]:
                out["slo"] = alerts
        if self.caches:
            out["cache"] = {n: c.stats() for n, c in self.caches.items()}
        out["kernels"] = await self.worker_kernel_counts()
        return json_response(out)

    async def reset_kernel_counts(self, req: Request) -> Response:
        """Set every live worker's kernel launch counts to 0."""
        results = await asyncio.gather(*(self._admin_call(w, "POST", "/debug/kernels:reset")
                                         for w in self.supervisor.live_workers()))
        bad = {str(wid): status for wid, status, _ in results if status != 200}
        if bad:
            return _err(503, f"kernel count reset failed on workers {bad}")
        return json_response({"kernels": await self.worker_kernel_counts()})

    async def models_json(self, req: Request) -> Response:
        """The model inventory of the first healthy worker (every worker
        serves an identical config)."""
        w = self.supervisor.pick()
        if w is None:
            return _err(503, "no healthy worker", retry_after=self.no_worker_retry_after())
        _, status, body = await self._admin_call(w, "GET", "/v1/models")
        return json_response(body, status=status or 503)

    def stats_history(self, req: Request) -> Response:
        """The router tier's own series (router_latency_ms, relay counters,
        supervision gauges), the worker endpoint's query surface."""
        if self.store is None:
            return _err(409, "[telemetry] is disabled; no history is recorded")
        metric = req.query.get("metric")
        if not metric:
            return json_response({"metrics": self.store.metric_names(), **self.store.stats()})
        try:
            window_s = float(req.query["window_s"]) if "window_s" in req.query else None
            if window_s is not None and window_s <= 0:
                raise ValueError(window_s)
        except (TypeError, ValueError):
            return _err(400, "window_s must be a positive number")
        names = self.store.match(metric)
        if not names:
            return _err(404, f"no recorded series matches {metric!r} "
                             "(GET /stats/history lists the inventory)")
        series = [self.store.history(n, window_s) for n in names]
        return json_response({"series": [x for x in series if x is not None]})

    def alerts(self, req: Request) -> Response:
        if self.slo is None:
            return _err(409, "[telemetry] is disabled; no SLO evaluation runs")
        return json_response(self.slo.alerts())

    def debug_slow(self, req: Request) -> Response:
        return json_response(self.recorder.dump(model=req.query.get("model")))

    async def debug_trace(self, req: Request) -> Response:
        """One request's STITCHED span tree: the router's record (pid 0)
        merged with every live worker's record of the trace id (pid =
        worker id + 1) and the matching events of the router and the
        workers, as one Chrome trace (``&format=record``: the raw spans and
        events)."""
        trace_id = req.query.get("trace_id")
        if not trace_id:
            return _err(400, "the router trace endpoint needs ?trace_id=... "
                             "(find recorded ids at /debug/slow)")
        spans: list[dict] = []
        events = (self.events.query(trace_id=trace_id, limit=200)
                  if self.events is not None else [])
        meta: dict = {"trace_id": trace_id, "sources": []}
        rec = self.recorder.get(trace_id)
        if rec is not None:
            spans.extend(rec["spans"])
            meta["sources"].append("router")
            meta.update(model=rec["model"], status=rec["status"],
                        duration_ms=rec["duration_ms"])
        results = await asyncio.gather(*(
            self._admin_call(w, "GET", f"/debug/trace?trace_id={trace_id}&format=record")
            for w in self.supervisor.live_workers()))
        for wid, status, body in results:
            if status == 200 and isinstance(body.get("spans"), list):
                spans.extend(body["spans"])
                if isinstance(body.get("events"), list):
                    events.extend(body["events"])
                meta["sources"].append(f"worker{wid}")
        if not spans:
            return _err(404, f"trace {trace_id!r} is not recorded on the router or any "
                             "live worker")
        if req.query.get("format") == "record":
            return json_response(dict(meta, spans=spans, events=events))
        return Response(200, spans_to_chrome(spans, events=events).encode())

    def debug_events(self, req: Request) -> Response:
        if self.events is None:
            return _err(409, "[events] is disabled; no events are recorded")
        try:
            q = events_mod.parse_events_query(req.query)
        except ValueError as e:
            return _err(400, str(e))
        return json_response({"events": self.events.query(**q), **self.events.stats()})

    async def debug_postmortems(self, req: Request) -> Response:
        """The fleet's crash forensics: one record per reaped worker, host
        agent or peer router (exit code and signal, its stderr tail, its
        last black-box snapshot). The primary's supervisors reap everything,
        so its ledger is the fleet's; peers proxy to it."""
        if self.postmortems is None:
            return _err(409, "[events] is disabled; no postmortems are kept")
        if not self.is_primary:
            return await self._proxy_to_primary("GET", "/peer/debug/postmortems")
        return json_response({"postmortems": self.postmortems.dump(),
                              **self.postmortems.stats()})

    async def debug_audit(self, req: Request) -> Response:
        """The fleet's admin audit trail: admin verbs serialize through the
        primary, so its trail is the fleet's; peers proxy to it."""
        if self.audit is None:
            return _err(409, "[events] is disabled; no audit trail is kept")
        if not self.is_primary:
            return await self._proxy_to_primary("GET", "/peer/debug/audit")
        return json_response({"audit": self.audit.dump(), **self.audit.stats()})


def _stream_error_bytes(content_type: str, reason: str, message: str) -> bytes:
    """A well-formed error terminal in the stream's own wire format, which
    the router appends when the worker no longer can: a KIND_EVENT frame for
    binary streams, the SSE error event otherwise (the worker's own terminal
    encodings)."""
    data = {"error": reason, "message": message}
    if content_type == frame.CONTENT_TYPE:
        return frame.encode_stream_event(json.dumps({"type": "error", **data}).encode("utf-8"))
    return f"event: error\ndata: {json.dumps(data)}\n\n".encode("utf-8")


class PeerApp:
    """A router's loopback control plane, served beside its public
    listener: topology for the peers, forwarded cache hops, the pushed
    invalidation, and (on the primary) the admin, audit, postmortem and
    fleet-scrape entries the peers proxy to. Answers each request with the
    router's own handler."""

    def __init__(self, state: RouterState) -> None:
        self.state = state

    async def handle(self, req: Request, ingest=None) -> Response:
        st = self.state
        path = req.path
        if not path.startswith("/peer/"):
            return _text(404)
        rest = path[len("/peer/"):]
        if rest.startswith("models/") and ":" in rest:
            name, _, verb = rest[len("models/"):].rpartition(":")
            if verb in _VERBS and name and "/" not in name:
                if req.method != "POST":
                    return _text(405)
                return await st.peer_relay(req, name, verb)
        await req.read()
        if rest.startswith("admin/"):
            # /peer/admin/{name}:{verb}, /peer/admin/{name}/versions and
            # /peer/admin/hosts/{hid}:scale: the public admin routes.
            admin = rest[len("admin/"):]
            return await st.admin(req, admin if admin.startswith("hosts/")
                                  else "models/" + admin)
        routes = {
            "state": ("GET", lambda r: json_response(st.peer_state())),
            "invalidate": ("POST", self.invalidate),
            "stats": ("GET", st.stats),
            "healthz": ("GET", st.healthz),
            "metrics": ("GET", st.metrics_text),
            "fleet/metrics": ("GET", st.fleet_metrics),
            "fleet/stats": ("GET", st.fleet_stats),
            "debug/audit": ("GET", st.debug_audit),
            "debug/postmortems": ("GET", st.debug_postmortems),
        }
        route = routes.get(rest)
        if route is None:
            return _text(404)
        method, fn = route
        if req.method != method:
            return _text(405)
        resp = fn(req)
        return await resp if asyncio.iscoroutine(resp) else resp

    def invalidate(self, req: Request) -> Response:
        """``POST /peer/invalidate {model, generation}``: the push half of
        a fleet reload's invalidation (the topology sync is the backstop)."""
        try:
            data = json.loads(req.body)
            name = data["model"]
            gen = int(data["generation"])
        except (ValueError, KeyError, TypeError):
            return _err(400, "body must be {model, generation}")
        self.state._set_generation(name, gen)
        return json_response({"ok": True, "generation": self.state.generations.get(name)})


def bind_public_socket(host: str, port: int) -> socket.socket:
    """Bind (not listen) the shared public socket with SO_REUSEPORT, so N
    router processes serve one port; ``port=0`` binds an ephemeral one (the
    peers then join the bound port)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind((host, port))
    except OSError:
        sock.close()
        raise
    return sock


async def listen_on(state: RouterState, sock: socket.socket) -> asyncio.AbstractServer:
    """Serve ``state`` on the bound public socket ``sock`` (listening starts
    here)."""
    return await asyncio.start_server(
        lambda r, w: _serve_connection(state, state.connections, None, r, w),
        sock=sock, limit=_MAX_HEAD)


async def start_router(state: RouterState, host: str | None = None,
                       port: int | None = None) -> asyncio.AbstractServer:
    """Spawn the fleet (``state.start``), then listen; ``port=0`` binds an
    ephemeral port, recorded in ``state.serving_addresses``. With ``[router]
    routers > 1`` the SO_REUSEPORT socket is bound BEFORE the start, so the
    peer routers it spawns join the final (host, port), ephemeral
    included."""
    host = state.cfg.host if host is None else host
    port = state.cfg.port if port is None else port
    if state.rcfg.routers > 1:
        sock = bind_public_socket(host, port)
        state.public_addr = (host, sock.getsockname()[1])
        try:
            await state.start()
            server = await listen_on(state, sock)
        except BaseException:
            sock.close()
            raise
    else:
        await state.start()
        server = await _listen(state, state.connections, None, host, port, False)
    state.serving_addresses = [s.getsockname()[:2] for s in server.sockets]
    return server


async def stop_router(state: RouterState, server: asyncio.AbstractServer) -> None:
    """Stop listening, let the handlers answer, close the connections, then
    stop the fleet (each worker drains its accepted work)."""
    state.draining = True
    server.close()
    await state.connections.close(5.0)
    await server.wait_closed()
    await state.stop()


async def serve_router_async(state: RouterState, ready: asyncio.Event | None = None,
                             stop: asyncio.Event | None = None) -> None:
    """Serve until SIGTERM/SIGINT (or ``stop``), then drain across the
    process boundary: stop admitting, let the relays in flight resolve,
    then the workers flush their accepted work and exit."""
    server = await start_router(state)
    loop = asyncio.get_running_loop()
    if stop is None:
        stop = asyncio.Event()
    installed: list[signal.Signals] = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
            installed.append(sig)
        except (NotImplementedError, RuntimeError):
            pass  # not the main thread
    log.info("router %d serving on %s (%d router(s), %d host(s), %d worker(s)%s on %s)",
             state.router_id, state.serving_addresses, state.rcfg.routers, state.rcfg.hosts,
             state.rcfg.workers, " per host" if state.rcfg.hosts else "", state.device)
    if ready is not None:
        ready.set()
    try:
        await stop.wait()
        log.info("shutdown signal: draining router (budget %.0fs)", state.cfg.drain_timeout_s)
        if not await state.drain():
            log.warning("router drain budget expired with relays in flight")
    finally:
        for sig in installed:
            loop.remove_signal_handler(sig)
        await stop_router(state, server)


def serve_router(cfg: ServerConfig, device: str | None = None) -> None:
    """Blocking entry point of ``[router] enabled = true`` deployments
    (``tpuserve_torch.server.serve``); the workers serve on ``device``
    ("cuda" unless another device, "cpu" included, is asked for)."""
    state = RouterState(cfg, device=device or "cuda")
    asyncio.run(serve_router_async(state))
