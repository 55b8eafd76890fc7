"""Router/worker process split, ported from ``tpuserve/workerproc/``.

The single-process server is one GIL, one event loop, one failure domain: a
wedged handler or a crash in the runtime takes the HTTP front door down with
it. This package splits a deployment into failure domains:

- ``worker``     — the process entry of one isolated serving process: the
  port's single-process server, bound to loopback on the device the
  supervisor names, announced to the supervisor over a pipe handshake.
- ``supervisor`` — spawns (``spawn`` method only: worker 0 first) and owns
  N workers, health-checks them over HTTP, reaps dead processes and
  respawns them with exponential backoff.
- ``router``     — the front tier: HTTP/JSON, admission and deadline
  stamping, the result cache with single-flight coalescing, per-model
  circuit breakers; relays to the least-loaded healthy worker with
  transport-failure retry and hedging, never past a request's deadline, and
  relays streams with a well-formed terminal when a worker dies mid-stream.
- ``hosts``      — host failure domains: workers grouped into named hosts,
  each a host-agent process in its own process group (one ``killpg`` is one
  machine death), with host breakers, host-aware hedging and whole-domain
  respawn.
- ``peers``      — the horizontal router tier: N router processes on one
  SO_REUSEPORT port sharing a result cache sharded by consistent hash;
  peers forward a miss to its key's owning router and degrade to local-only
  when it dies.
- ``drill``      — ``chaos --drill worker_kill``, ``--drill host_kill`` and
  ``--drill stream_kill``: SIGKILL a worker (or a whole host's process
  group) under load and gate availability, the respawn time, torn and
  duplicate answers and torn or reordered streams.

Enable with ``[router] enabled = true``; ``[router] hosts`` and ``[router]
routers`` grow the failure domains outward. Not ported yet (ROADMAP.md item
11b): the fleet scheduler, tenants, the autopilot and deferred mode.
"""

from tpuserve_torch.workerproc.hosts import HostSupervisor
from tpuserve_torch.workerproc.peers import HashRing, PeerRouterSupervisor
from tpuserve_torch.workerproc.router import RouterState, serve_router, serve_router_async
from tpuserve_torch.workerproc.supervisor import WorkerHandle, WorkerSupervisor
from tpuserve_torch.workerproc.worker import worker_config, worker_main

__all__ = [
    "HashRing",
    "HostSupervisor",
    "PeerRouterSupervisor",
    "RouterState",
    "WorkerHandle",
    "WorkerSupervisor",
    "serve_router",
    "serve_router_async",
    "worker_config",
    "worker_main",
]
