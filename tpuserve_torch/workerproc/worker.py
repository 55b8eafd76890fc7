"""Worker-process entry of the router split, ported from
``tpuserve/workerproc/worker.py``.

A worker is deliberately NOT a new kind of server: it is the port's
single-process server (``tpuserve_torch.server``) — batcher or generation
engine, host pipeline, runtime, lifecycle, watchdog, graceful SIGTERM
drain — built in its own process on the device the supervisor names and
bound to loopback, so every property the single-process tests prove holds
unchanged behind the boundary.

Differences from a standalone server, all applied to the config before
build (``worker_config``):

- binds ``[worker] host`` (loopback) on ``port_base + id`` or an ephemeral
  port, and reports the bound port to the supervisor over a pipe handshake
  (``{"op": "ready", "port": ...}``);
- the result cache is forced OFF: caching and single-flight coalescing are
  the router's (one shared cache beats N private ones, and a cached answer
  must survive the worker that computed it);
- ``[router]`` is forced off (a worker never spawns workers of its own);
- recycle-mode models are rejected up front, as the reference does;
- ``[events]`` on: the slot's stderr capture and snapshot files in one
  black-box directory for the deployment.

Deadlines cross the boundary as REMAINING budget: the router stamps the
absolute deadline at admission and forwards ``X-Timeout-Ms`` = time left at
dispatch, which the server's ``_requested_timeout_ms`` re-stamps on this
process's clock, so a request 504s at the same absolute instant wherever it
dies. ``X-Trace-Id`` and ``X-Parent-Span`` parent this process's spans
under the router's attempt span.

The device is explicit: the supervisor passes ``"cuda"`` (the current CUDA
device) or ``"cpu"``; a worker never chooses the CPU on its own. Every
worker of one router shares that device, each with its own CUDA context.
"""

from __future__ import annotations

import copy
import gc
import os
import time

from tpuserve_torch.config import ServerConfig
from tpuserve_torch.telemetry.events import redirect_stderr, resolve_blackbox_dir


def worker_config(cfg: ServerConfig, worker_id: int) -> ServerConfig:
    """Derive one worker's ServerConfig from the deployment config."""
    for m in cfg.models:
        if m.unported.get("session_mode") == "recycle":
            raise ValueError(
                f"model {m.name!r}: recycle-mode models cannot run behind "
                "the router tier (the deferred pool is its own process "
                "split, and daemonic workers cannot fork grandchildren); "
                "serve them single-process")
    wcfg = copy.deepcopy(cfg)
    wcfg.host = cfg.worker.host
    wcfg.port = (cfg.worker.port_base + worker_id
                 if cfg.worker.port_base else 0)
    if cfg.worker.drain_timeout_s > 0:
        wcfg.drain_timeout_s = cfg.worker.drain_timeout_s
    # Router-owned layers never run in the worker.
    wcfg.router.enabled = False
    wcfg.cache.enabled = False
    # Black box: the supervisor resolves ONE directory for the deployment
    # (stable across respawns: it runs in the supervisor's process) and
    # assigns the slot's stderr capture and snapshot files; the worker
    # writes both, the supervisor reads them back when it reaps the slot.
    if cfg.events.enabled and not wcfg.events.stderr_path:
        bb = resolve_blackbox_dir(cfg.events)
        wcfg.events.dir = bb
        wcfg.events.stderr_path = os.path.join(bb, f"worker{worker_id}.stderr")
        wcfg.events.snapshot_path = os.path.join(bb, f"worker{worker_id}.snapshot.json")
    return wcfg


def worker_main(cfg: ServerConfig, worker_id: int, device: str, conn) -> None:
    """Process entry (the multiprocessing spawn target).

    ``cfg`` is the WORKER config (``worker_config`` already applied, so
    every respawn serves an identical config); ``device`` is ``"cuda"`` or
    ``"cpu"``. ``conn`` carries the ready handshake and stays open after it,
    so an EOF tells this worker the supervisor vanished."""
    # Redirect fd 2 to the slot's capture file BEFORE any import can write
    # to it: a native crash's message or a Python traceback lands in a file
    # the supervisor folds into the postmortem.
    redirect_stderr(cfg.events.stderr_path,
                    f"worker {worker_id} boot pid {os.getpid()} ts {time.time():.3f}")

    import asyncio
    import logging

    from tpuserve_torch.server import ServerState, configure_logging, serve_async

    configure_logging(cfg)
    logging.getLogger("tpuserve_torch.workerproc").info(
        "worker %d: building models on %s (pid %d)", worker_id, device, os.getpid())
    try:
        state = ServerState(cfg, device=device)
        state.worker_id = worker_id
        if state.injector is not None:
            # Worker-pinned [[faults.rule]] entries (rule.worker >= 0) fire
            # only in the matching worker process.
            state.injector.worker_id = worker_id
        if state.events is not None:
            # Events carry the spans' process lanes (0 = router).
            state.events.pid = worker_id + 1
        state.build()
        # As serve() does: the startup heap is frozen, never scanned again.
        gc.collect()
        gc.freeze()
    except Exception as e:  # noqa: BLE001 — report any boot death upward
        try:
            conn.send({"op": "died", "error": f"{type(e).__name__}: {e}"})
        finally:
            conn.close()
        raise

    async def _serve() -> None:
        loop = asyncio.get_running_loop()
        ready = asyncio.Event()
        serve_task = loop.create_task(serve_async(state, ready))
        ready_task = loop.create_task(ready.wait())
        # First of: listener up (-> handshake) or an early serve failure
        # (port bind, startup canary), which must surface as a "died"
        # message, not a handshake timeout.
        await asyncio.wait({serve_task, ready_task}, return_when=asyncio.FIRST_COMPLETED)
        if serve_task.done():
            ready_task.cancel()
            serve_task.result()  # raises the boot failure
            return
        conn.send({"op": "ready", "port": state.serving_addresses[0][1],
                   "pid": os.getpid()})
        await serve_task

    try:
        asyncio.run(_serve())
    except Exception as e:  # noqa: BLE001 — report any death upward
        try:
            conn.send({"op": "died", "error": f"{type(e).__name__}: {e}"})
        except (BrokenPipeError, OSError):
            pass
        raise
    finally:
        conn.close()
