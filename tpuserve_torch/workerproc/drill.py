"""Kill-a-worker and kill-a-host chaos drills (``python -m tpuserve_torch
chaos --drill worker_kill``, ``--drill host_kill`` and ``--drill
stream_kill``) and the hostile-tenant autopilot drill (``--drill
autopilot``), ported from ``tpuserve/workerproc/drill.py``.

Each drill serves a REAL router over N >= 2 worker processes on an
ephemeral loopback port (in the calling process, which stays free of CUDA:
the workers build the models), drives the closed-loop load generator at one
model, SIGKILLs one worker mid-load, and reports the properties the process
split promises, with a ``gates`` block the CLI exits on:

- ``worker_kill`` — **availability** n_ok / (n_ok + n_err) over the whole
  run (the caller's bound; requests in flight on the victim are transport
  errors the router retries on the survivor); **respawn_s**, SIGKILL until
  the victim's slot is healthy again, within ``respawn_budget_s`` (the
  backoff plus the boot time the caller allows); **zero torn responses** —
  a validator sends one known payload in a closed loop throughout and every
  200 body must equal a pre-kill reference byte for byte (workers build the
  same seeded weights; for a batching text model the reference holds the
  payload's answer in each batch bucket, since a GEMM's rounding may depend
  on the batch it ran in); **zero duplicate responses** — every validator
  request carries its own ``X-Trace-Id`` and its answer must carry it back,
  so a duplicated or crossed answer cannot pass.
- ``host_kill`` — the same load over >= 2 host domains of >= 2 workers
  each: one WHOLE domain is killed with ``killpg`` (its agent and every
  worker at once); gates **reabsorb_s** (SIGKILL until the host is back
  with every worker healthy) within ``reabsorb_budget_s``, zero torn and
  zero duplicate answers, and the surviving workers' compile counts
  unchanged.
- ``stream_kill`` — mixed streaming and unary load on a generative model:
  every stream that STARTED ends in exactly one terminal event (zero
  ``torn``: the router appends the terminal for the streams the SIGKILL
  cut), token indices exactly 0..n-1 (zero ``order_violations``), a "done"
  stream's text equal to the unary reference of the same seeded body (zero
  ``mismatched``) and an error-terminated one's a prefix of it (zero
  ``non_prefix``); the survivors' compile counts do not move.
- ``autopilot`` — a router fleet over >= 2 host domains with one dormant
  worker slot per domain, ``[tenants]`` and the autopilot on, and no
  operator: tenant "hostile" floods past its quota and rate (ignoring
  Retry-After) while tenant "victim" sends at a modest pace. Its gates are
  those of the reference's ``scripts/autopilot_drill.sh``: the hostile
  tenant is 429'd with ``tenant_*`` reasons and charged device-seconds,
  the victim never is (its availability, which the caller bounds, is the
  drill's ``availability``) and its SLO does not fire, the controller acted
  (``scale_up`` or ``shed_on``) with its first action within 18 s of the
  load's start and no actuation error, every decision carries its signals
  and is readable from ``GET /debug/audit`` as ``autopilot:*``, and
  ``/debug/autopilot`` and ``/tenants`` answer 200.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import time

from tpuserve_torch.bench.client import ClientSession
from tpuserve_torch.config import ServerConfig

log = logging.getLogger("tpuserve_torch.workerproc")

# The stream drill's audited body: a fixed (prompt, seed, cap). Seeded
# generation is deterministic across workers (identical seeded weights).
STREAM_REF_BODY = {"prompt": "the quick brown fox jumps over", "seed": 7,
                   "max_new_tokens": 24, "temperature": 0.7}
_TEXT = "the router relays this text to a worker that may die"


def drill_payload(cfg: ServerConfig, model: str) -> tuple[bytes, str, list[bytes]]:
    """The validator's body for ``model``, its content type, and the batch
    bodies whose answers complete its reference (a BERT text repeated to
    fill each batch bucket; none for other families, whose reference is the
    single answer)."""
    mcfg = cfg.model(model)
    if mcfg.family == "bert":
        batches = [json.dumps({"texts": [_TEXT] * b}).encode()
                   for b in mcfg.batch_buckets if b > 1]
        return json.dumps({"text": _TEXT}).encode(), "application/json", batches
    if mcfg.family == "textgen":
        return json.dumps(STREAM_REF_BODY).encode(), "application/json", []
    from tpuserve_torch.bench.loadgen import synthetic_image_npy

    return synthetic_image_npy(edge=mcfg.wire_size), "application/x-npy", []


async def _reference_bodies(session: ClientSession, url: str, payload: bytes,
                            ctype: str, batches: list[bytes]) -> set[bytes]:
    """Every 200 body the payload may answer with: alone, and as a row of
    each batch body (its rows re-encoded as a single answer is)."""
    headers = {"Content-Type": ctype}
    r = await session.post(url, payload, headers)
    if r.status != 200:
        raise RuntimeError(f"reference request failed: {r.status} {r.body[:200]!r}")
    refs = {r.body}
    for body in batches:
        rb = await session.post(url, body, headers)
        if rb.status != 200:
            raise RuntimeError(f"reference batch failed: {rb.status} {rb.body[:200]!r}")
        refs |= {json.dumps(row).encode() for row in rb.json()["results"]}
    return refs


async def _validator(url: str, payload: bytes, ctype: str, refs: set[bytes],
                     stop: asyncio.Event, out: dict) -> None:
    """Closed-loop correctness probe: every 200 body must be one of the
    reference bodies and carry back the request's own trace id; non-200s
    are availability's business."""
    async with ClientSession(limit=2, timeout_s=30.0) as session:
        while not stop.is_set():
            trace_id = os.urandom(16).hex()
            try:
                r = await session.post(url, payload, {"Content-Type": ctype,
                                                      "X-Trace-Id": trace_id})
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — resets count in the load
                out["transport_errors"] += 1
            else:
                if r.status == 200:
                    out["validated"] += 1
                    if r.body not in refs:
                        out["mismatched"] += 1
                        log.error("torn or mixed response: %r", r.body[:128])
                    if r.headers.get("x-trace-id") != trace_id:
                        out["duplicates"] += 1
                        log.error("answer for another request: trace %s != %s",
                                  r.headers.get("x-trace-id"), trace_id)
            await asyncio.sleep(0.01)


async def _await_postmortem(state, deadline_s: float = 10.0) -> list[dict]:
    """Wait for the supervisor's postmortem of the SIGKILL (captured on an
    executor thread), then return the ledger."""
    if state.postmortems is None:
        return []
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        records = state.postmortems.dump()
        if any(r.get("signal") == "SIGKILL" for r in records):
            return records
        await asyncio.sleep(0.1)
    return state.postmortems.dump()


async def _worker_compile_totals(urls: dict[int, str]) -> dict[int, float]:
    """runtime_compiles_total summed over models, per worker, off each
    worker's own /metrics."""
    out: dict[int, float] = {}
    async with ClientSession(timeout_s=5.0) as session:
        for wid, url in urls.items():
            try:
                text = (await session.get(f"{url}/metrics")).body.decode()
            except Exception:  # noqa: BLE001 — a dead worker: no snapshot
                continue
            out[wid] = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                           if line.startswith("runtime_compiles_total"))
    return out


async def _kill_and_wait(state, warmup_s: float, kill_at_s: float, respawn_budget_s: float,
                         kill_info: dict, survivor_urls: dict | None = None) -> None:
    """SIGKILL the worker the router would pick next, then wait for its
    slot to be healthy again (``respawn_s``; None past the budget)."""
    await asyncio.sleep(warmup_s + kill_at_s)
    victim = state.supervisor.pick()
    if victim is None:
        kill_info["error"] = "no healthy worker to kill"
        return
    wid, pid = victim.wid, victim.pid
    if survivor_urls is not None:
        survivor_urls.pop(wid, None)  # the victim is no compile-audit subject
    log.warning("drill: SIGKILL worker %d (pid %d)", wid, pid)
    t0 = time.monotonic()
    os.kill(pid, signal.SIGKILL)
    kill_info.update(killed_worker=wid, killed_pid=pid)
    deadline = t0 + respawn_budget_s
    while time.monotonic() < deadline:
        h = state.supervisor.slots[wid]
        if h is not None and h.pid != pid and h.healthy:
            kill_info["respawn_s"] = round(time.monotonic() - t0, 2)
            return
        await asyncio.sleep(0.05)
    kill_info["respawn_s"] = None  # did not come back in budget


def _fleet_cfg(cfg: ServerConfig) -> None:
    cfg.router.enabled = True
    cfg.router.workers = max(2, cfg.router.workers)
    # Every validated response must be a real execution: a cache would
    # serve perfect answers from a fleet of corpses.
    cfg.cache.enabled = False


async def run_worker_kill_drill(cfg: ServerConfig, model_name: str | None = None,
                                duration_s: float = 20.0, warmup_s: float = 1.0,
                                concurrency: int = 16, kill_after_s: float | None = None,
                                respawn_budget_s: float = 120.0,
                                device: str = "cuda") -> dict:
    """Serve a router fleet on ``device``, SIGKILL one worker mid-load,
    report availability, respawn and integrity with their gates (all but
    availability, whose bound the caller holds)."""
    from tpuserve_torch.bench.loadgen import run_load
    from tpuserve_torch.workerproc.router import RouterState, start_router, stop_router

    _fleet_cfg(cfg)
    model = model_name or cfg.models[0].name
    state = RouterState(cfg, device=device)
    server = await start_router(state, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{state.serving_addresses[0][1]}/v1/models/{model}:predict"
    payload, ctype, batches = drill_payload(cfg, model)
    kill_info: dict = {}
    integrity = {"validated": 0, "mismatched": 0, "duplicates": 0, "transport_errors": 0}
    stop_validator = asyncio.Event()
    loop = asyncio.get_running_loop()
    try:
        async with ClientSession(timeout_s=60.0) as session:
            refs = await _reference_bodies(session, url, payload, ctype, batches)
        validator = loop.create_task(_validator(url, payload, ctype, refs, stop_validator,
                                                integrity))
        load = loop.create_task(run_load(url, payload, ctype, duration_s, concurrency,
                                         warmup_s))
        killer = loop.create_task(_kill_and_wait(
            state, warmup_s, duration_s * 0.25 if kill_after_s is None else kill_after_s,
            respawn_budget_s, kill_info))
        result = await load
        await killer
        stop_validator.set()
        await validator
        postmortems = await _await_postmortem(state)
        workers = state.supervisor.stats()
    finally:
        await stop_router(state, server)

    out = result.summary()
    total = result.n_ok + result.n_err
    out["availability"] = round(result.n_ok / total, 5) if total else 0.0
    out["drill"] = "worker_kill"
    out["postmortems"] = postmortems
    out["kill"] = kill_info
    out["integrity"] = dict(integrity, reference_bodies=len(refs))
    out["workers"] = workers
    out["router"] = {
        "retries_total": state.handles[model].retries.value,
        "hedges_total": state.handles[model].hedges.value,
        "respawn_budget_s": respawn_budget_s,
        "respawn_backoff_initial_s": cfg.router.respawn_initial_s,
    }
    respawn_s = kill_info.get("respawn_s")
    out["gates"] = {
        "respawn_within_budget": respawn_s is not None and respawn_s <= respawn_budget_s,
        "zero_torn": integrity["mismatched"] == 0 and integrity["validated"] > 0,
        "zero_duplicates": integrity["duplicates"] == 0,
    }
    return out


async def _kill_host_and_wait(state, warmup_s: float, kill_at_s: float,
                              reabsorb_budget_s: float, kill_info: dict,
                              survivor_urls: dict) -> None:
    """killpg(SIGKILL) the host domain of the worker the router would pick
    next (its agent and every worker, one syscall: a machine losing power),
    then wait until the host slot is respawned with every worker healthy
    again (``reabsorb_s``; None past the budget). The pgid comes from the
    supervisor's roster, never from a process search."""
    await asyncio.sleep(warmup_s + kill_at_s)
    victim = state.supervisor.pick()
    if victim is None:
        kill_info["error"] = "no healthy worker whose host to kill"
        return
    hid = victim.host
    h = state.supervisor.hosts[hid]
    if h is None:
        kill_info["error"] = f"host {hid} already down"
        return
    pgid, old_pids = h.pgid, {r.wid: r.pid for r in h.workers.values()}
    for wid in old_pids:
        survivor_urls.pop(wid, None)  # the victims are no compile-audit subjects
    log.warning("drill: SIGKILL host %d: killpg(%d) takes the agent and workers %s at once",
                hid, pgid, sorted(old_pids))
    t0 = time.monotonic()
    os.killpg(pgid, signal.SIGKILL)
    kill_info.update(killed_host=hid, killed_pgid=pgid, workers_killed=len(old_pids))
    deadline = t0 + reabsorb_budget_s
    while time.monotonic() < deadline:
        nh = state.supervisor.hosts[hid]
        if nh is not None and nh.pgid != pgid and nh.proc.is_alive():
            refs = list(nh.workers.values())
            if len(refs) == state.rcfg.workers and all(r.up and r.healthy for r in refs):
                kill_info["reabsorb_s"] = round(time.monotonic() - t0, 2)
                kill_info["host_boot_s"] = round(nh.boot_s, 2)
                return
        await asyncio.sleep(0.05)
    kill_info["reabsorb_s"] = None  # did not come back in budget


async def run_host_kill_drill(cfg: ServerConfig, model_name: str | None = None,
                              duration_s: float = 25.0, warmup_s: float = 1.0,
                              concurrency: int = 16, kill_after_s: float | None = None,
                              reabsorb_budget_s: float = 120.0,
                              device: str = "cuda") -> dict:
    """Serve a router over >= 2 host domains of >= 2 workers each on
    ``device``, killpg(SIGKILL) one WHOLE host 25 % into the load (or
    ``kill_after_s`` after the warm-up), and report availability (the
    caller's bound: the surviving host absorbs the retries), ``reabsorb_s``
    (SIGKILL until the host is respawned with every worker healthy: the
    backoff, the agent's boot and its workers' boots), the validator's
    torn and duplicate audit, and the survivors' ``compile_deltas`` (the
    kill must not perturb the survivors), with their gates."""
    from tpuserve_torch.bench.loadgen import run_load
    from tpuserve_torch.workerproc.router import RouterState, start_router, stop_router

    _fleet_cfg(cfg)
    cfg.router.hosts = max(2, cfg.router.hosts)
    model = model_name or cfg.models[0].name
    state = RouterState(cfg, device=device)
    server = await start_router(state, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{state.serving_addresses[0][1]}/v1/models/{model}:predict"
    payload, ctype, batches = drill_payload(cfg, model)
    kill_info: dict = {}
    integrity = {"validated": 0, "mismatched": 0, "duplicates": 0, "transport_errors": 0}
    stop_validator = asyncio.Event()
    loop = asyncio.get_running_loop()
    try:
        async with ClientSession(timeout_s=60.0) as session:
            refs = await _reference_bodies(session, url, payload, ctype, batches)
        survivor_urls = {w.wid: w.base_url for w in state.supervisor.live_workers()}
        compiles_before = await _worker_compile_totals(dict(survivor_urls))
        validator = loop.create_task(_validator(url, payload, ctype, refs, stop_validator,
                                                integrity))
        load = loop.create_task(run_load(url, payload, ctype, duration_s, concurrency,
                                         warmup_s))
        killer = loop.create_task(_kill_host_and_wait(
            state, warmup_s, duration_s * 0.25 if kill_after_s is None else kill_after_s,
            reabsorb_budget_s, kill_info, survivor_urls))
        result = await load
        await killer
        stop_validator.set()
        await validator
        compiles_after = await _worker_compile_totals(survivor_urls)
        postmortems = await _await_postmortem(state)
        workers = state.supervisor.stats()
    finally:
        await stop_router(state, server)

    out = result.summary()
    total = result.n_ok + result.n_err
    out["availability"] = round(result.n_ok / total, 5) if total else 0.0
    out["drill"] = "host_kill"
    out["postmortems"] = postmortems
    out["kill"] = kill_info
    out["integrity"] = dict(integrity, reference_bodies=len(refs))
    out["workers"] = workers
    out["compile_deltas"] = {
        str(wid): compiles_after.get(wid, compiles_before[wid]) - compiles_before[wid]
        for wid in compiles_before if wid in compiles_after}
    out["router"] = {
        "retries_total": state.handles[model].retries.value,
        "hedges_total": state.handles[model].hedges.value,
        "reabsorb_budget_s": reabsorb_budget_s,
        "respawn_backoff_initial_s": cfg.router.respawn_initial_s,
        "host_breaker_threshold": cfg.router.host_breaker_threshold,
    }
    reabsorb_s = kill_info.get("reabsorb_s")
    out["gates"] = {
        "reabsorb_within_budget": reabsorb_s is not None and reabsorb_s <= reabsorb_budget_s,
        "zero_torn": integrity["mismatched"] == 0 and integrity["validated"] > 0,
        "zero_duplicates": integrity["duplicates"] == 0,
        "survivor_compiles_zero": bool(out["compile_deltas"])
        and all(v == 0 for v in out["compile_deltas"].values()),
    }
    return out


async def run_stream_kill_drill(cfg: ServerConfig, model_name: str | None = None,
                                duration_s: float = 20.0, warmup_s: float = 1.0,
                                concurrency: int = 16, kill_after_s: float | None = None,
                                respawn_budget_s: float = 120.0,
                                device: str = "cuda") -> dict:
    """Serve a router over >= 2 workers with a generative model on
    ``device``, drive MIXED streaming and unary load, SIGKILL one worker
    mid-load and audit the stream semantics end to end (module docstring);
    availability, held by the caller, is the unary load's."""
    from tpuserve_torch.bench.loadgen import run_load, stream_generate, synthetic_prompt_pool
    from tpuserve_torch.obs import percentile
    from tpuserve_torch.workerproc.router import RouterState, start_router, stop_router

    _fleet_cfg(cfg)
    model = model_name or cfg.models[0].name
    state = RouterState(cfg, device=device)
    server = await start_router(state, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{state.serving_addresses[0][1]}"
    url = f"{base}/v1/models/{model}:generate"
    ctype = "application/json"
    ref_body = json.dumps(STREAM_REF_BODY).encode()
    unary_pool = synthetic_prompt_pool(16, max_new=(2, 24))
    kill_info: dict = {}
    records: list[dict] = []
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()

    async def _stream_client() -> None:
        async with ClientSession(limit=2) as session:
            while not stop.is_set():
                records.append(await stream_generate(session, url, ref_body,
                                                     {"Content-Type": ctype}))
                await asyncio.sleep(0.01)

    try:
        async with ClientSession(timeout_s=120.0) as session:
            r = await session.post(url, ref_body, {"Content-Type": ctype})
        if r.status != 200:
            raise RuntimeError(f"reference request failed: {r.status} {r.body[:200]!r}")
        ref_text = r.json()["text"]
        survivor_urls = {w.wid: w.base_url for w in state.supervisor.live_workers()}
        compiles_before = await _worker_compile_totals(dict(survivor_urls))
        n_streamers = max(2, concurrency // 4)
        streamers = [loop.create_task(_stream_client()) for _ in range(n_streamers)]
        load = loop.create_task(run_load(url, unary_pool, ctype, duration_s,
                                         max(2, concurrency - n_streamers), warmup_s))
        killer = loop.create_task(_kill_and_wait(
            state, warmup_s, duration_s * 0.25 if kill_after_s is None else kill_after_s,
            respawn_budget_s, kill_info, survivor_urls))
        result = await load
        await killer
        stop.set()
        await asyncio.gather(*streamers)
        compiles_after = await _worker_compile_totals(survivor_urls)
        postmortems = await _await_postmortem(state)
        workers = state.supervisor.stats()
        async with ClientSession(timeout_s=10.0) as session:
            metrics_text = (await session.get(f"{base}/metrics")).body.decode()
    finally:
        await stop_router(state, server)

    started = [r for r in records if r["status"] == 200]
    done_s = [r for r in started if r["terminal"] == "done"]
    error_s = [r for r in started if r["terminal"] == "error"]
    first_tokens = [r["first_token_ms"] for r in started if r["first_token_ms"] is not None]
    gaps = [(b - a) * 1e3 for r in done_s
            for a, b in zip(r["token_times"], r["token_times"][1:])]
    audit = {
        "streams": len(records),
        "started": len(started),
        "done": len(done_s),
        "error_terminals": len(error_s),
        "error_reasons": {},
        # The zero gates:
        "torn": sum(1 for r in started if r["torn"]),
        "order_violations": sum(1 for r in started
                                if r["indices"] != list(range(len(r["indices"])))),
        "mismatched": sum(1 for r in done_s if r["text"] != ref_text),
        "non_prefix": sum(1 for r in error_s if not ref_text.startswith(r["text"])),
        "junk_events": sum(r["junk"] for r in records),
        # Pre-latch outcomes: the router retried or shed these with a plain
        # status; no stream semantics are owed.
        "not_started": len(records) - len(started),
        "first_token_p50_ms": round(percentile(first_tokens, 0.5), 3),
        "first_token_p99_ms": round(percentile(first_tokens, 0.99), 3),
        "inter_token_gap_p99_ms": round(percentile(gaps, 0.99), 3),
    }
    for r in error_s:
        key = str(r["error"])
        audit["error_reasons"][key] = audit["error_reasons"].get(key, 0) + 1
    stream_terminated = {}
    for line in metrics_text.splitlines():
        if line.startswith("router_stream_terminated_total"):
            k, v = line.rsplit(" ", 1)
            stream_terminated[k] = float(v)

    out = result.summary()
    total = result.n_ok + result.n_err
    out["availability"] = round(result.n_ok / total, 5) if total else 0.0
    out["drill"] = "stream_kill"
    out["postmortems"] = postmortems
    out["kill"] = kill_info
    out["stream_audit"] = audit
    out["workers"] = workers
    out["compile_deltas"] = {
        str(wid): compiles_after.get(wid, compiles_before[wid]) - compiles_before[wid]
        for wid in compiles_before if wid in compiles_after}
    out["router"] = {
        "retries_total": state.handles[model].retries.value,
        "hedges_total": state.handles[model].hedges.value,
        "streams_total": state.handles[model].streams.value,
        "stream_terminated": stream_terminated,
        "respawn_budget_s": respawn_budget_s,
    }
    out["gates"] = {
        "zero_torn": audit["torn"] == 0,
        "zero_order_violations": audit["order_violations"] == 0,
        "byte_audit": audit["mismatched"] == 0 and audit["non_prefix"] == 0
        and audit["done"] > 0,
        "survivor_compiles_zero": all(v == 0 for v in out["compile_deltas"].values()),
    }
    return out


# The reference script's bound on the controller's reaction (seconds from
# the load's start to its first action).
FIRST_ACTION_BOUND_S = 18.0


async def _tenant_load(url: str, payload: bytes, ctype: str, api_key: str,
                       stop: asyncio.Event, out: dict, clients: int,
                       think_s: float = 0.0) -> None:
    """Closed-loop load of one tenant: ``clients`` concurrent callers, each
    presenting ``X-Api-Key`` and counting every answer by status and shed
    reason. The hostile tenant is this with no think time: it ignores
    Retry-After."""
    headers = {"Content-Type": ctype, "X-Api-Key": api_key}

    async def _one(session: ClientSession) -> None:
        while not stop.is_set():
            try:
                r = await session.post(url, payload, headers)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — a transport-level failure
                out["transport_errors"] += 1
            else:
                if r.status == 200:
                    out["n_200"] += 1
                else:
                    key = f"n_{r.status}" if r.status in (429, 503) else "n_other"
                    out[key] = out.get(key, 0) + 1
                    try:
                        reason = r.json().get("reason", "")
                    except (ValueError, AttributeError):
                        reason = ""
                    if reason:
                        out["reasons"][reason] = out["reasons"].get(reason, 0) + 1
            if think_s:
                await asyncio.sleep(think_s)

    async with ClientSession(limit=clients * 2, timeout_s=30.0) as session:
        await asyncio.gather(*(_one(session) for _ in range(clients)))


async def run_autopilot_drill(cfg: ServerConfig, model_name: str | None = None,
                              duration_s: float = 25.0, warmup_s: float = 1.0,
                              concurrency: int = 16, device: str = "cuda") -> dict:
    """Serve a tenant-fenced router fleet on ``device`` with the autopilot
    engaged, let the hostile tenant flood beside the victim for
    ``duration_s``, and report containment, the controller's reaction and
    the audit trail read over HTTP from the live fleet, with the gates of
    the module docstring (all but the victim's availability, whose bound
    the caller holds)."""
    from tpuserve_torch.config import TenantConfig
    from tpuserve_torch.workerproc.router import RouterState, start_router, stop_router

    cfg.router.enabled = True
    cfg.router.hosts = max(2, cfg.router.hosts)
    cfg.router.workers = max(2, cfg.router.workers)  # per host
    if not 1 <= cfg.router.active_workers < cfg.router.workers:
        # One dormant slot per host: scale_up has real headroom.
        cfg.router.active_workers = cfg.router.workers - 1
    # Identical payloads would coalesce into one cache hit, hiding both the
    # hostile load and the pressure signal the controller reads.
    cfg.cache.enabled = False
    ap = cfg.autopilot
    ap.enabled = True
    # The drill runs tens of seconds: tighten the controller's clocks so
    # hysteresis, cooldown and follow-up fit inside it (never loosening
    # what the config set tighter).
    ap.interval_s = min(ap.interval_s, 0.25)
    ap.hysteresis_ticks = min(ap.hysteresis_ticks, 2)
    ap.cooldown_s = min(ap.cooldown_s, 3.0)
    ap.follow_up_s = min(ap.follow_up_s, 5.0)
    tn = cfg.tenants
    tn.enabled = True
    have = {t.name for t in tn.tenants}
    if "hostile" not in have:
        # A tight envelope: the flood must hit its quota mid-run.
        tn.tenants.append(TenantConfig(name="hostile", api_key="drill-hostile-key",
                                       weight=1.0, quota_device_s=max(1.0, duration_s * 0.2),
                                       rate_per_s=float(concurrency)))
    if "victim" not in have:
        tn.tenants.append(TenantConfig(name="victim", api_key="drill-victim-key", weight=4.0))
    keys = {t.name: t.api_key for t in tn.tenants}
    model = model_name or cfg.models[0].name

    state = RouterState(cfg, device=device)
    server = await start_router(state, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{state.serving_addresses[0][1]}"
    url = f"{base}/v1/models/{model}:predict"
    payload, ctype, _ = drill_payload(cfg, model)

    def _bucket() -> dict:
        return {"n_200": 0, "n_429": 0, "n_503": 0, "n_other": 0,
                "transport_errors": 0, "reasons": {}}

    hostile, victim = _bucket(), _bucket()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    try:
        # A reference request as the victim (anonymous is 401): the fleet
        # serves before the clock starts.
        async with ClientSession(timeout_s=60.0) as session:
            r = await session.post(url, payload, {"Content-Type": ctype,
                                                  "X-Api-Key": keys["victim"]})
            if r.status != 200:
                raise RuntimeError(f"reference request failed: {r.status} {r.body[:200]!r}")
        await asyncio.sleep(warmup_s)
        t_load0 = time.monotonic()
        tasks = [
            loop.create_task(_tenant_load(url, payload, ctype, keys["hostile"], stop, hostile,
                                          clients=max(4, concurrency))),
            loop.create_task(_tenant_load(url, payload, ctype, keys["victim"], stop, victim,
                                          clients=max(2, concurrency // 4), think_s=0.05)),
        ]
        await asyncio.sleep(duration_s)
        stop.set()
        await asyncio.gather(*tasks)

        ap_desc = state.autopilot.describe() if state.autopilot else {}
        decisions = ap_desc.get("decisions", [])
        # Reaction time from the load's start (decision timestamps are
        # wall-clock; so is this conversion).
        wall_load0 = time.time() - (time.monotonic() - t_load0)
        first_action_s = round(decisions[0]["ts"] - wall_load0, 2) if decisions else None
        usage = state.tenants.usage() if state.tenants else {}
        tenant_slo = state.tenant_slo.alerts() if state.tenant_slo is not None else {}
        scale_state = (state.supervisor.scale_state()
                       if hasattr(state.supervisor, "scale_state") else [])
        # Audit completeness against the LIVE endpoint: every decision must
        # be readable from GET /debug/audit.
        async with ClientSession(timeout_s=30.0) as session:
            r = await session.get(f"{base}/debug/audit")
            audit_body = r.json() if r.status == 200 else {}
            ap_http_status = (await session.get(f"{base}/debug/autopilot")).status
            tenants_http_status = (await session.get(f"{base}/tenants")).status
        audit_recs = [rec for rec in audit_body.get("audit", [])
                      if str(rec.get("verb", "")).startswith("autopilot:")]
    finally:
        await stop_router(state, server)

    kinds: dict[str, int] = {}
    for d in decisions:
        kinds[d["kind"]] = kinds.get(d["kind"], 0) + 1
    v_total = (victim["n_200"] + victim["n_429"] + victim["n_503"] + victim["n_other"]
               + victim["transport_errors"])
    autopilot = {
        "ticks": ap_desc.get("ticks", 0),
        "actions_total": ap_desc.get("actions_total", 0),
        "errors_total": ap_desc.get("errors_total", 0),
        "rollbacks_total": ap_desc.get("policy", {}).get("rollbacks_total", 0),
        "action_kinds": kinds,
        "first_action_s": first_action_s,
        "decisions": decisions,
        "http_status": ap_http_status,
    }
    audit = {"autopilot_records": len(audit_recs), "decisions_total": len(decisions),
             "complete": len(audit_recs) >= min(len(decisions), cfg.events.audit_capacity)}
    hostile_tenant_reasons = {r: n for r, n in hostile["reasons"].items()
                              if r.startswith("tenant_")}
    out = {
        "drill": "autopilot",
        "model": model,
        "duration_s": duration_s,
        # The CLI's --min-availability bounds the VICTIM: the hostile
        # tenant's 429s are the contract working, not an outage.
        "availability": round(victim["n_200"] / v_total, 5) if v_total else 0.0,
        "tenants": {"hostile": hostile, "victim": victim},
        "autopilot": autopilot,
        "audit": audit,
        "tenant_slo": tenant_slo,
        "tenants_endpoint_status": tenants_http_status,
        "usage": usage,
        "scale_state": scale_state,
    }
    out["gates"] = {
        "hostile_shed_by_tenant_reason": hostile["n_429"] > 0 and bool(hostile_tenant_reasons),
        "victim_never_429": victim["n_429"] == 0,
        "victim_slo_not_firing": tenant_slo.get("models", {}).get("victim", {})
        .get("state", "ok") != "firing",
        "hostile_charged": usage.get("tenants", {}).get("hostile", {})
        .get("device_seconds_total", 0) > 0,
        "controller_acted": autopilot["actions_total"] >= 1
        and bool(set(kinds) & {"scale_up", "shed_on"}),
        "first_action_in_window": first_action_s is not None
        and first_action_s <= FIRST_ACTION_BOUND_S,
        "zero_actuation_errors": autopilot["errors_total"] == 0,
        "decisions_carry_signals": all(d.get("signals") for d in decisions),
        "audit_complete": audit["complete"]
        and audit["autopilot_records"] >= audit["decisions_total"],
        "autopilot_endpoint_200": ap_http_status == 200,
        "tenants_endpoint_200": tenants_http_status == 200,
    }
    return out
