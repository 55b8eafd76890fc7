"""Fleet isolation drill (``python -m tpuserve_torch chaos --drill fleet``),
ported from ``tpuserve/scheduler/drill.py``.

A fleet's availability property is per-model isolation: one misbehaving
model must cost its own traffic, never the front door. The drill serves one
real multi-model server (>= 3 models, fleet scheduler armed) on the port's
own HTTP server, drives its closed-loop load generator at every model at
once, poisons one victim with ``device_error`` at 100 % (every dispatch
below the batcher fails: retry, split and breaker all see real failures),
and measures:

- **victim containment** — the victim's circuit breaker opens, so its
  traffic degrades to fast 503s instead of slow 500s;
- **survivor availability** — every other model holds availability >= the
  bound with its p99 within budget: the victim's failing dispatches never
  starve the survivors' batchers, stage executors or admission;
- the summary's ``availability`` is the MINIMUM across survivors (what the
  chaos CLI gates), with per-model latency percentiles and the scheduler,
  breaker and injector state attached.

Each model is loaded with the body its family serves (the payload of
``tpuserve_torch.workerproc.drill.drill_payload``: a text for BERT, an npy
image at the wire size otherwise), and a ``cold_start`` survivor is warmed
before the clock starts, so the run measures isolation, not a warm-up.
"""

from __future__ import annotations

import asyncio
import logging

from tpuserve_torch.config import FaultRuleConfig, ServerConfig

log = logging.getLogger("tpuserve_torch.scheduler")


async def run_fleet_drill(cfg: ServerConfig, victim: str | None = None,
                          duration_s: float = 10.0, warmup_s: float = 1.0,
                          concurrency: int = 8,
                          device: "str | None" = None) -> dict:
    """Serve ``cfg``'s models on an ephemeral port of ``device`` (default
    the current CUDA device) with the victim poisoned, load every model at
    once, and report per-model availability and the breaker and scheduler
    state. The caller (the CLI) owns asserting the bounds."""
    from tpuserve_torch.bench.loadgen import run_load
    from tpuserve_torch.ops import flash_attention as fa
    from tpuserve_torch.server import ServerState, start_server, stop_server
    from tpuserve_torch.workerproc.drill import drill_payload

    if len(cfg.models) < 3:
        raise ValueError(
            f"the fleet drill needs >= 3 models to prove isolation; "
            f"config has {len(cfg.models)}")
    victim = victim or cfg.models[0].name
    if victim not in {m.name for m in cfg.models}:
        raise ValueError(f"victim {victim!r} is not a configured model")

    # Poison the victim: every dispatch below the batcher raises, so the
    # whole recovery ladder (retry -> split -> breaker) runs against real
    # failures. The drill proves the blast radius stops at the victim.
    cfg.faults.enabled = True
    cfg.faults.rules.append(FaultRuleConfig(
        kind="device_error", model=victim, probability=1.0))
    # The drill IS the scheduler's fleet mode; and every measured response
    # must be a real execution — a cache would serve perfect answers on
    # behalf of a poisoned model.
    cfg.scheduler.enabled = True
    cfg.cache.enabled = False

    state = ServerState(cfg, device=device)
    state.build()
    server = await start_server(state, host="127.0.0.1", port=0)
    try:
        base = f"http://127.0.0.1:{state.serving_addresses[0][1]}"
        for m in cfg.models:
            if m.name != victim and not state.scheduler.is_warm(m.name):
                await state.scheduler.warm(m.name)
        # The kernels' launches and the batches over the load alone.
        fa.reset_launches()
        batches0 = {m.name: state.metrics.counter(f"batches_total{{model={m.name}}}").value
                    for m in cfg.models}
        loads = await asyncio.gather(*(
            run_load(f"{base}/v1/models/{m.name}:predict",
                     *drill_payload(cfg, m.name)[:2], duration_s, concurrency,
                     warmup_s)
            for m in cfg.models))
        kernels = {"k1_launches": fa.launches, "k2_launches": fa.stats_launches,
                   "batches": {n: state.metrics.counter(f"batches_total{{model={n}}}").value - b
                               for n, b in batches0.items()}}
        breakers = {n: br.describe() for n, br in state.breakers.items()}
        sched = state.scheduler.stats()
        faults = state.injector.snapshot() if state.injector else []
    finally:
        await stop_server(state, server)

    models: dict[str, dict] = {}
    survivor_avail = []
    for m, res in zip(cfg.models, loads):
        total = res.n_ok + res.n_err
        avail = round(res.n_ok / total, 5) if total else 0.0
        row = res.summary()
        row["availability"] = avail
        row["role"] = "victim" if m.name == victim else "survivor"
        models[m.name] = row
        if m.name != victim:
            survivor_avail.append(avail)
    return {
        "drill": "fleet",
        "victim": victim,
        "victim_breaker": breakers.get(victim, {}),
        "victim_breaker_open": breakers.get(victim, {}).get("state")
        in ("open", "half_open"),
        # The chaos CLI gates this: the WORST survivor must hold the SLO.
        "availability": min(survivor_avail) if survivor_avail else 0.0,
        "models": models,
        "breakers": breakers,
        "scheduler": sched,
        "faults": faults,
        "kernels": kernels,
    }
