"""Where the first request of a ResNet-50 bucket spends its time, on the card.

    python3 scripts/torch_first_request.py     # from the root of a checkout; one GPU

Serves ``examples/resnet50.toml`` through ``python -m tpuserve_torch serve``
(``chip_smoke.serving``), sends ``chip_smoke.resnet_requests``' five bodies
(framed yuv420 1/8/32 items to ``resnet50``, npy 8 + 1 to ``resnet50_rgb``)
four rounds over, one at a time, and prints each request's time per stage
(``body_read`` ... ``postproc``, ``total``): the server's per-stage histogram
sums after the request less before it. Round 1 is each bucket's first
request. Then, in-process, with both models of the config built as the
server builds them: the objects the collector tracks and the time of a full
collection, before and after ``gc.freeze()``; the time of the assembly
arena's pinned allocation per bucket (first and later); and ``resnet50``'s
runtime's first and later runs per bucket, from an unpinned host batch and
from a new thread.
It uses only ``chip_smoke``'s ``serving``, ``resnet_requests``, ``call``,
``check`` and ``card_line``, which older checkouts have too, so the same
file measures an older checkout: copy it into that tree's ``scripts/``.
"""

from __future__ import annotations

import gc
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

STAGES = ("body_read", "parse", "queue", "preproc", "h2d", "compute", "postproc", "total")


def stage_totals(port: int, model: str) -> dict:
    """The summed milliseconds of each stage histogram of ``model`` so far."""
    lat = json.loads(cs.call(port, "GET", "/stats")[1])["latency"]
    out = {}
    for p in STAGES:
        row = lat.get(f"latency_ms{{model={model},phase={p}}}")
        out[p] = row["mean_ms"] * row["n"] if row else 0.0
    return out


def main() -> int:
    import numpy as np
    import torch

    from tpuserve_torch.config import load_config
    from tpuserve_torch.hostpipe import AssemblyArena
    from tpuserve_torch.server import ServerState

    print(cs.card_line(), flush=True)
    reqs = cs.resnet_requests()
    rows: dict[str, list] = {}
    with cs.serving(cs.RESNET_CONFIG, n_buckets=6) as port:
        for _ in range(4):
            for name, label, body, ctype, _ in reqs:
                before = stage_totals(port, name)
                st, _ = cs.call(port, "POST", f"/v1/models/{name}:classify", raw=body, ctype=ctype)
                cs.check(st == 200, f"{label} answered {st}")
                after = stage_totals(port, name)
                rows.setdefault(label, []).append({p: round(after[p] - before[p], 3) for p in STAGES})
    print(json.dumps({"stages_ms_per_round": rows}), flush=True)

    # The serving process's heap: both models of the config, built.
    state = ServerState(load_config(str(cs.RESNET_CONFIG)), device="cuda")
    state.build()
    tracked = len(gc.get_objects())
    full_gc = []
    for freeze in (False, True):
        if freeze:
            gc.freeze()
        for _ in range(3):
            t0 = time.perf_counter()
            gc.collect()
            full_gc.append((freeze, (time.perf_counter() - t0) * 1e3))
    gc.unfreeze()
    model, rt = state.models["resnet50"], state.runtimes["resnet50"]
    arena = AssemblyArena(model, 4, pin=True)
    alloc = []
    for bucket in [(8,), (32,), (32,), (8,)]:
        t0 = time.perf_counter()
        arena._alloc(bucket)
        alloc.append((bucket[0], (time.perf_counter() - t0) * 1e3))
    replays = []

    def replay(bucket, pinned, tag):
        sig = model.input_signature(bucket)
        host = tuple((torch.zeros(s.shape, dtype=torch.uint8).pin_memory().numpy() if pinned
                      else np.zeros(s.shape, s.dtype)) for s in sig)
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = rt.run(bucket, host)
            t1 = time.perf_counter()
            rt.fetch(out)
            replays.append((tag, bucket[0], i, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))

    for bucket in [(8,), (32,)]:
        replay(bucket, False, "main thread, unpinned")
    t = threading.Thread(target=replay, args=((32,), True, "new thread, pinned"))
    t.start()
    t.join()
    print(json.dumps({"pinned_alloc_ms": alloc, "run_then_fetch_ms": replays,
                      "gc_tracked_objects": tracked,
                      "full_gc_ms_without_with_freeze": full_gc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
