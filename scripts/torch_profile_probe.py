"""Does torch.profiler see the kernels of a CUDA graph, and on which clock?

    python3 scripts/torch_profile_probe.py cold   # the profiler first starts after capture
    python3 scripts/torch_profile_probe.py warm   # a profiler session before the capture

Captures a CUDA graph of a 512 x 512 matmul + ReLU + add, then profiles
five replays (CPU and CUDA activity) and exports the Chrome trace. Prints
the trace's ``baseTimeNanoseconds``, the number of events and of kernel
events, their names, the event categories, how many kernels land inside the
profiling window once ``baseTimeNanoseconds / 1000`` is added to their
``ts`` (µs, the ``time.time()`` clock), and the window itself (the start
call included: the first start of CUPTI in a process is slow).
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile


def graph_of(fn, x):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = fn(x)
    return g, y


def run(mode: str) -> None:
    x = torch.randn(512, 512, device="cuda")
    if mode == "warm":
        p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        p.start()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        p.stop()
    g, _ = graph_of(lambda t: torch.relu(t @ t) + 1, x)
    torch.cuda.synchronize()
    t0 = time.time()
    p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    p.start()
    for _ in range(5):
        g.replay()
    torch.cuda.synchronize()
    p.stop()
    t1 = time.time()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        p.export_chrome_trace(f.name)
        data = json.load(open(f.name))
    base = data.get("baseTimeNanoseconds")
    kernels = [e for e in data["traceEvents"] if e.get("cat") == "kernel"]
    walls = [base / 1e3 + e["ts"] for e in kernels] if base else []
    print(mode, "base", base, "events", len(data["traceEvents"]), "kernels", len(kernels),
          sorted({e["name"][:60] for e in kernels}),
          "categories", sorted({e.get("cat") for e in data["traceEvents"] if e.get("cat")}),
          "inside the window", sum(t0 * 1e6 <= w <= t1 * 1e6 for w in walls),
          "window ms", round((t1 - t0) * 1e3, 1), flush=True)


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else "cold")
