#!/usr/bin/env python3
"""Which CUDA calls torch's sync debug mode flags, on the card, and what the
blessed readback costs.

    python3 scripts/torch_sync_guard.py    # from the root of a checkout; one GPU

The retrace witness (``tpuserve_torch.utils.retrace``) arms
``torch.cuda.set_sync_debug_mode("error")`` after the warmup barrier and
relies on what this script checks, call by call, with the mode set:

- the blessed readback, ``host_fetch`` (pinned ``non_blocking`` copies and
  one ``torch.cuda.Event`` wait), and the served path's pinned
  host-to-device copy and graph replay pass;
- the implicit syncs the guard exists for (``.item()``, pageable ``.cpu()``,
  ``float()`` of a CUDA tensor, ``torch.cuda.synchronize()``,
  ``Stream.synchronize()``) are flagged;
- which of the runtime's blessed sites (a graph capture, ``empty_cache``,
  the profiler's start and stop, a blocking host-to-device copy, a graph's
  destruction) need an ``allow_transfers`` window.

Then it times ``host_fetch`` against the ``.cpu().numpy()`` it replaced on
a served BERT-flash batch's outputs ((32, 5) float32 and int64), guard off,
on the card held idle. Prints one JSON line (``sync_guard``) with the
card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_sync_guard: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tpuserve_torch.utils.retrace import host_fetch

    dev = torch.device("cuda", 0)
    x = torch.randn(32, 5, device=dev)
    idx = torch.randint(0, 1000, (32, 5), device=dev)
    host_pinned = torch.zeros(32, 5).pin_memory()
    host_pageable = torch.zeros(32, 5)
    w = torch.randn(64, 64, device=dev)
    static = torch.randn(8, 64, device=dev)
    torch.cuda.synchronize()

    def capture():
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            static @ w
        torch.cuda.current_stream().wait_stream(s)
        with torch.cuda.graph(g):
            static @ w
        return g

    # Captured with the mode off: their replay and their destruction are
    # what is probed.
    kept, doomed = capture(), [capture()]
    torch.cuda.synchronize()

    def destroy_graph():
        doomed.clear()
        gc.collect()

    def profiler():
        from torch.profiler import ProfilerActivity, profile

        p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        p.start()
        static @ w
        p.stop()

    def event_wait():
        e = torch.cuda.Event()
        e.record()
        e.synchronize()

    def stream_sync():
        torch.cuda.current_stream().synchronize()

    calls = {
        "host_fetch": lambda: host_fetch({"probs": x, "indices": idx}),
        "event_record_and_synchronize": event_wait,
        "event_query": lambda: torch.cuda.Event().query(),
        "pinned_h2d_non_blocking": lambda: host_pinned.to(dev, non_blocking=True),
        "device_to_device_copy": lambda: static.clone().copy_(static),
        "graph_replay": kept.replay,
        "memory_reserved": lambda: torch.cuda.memory_reserved(dev),
        "item": lambda: x.sum().item(),
        "cpu_pageable": lambda: x.cpu(),
        "float_of_cuda_tensor": lambda: float(x[0, 0]),
        "torch_cuda_synchronize": torch.cuda.synchronize,
        "stream_synchronize": stream_sync,
        "pageable_h2d_blocking": lambda: host_pageable.to(dev),
        "torch_tensor_on_device": lambda: torch.tensor([1.0, 2.0], device=dev),
        "nonzero": lambda: torch.nonzero(x > 0),
        "empty_cache": torch.cuda.empty_cache,
        "graph_capture": capture,
        "graph_destroy_and_gc": destroy_graph,
        "profiler_start_stop": profiler,
    }
    verdicts = {}
    for name, fn in calls.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            verdicts[name] = "passes"
        except RuntimeError as e:
            msg = str(e)
            verdicts[name] = ("flagged" if "synchroniz" in msg
                              else f"error: {msg.splitlines()[0][:160]}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()

    # host_fetch against the .cpu().numpy() it replaced, guard off.
    outputs = {"probs": x, "indices": idx}

    def per_call_us(fn, n: int = 500) -> float:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    rounds = [{"host_fetch_us": per_call_us(lambda: host_fetch(outputs)),
               "cpu_numpy_us": per_call_us(
                   lambda: {k: v.cpu().numpy() for k, v in outputs.items()})}
              for _ in range(3)]
    print(json.dumps({"sync_guard": {
        "card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda,
        "verdicts": verdicts, "readback_us_rounds": rounds}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
