#!/usr/bin/env python3
"""What the lock and retrace witnesses cost a served request, on the card.

    python3 scripts/torch_witness_cost.py --root <checkout> [--witness both|lock|retrace|none]
                                          [--seconds 10] [--clients 4]

Serves ``examples/bert_flash.toml`` with ``chip_smoke.py`` phase 11's
observability table (full-width 12-layer BERT-flash, bf16, seeded) from the
checkout at ``--root`` (its own ``chip_smoke.py`` supplies the config, the
32-text body and the server helper, so a parent commit unpacked elsewhere
runs as it was), with ``TPUSERVE_LOCK_WITNESS=1`` and/or
``TPUSERVE_RETRACE_WITNESS=1`` in the server's environment as
``--witness`` says (default none). Four closed-loop clients send 32-text
``:classify`` bodies for ``--seconds``; each request's wall time on the
client is kept. Prints one JSON line: the root, whether the witnesses were
armed, the request count, p50 / p99 / mean in ms, every answer's status,
the card's name and power limit, and the server's witness blocks from
``/stats`` when it has them. To compare two trees, run them in one call in
the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def summary(robustness: dict) -> dict:
    """The witness blocks of ``/stats`` ``robustness``, counted."""
    out = {}
    if "lock_witness" in robustness:
        lw = robustness["lock_witness"]
        out["lock_witness"] = {"locks": len(lw["locks"]), "edges": len(lw["edges"]),
                               "acquisitions": lw["acquisitions"],
                               "violations": len(lw["violations"])}
    if "retrace_witness" in robustness:
        rw = dict(robustness["retrace_witness"])
        rw["violations"] = len(rw["violations"])
        out["retrace_witness"] = rw
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="checkout whose tpuserve_torch serves")
    ap.add_argument("--witness", choices=("none", "lock", "retrace", "both"), default="none",
                    help="the witnesses armed in the server's environment")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--clients", type=int, default=4)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    for name, kind in (("TPUSERVE_LOCK_WITNESS", "lock"),
                       ("TPUSERVE_RETRACE_WITNESS", "retrace")):
        if args.witness in (kind, "both"):
            os.environ[name] = "1"
        else:
            os.environ.pop(name, None)
    spec = importlib.util.spec_from_file_location("chip_smoke_at_root", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    walls: list[float] = []
    statuses: dict[int, int] = {}
    lock = threading.Lock()
    with smoke.serving(smoke.CONFIG, n_buckets=6, extra_toml=smoke.OBS_TOML) as port:
        for _ in range(8):  # warm the connection path and the batcher
            smoke.call(port, "POST", "/v1/models/bert:classify", {"texts": smoke.TEXTS_32})
        stop = threading.Event()

        def client() -> None:
            while not stop.is_set():
                t = time.perf_counter()
                st = smoke.call(port, "POST", "/v1/models/bert:classify",
                                {"texts": smoke.TEXTS_32})[0]
                ms = (time.perf_counter() - t) * 1e3
                with lock:
                    walls.append(ms)
                    statuses[st] = statuses.get(st, 0) + 1

        threads = [threading.Thread(target=client) for _ in range(args.clients)]
        for t in threads:
            t.start()
        time.sleep(args.seconds)
        stop.set()
        for t in threads:
            t.join()
        robustness = json.loads(smoke.call(port, "GET", "/stats")[1])["robustness"]
    walls.sort()
    n = len(walls)
    print(json.dumps({"witness_cost": {
        "root": str(root), "witness": args.witness, "card": card_line(),
        "clients": args.clients, "seconds": args.seconds, "requests": n,
        "statuses": statuses, "p50_ms": walls[n // 2],
        "p99_ms": walls[min(n - 1, int(0.99 * n))], "mean_ms": sum(walls) / n,
        "witness_blocks": summary(robustness)}}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
