"""What the reference's observability planes cost a served BERT-flash, on
the card, plane by plane.

    python3 scripts/torch_obs_cost.py      # from the root of a checkout; one GPU

Serves ``examples/bert_flash.toml`` five times at once through ``python -m
tpuserve_torch serve`` (``chip_smoke.serving``): as it is (the planes on),
with ``[telemetry]``, ``[events]`` and the flight recorder off, and with
each of the three off alone. Then runs ``chip_smoke.latency_cost`` (32-text
batches: 40 from one client, 100 from four) on each server, in that order
and again in reverse, and prints each run's p50 / p99 walls and its mean
time per stage (the server's per-stage histogram sums around the run, per
request), then one JSON line with all of it and the card's name and power
limit.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402

VARIANTS = {
    "on": "",
    "off": c.OBS_OFF_TOML,
    "telemetry_off": "\n[telemetry]\nenabled = false\n",
    "events_off": "\n[events]\nenabled = false\n",
    "recorder_off": "\n[trace]\nslow_n = 0\nerror_capacity = 0\n",
}


def main() -> int:
    card = c.card_line()
    print(card, flush=True)
    c.build_kernels()
    out = {k: [] for k in VARIANTS}
    with contextlib.ExitStack() as stack:
        ports = {k: stack.enter_context(c.serving(c.CONFIG, 6, extra_toml=v))
                 for k, v in VARIANTS.items()}
        for k in list(VARIANTS) + list(reversed(VARIANTS)):
            s0 = c.stage_totals(ports[k], "bert")
            res = c.latency_cost(ports[k])
            s1 = c.stage_totals(ports[k], "bert")
            n = sum(v["n"] for v in res.values()) + 5
            res["stage_mean_ms"] = {p: round((s1[p] - s0[p]) / n, 3) for p in c.STAGES}
            out[k].append(res)
            print(k, json.dumps(res), flush=True)
    print(json.dumps({"cost_diag": out, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
