#!/usr/bin/env python3
"""Operations and bytes of one SD 1.5 request in ``tpuserve_torch``, counted
from the code at full width on the meta device (no memory, no card):

    python scripts/torch_sd15_flops.py [--image-size 512] [--slots 8]

``torch.utils.flop_counter.FlopCounterMode`` counts the matmuls and
convolutions of one CLIP call (2 rows: uncond + cond), one UNet call at
2 x ``lanes`` rows (classifier-free guidance) and one VAE decode of one
latent; K1's calls are replaced by a stub that records their padded shapes
and counts 4 * B * H * S^2 * Dp operations for each (q.k^T and p.v at the
padded head dim, what the kernel computes). Prints one JSON object: per
network the operations, K1's share of the UNet's, the parameter bytes at
bf16, and a locked 20-step image's total.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tpuserve_torch.config import ModelConfig  # noqa: E402
from tpuserve_torch.models import build  # noqa: E402
from tpuserve_torch.models import sd15  # noqa: E402


def count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--slots", type=int, default=8, help="engine step lanes to count too")
    args = ap.parse_args()
    model = build(ModelConfig(name="sd15", family="sd15", dtype="bfloat16",
                              parallelism="single", image_size=args.image_size,
                              options=dict(unet_attention="flash", vocab_size=49408)))
    k1_calls: list = []

    def k1(q, k, v):
        k1_calls.append(tuple(q.shape))
        return torch.empty_like(q)

    sd15.flash_attention = k1
    lat = model.latent
    with torch.device("meta"):
        module = model.build_module().to(torch.bfloat16)
        ids = torch.zeros(2, sd15.MAX_TOKENS, dtype=torch.int32)
        text = count(lambda: module.text(ids))
        out: dict = {"image_size": args.image_size, "latent": lat, "steps": model.steps,
                     "clip_2rows_flops": text}
        for lanes in (1, args.slots):
            k1_calls.clear()
            ctx = torch.empty(2 * lanes, sd15.MAX_TOKENS, 768, dtype=torch.bfloat16)
            unet = count(lambda: module.unet(torch.empty(2 * lanes, lat, lat, 4),
                                             torch.zeros(2 * lanes, dtype=torch.int32), ctx))
            k1_flops = sum(4 * b * h * s * s * d for b, s, h, d in k1_calls)
            out[f"unet_{2 * lanes}rows"] = {
                "flops_without_k1": unet, "k1_flops": k1_flops, "flops": unet + k1_flops,
                "k1_share": k1_flops / (unet + k1_flops),
                "k1_calls": sorted(set(k1_calls)), "k1_launches": len(k1_calls)}
        vae = count(lambda: module.vae(torch.empty(1, lat, lat, 4)))
        out["vae_1row_flops"] = vae
        params = {net: sum(p.numel() for p in getattr(module, net).parameters())
                  for net in ("text", "unet", "vae")}
    out["params"] = params
    out["param_bytes_bf16"] = 2 * sum(params.values())
    u = out["unet_2rows"]["flops"]
    out["locked_image_flops"] = text + model.steps * u + vae
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
