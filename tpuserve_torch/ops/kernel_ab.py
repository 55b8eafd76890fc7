"""Compare two source trees of the port's flash-attention kernels (K1, K2)
on one NVIDIA GPU.

    python3 -m tpuserve_torch.ops.kernel_ab A_DIR B_DIR   # from the root of a checkout

Each directory holds a ``flash_attention.cu`` and the headers it includes,
as ``tpuserve_torch/ops/csrc`` does (pass that directory for the tree as it
stands). Each tree is built into its own directory under ``build/``, held
once against the plain PyTorch version (``chip_smoke.compare`` and
``compare_stats``, bf16 tolerances), and timed in the order A, B, B, A:
K1 at (32, 64), (32, 128), (8, 512) and (8, 2048) and K2 at (8, 2048),
H 12, D 64, bf16 with padded keys, device time per launch
(``chip_smoke.time_ms``). Prints ptxas' spill and register lines of each
tree, one JSON line per round (microseconds), then the card's name and
power limit.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPES = (("K1", 32, 64), ("K1", 32, 128), ("K1", 8, 512), ("K1", 8, 2048), ("K2", 8, 2048))


def use(tree: Path, tag: str) -> None:
    """Build the library from ``tree`` into its own directory and load it."""
    from tpuserve_torch.ops import _build
    from tpuserve_torch.ops import flash_attention as fa

    _build.CSRC = tree
    _build.BUILD_DIR = ROOT / "build" / f"kernel_ab_{tag}"
    _build._loaded.clear()
    fa._fns.clear()
    _build.load("flash_attention")


def ptxas_report(tag: str) -> list[str]:
    from tpuserve_torch.ops import _build

    log = _build.library_path("flash_attention").with_name(
        _build.library_path("flash_attention").name + ".log")
    out, name = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '\w*(flash_fwd_\w+?I\w+?)EEEv", line)
        if m:
            name = m.group(1)
        elif name and ("spill" in line or "registers" in line):
            out.append(f"{tag} {name}: {line.split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: FAIL: needs a CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tpuserve_torch.ops import flash_attention as fa

    trees = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    inputs = {(b, s): cs.qkv(b, s, s, 12, 64, torch.bfloat16, seed=7) for _, b, s in SHAPES}
    for tag, tree in trees.items():
        use(tree, tag)
        print("\n".join(ptxas_report(tag)))
        for b, s in inputs:
            cs.compare(*inputs[b, s])
        cs.compare_stats(*inputs[8, 2048])
    for tag in ("A", "B", "B", "A"):
        use(trees[tag], tag)
        row = {}
        for kernel, b, s in SHAPES:
            q, k, v, bias = inputs[b, s]
            stats = kernel == "K2"
            row[f"{kernel} ({b}, {s})"] = 1e3 * cs.time_ms(
                lambda: fa.flash_attention(q, k, v, bias, return_stats=stats), iters=20)
        print(json.dumps({"tree": tag, "dir": str(trees[tag]), "us": row}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
