"""Command-line entry point of the port (``tpuserve/cli.py``'s ``serve``).

Usage::

    python -m tpuserve_torch serve --config serve.toml [--set port=9000 ...]
                                   [--device cuda|cpu|cuda:N]

The server runs on the current CUDA device unless ``--device cpu`` asks for
the CPU. The JAX package's other subcommands (bench, chaos, import-model,
warmup, lint, describe) are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="tpuserve_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_serve = sub.add_parser("serve", help="start the inference server")
    p_serve.add_argument("--config", default=None, help="TOML config path")
    p_serve.add_argument("--set", dest="overrides", action="append", default=[],
                         help="dot-path override, e.g. --set model.bert.deadline_ms=2")
    p_serve.add_argument("--device", default=None,
                         help="torch device to serve on (default: the current CUDA device)")
    args = parser.parse_args(argv)

    from tpuserve_torch.config import load_config
    from tpuserve_torch.server import serve

    cfg = load_config(args.config, args.overrides)
    if not cfg.models:
        parser.error("the config names no [[model]]")
    serve(cfg, device=args.device)
    return 0
