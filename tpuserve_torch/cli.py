"""Command-line entry points of the port (``tpuserve/cli.py``'s).

Usage::

    python -m tpuserve_torch serve    --config serve.toml [--set port=9000 ...]
                                      [--device cuda|cpu|cuda:N]
    python -m tpuserve_torch bench    --url http://127.0.0.1:8000 --model resnet50 ...
    python -m tpuserve_torch chaos    --config chaos.toml --min-availability 0.99 \\
                                      [--drill reload|worker_kill|host_kill|stream_kill|
                                               fleet|autopilot]
                                      [--device ...]
    python -m tpuserve_torch warmup   --config serve.toml [--device ...]
    python -m tpuserve_torch describe [--device ...]
    python -m tpuserve_torch import-model --saved-model <SavedModel dir | .pb | torch ckpt>
                                      --family resnet50 --out weights.npz [--opt k=v ...]
    python -m tpuserve_torch lint     [paths ...] [--no-baseline] [--update-baseline]
                                      [--no-drift] [--json]

Flags, names and defaults are the reference's. The subcommands that build a
model (``serve``, ``chaos``, ``warmup``) and ``describe`` run on the current
CUDA device unless ``--device`` names another (``cpu`` included); without
CUDA they fail instead of falling back to the CPU. ``bench`` builds nothing:
it is the HTTP load generator (``tpuserve_torch.bench.loadgen``). With
``[router] enabled``, ``serve`` runs the router in this process and the
workers build the models on ``--device`` (with ``[router] hosts > 0`` under
host agents, with ``[router] routers > 1`` beside peer routers on the same
port); ``chaos --drill worker_kill``, ``--drill host_kill`` and ``--drill
stream_kill`` (``tpuserve_torch.workerproc.drill``) do the same with a
SIGKILL of a worker (of a whole host domain with ``host_kill``) mid-load and
exit 1 unless availability holds and every drill gate passes; ``chaos
--drill autopilot`` serves a tenant-fenced router fleet with the autopilot
on, floods it as a hostile tenant beside a victim one, and exits 1 unless
the victim's availability holds and every gate passes. Either way this
process never initializes CUDA. ``chaos --drill fleet``
(``tpuserve_torch.scheduler.run_fleet_drill``) serves the config's >= 3
models in this process with the scheduler on, poisons ``--model`` (the
victim) with ``device_error`` and gates the worst survivor's availability.

``import-model`` (``savedmodel.convert_cli``) converts a TF SavedModel, a
frozen GraphDef or a torch checkpoint into the port's ``.npz`` and its
manifest; it imports TensorFlow for the TF forms, so it runs where
TensorFlow is installed, and the card's machine serves the ``.npz``. Its
``--quantize int8`` writes the reference's weight-only int8 tree (serve it
with ``quantize = "int8"``); an orbax directory is refused by name with
exit code 2.

``lint`` (``tpuserve_torch.analysis.cli``) runs the reference's analysis
passes over ``tpuserve_torch/`` against the port's checked-in baseline:
exit 0 clean, 1 on a new finding, 2 on a bad path. It imports no torch, so
it runs on a bare Python.

Not ported, refused by name with exit code 2: ``finetune-det`` (ROADMAP.md
queue 1 item 13).
"""

from __future__ import annotations

import argparse
import json
import sys

# Subcommands of the reference that the port does not serve yet: what each
# is refused with.
UNPORTED_COMMANDS = {
    "finetune-det": "not yet ported: ROADMAP.md queue 1 item 13 (training)",
}
# The drills that serve a router over worker processes.
PROCESS_DRILLS = ("worker_kill", "host_kill", "stream_kill", "autopilot")


def _add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="TOML config path")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="dot-path override, e.g. --set model.bert.deadline_ms=2")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the current CUDA device; "
                        "'cpu' asks for the CPU)")


def _add_bench_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--url", default="http://127.0.0.1:8000")
    p.add_argument("--model", default="resnet50")
    p.add_argument("--verb", default="predict")
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--warmup", type=float, default=2.0)
    p.add_argument("--concurrency", type=int, default=64,
                   help="closed-loop workers (ignored with --rate)")
    p.add_argument("--rate", type=float, default=None,
                   help="open-loop offered rate (req/s); switches to open-loop mode")
    p.add_argument("--payload", default=None, help="file to POST; default synthetic image")
    p.add_argument("--content-type", default="application/x-npy")
    p.add_argument("--batch", type=int, default=0,
                   help="client-side batch: POST (N,H,W,3) npy bodies; "
                        "throughput counts items")
    p.add_argument("--distinct", type=int, default=0,
                   help="cycle N distinct synthetic payloads — a miss-only "
                        "workload for the result cache when N exceeds its "
                        "capacity; 0/1 repeats one payload (hit-heavy once the "
                        "cache is warm)")
    p.add_argument("--synthetic", choices=["npy", "jpeg", "prompt", "sd-prompt"],
                   default="npy",
                   help="synthetic payload kind for --distinct pools: npy/jpeg "
                        "images (jpeg needs PIL), or JSON prompt bodies for the "
                        "generative families (prompt = textgen with mixed "
                        "max_new_tokens, sd-prompt = fixed-steps txt2img)")
    p.add_argument("--edge", type=int, default=256,
                   help="synthetic payload image edge for --distinct")
    p.add_argument("--max-new", default="2,32",
                   help="lo,hi range of max_new_tokens for --synthetic prompt "
                        "pools (mixed output lengths)")
    p.add_argument("--wire", choices=["npy", "frame"], default="npy",
                   help="client wire: npy bodies, or framed binary multi-item "
                        "bodies (application/x-tpuserve-frame — zero-copy "
                        "server parse; --batch sets items per frame, "
                        "--frame-kind the pixel layout)")
    p.add_argument("--frame-kind", choices=["yuv420", "rgb8"], default="yuv420",
                   help="--wire frame item layout; must match the served "
                        "model's wire_format")
    p.add_argument("--procs", type=int, default=1,
                   help="load-worker processes; > 1 splits --concurrency (and "
                        "--rate) across workers with disjoint synthetic seed "
                        "ranges and merges exact percentiles — so the measured "
                        "bottleneck is the server, not one client process's "
                        "event loop")
    p.add_argument("--seed-base", type=int, default=0,
                   help="first synthetic seed (multi-process workers take "
                        "disjoint ranges automatically)")
    p.add_argument("--dump-latencies", default=None,
                   help="write raw latency samples as JSON to this path (the "
                        "multi-process merge reads them)")
    p.add_argument("--stream", action="store_true",
                   help="closed-loop STREAMING mode (?stream=true, SSE): "
                        "reports first-token p50/p99, inter-token-gap "
                        "p50/p99/max + histogram, and exact tokens/s from token "
                        "event timestamps; use with --synthetic prompt against "
                        "a generative model (--rate/--procs don't apply)")
    p.add_argument("--long-every", type=int, default=0,
                   help="skew the --synthetic prompt pool: every Nth body is a "
                        "--long-words-word prompt at the top of --max-new "
                        "(0 = uniform pool)")
    p.add_argument("--long-words", type=int, default=16,
                   help="prompt length (words) of the injected long bodies for "
                        "--long-every")


def _add_chaos_args(p: argparse.ArgumentParser) -> None:
    _add_config_args(p)
    _add_device_arg(p)
    p.add_argument("--model", default=None,
                   help="model to load test (default: first configured)")
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--warmup", type=float, default=1.0)
    p.add_argument("--concurrency", type=int, default=16)
    p.add_argument("--rate", type=float, default=None,
                   help="open-loop offered rate (req/s); default closed loop")
    p.add_argument("--min-availability", type=float, default=0.0,
                   help="exit non-zero when n_ok/(n_ok+n_err) falls below this")
    p.add_argument("--drill", choices=["reload", "fleet", *PROCESS_DRILLS],
                   default=None,
                   help="additionally drive a drill during the run: 'reload' "
                        "POSTs :reload on an interval so reload_* fault rules "
                        "prove the lifecycle gates hold availability; "
                        "'worker_kill' serves a router + worker fleet and "
                        "SIGKILLs one worker mid-load (availability, respawn "
                        "time, zero torn or duplicate answers); 'host_kill' "
                        "serves >= 2 host domains and SIGKILLs one whole domain "
                        "(its process group) mid-load (availability, re-absorb "
                        "time, zero torn or duplicate answers, survivors' "
                        "compiles unchanged); 'stream_kill' "
                        "does so under mixed streaming + unary load on a "
                        "generative model (zero torn or reordered streams, "
                        "streams equal to a seeded reference); 'fleet' loads "
                        "every model of a >= 3-model config with --model "
                        "poisoned (device_error at 100%%) and gates the worst "
                        "survivor; 'autopilot' serves a tenant-fenced fleet "
                        "with the autopilot on and floods it as a hostile "
                        "tenant beside a victim tenant (the victim's "
                        "availability is gated)")
    p.add_argument("--drill-interval", type=float, default=0.5,
                   help="seconds between drill operations")
    p.add_argument("--kill-after", type=float, default=None,
                   help="worker_kill/host_kill/stream_kill: seconds after warmup "
                        "before the SIGKILL (default: 25%% of the run)")
    p.add_argument("--respawn-budget", type=float, default=120.0,
                   help="worker_kill/host_kill/stream_kill: seconds the killed "
                        "worker (or host, with all its workers) has to come "
                        "back healthy (backoff + boot)")


def _parse_opt_args(parser: argparse.ArgumentParser, items: list[str]) -> dict:
    """--opt KEY=VALUE pairs -> {key: TOML-parsed value}."""
    from tpuserve_torch.config import _parse_toml_value

    options = {}
    for item in items:
        if "=" not in item:
            parser.error(f"--opt must look like key=value, got {item!r}")
        key, _, text = item.partition("=")
        options[key.strip()] = _parse_toml_value(text.strip())
    return options


def _load(parser: argparse.ArgumentParser, args):
    from tpuserve_torch.config import load_config

    cfg = load_config(args.config, args.overrides)
    if not cfg.models:
        parser.error("the config names no [[model]]")
    return cfg


def _refuse(what: str, why: str) -> int:
    print(f"tpuserve_torch: {what}: {why}", file=sys.stderr)
    return 2


def describe(device: str | None) -> dict:
    """The device and mesh inventory: every visible CUDA device, or the CPU
    with ``device="cpu"``; raises without CUDA otherwise."""
    import torch

    from tpuserve_torch.parallel.mesh import AXES, MeshPlan
    from tpuserve_torch.runtime import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        devices = ["cpu"]
    else:
        devices = [f"cuda:{i} ({torch.cuda.get_device_name(i)})"
                   for i in range(torch.cuda.device_count())]
    return {"devices": devices,
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "mesh": dict(zip(AXES, MeshPlan().resolve(len(devices))))}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="tpuserve_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_serve = sub.add_parser("serve", help="start the inference server")
    _add_config_args(p_serve)
    _add_device_arg(p_serve)

    _add_bench_args(sub.add_parser("bench", help="run the HTTP load generator"))

    _add_chaos_args(sub.add_parser(
        "chaos",
        help="serve a fault-injected config on an ephemeral port, drive the load "
             "generator at it, and report availability (staging drills)"))

    p_warm = sub.add_parser(
        "warmup",
        help="build the kernels, every runtime and every bucket's CUDA graphs, and "
             "print each runtime's describe(); CUDA graphs cannot be persisted "
             "the way the XLA cache is, so what persists is the kernels' nvcc "
             "build (build/kernels/)")
    _add_config_args(p_warm)
    _add_device_arg(p_warm)

    p_desc = sub.add_parser("describe", help="print device / mesh inventory")
    _add_device_arg(p_desc)

    p_imp = sub.add_parser(
        "import-model",
        help="convert a TF SavedModel / GraphDef (or a torch checkpoint) -> the "
             "port's .npz and its manifest")
    p_imp.add_argument("--saved-model", required=True)
    p_imp.add_argument("--family", required=True)
    p_imp.add_argument("--out", required=True)
    p_imp.add_argument("--opt", action="append", default=[], metavar="KEY=VALUE",
                       help="model option for the import (TOML-parsed value), "
                            "e.g. --opt vocab_file=vocab.txt --opt layers=24")
    p_imp.add_argument("--quantize", choices=["int8"], default=None,
                       help="write the weight-only int8 tree (serve it with "
                            "quantize = \"int8\")")

    p_lint = sub.add_parser(
        "lint",
        help="concurrency, capture-discipline, ledger and drift analysis over "
             "tpuserve_torch/; fails on findings not in the checked-in baseline")
    from tpuserve_torch.analysis.cli import add_lint_args

    add_lint_args(p_lint)

    for name, why in UNPORTED_COMMANDS.items():
        sub.add_parser(name, help=why)

    # A refused subcommand is refused whatever its arguments (the
    # reference's); every other one takes only its own.
    args, extra = parser.parse_known_args(argv)
    if args.cmd in UNPORTED_COMMANDS:
        return _refuse(args.cmd, UNPORTED_COMMANDS[args.cmd])
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")

    if args.cmd == "lint":
        from tpuserve_torch.analysis.cli import run_lint

        return run_lint(args)

    if args.cmd == "serve":
        from tpuserve_torch.server import serve

        serve(_load(parser, args), device=args.device)
        return 0

    if args.cmd == "bench":
        from tpuserve_torch.bench.loadgen import run_loadgen_cli

        return run_loadgen_cli(args)

    if args.cmd == "chaos":
        import asyncio

        from tpuserve_torch.server import ServerState, configure_logging

        cfg = _load(parser, args)
        configure_logging(cfg)
        model = args.model or cfg.models[0].name
        if args.drill in PROCESS_DRILLS:
            # This process is the router: it stays free of CUDA, the workers
            # build the models on --device.
            from tpuserve_torch.workerproc import drill

            kw = dict(duration_s=args.duration, warmup_s=args.warmup,
                      concurrency=args.concurrency, kill_after_s=args.kill_after,
                      device=args.device or "cuda")
            if args.drill == "autopilot":
                del kw["kill_after_s"]
                summary = asyncio.run(drill.run_autopilot_drill(cfg, model, **kw))
            elif args.drill == "host_kill":
                summary = asyncio.run(drill.run_host_kill_drill(
                    cfg, model, reabsorb_budget_s=args.respawn_budget, **kw))
            else:
                run = (drill.run_worker_kill_drill if args.drill == "worker_kill"
                       else drill.run_stream_kill_drill)
                summary = asyncio.run(run(cfg, model, respawn_budget_s=args.respawn_budget,
                                          **kw))
            print(json.dumps(summary, indent=2))
            return 0 if (summary["availability"] >= args.min_availability
                         and all(summary["gates"].values())) else 1
        if args.drill == "fleet":
            # --model names the VICTIM; the gated availability is the worst
            # survivor's.
            from tpuserve_torch.scheduler import run_fleet_drill

            summary = asyncio.run(run_fleet_drill(
                cfg, victim=model, duration_s=args.duration, warmup_s=args.warmup,
                concurrency=args.concurrency, device=args.device))
            print(json.dumps(summary, indent=2))
            return 0 if summary["availability"] >= args.min_availability else 1
        from tpuserve_torch.faults import run_chaos

        state = ServerState(cfg, device=args.device)
        state.build()
        summary = asyncio.run(run_chaos(
            state, model, duration_s=args.duration, warmup_s=args.warmup,
            concurrency=args.concurrency, rate_per_s=args.rate,
            edge=cfg.model(model).wire_size, drill=args.drill,
            drill_interval_s=args.drill_interval))
        print(json.dumps(summary, indent=2))
        return 0 if summary["availability"] >= args.min_availability else 1

    if args.cmd == "warmup":
        from tpuserve_torch.server import ServerState, configure_logging

        cfg = _load(parser, args)
        configure_logging(cfg)
        state = ServerState(cfg, device=args.device)
        state.build()
        print(json.dumps({n: rt.describe() for n, rt in state.runtimes.items()}, indent=2))
        for pool in state.pools().values():
            pool.close()  # a recycle model's workers: stopped, segments unlinked
        return 0

    if args.cmd == "import-model":
        from tpuserve_torch import savedmodel

        try:
            savedmodel.convert_cli(args.saved_model, args.family, args.out,
                                   _parse_opt_args(parser, args.opt), quantize=args.quantize)
        except NotImplementedError as e:  # an orbax directory
            return _refuse("import-model", str(e))
        return 0

    if args.cmd == "describe":
        print(json.dumps(describe(args.device), indent=2))
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
