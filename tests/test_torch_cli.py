"""The port's command line (``python -m tpuserve_torch``) against the
reference's (``python -m tpuserve``), on the CPU: ``describe``, ``warmup``,
``chaos`` and ``bench`` on the same inputs, and the subcommands and drills
the port refuses.

- ``describe --device cpu``: the reference's keys and platform ``cpu``;
  without CUDA and without ``--device cpu`` it fails, never reporting the
  CPU quietly.
- ``warmup --device cpu`` on a toy config: every bucket, as the reference
  lists them, and a raw forward probe per bucket.
- ``chaos --device cpu``: exit 0 at ``--min-availability 0.99`` under a
  10 % ``batch_error`` rule with the reload drill (every reload refused by
  ``reload_corrupt``), exit 1 when the rule fires on every batch; both
  packages alike.
- ``bench`` against the standard-library stub of
  ``tests/test_torch_loadgen.py``: ``--dump-latencies`` writes the summary
  it prints and one sample per completion; ``--procs 2`` merges two worker
  processes' exact samples; the summaries have the reference's keys.
- ``bench --synthetic prompt`` (a pool of distinct prompts with mixed
  ``max_new_tokens`` and the ``--long-every`` skew) against the port's
  textgen served on the CPU through its generation engine: ``n_err`` 0, the
  summary keys equal to the reference's load generator's against the same
  server, and the server's token and fold-in counters moving;
- ``import-model``, ``finetune-det``, ``lint`` and the drills ``host_kill``,
  ``fleet`` and ``autopilot`` exit 2 naming their ROADMAP item (the
  ``worker_kill`` and ``stream_kill`` drills run against the port:
  ``tests/test_torch_drill.py``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_loadgen import Stub
from tpuserve.cli import main as jax_main
from tpuserve_torch.cli import UNPORTED_COMMANDS, UNPORTED_DRILLS
from tpuserve_torch.cli import main as port_main

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
MAINS = {"jax": jax_main, "port": port_main}
TOY_TOML = """
roofline_probe_iters = 2
decode_threads = 2

[[model]]
name = "toy"
family = "toy"
batch_buckets = [1, 2, 4]
deadline_ms = 5.0
dtype = "float32"
num_classes = 10
parallelism = "single"
request_timeout_ms = 10000.0
wire_size = 8
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def run_main(pkg: str, argv: list[str], capsys) -> tuple[int, str]:
    capsys.readouterr()
    rc = MAINS[pkg](argv)
    return rc, capsys.readouterr().out


def port_args(pkg: str, *args: str) -> list[str]:
    """``--device cpu`` for the port (its default is CUDA); the reference
    takes no such flag."""
    return [*args, "--device", "cpu"] if pkg == "port" else list(args)


def test_describe(capsys, monkeypatch):
    outs = {pkg: json.loads(run_main(pkg, port_args(pkg, "describe"), capsys)[1])
            for pkg in MAINS}
    assert sorted(outs["port"]) == sorted(outs["jax"]) == ["devices", "mesh", "platform"]
    assert outs["port"]["platform"] == outs["jax"]["platform"] == "cpu"
    assert outs["port"]["devices"] == ["cpu"]
    assert outs["port"]["mesh"] == {"data": 1, "model": 1, "seq": 1}
    assert sorted(outs["port"]["mesh"]) == sorted(outs["jax"]["mesh"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["describe"])


def test_warmup_lists_every_bucket(tmp_path, capsys):
    path = tmp_path / "toy.toml"
    path.write_text(TOY_TOML)
    outs = {}
    for pkg in MAINS:
        rc, out = run_main(pkg, port_args(pkg, "warmup", "--config", str(path)), capsys)
        assert rc == 0
        outs[pkg] = json.loads(out)
    assert list(outs["port"]) == list(outs["jax"]) == ["toy"]
    port, jax = outs["port"]["toy"], outs["jax"]["toy"]
    assert port["buckets"] == jax["buckets"] == [[1], [2], [4]]
    assert port["device"] == "cpu" and port["compiles_total"] == 3
    assert sorted(port["raw_ms_per_batch"]) == ["[1]", "[2]", "[4]"]
    assert all(v > 0 for v in port["raw_ms_per_batch"].values())


@pytest.mark.parametrize("probability, want_rc", [(0.1, 0), (1.0, 1)])
def test_chaos_gate_both_ways(tmp_path, capsys, probability, want_rc):
    """The CLI's availability gate: exit 0 when the retry carries a 10 %
    batch-failure rate past 0.99 (every drilled reload refused, version 1
    serving), exit 1 when every batch fails."""
    path = tmp_path / "chaos.toml"
    path.write_text(TOY_TOML.replace("roofline_probe_iters = 2", "") + f"""
[faults]
enabled = true
seed = 1

[[faults.rule]]
kind = "batch_error"
model = "toy"
probability = {probability}

[[faults.rule]]
kind = "reload_corrupt"
model = "toy"
""")
    for pkg in MAINS:
        rc, out = run_main(pkg, port_args(
            pkg, "chaos", "--config", str(path), "--duration", "1.5", "--warmup", "0.3",
            "--concurrency", "8", "--min-availability", "0.99", "--drill", "reload",
            "--drill-interval", "0.2"), capsys)
        summary = json.loads(out)
        assert rc == want_rc, (pkg, summary)
        assert summary["reload_drill"]["ok"] == 0
        assert summary["lifecycle"]["toy"]["live_version"] == 1
        assert summary["faults"][0]["fired"] > 5
        if want_rc == 0:
            assert summary["availability"] >= 0.99
            assert summary["breakers"]["toy"]["state"] == "closed"
        else:
            assert summary["availability"] < 0.99


def bench_argv(url: str, payload: Path, *extra: str) -> list[str]:
    return ["bench", "--url", url, "--model", "m", "--duration", "0.8", "--warmup", "0.2",
            "--concurrency", "4", "--payload", str(payload),
            "--content-type", "application/json", *extra]


def test_bench_dump_latencies_and_procs(tmp_path, capsys):
    payload = tmp_path / "texts.json"
    payload.write_text(json.dumps({"texts": ["a b c"] * 32}))
    dumps, summaries = {}, {}
    with Stub(delay_s=0.005) as stub:
        # The port's entry point as a user runs it.
        dump = tmp_path / "port.json"
        out = subprocess.run(
            [sys.executable, "-m", "tpuserve_torch",
             *bench_argv(stub.base, payload, "--dump-latencies", str(dump))],
            cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        summaries["port"], dumps["port"] = json.loads(out.stdout), json.loads(dump.read_text())
        dump = tmp_path / "jax.json"
        rc, out = run_main("jax", bench_argv(stub.base, payload, "--dump-latencies",
                                             str(dump)), capsys)
        assert rc == 0
        summaries["jax"], dumps["jax"] = json.loads(out), json.loads(dump.read_text())
        assert stub.bodies[0] == payload.read_bytes()
        merged = {}
        for pkg in MAINS:
            rc, out = run_main(pkg, bench_argv(stub.base, payload, "--procs", "2",
                                               "--rate", "100"), capsys)
            assert rc == 0, pkg
            merged[pkg] = json.loads(out)
    for pkg in MAINS:
        s, d = summaries[pkg], dumps[pkg]
        assert s == d["summary"] and s["n_ok"] == len(d["latencies_ms"]) > 0
        assert s["n_err"] == 0 and s["mode"] == "closed"
        m = merged[pkg]
        assert m["load_workers"] == 2 and m["mode"] == "open" and m["n_err"] == 0
        assert m["offered_rate_per_s"] == 50.0  # each worker's half of --rate
        assert 40 <= m["n_ok"] <= 100  # ~80 completions in the 0.8 s windows
    assert sorted(summaries["port"]) == sorted(summaries["jax"])
    assert sorted(merged["port"]) == sorted(merged["jax"])


def test_bench_frame_wire_and_synthetic_payloads(capsys):
    """``--wire frame`` posts the framed body ``synthetic_frame`` builds,
    ``--distinct`` cycles a pool, as the reference's do."""
    with Stub() as stub:
        rc, out = run_main("port", ["bench", "--url", stub.base, "--model", "m",
                                    "--duration", "0.3", "--warmup", "0.0", "--concurrency", "2",
                                    "--wire", "frame", "--edge", "16", "--batch", "4"], capsys)
        assert rc == 0 and json.loads(out)["items_per_request"] == 4
        from tpuserve.bench.loadgen import synthetic_frame

        assert set(stub.bodies) == {synthetic_frame(16, 4, "yuv420", seed=0)}
    with Stub() as stub:
        rc, out = run_main("port", ["bench", "--url", stub.base, "--model", "m",
                                    "--duration", "0.3", "--warmup", "0.0", "--concurrency", "2",
                                    "--distinct", "3", "--edge", "8"], capsys)
        assert rc == 0 and json.loads(out)["distinct_payloads"] == 3
        assert len(set(stub.bodies)) == 3


@pytest.mark.parametrize("argv, item", [
    (["import-model", "--saved-model", "d", "--family", "resnet50", "--out", "o"],
     "needs TensorFlow (import-model converts a TF SavedModel; ROADMAP.md lists "
     "it as never ported)"),
    (["finetune-det", "--out", "o"], "ROADMAP.md queue 1 item 13"),
    (["lint"], "ROADMAP.md queue 1 item 12"),
    *[(["chaos", "--drill", drill], "ROADMAP.md queue 1 item") for drill in UNPORTED_DRILLS],
    # host_kill is served since host failure domains were ported; this case
    # (keeping its id) holds that a refused drill is refused whatever the
    # run's own arguments.
    pytest.param(["chaos", "--drill", "autopilot", "--duration", "1", "--concurrency", "2"],
                 "ROADMAP.md queue 1 item 11b", id="argv5-ROADMAP.md queue 1 item"),
])
def test_refused_subcommands_and_drills_exit_2(argv, item, capsys):
    assert port_main(argv) == 2
    err = capsys.readouterr().err
    assert "not" in err and "ported" in err
    assert item in err
    assert set(UNPORTED_COMMANDS) == {"import-model", "finetune-det", "lint"}


def test_unknown_arguments_still_refused(capsys):
    with pytest.raises(SystemExit) as e:
        port_main(["describe", "--device", "cpu", "--no-such-flag"])
    assert e.value.code == 2 and "--no-such-flag" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--kill-after", "--respawn-budget"])
def test_unported_drill_flags_refused(flag, capsys):
    """The reference's worker_kill options came with that drill; a drill
    still refused (fleet, ROADMAP.md item 11b) is refused by name with
    them too, before any config is read, and no process drill is left in
    the refusal table."""
    assert port_main(["chaos", "--device", "cpu", "--drill", "fleet", flag, "5"]) == 2
    err = capsys.readouterr().err
    assert "chaos --drill fleet: not yet ported: ROADMAP.md queue 1 item 11b" in err
    assert not {"worker_kill", "host_kill", "stream_kill"} & set(UNPORTED_DRILLS)


TEXTGEN_TOML = """
decode_threads = 2

[genserve]
enabled = true
slots = 4

[[model]]
name = "tg"
family = "textgen"
batch_buckets = [1, 2, 4]
dtype = "float32"
parallelism = "single"
request_timeout_ms = 60000.0

[model.options]
layers = 1
d_model = 32
heads = 2
d_ff = 64
vocab_size = 512
prompt_len = 16
max_new_tokens = 64
"""


def test_bench_prompt_pool_against_served_textgen(tmp_path, capsys):
    """The generative load against the engine-served textgen: each
    package's ``bench`` with a prompt pool, mixed lengths and a long-prompt
    skew, closed loop; both summaries error-free with the same keys."""
    import asyncio
    import threading

    from tpuserve_torch.config import load_config
    from tpuserve_torch.server import ServerState, start_server, stop_server

    path = tmp_path / "tg.toml"
    path.write_text(TEXTGEN_TOML)
    state = ServerState(load_config(str(path)), device="cpu")
    state.build()
    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()
    srv = asyncio.run_coroutine_threadsafe(start_server(state, "127.0.0.1", 0), loop).result(60)
    url = f"http://127.0.0.1:{state.serving_addresses[0][1]}"
    argv = ["bench", "--url", url, "--model", "tg", "--verb", "generate", "--duration", "1.0",
            "--warmup", "0.2", "--concurrency", "4", "--content-type", "application/json",
            "--synthetic", "prompt", "--distinct", "16", "--max-new", "2,12",
            "--long-every", "4"]
    try:
        summaries = {}
        for pkg in MAINS:
            rc, out = run_main(pkg, argv, capsys)
            assert rc == 0, (pkg, out)
            summaries[pkg] = json.loads(out)
        units = state.metrics.counter("gen_units_total{model=tg}").value
        stats = state.engines["tg"].pipeline_stats()
    finally:
        asyncio.run_coroutine_threadsafe(stop_server(state, srv), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
    for pkg, s in summaries.items():
        assert s["n_ok"] > 0 and s["n_err"] == 0 and s["distinct_payloads"] == 16, (pkg, s)
    assert sorted(summaries["port"]) == sorted(summaries["jax"])
    # Mixed lengths: the server retired tokens, folded requests into a
    # generating block and let short ones exit early.
    n_ok = sum(s["n_ok"] for s in summaries.values())
    assert units >= 2 * n_ok
    assert stats["fold_ins_total"] > 0 and stats["early_exits_total"] > 0
