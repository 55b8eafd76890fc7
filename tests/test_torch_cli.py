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
- ``finetune-det`` exits 2 naming its ROADMAP item, ``import-model
  --quantize int8`` (ported) exits 0 and writes the reference's
  ``quantize_tree`` of its input, and ``lint`` (ported) exits 0 against the
  port's baseline (the ``worker_kill``, ``host_kill`` and ``stream_kill``
  drills run against the port: ``tests/test_torch_drill.py``);
- ``chaos --drill fleet`` (3 toy models, one poisoned) exits 0 with the
  victim's breaker open and the survivors whole, with the reference's
  summary keys against the reference's own run on the same config; ``chaos
  --drill autopilot`` (a toy router fleet over 2 host domains with tenants
  and the autopilot, a hostile tenant flooding) exits 0 with every gate;
  the process drills' flags are accepted by the fleet drill, the
  reference's way.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_loadgen import Stub
from tpuserve.cli import main as jax_main
from tpuserve_torch.cli import PROCESS_DRILLS, UNPORTED_COMMANDS
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
    # import-model --quantize int8 is ported since item 14b: this case
    # (keeping its id) converts a toy .npz and holds the int8 tree it
    # writes to the reference's quantize_tree of the same float tree.
    pytest.param(["import-model", "--family", "toy", "--quantize", "int8",
                  "--opt", "quantize_min_size=256"], "int8",
                 id="argv0-ROADMAP.md queue 1: item 14b"),
    (["finetune-det", "--out", "o"], "ROADMAP.md queue 1 item 13"),
    # lint is ported since the analysis item (12): this case (keeping its
    # id) holds that it runs over tpuserve_torch/ and exits 0 against the
    # port's checked-in baseline.
    pytest.param(["lint"], None, id="argv2-ROADMAP.md queue 1 item 12"),
])
def test_refused_subcommands_and_drills_exit_2(argv, item, capsys, tmp_path):
    assert set(UNPORTED_COMMANDS) == {"finetune-det"}
    if item == "int8":
        from tpuserve import quantize as jqz
        from tpuserve_torch import savedmodel
        from tpuserve_torch.config import ModelConfig
        from tpuserve_torch.models import build
        from tpuserve_torch.utils.trees import flatten_with_paths

        model = build(ModelConfig(name="toy", family="toy"))
        tree = model.to_jax_params(model.init_params(1))
        src, out = str(tmp_path / "toy.npz"), str(tmp_path / "toy_q8.npz")
        savedmodel.save_npz(src, tree)
        assert port_main(argv + ["--saved-model", src, "--out", out]) == 0
        got = list(flatten_with_paths(savedmodel.load_npz(out)))
        want = list(flatten_with_paths(jqz.quantize_tree(tree, 256)))
        assert [p for p, _ in got] == [p for p, _ in want]
        assert any(p.endswith("['q8']") for p, _ in got)
        assert all(g.dtype == np.asarray(w).dtype and np.array_equal(g, w)
                   for (_, g), (_, w) in zip(got, want))
        return
    if item is None:
        assert port_main(argv) == 0
        assert "0 new" in capsys.readouterr().err
        return
    assert port_main(argv) == 2
    err = capsys.readouterr().err
    assert "not" in err and "ported" in err
    assert item in err




def fleet_toml(cold_start: bool) -> str:
    """Three toy models behind the scheduler, ``ok_a`` declared cold_start
    (the port's drill warms a cold survivor before the clock; the
    reference's does not, so its runs take none)."""
    return "decode_threads = 2\nstartup_canary = false\n[scheduler]\nenabled = true\n" + "".join(
        f"""
[[model]]
name = "{name}"
family = "toy"
batch_buckets = [1, 2, 4]
dtype = "float32"
num_classes = 10
parallelism = "single"
request_timeout_ms = 10000.0
wire_size = 8
breaker_threshold = 3
cold_start = {str(cold_start and name == "ok_a").lower()}
""" for name in ("victim", "ok_a", "ok_b"))

# The reference's scripts/autopilot_drill.sh config with three changes for
# a short run on a loaded CPU: the fault armed 2 s after the worker's boot
# (the drill is shorter than the script's); the hostile tenant's quota 30
# device-seconds, not 3 (the flood spent 3 within its first second, every
# request charging its wall time, and the pressure the controller reads
# went with it; its rate limit still sheds it with tenant_rate_exceeded);
# and pressure_high 0.5, not 1.5 (the router routes around the slowed
# worker, so its domain held more than 1.5 relays per slot for two ticks in
# some runs only; at 0.5 one relay in flight on a one-slot domain is a
# trigger).
AUTOPILOT_TOML = """
decode_threads = 2
startup_canary = false
drain_timeout_s = 5.0
watchdog_interval_s = 0.2

[telemetry]
sample_interval_s = 0.25
burn_windows_s = [5.0, 30.0, 120.0]

[router]
enabled = true
hosts = 2
workers = 2
active_workers = 1
retry_max = 3
hedge_ms = 500.0
health_interval_s = 0.2
respawn_initial_s = 0.5
respawn_max_s = 5.0

[autopilot]
enabled = true
interval_s = 0.25
hysteresis_ticks = 2
cooldown_s = 3.0
window_s = 30.0
max_actions_per_window = 8
follow_up_s = 5.0
pressure_high = 0.5
pressure_low = 0.05

[tenants]
enabled = true
window_s = 30.0
slo_latency_ms = 2000.0
slo_availability = 0.99

[[tenants.tenant]]
name = "hostile"
api_key = "drill-hostile-key"
weight = 1.0
quota_device_s = 30.0
rate_per_s = 40.0

[[tenants.tenant]]
name = "victim"
api_key = "drill-victim-key"
weight = 4.0

[faults]
enabled = true
seed = 7

[[faults.rule]]
kind = "worker_slow"
model = "*"
probability = 1.0
delay_ms = 250.0
after_s = 2.0
worker = 2

[[model]]
name = "toy"
family = "toy"
batch_buckets = [1, 2]
deadline_ms = 2.0
dtype = "float32"
num_classes = 10
parallelism = "single"
request_timeout_ms = 10000.0
wire_size = 8
"""
FLEET_ARGS = ("--drill", "fleet", "--model", "victim", "--duration", "1.5", "--warmup", "0.3",
              "--concurrency", "4", "--min-availability", "0.99")


def fleet_check(summary: dict) -> None:
    assert summary["victim"] == "victim" and summary["victim_breaker_open"]
    assert summary["availability"] >= 0.99
    assert {n: r["role"] for n, r in summary["models"].items()} == {
        "victim": "victim", "ok_a": "survivor", "ok_b": "survivor"}
    assert summary["scheduler"]["models"]["ok_a"]["state"] == "warm"


@pytest.mark.parametrize("case", ["fleet", "fleet_against_reference", "autopilot"])
def test_fleet_and_autopilot_drills_exit_0(case, tmp_path, capsys):
    """Served since the fleet scheduler, tenants and the autopilot were
    ported (until then these cases were refusals, exit 2): ``chaos --drill
    fleet`` on the CPU exits 0 (the worst survivor at >= 0.99, the victim's
    breaker open, the cold survivor warmed before the clock), with the
    summary keys of the reference's own run on the same config (the port
    adds ``kernels``); ``chaos --drill autopilot`` exits 0 with every gate
    of the reference's scripts/autopilot_drill.sh and the victim at >=
    0.97."""
    path = tmp_path / "drill.toml"
    if case == "autopilot":
        assert "autopilot" in PROCESS_DRILLS
        path.write_text(AUTOPILOT_TOML)
        rc, out = run_main("port", ["chaos", "--config", str(path), "--device", "cpu",
                                    "--drill", "autopilot", "--duration", "8", "--warmup", "0.5",
                                    "--concurrency", "8", "--min-availability", "0.97"], capsys)
        summary = json.loads(out)
        assert rc == 0, summary["gates"]
        assert all(summary["gates"].values()) and summary["availability"] >= 0.97
        assert summary["tenants"]["hostile"]["n_429"] > 0
        assert set(summary["autopilot"]["action_kinds"]) & {"scale_up", "shed_on"}
        return
    path.write_text(fleet_toml(cold_start=case == "fleet"))
    rc, out = run_main("port", ["chaos", "--config", str(path), "--device", "cpu",
                                *FLEET_ARGS], capsys)
    summary = json.loads(out)
    assert rc == 0
    fleet_check(summary)
    if case == "fleet_against_reference":
        rc, out = run_main("jax", ["chaos", "--config", str(path), *FLEET_ARGS], capsys)
        ref = json.loads(out)
        assert rc == 0
        fleet_check(ref)
        assert sorted(summary) == sorted([*ref, "kernels"])
        assert sorted(summary["scheduler"]) == sorted(ref["scheduler"])
        assert sorted(summary["models"]["ok_b"]) == sorted(ref["models"]["ok_b"])


def test_unknown_arguments_still_refused(capsys):
    with pytest.raises(SystemExit) as e:
        port_main(["describe", "--device", "cpu", "--no-such-flag"])
    assert e.value.code == 2 and "--no-such-flag" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--kill-after", "--respawn-budget"])
def test_unported_drill_flags_refused(flag, tmp_path, capsys):
    """The reference's worker_kill options came with that drill. Until the
    fleet drill was ported it was refused by name with them; since, it
    takes them as the reference's CLI does (and does not use them): the
    drill runs and exits 0. No drill is refused any more."""
    path = tmp_path / "fleet.toml"
    path.write_text(fleet_toml(cold_start=True))
    rc, out = run_main("port", ["chaos", "--config", str(path), "--device", "cpu",
                                *FLEET_ARGS, flag, "5"], capsys)
    assert rc == 0
    fleet_check(json.loads(out))
    assert {"worker_kill", "host_kill", "stream_kill", "autopilot"} == set(PROCESS_DRILLS)


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
