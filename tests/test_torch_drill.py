"""The ``worker_kill``, ``host_kill`` and ``stream_kill`` drills (``python -m
tpuserve_torch chaos --drill ...``, ``tpuserve_torch.workerproc.drill``)
against the port on the CPU, at a small size: a router over 2 spawned
workers (2 host domains of 2 workers for ``host_kill``) serving a narrow
seeded BERT-flash (2 layers, d_model 32) or textgen (2 layers, d_model 64),
one worker (one whole domain) SIGKILLed under load.

The reference's gates (``tpuserve/workerproc/drill.py``):

- ``worker_kill``: availability >= 0.99 over the run, the killed slot back
  healthy within the respawn budget (backoff + boot), zero torn responses
  (every validated 200 body equal to a pre-kill reference, per batch
  bucket) and zero duplicates (every answer carries back its request's own
  trace id); the reaped worker's postmortem names SIGKILL. The CLI exits 0
  with all of them and 1 when one breaks (a respawn budget no boot meets).
- ``stream_kill``: zero torn streams (each started stream ends in exactly
  one terminal event, the router writing it for the streams the SIGKILL
  cut), zero order violations (token indices 0..n-1), every done stream's
  text equal to the unary reference of the same seeded body and every
  error-terminated one a prefix of it, the survivor's compile count
  unchanged; the router's terminations counted under the closed
  vocabulary.
- ``host_kill``: availability >= 0.99 with one whole host domain killed
  (``killpg`` of its agent's process group), the domain back (agent and
  every worker healthy) within the re-absorb budget, zero torn and zero
  duplicate answers, the surviving workers' compile counts unchanged; the
  CLI exits 1 when a gate breaks.
"""

import asyncio
import json
import os

import pytest
import torch

from tpuserve_torch.cli import main as port_main
from tpuserve_torch.config import load_config
from tpuserve_torch.obs import ROUTER_STREAM_REASONS
from tpuserve_torch.workerproc.drill import run_stream_kill_drill

BERT_TOML = """
host = "127.0.0.1"
decode_threads = 2
drain_timeout_s = 3.0

[router]
enabled = true
workers = 2
respawn_initial_s = 0.3
health_interval_s = 0.2

[[model]]
name = "bert"
family = "bert"
batch_buckets = [1, 2, 4]
seq_buckets = [16]
dtype = "float32"
num_classes = 16
parallelism = "single"
request_timeout_ms = 10000.0

[model.options]
attention = "flash"
layers = 2
d_model = 32
heads = 2
d_ff = 64
vocab_size = 512
"""

TEXTGEN_TOML = """
host = "127.0.0.1"
decode_threads = 2
drain_timeout_s = 3.0

[router]
enabled = true
workers = 2
respawn_initial_s = 0.3
health_interval_s = 0.2

[genserve]
enabled = true
slots = 4

[[model]]
name = "textgen"
family = "textgen"
batch_buckets = [1, 4]
dtype = "float32"
parallelism = "single"
request_timeout_ms = 30000.0

[model.options]
attention = "flash"
layers = 2
d_model = 64
heads = 2
d_ff = 128
vocab_size = 2048
prompt_len = 32
max_new_tokens = 32
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    prev_env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the spawned workers read it at import
    yield
    torch.set_num_threads(prev)
    if prev_env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = prev_env


def _chaos(tmp_path, capsys, budget: float) -> tuple[int, dict]:
    path = tmp_path / "bert_router.toml"
    path.write_text(BERT_TOML)
    rc = port_main(["chaos", "--config", str(path), "--device", "cpu", "--drill",
                    "worker_kill", "--duration", "3", "--warmup", "0.5", "--concurrency", "4",
                    "--kill-after", "0.5", "--respawn-budget", str(budget),
                    "--min-availability", "0.99"])
    return rc, json.loads(capsys.readouterr().out)


def test_worker_kill_drill_passes_its_gates(tmp_path, capsys):
    rc, out = _chaos(tmp_path, capsys, 90.0)
    assert rc == 0, out["gates"]
    assert out["drill"] == "worker_kill" and out["availability"] >= 0.99
    assert out["gates"] == {"respawn_within_budget": True, "zero_torn": True,
                            "zero_duplicates": True}
    kill = out["kill"]
    assert kill["killed_worker"] in (0, 1) and 0 < kill["respawn_s"] <= 90.0
    integrity = out["integrity"]
    assert integrity["validated"] > 0 and integrity["mismatched"] == integrity["duplicates"] == 0
    assert integrity["reference_bodies"] >= 1
    assert any(p["signal"] == "SIGKILL" and p["id"] == f"worker{kill['killed_worker']}"
               for p in out["postmortems"])
    workers = out["workers"]
    assert workers["deaths_total"] == 1 and workers["healthy"] == 2
    assert sum(row["respawns_total"] for row in workers["workers"]) == 1
    # The reference's summary keys are all there.
    assert {"mode", "n_ok", "n_err", "throughput_per_s", "p50_ms", "p99_ms", "availability",
            "drill", "postmortems", "kill", "integrity", "workers", "router"} <= set(out)


def test_worker_kill_drill_exits_1_when_a_gate_breaks(tmp_path, capsys):
    """A respawn budget no boot meets breaks the respawn gate: exit 1, the
    other gates and availability still reported."""
    rc, out = _chaos(tmp_path, capsys, 0.05)
    assert rc == 1
    assert out["gates"]["respawn_within_budget"] is False
    assert out["kill"]["respawn_s"] is None
    assert out["gates"]["zero_torn"] and out["gates"]["zero_duplicates"]


def _host_chaos(tmp_path, capsys, budget: float) -> tuple[int, dict]:
    """``chaos --drill host_kill`` on BERT_TOML: the drill makes it 2 host
    domains of 2 workers each and kills one domain with killpg 0.5 s in."""
    path = tmp_path / "bert_router.toml"
    path.write_text(BERT_TOML)
    rc = port_main(["chaos", "--config", str(path), "--device", "cpu", "--drill",
                    "host_kill", "--duration", "3", "--warmup", "0.5", "--concurrency", "4",
                    "--kill-after", "0.5", "--respawn-budget", str(budget),
                    "--min-availability", "0.99"])
    return rc, json.loads(capsys.readouterr().out)


def test_host_kill_drill_passes_its_gates(tmp_path, capsys):
    """The reference's host_kill gates: availability >= 0.99 with a whole
    domain killed, the domain re-absorbed (agent and both workers healthy)
    within the budget, zero torn and zero duplicate answers, the survivors'
    compile counts unchanged; the domain's postmortem names SIGKILL."""
    rc, out = _host_chaos(tmp_path, capsys, 90.0)
    assert rc == 0, (out["gates"], out["kill"])
    assert out["drill"] == "host_kill" and out["availability"] >= 0.99
    assert out["gates"] == {"reabsorb_within_budget": True, "zero_torn": True,
                            "zero_duplicates": True, "survivor_compiles_zero": True}
    kill = out["kill"]
    assert kill["killed_host"] in (0, 1) and kill["workers_killed"] == 2
    assert 0 < kill["reabsorb_s"] <= 90.0
    survivors = {str(w) for w in range(4)} - {str(2 * kill["killed_host"]),
                                              str(2 * kill["killed_host"] + 1)}
    assert set(out["compile_deltas"]) == survivors
    assert out["integrity"]["validated"] > 0
    workers = out["workers"]
    assert workers["hosts_up"] == 2 and workers["host_deaths_total"] == 1
    assert any(p["component"] == "host" and p["signal"] == "SIGKILL"
               and p["id"] == f"host{kill['killed_host']}" for p in out["postmortems"])
    assert {"availability", "kill", "integrity", "workers", "compile_deltas",
            "router"} <= set(out)


def test_host_kill_drill_exits_1_when_a_gate_breaks(tmp_path, capsys):
    """A budget no re-absorb meets breaks that gate: exit 1, the others
    still reported."""
    rc, out = _host_chaos(tmp_path, capsys, 0.05)
    assert rc == 1
    assert out["gates"]["reabsorb_within_budget"] is False and out["kill"]["reabsorb_s"] is None
    assert out["gates"]["zero_torn"] and out["gates"]["zero_duplicates"]


def test_stream_kill_drill_passes_its_gates(tmp_path):
    path = tmp_path / "textgen_router.toml"
    path.write_text(TEXTGEN_TOML)
    out = asyncio.run(asyncio.wait_for(run_stream_kill_drill(
        load_config(str(path)), duration_s=4.0, warmup_s=0.5, concurrency=8,
        kill_after_s=1.0, respawn_budget_s=90.0, device="cpu"), 300.0))
    assert all(out["gates"].values()), out["gates"]
    audit = out["stream_audit"]
    assert audit["started"] > 0 and audit["done"] > 0
    assert audit["torn"] == audit["order_violations"] == 0
    assert audit["mismatched"] == audit["non_prefix"] == 0
    assert set(audit["error_reasons"]) <= set(ROUTER_STREAM_REASONS)
    assert out["availability"] >= 0.99 and out["kill"]["respawn_s"] is not None
    assert out["compile_deltas"] and all(v == 0 for v in out["compile_deltas"].values())
    router = out["router"]
    terminated = router["stream_terminated"]
    assert sum(terminated.values()) == router["streams_total"] > 0
    assert any('reason="done"' in k for k in terminated)
