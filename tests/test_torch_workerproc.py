"""The router/worker tier's parts against the reference
(``tpuserve/workerproc/``), without spawning a fleet, and the server's small
keys (ROADMAP.md item 5a).

- ``worker_config``: the same deployment config derives the same worker
  config in both packages, field by field over every key the port types
  (loopback bind, ports, drain budget, the router-owned layers off, the
  black-box paths); recycle-mode models are rejected by both.
- The router's ``Retry-After`` derivations (no healthy worker: the live
  respawn ETA or the health interval; drain: ``shed_retry_after_s``), its
  stream terminals (``_stream_error_bytes``: SSE and binary frame),
  ``ROUTER_STREAM_REASONS`` and the shed-reason memory: equal to the
  reference's on the same inputs.
- The supervisor: least-loaded picks with least-recently-picked ties in
  the same order as the reference's over the same handles, exponential
  respawn backoff (one boot failure, then success: the backoff and respawn
  counts), its ``stats`` rows.
- The black box: ``redirect_stderr`` writes the reference's banner and
  captures fd 2 (in a child process); the default black-box directory is
  the reference's.
- Item 5a: ``log_json`` formats a record as the reference's
  ``JsonLogFormatter`` does (and ``configure_logging`` emits one JSON
  object per line); ``debug_nans`` fails a batch whose output holds a NaN
  (an injected NaN weight) with FloatingPointError, and costs nothing when
  off (the fetch is the plain one); ``prewarm_executables = false`` skips
  the startup runs, not the buckets (on the card: every graph is still
  captured, a ``cuda``-marked test); ``compilation_cache_dir`` moves the
  kernels' build directory (a stand-in ``nvcc`` on the PATH builds an
  empty library there).

Exact unless stated: bytes and values compared with ``==``.
"""

import asyncio
import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuserve import config as jconfig
from tpuserve import frame as jframe
from tpuserve import obs as jobs
from tpuserve.server import JsonLogFormatter as JaxJsonLogFormatter
from tpuserve.workerproc import router as jrouter
from tpuserve.workerproc import supervisor as jsupervisor
from tpuserve.workerproc.worker import worker_config as jax_worker_config
from tpuserve_torch import config as tconfig
from tpuserve_torch import frame as tframe
from tpuserve_torch import obs as tobs
from tpuserve_torch.bench import client as tclient
from tpuserve_torch.ops import _build
from tpuserve_torch.runtime import ModelRuntime
from tpuserve_torch.server import JsonLogFormatter, ServerState, start_server, stop_server
from tpuserve_torch.telemetry import events as tevents
from tpuserve_torch.workerproc import router as trouter
from tpuserve_torch.workerproc import supervisor as tsupervisor
from tpuserve_torch.workerproc.worker import worker_config

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
TINY = dict(layers=2, d_model=32, heads=2, d_ff=64, vocab_size=512, attention="flash")
DEPLOYMENT = """
drain_timeout_s = 7.0
[router]
enabled = true
workers = 3
[worker]
port_base = {port_base}
drain_timeout_s = {drain}
[cache]
enabled = true
[events]
dir = "{bb}"
[[model]]
name = "bert"
family = "bert"
parallelism = "single"
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def both_configs(tmp_path, port_base=0, drain=0.0, extra=""):
    path = tmp_path / "deploy.toml"
    path.write_text(DEPLOYMENT.format(port_base=port_base, drain=drain, bb=tmp_path / "bb")
                    + extra)
    return tconfig.load_config(str(path)), jconfig.load_config(str(path))


def _shared(port, ref) -> dict:
    """``port``'s value of every key the port types, beside the reference's
    value of the same key (dataclasses compared field by field)."""
    if dataclasses.is_dataclass(port):
        return {f.name: _shared(getattr(port, f.name), getattr(ref, f.name))
                for f in dataclasses.fields(port) if f.name not in ("unported", "models")}
    return (port, ref)


@pytest.mark.parametrize("wid, port_base, drain", [(0, 0, 0.0), (1, 9200, 0.0),
                                                    (2, 9200, 2.0)])
def test_worker_config_matches_reference(tmp_path, wid, port_base, drain):
    cfg, jcfg = both_configs(tmp_path, port_base, drain)
    wcfg, jwcfg = worker_config(cfg, wid), jax_worker_config(jcfg, wid)

    def pairs(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from pairs(v, f"{path}.{k}")
        else:
            yield path, tree

    for path, (port, ref) in pairs(_shared(wcfg, jwcfg)):
        assert port == ref, path
    assert wcfg.host == "127.0.0.1"
    assert wcfg.port == (port_base + wid if port_base else 0)
    assert wcfg.drain_timeout_s == (drain or 7.0)
    assert (wcfg.router.enabled, wcfg.cache.enabled) == (False, False)
    assert wcfg.events.stderr_path == str(tmp_path / "bb" / f"worker{wid}.stderr")
    assert wcfg.events.snapshot_path == str(tmp_path / "bb" / f"worker{wid}.snapshot.json")
    assert cfg.router.enabled and cfg.cache.enabled  # the deployment config is untouched
    assert [(m.name, m.family) for m in wcfg.models] == [("bert", "bert")]


def test_worker_config_rejects_recycle_mode_like_the_reference(tmp_path):
    cfg, jcfg = both_configs(tmp_path, extra='session_mode = "recycle"\n')
    with pytest.raises(ValueError, match="recycle") as port_err:
        worker_config(cfg, 0)
    with pytest.raises(ValueError, match="recycle") as ref_err:
        jax_worker_config(jcfg, 0)
    assert str(port_err.value) == str(ref_err.value)


def test_default_blackbox_dir_is_the_reference_one(tmp_path, monkeypatch):
    from tpuserve.telemetry.events import resolve_blackbox_dir as jax_resolve

    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    port = tevents.resolve_blackbox_dir(tconfig.EventsConfig())
    assert port == jax_resolve(jconfig.EventsConfig()) and os.path.isdir(port)
    assert tevents.resolve_blackbox_dir(tconfig.EventsConfig(dir=str(tmp_path / "x"))) \
        == str(tmp_path / "x")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_redirect_stderr_captures_fd2_with_the_banner(tmp_path, pkg):
    """In a child process: fd 2 goes to the capture file after the boot
    banner, appended on a second boot; an unset path leaves stderr alone."""
    mod = "tpuserve.telemetry.events" if pkg == "jax" else "tpuserve_torch.telemetry.events"
    path = tmp_path / "w0.stderr"
    code = (f"import os, sys\nfrom {mod} import redirect_stderr\n"
            "assert not redirect_stderr('', 'x')\n"
            f"assert redirect_stderr({str(path)!r}, 'worker 0 boot')\n"
            "os.write(2, b'native crash\\n')\nprint('traceback line', file=sys.stderr)\n")
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and out.stderr == "", out.stderr
    assert path.read_text() == ("--- worker 0 boot ---\nnative crash\ntraceback line\n" * 2)


def _router_states(tmp_path, **router):
    cfg, jcfg = both_configs(tmp_path)
    for c in (cfg, jcfg):
        for k, v in router.items():
            setattr(c.router, k, v)
        c.shed_retry_after_s = 2.2
    return trouter.RouterState(cfg, device="cpu"), jrouter.RouterState(jcfg)


@pytest.mark.parametrize("eta_s, interval_s", [(3.4, 0.5), (None, 2.5), (0.01, 0.5),
                                               (None, 0.2)])
def test_retry_after_derivation_matches_reference(tmp_path, eta_s, interval_s):
    """No healthy worker: ceil of the soonest respawn ETA, or of the health
    interval when no slot is respawning (at least 1); drain: ceil of
    shed_retry_after_s."""
    states = _router_states(tmp_path, health_interval_s=interval_s)
    now = time.monotonic()
    for st in states:
        if eta_s is not None:
            st.supervisor._respawning = {1}
            st.supervisor._next_up_at[1] = now + eta_s
    port, ref = states
    assert port.no_worker_retry_after() == ref.no_worker_retry_after()
    assert port.shed_retry_after() == ref.shed_retry_after() == 3


def test_router_stream_reasons_are_the_reference_ones():
    assert tobs.ROUTER_STREAM_REASONS == jobs.ROUTER_STREAM_REASONS
    assert tframe.CONTENT_TYPE == jframe.CONTENT_TYPE


@pytest.mark.parametrize("ctype", ["text/event-stream", jframe.CONTENT_TYPE])
@pytest.mark.parametrize("reason", tobs.ROUTER_STREAM_REASONS)
def test_stream_error_terminal_bytes_match_reference(ctype, reason):
    msg = f"worker 1 died mid-stream: {reason}"
    assert trouter._stream_error_bytes(ctype, reason, msg) \
        == jrouter._stream_error_bytes(ctype, reason, msg)


def test_router_termination_vocabulary_is_closed():
    """router_stream_terminated_total ticks only the closed vocabulary; an
    off-list reason raises instead of minting a label."""
    metrics = tobs.Metrics()
    for reason in tobs.ROUTER_STREAM_REASONS:
        metrics.router_stream_terminated_counter("bert", reason).inc()
    assert metrics.counter(
        "router_stream_terminated_total{model=bert,reason=client_disconnect}").value == 1
    with pytest.raises(ValueError, match="unknown stream-termination"):
        metrics.router_stream_terminated_counter("bert", "freestyle")
    with pytest.raises(ValueError, match="unknown router counter"):
        metrics.router_counter("bert", "sheds")


def test_router_records_worker_shed_reason_like_the_reference(tmp_path):
    port, ref = _router_states(tmp_path)
    answers = [(503, b'{"error": "full", "reason": "kv_pressure"}'),
               (200, b'{"reason": "nope"}'), (503, b"not json"), (504, b"[1, 2]"),
               (504, b'{"error": "late", "reason": "deadline"}'), (503, b"")]
    for status, body in answers:
        port.note_shed_reason("bert", trouter._Answer(status, "application/json", body, None))
        try:
            ref.note_shed_reason("bert", jrouter._Answer(status, "application/json", body,
                                                         None))
        except AttributeError:
            pass  # the reference raises on a JSON body that is not an object
        assert port.last_shed_reason == ref.last_shed_reason
    assert port.last_shed_reason == {"bert": "deadline"}


class _Proc:
    def __init__(self, alive=True, exitcode=None):
        self.alive, self.exitcode = alive, exitcode

    def is_alive(self):
        return self.alive

    def terminate(self):
        self.alive, self.exitcode = False, -15

    kill = terminate

    def join(self, timeout=None):
        pass


class _Conn:
    def close(self):
        pass


def _fleet(tmp_path, n=3):
    cfg, jcfg = both_configs(tmp_path)
    cfg.router.workers = jcfg.router.workers = n
    port = tsupervisor.WorkerSupervisor(cfg, tobs.Metrics(), device="cpu")
    ref = jsupervisor.WorkerSupervisor(jcfg, jobs.Metrics())
    for i in range(n):
        port.slots[i] = tsupervisor.WorkerHandle(i, _Proc(), _Conn(), 9000 + i, 100 + i,
                                                 "127.0.0.1")
        ref.slots[i] = jsupervisor.WorkerHandle(i, _Proc(), _Conn(), 9000 + i, 100 + i,
                                                "127.0.0.1")
    return port, ref


def test_pick_is_least_loaded_then_least_recently_picked_like_the_reference(tmp_path):
    port, ref = _fleet(tmp_path)
    rng = np.random.default_rng(0)
    for step in range(40):
        exclude = {int(rng.integers(3))} if step % 5 == 0 else set()
        p, r = port.pick(exclude=exclude), ref.pick(exclude=exclude)
        assert (p and p.wid) == (r and r.wid), step
        if step % 3 == 0:  # one pick stays in flight
            port.track_inflight(p, +1)
            ref.track_inflight(r, +1)
        if step % 7 == 6:
            for sup in (port, ref):
                for h in sup.slots:
                    if h.inflight:
                        sup.track_inflight(h, -1)
                        break
        if step == 20:
            port.slots[1].healthy = ref.slots[1].healthy = False
    assert [h.inflight for h in port.slots] == [h.inflight for h in ref.slots]
    assert port.pick(exclude={0, 2}) is None and ref.pick(exclude={0, 2}) is None


def test_stats_rows_and_down_domains_match_reference(tmp_path):
    port, ref = _fleet(tmp_path)
    for sup in (port, ref):
        sup.slots[2].proc.alive = False
        sup._respawning.add(0)
        sup.slots[0] = None
    assert port.down_domains() == ref.down_domains() == ["worker0", "worker2"]
    p, r = port.stats(), ref.stats()
    assert p["configured"] == r["configured"] == 3 and p["healthy"] == r["healthy"] == 2
    for prow, rrow in zip(p["workers"], r["workers"]):
        assert set(prow) - {"boot_s"} == set(rrow)
        assert {k: v for k, v in prow.items() if k not in ("uptime_s", "respawn_eta_s",
                                                            "boot_s")} \
            == {k: v for k, v in rrow.items() if k not in ("uptime_s", "respawn_eta_s")}
    assert p["device"] == "cpu"


def test_respawn_backs_off_exponentially_then_resets(tmp_path, monkeypatch):
    """A dead slot respawns after initial * multiplier^failures: one failed
    boot (0.02 s, then 0.04 s), then success; the failure count resets, the
    respawn is counted and the gauges follow."""
    cfg, _ = both_configs(tmp_path)
    cfg.router.workers = 1
    cfg.router.respawn_initial_s, cfg.router.respawn_multiplier = 0.02, 2.0
    sup = tsupervisor.WorkerSupervisor(cfg, tobs.Metrics(), device="cpu")
    boots, delays = [], []
    real_sleep = asyncio.sleep

    async def sleep(s):
        delays.append(s)
        await real_sleep(0)

    def spawn(wid):
        boots.append(wid)
        if len(boots) == 1:
            raise RuntimeError("boot failed")
        return tsupervisor.WorkerHandle(wid, _Proc(), _Conn(), 9100, 555, "127.0.0.1", boot_s=0.1)

    monkeypatch.setattr(sup, "_spawn_blocking", spawn)
    monkeypatch.setattr(tsupervisor.asyncio, "sleep", sleep)

    async def go():
        sup.slots[0] = tsupervisor.WorkerHandle(0, _Proc(alive=False, exitcode=-9), _Conn(),
                                                9000, 1, "127.0.0.1")
        assert sup.sweep() == 1 and sup.slots[0] is None
        assert sup.stats()["workers"][0]["state"] == "respawning"
        await asyncio.wait_for(asyncio.gather(*sup._bg), 10.0)

    asyncio.run(go())
    assert boots == [0, 0] and delays == [0.02, 0.04]
    assert sup.slots[0].pid == 555 and sup._fails[0] == 0 and sup.deaths_total == 1
    row = sup.stats()["workers"][0]
    assert row["state"] == "ready" and row["respawns_total"] == 1 and row["boot_s"] == 0.1
    assert sup._g_backoff[0].value == 0.0 and sup._g_up[0].value == 1.0


@pytest.mark.parametrize("device, built, first_alone", [
    ("cuda", False, True), ("cuda", True, False), ("cpu", False, False)])
def test_worker_0_boots_alone_while_the_kernels_are_unbuilt(tmp_path, monkeypatch, device,
                                                             built, first_alone):
    """On the card with no library of this source tree in the build
    directory, worker 0 boots alone and the rest together after it (one
    nvcc); with the library there, or on the CPU, all boot at once."""
    cfg, _ = both_configs(tmp_path)
    cfg.compilation_cache_dir = str(tmp_path / "kernels")
    if built:
        (tmp_path / "kernels").mkdir()
        (tmp_path / "kernels" / _build.library_path("flash_attention").name).write_bytes(b"")
    sup = tsupervisor.WorkerSupervisor(cfg, tobs.Metrics(), device=device)
    assert sup.kernels_built() is built
    spans = {}

    def spawn(wid):
        t0 = time.monotonic()
        time.sleep(0.2)
        spans[wid] = (t0, time.monotonic())
        return tsupervisor.WorkerHandle(wid, _Proc(), _Conn(), 9000 + wid, 100 + wid,
                                        "127.0.0.1")

    monkeypatch.setattr(sup, "_spawn_blocking", spawn)

    async def go():
        await sup.start()
        await sup.stop(drain=False)

    asyncio.run(asyncio.wait_for(go(), 30.0))
    assert sorted(spans) == [0, 1, 2]
    after_0 = all(spans[w][0] >= spans[0][1] for w in (1, 2))
    assert after_0 is first_alone
    assert spans[2][0] < spans[1][1]  # the rest boot together


# -- item 5a: the server's small keys ------------------------------------------

def _record(exc: bool) -> logging.LogRecord:
    exc_info = None
    if exc:
        try:
            raise ValueError("boom")
        except ValueError:
            exc_info = sys.exc_info()
    return logging.LogRecord("tpuserve_torch.server", logging.WARNING, __file__, 1,
                             "worker %d: %s", (3, "naïve"), exc_info)


@pytest.mark.parametrize("exc", [False, True])
def test_log_json_formatter_matches_reference(exc):
    rec = _record(exc)
    port, ref = JsonLogFormatter().format(rec), JaxJsonLogFormatter().format(rec)
    assert port == ref
    out = json.loads(port)
    assert set(out) == {"ts", "level", "logger", "msg"} | ({"exc"} if exc else set())
    assert out["msg"] == "worker 3: naïve" and out["level"] == "WARNING"


@pytest.mark.parametrize("log_json", [True, False])
def test_configure_logging_emits_one_json_object_per_line(log_json):
    code = ("import logging\n"
            "from tpuserve_torch.config import ServerConfig\n"
            "from tpuserve_torch.server import configure_logging\n"
            f"configure_logging(ServerConfig(log_json={log_json}))\n"
            "log = logging.getLogger('tpuserve_torch.test')\n"
            "log.info('first %s', 1)\nlog.warning('second')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stderr.strip().splitlines()
    assert len(lines) == 2
    if log_json:
        recs = [json.loads(line) for line in lines]
        assert [(r["level"], r["msg"]) for r in recs] == [("INFO", "first 1"),
                                                          ("WARNING", "second")]
        assert all(r["logger"] == "tpuserve_torch.test" for r in recs)
    else:
        assert "INFO tpuserve_torch.test: first 1" in lines[0]


def _bert_cfg(**server) -> tconfig.ServerConfig:
    model = tconfig.ModelConfig(name="bert", family="bert", batch_buckets=[1, 2],
                                seq_buckets=[16], dtype="float32", parallelism="single",
                                num_classes=8, request_timeout_ms=30_000.0,
                                batch_retry=False, retry_split=False, options=dict(TINY))
    return tconfig.ServerConfig(models=[model], decode_threads=2, startup_canary=False,
                                **server)


@pytest.mark.parametrize("debug_nans", [False, True])
def test_debug_nans_fails_the_batch_that_carries_a_nan(debug_nans):
    state = ServerState(_bert_cfg(debug_nans=debug_nans), device="cpu")
    state.build()
    rt = state.runtimes["bert"]
    if not debug_nans:
        # Off: the hot path's fetch is the plain one (nothing is checked).
        assert rt.fetch is ModelRuntime.fetch
        assert "fetch" not in vars(rt) and "fetch_program" not in vars(rt)
    else:
        assert vars(rt)["fetch"] == rt._fetch_finite

    async def go():
        from tpuserve_torch.bench.client import ClientSession

        server = await start_server(state, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{state.serving_addresses[0][1]}/v1/models/bert:classify"
        try:
            async with ClientSession() as s:
                clean = await s.post(url, b'{"text": "clean weights"}',
                                     {"Content-Type": "application/json"})
                # The injected fault: a NaN in the live slot's classifier.
                with torch.no_grad():
                    next(p for n, p in rt.module.named_parameters()
                         if "classifier" in n or "cls" in n).view(-1)[0] = float("nan")
                bad = await s.post(url, b'{"text": "poisoned weights"}',
                                   {"Content-Type": "application/json"})
        finally:
            await stop_server(state, server)
        return clean, bad

    clean, bad = asyncio.run(go())
    assert clean.status == 200
    if debug_nans:
        assert bad.status == 500
        assert "FloatingPointError" in bad.body.decode() or "debug_nans" in bad.body.decode()
    else:
        assert bad.status == 200


@pytest.mark.parametrize("prewarm", [True, False])
def test_prewarm_false_skips_the_startup_runs_not_the_buckets(prewarm, monkeypatch):
    from tpuserve_torch.models import bert

    calls = []
    real = bert.BertServing.forward

    def counting(self, module, batch):
        calls.append(tuple(batch[0].shape))
        return real(self, module, batch)

    monkeypatch.setattr(bert.BertServing, "forward", counting)
    state = ServerState(_bert_cfg(prewarm_executables=prewarm), device="cpu")
    state.build()
    rt = state.runtimes["bert"]
    assert rt.compiles_total == 2 and len(rt.variants) == 2
    assert calls == ([(1, 16), (2, 16)] if prewarm else [])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_prewarm_false_still_captures_every_graph_on_the_card(cuda):
    """On the card prewarm_executables = false skips each graph's startup
    replay only: every (bucket, slot) graph is captured, and the first
    replay answers as the eager forward does."""
    from tpuserve_torch.models import build
    from tpuserve_torch.ops import flash_attention as fa
    from tpuserve_torch.runtime import N_SLOTS, build_runtime

    model = build(_bert_cfg().models[0])
    fa.reset_launches()
    rt = build_runtime(model, device=cuda, prewarm=False)
    assert rt.captures_total == N_SLOTS * 2
    captured = fa.launches  # the eager warm-ups' launches, no replay
    batch = rt._zeros((2, 16))
    out = rt.fetch(rt.run((2, 16), batch))
    assert fa.launches - captured == TINY["layers"]
    with torch.inference_mode():
        eager = model.forward(rt.module, tuple(torch.from_numpy(a).to(cuda) for a in batch))
    np.testing.assert_array_equal(out["indices"], eager["indices"].cpu().numpy())


def test_compilation_cache_dir_moves_the_kernel_build(tmp_path, monkeypatch):
    """``compilation_cache_dir`` is where the kernels build and load (a
    stand-in nvcc on the PATH links an empty library); the default stays
    build/kernels."""
    import shutil

    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler to stand in for nvcc")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\nout=''\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then out=$2; fi; shift\ndone\n"
                    f"echo 'int stand_in(void) {{ return 7; }}' | {cc} -shared -fPIC -x c "
                    "-o \"$out\" -\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    default = _build.BUILD_DIR
    assert default == ROOT / "build" / "kernels"
    monkeypatch.setattr(_build, "BUILD_DIR", default)
    monkeypatch.setattr(_build, "_loaded", {})
    cache = tmp_path / "kernels"
    ServerState(_bert_cfg(compilation_cache_dir=str(cache)), device="cpu")
    assert _build.BUILD_DIR == cache
    lib = _build.load("flash_attention")
    assert lib.stand_in() == 7
    so = _build.library_path("flash_attention")
    assert so.parent == cache and so.exists() and (so.parent / (so.name + ".log")).exists()
    # A second process finds the library there and loads it without nvcc.
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("PATH", "/nonexistent")
    assert _build.load("flash_attention").stand_in() == 7


def _route(state, path, method="GET", query=None):
    from tpuserve_torch.server import Request

    async def go():
        req = Request(method=method, path=path, query=query or {}, headers={}, body=b"")
        return await state.handle(req)

    return asyncio.run(go())


def test_refused_router_routes_name_their_item(tmp_path):
    """The autopilot and tenants (item 11b) answer with their refusal,
    without a fleet; host scaling with no host domains answers the
    reference's 409."""
    state, _ = _router_states(tmp_path)
    for path in ("/debug/autopilot", "/tenants"):
        resp = _route(state, path)
        assert resp.status == 409 and "item 11b" in json.loads(resp.body)["error"], path
    resp = _route(state, "/admin/hosts/0:scale", "POST", {"active": "1"})
    assert resp.status == 409
    assert json.loads(resp.body)["error"] == ("[router] hosts = 0: there are no host "
                                              "domains to scale")
    assert _route(state, "/no/such/page").status == 404


@pytest.mark.parametrize("path", ["/metrics/fleet", "/stats/fleet"])
def test_fleet_scrape_routes_are_served_without_a_fleet(tmp_path, path):
    """The fleet scrape, refused until it was ported, answers 200 with every
    worker slot stale (no fleet was started), never a 5xx."""
    state, _ = _router_states(tmp_path)
    state._session = tclient.ClientSession(timeout_s=1.0)
    resp = _route(state, path)
    assert resp.status == 200, resp.body
    if path == "/stats/fleet":
        rollup = json.loads(resp.body)
        assert rollup["stale"] == ["worker0", "worker1", "worker2"]
        assert rollup["sources"]["router0"] == "up"
    else:
        assert b"# STALE worker0" in resp.body and resp.body.endswith(b"# EOF\n")


@pytest.mark.parametrize("query, status", [({}, 400), ({"active": "x"}, 400),
                                           ({"active": "1", "junk": "1"}, 400)])
def test_host_scale_validates_its_query_like_the_reference(tmp_path, query, status):
    state, _ = _router_states(tmp_path)
    assert _route(state, "/admin/hosts/0:scale", "POST", query).status == status


def test_worker_fault_kinds_fire_pinned_to_their_worker():
    """worker_slow/hang/crash are served; a rule with worker >= 0 fires
    only in that worker's process (the injector's worker_id)."""
    from tpuserve_torch.faults import FaultInjector

    assert "worker_crash" not in tconfig._FAULT_KINDS_UNPORTED
    inj = FaultInjector(tconfig.FaultsConfig(enabled=True, rules=[
        tconfig.FaultRuleConfig(kind="worker_slow", delay_ms=20.0, worker=1)]))
    assert inj.delay_s("worker_slow", "bert") == 0.0  # no worker id: alone
    inj.worker_id = 0
    assert inj.delay_s("worker_slow", "bert") == 0.0
    inj.worker_id = 1
    assert inj.delay_s("worker_slow", "bert") == 0.02
    cfg = tconfig.ServerConfig(models=[tconfig.ModelConfig(name="m")],
                               faults=tconfig.FaultsConfig(enabled=True, rules=[
                                   tconfig.FaultRuleConfig(kind=k) for k in
                                   ("worker_slow", "worker_hang", "worker_crash")]))
    assert tconfig.unported_settings(cfg) == []
