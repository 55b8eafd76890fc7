"""The port's capture discipline (TPS5xx), ledger escape (TPS601) and
retrace witness against the reference's.

- ``ledgerlint``: the fixture of ``tests/test_tracelint.py``
  (``tests/fixtures/analysis/ledger_escape.py``) and the port's own tree
  through both packages give identical TPS601 findings (rule, file,
  symbol, message, line, key).
- ``tracelint`` is the port's own (its hazards are a CUDA graph's, not a
  ``jax.jit`` trace's): torch-idiom fixtures, written here, are flagged —
  TPS501 a lambda or local def handed to ``register_program``, TPS502
  ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, ``float()``,
  ``torch.cuda.synchronize()``, ``Stream.synchronize()``, ``print`` and
  ``np.*`` in a captured body (a registered program, a conventional entry
  point, a program a factory returns, the body of a ``torch.cuda.graph``
  block), TPS503 ``if``/``while`` on a tensor, TPS504/505 capture by
  closure — while host-side code, shape reads, kwonly statics and
  sanctioned lines are not; the sanction parser equals the reference's.
- The port's tree has no TPS5xx/TPS6xx finding and none is baselined.
- The retrace registry's semantics equal the reference's
  (``test_retrace_registry_semantics``), the port's capture ledger beside
  it; on the CPU runtime, after the barrier a new bucket raises
  ``RetraceViolation`` naming (tag, variant) exactly as the reference's
  runtime does, a capture is heard before it starts, the lifecycle's warm
  of a cold model is sanctioned, and with the witness off it is inert.
- The sync guard's reference-counted window (``utils.retrace``) against a
  recorded device mode; ``host_fetch`` on CPU trees.

Exact throughout: findings, outcomes and counts are compared with ``==``.
"""

import asyncio
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuserve.analysis import ledgerlint as jledgerlint
from tpuserve.analysis import tracelint as jtracelint
from tpuserve.analysis import witness as jwitness
from tpuserve_torch.analysis import astlint, ledgerlint, tracelint
from tpuserve_torch.analysis import witness as twitness
from tpuserve_torch.analysis.findings import load_baseline
from tpuserve_torch.utils import retrace

FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
ROOT = Path(__file__).resolve().parents[1]

CAPTURE_FIXTURE = '''
import numpy as np
import torch


class GenerativeModel:
    pass


class ToyGen(GenerativeModel):
    def step(self, module, state):
        if state["done"].all():
            return state
        return state


def _sync_prog(module, state, x):
    a = float(x)
    b = x.sum().item()
    c = x.cpu()
    d = x.numpy()
    e = x.tolist()
    torch.cuda.synchronize()
    torch.cuda.current_stream().synchronize()
    print(a)
    f = np.log(x)
    return x


def _branch_prog(module, state, x):
    if x.sum() > 0:
        x = x * 2
    while x.max() > 1:
        x = x / 2
    return x


def good_static_reads(module, state, x):
    if x.shape[0] > 1 and x.size(1) > 2 and x.dim() == 2 and len(x) > 0:
        x = x + 1
    if x is None:
        return state
    return x


def good_kwonly_static(module, state, x, *, chunk):
    if chunk > 4:
        return x
    return x * chunk


def good_sanctioned(module, state, x):
    if "kp" in state:  # tps-ok[TPS503]: dict structure check at capture time
        return x
    return x


def _good_prog(module, state, table):
    return state["x"] + table


def register_all(rt):
    rt.register_program("sync", _sync_prog, ())
    rt.register_program("branch", _branch_prog, ())
    rt.register_program("static", good_static_reads, ())
    rt.register_program("kwonly", good_kwonly_static, ())
    rt.register_program("sanctioned", good_sanctioned, ())


def bad_register_lambda(rt):
    rt.register_program("lam", lambda module, state: state, ())


def bad_register_local(rt):
    def prog(module, state):
        return state
    rt.register_program("local", prog, ())


def good_register_local_sanctioned(rt):
    def prog(module, state):
        return state
    rt.register_program("once", prog, ())  # tps-ok[TPS501]: registered once per runtime


def bad_capture_arg(rt, n):
    def prog(module, state):
        return state["x"] * n
    rt.register_program("cap", prog, ())  # tps-ok[TPS501]: the closure is what is probed


def bad_capture_fresh_tensor(rt, n):
    table = torch.arange(n)

    def prog(module, state):
        return state["x"] + table
    rt.register_program("fresh", prog, ())  # tps-ok[TPS501]: the closure is what is probed


def good_pass_as_argument(rt, n):
    rt.register_program("arg", _good_prog, ())


def host_graph_block(runtime, x):
    g = torch.cuda.CUDAGraph()
    y = x.sum().item()
    with torch.cuda.graph(g):
        z = x * 2
        w = z.sum().item()
    return y


def _packed(model):
    def step(module, state):
        return state["x"].tolist()
    return step


def register_factory(rt, model):
    rt.register_program("packed", _packed(model), ())
'''


@pytest.fixture(scope="module")
def capture_findings(tmp_path_factory):
    d = tmp_path_factory.mktemp("capture")
    (d / "capture_discipline.py").write_text(textwrap.dedent(CAPTURE_FIXTURE))
    return tracelint.run_paths([d / "capture_discipline.py"], d)


def found(findings, rule=None, symbol=None) -> list[str]:
    return [f.message for f in findings
            if (rule is None or f.rule == rule) and (symbol is None or f.symbol == symbol)]


def rows(findings) -> list[tuple]:
    return [(f.rule, f.file, f.symbol, f.message, f.line, f.key) for f in findings]


# ---------------------------------------------------------------------------
# TPS601: the same rule in both packages
# ---------------------------------------------------------------------------

def test_ledger_fixture_findings_equal_the_reference():
    ref = rows(jledgerlint.run_paths([FIXTURES / "ledger_escape.py"], FIXTURES))
    port = rows(ledgerlint.run_paths([FIXTURES / "ledger_escape.py"], FIXTURES))
    assert port == ref
    assert {(r, s) for r, _f, s, *_ in port} >= {
        ("TPS601", "Engine.bad_await_while_held"), ("TPS601", "Engine.bad_raise_while_held"),
        ("TPS601", "Engine.bad_call_while_held")}


def test_ledger_port_tree_findings_equal_the_reference():
    """The port's four ledgers (``SlotArena``, ``PageLedger``, ``SlotPool``,
    ``AssemblyArena``: the reference's class names) through both rules."""
    files = astlint.collect_files([ROOT / "tpuserve_torch"])
    assert rows(ledgerlint.run_paths(files, ROOT)) == rows(jledgerlint.run_paths(files, ROOT))


# ---------------------------------------------------------------------------
# TPS5xx over captured regions
# ---------------------------------------------------------------------------

def test_fresh_program_registration_flagged(capture_findings):
    assert len(found(capture_findings, "TPS501", "bad_register_lambda")) == 1
    assert "locally-defined prog" in found(capture_findings, "TPS501", "bad_register_local")[0]
    assert not found(capture_findings, symbol="good_register_local_sanctioned")


def test_host_syncs_in_captured_bodies_flagged(capture_findings):
    msgs = found(capture_findings, "TPS502", "_sync_prog")
    for want in ("float()", ".item()", ".cpu()", ".numpy()", ".tolist()",
                 "torch.cuda.synchronize()", ".synchronize()", "print()", "np.log()"):
        assert any(want in m for m in msgs), (want, msgs)
    # The body of a graph block, and a program a factory returns.
    assert found(capture_findings, "TPS502", "host_graph_block") == [
        "host-forcing .item() on captured value z.sum()"]
    assert found(capture_findings, "TPS502", "_packed.<locals>.step") == [
        "host-forcing .tolist() on captured value state['x']"]


def test_tensor_branches_flagged(capture_findings):
    msgs = found(capture_findings, "TPS503", "_branch_prog")
    assert any("`if`" in m for m in msgs) and any("`while`" in m for m in msgs)
    assert found(capture_findings, "TPS503", "ToyGen.step"), \
        "GenerativeModel.step must be in the capture-reachability set"


def test_closure_capture_flagged(capture_findings):
    assert "'n'" in found(capture_findings, "TPS505", "bad_capture_arg")[0]
    assert "'table'" in found(capture_findings, "TPS504", "bad_capture_fresh_tensor")[0]


def test_clean_and_sanctioned_patterns(capture_findings):
    bad = [f.render() for f in capture_findings if f.symbol.startswith("good_")
           or f.symbol in ("register_all", "register_factory")]
    assert not bad, bad


def test_sanction_parser_equals_the_reference():
    for line in ("x = 1  # tps-ok[TPS503]: structure check",
                 "x = 1  # tps-ok[TPS501,TPS505]: factory",
                 "x = 1  # tps-ok[TPS503]:", "x = 1  # tps-ok: because", "x = 1"):
        assert tracelint.sanctioned_rules(line) == jtracelint.sanctioned_rules(line)
    assert tracelint.sanctioned_rules("x  # tps-ok[TPS501, TPS505]: once") == {"TPS501", "TPS505"}


def test_port_tree_clean_for_capture_and_ledger_rules():
    files = astlint.collect_files([ROOT / "tpuserve_torch"])
    findings = tracelint.run_paths(files, ROOT) + ledgerlint.run_paths(files, ROOT)
    assert not findings, "\n".join(f.render() for f in findings)
    baseline = load_baseline(ROOT / "tpuserve_torch" / "analysis" / "baseline.json")
    assert not [k for k in baseline if k.startswith(("TPS5", "TPS6"))]


# ---------------------------------------------------------------------------
# The retrace witness
# ---------------------------------------------------------------------------

@pytest.fixture
def armed_witness():
    for w in (jwitness, twitness):
        w.force_retrace(True)
        w.reset_retrace()
    yield
    for w in (jwitness, twitness):
        w.force_retrace(None)
        w.reset_retrace()


def registry_scenario(w):
    w.note_compile("tg", "b4/float32/none/single")
    w.declare_warmup_complete()
    with w.sanctioned_compiles():
        w.note_compile("tg", "b8/float32/none/single")
    try:
        w.note_compile("tg", "b16/float32/none/single")
        raised = None
    except w.RetraceViolation as e:
        raised = "tag=tg" in str(e) and "b16/float32/none/single" in str(e)
    snap = w.retrace_snapshot()
    return (raised, snap["enabled"], snap["barrier_declared"], snap["warmup_compiles"],
            snap["sanctioned_compiles"],
            [(v["kind"], v["tag"], v["variant"]) for v in snap["violations"]])


def test_retrace_registry_semantics(armed_witness):
    ref, port = registry_scenario(jwitness), registry_scenario(twitness)
    assert port == ref == (True, True, True, 1, 1,
                           [("retrace", "tg", "b16/float32/none/single")])


def test_capture_ledger(armed_witness):
    """The port's captures: warm-up before the barrier, sanctioned inside a
    window, a ``recapture`` violation outside one — raised before the
    capture, naming (tag, variant)."""
    twitness.note_capture("toy", "1/float32/fp/single")
    twitness.declare_warmup_complete()
    with twitness.sanctioned_compiles():
        twitness.note_capture("toy", "1/float32/fp/single")
    with pytest.raises(twitness.RetraceViolation, match="graph capture after warmup barrier: "
                       "tag=toy variant=2/float32/fp/single"):
        twitness.note_capture("toy", "2/float32/fp/single")
    snap = twitness.retrace_snapshot()
    assert (snap["warmup_captures"], snap["sanctioned_captures"], snap["warmup_compiles"]) \
        == (1, 1, 0)
    assert [(v["kind"], v["variant"]) for v in snap["violations"]] \
        == [("recapture", "2/float32/fp/single")]


def runtime_scenario(pkg):
    """The reference's end-to-end runtime test, on either package's CPU
    runtime: warm-up compiles silent, compile delta 0 after the barrier, a
    new bucket raises naming (tag, variant), the counter ticked first."""
    if pkg == "jax":
        from tpuserve.config import ModelConfig
        from tpuserve.models import build
        from tpuserve.runtime import build_runtime
        w = jwitness
        kw = {}
    else:
        from tpuserve_torch.config import ModelConfig
        from tpuserve_torch.models import build
        from tpuserve_torch.runtime import build_runtime
        w = twitness
        kw = {"device": "cpu"}
    cfg = ModelConfig(name="toy", family="toy", batch_buckets=[1], dtype="float32",
                      num_classes=10, parallelism="single")
    rt = build_runtime(build(cfg), **kw)
    w.declare_warmup_complete()
    before = rt.compiles_total
    steady = (rt.ensure_compiled(), rt.compiles_total == before,
              w.retrace_snapshot()["violations"])
    cfg.batch_buckets.append(2)
    try:
        rt.ensure_compiled()
        raised = None
    except w.RetraceViolation as e:
        raised = "tag=toy" in str(e)
    viol = w.retrace_snapshot()["violations"][0]
    return (steady, raised, viol["tag"], viol["variant"].split("/")[0],
            rt.compiles_total == before + 1, w.retrace_snapshot()["warmup_compiles"])


def test_retrace_witness_end_to_end_on_runtime(armed_witness):
    ref, port = runtime_scenario("jax"), runtime_scenario("port")
    assert port == ref == ((0, True, []), True, "toy", "2", True, 1)


def test_runtime_hears_a_capture_before_it_starts(armed_witness, monkeypatch):
    """``ModelRuntime._capture`` (CUDA only; its capture stubbed here): after
    the barrier it raises before capturing, outside a sanctioned window;
    inside one it captures in an ``allow_transfers`` window."""
    from tpuserve_torch.config import ModelConfig
    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    rt = build_runtime(build(ModelConfig(name="toy", family="toy", batch_buckets=[1],
                                         dtype="float32", num_classes=10,
                                         parallelism="single")), device="cpu")
    calls = []
    monkeypatch.setattr(rt, "_warm_and_capture",
                        lambda slot, bucket: calls.append((bucket, retrace._depth)) or "graph")
    twitness.declare_warmup_complete()
    with pytest.raises(twitness.RetraceViolation, match="variant=1/float32/fp/single"):
        rt._capture(rt.slots[0], (1,))
    assert calls == []
    with twitness.sanctioned_compiles():
        assert rt._capture(rt.slots[0], (1,)) == "graph"
    assert calls == [((1,), 1)] and retrace._depth == 0
    assert twitness.retrace_snapshot()["sanctioned_captures"] == 1


def test_lifecycle_warm_of_a_cold_model_is_sanctioned(armed_witness):
    """A cold_start model warmed through the lifecycle after the barrier
    compiles inside ``sanctioned_compiles`` (0 violations); the same
    ``ensure_compiled`` outside the lifecycle raises."""
    from tpuserve_torch.config import ModelConfig, SchedulerConfig, ServerConfig
    from tpuserve_torch.server import ServerState

    def toy(name, **over):
        return ModelConfig(name=name, family="toy", batch_buckets=[1, 2, 4],
                           dtype="float32", num_classes=10, parallelism="single",
                           wire_size=8, **over)

    cfg = ServerConfig(decode_threads=2, startup_canary=False,
                       scheduler=SchedulerConfig(enabled=True),
                       models=[toy("cold", cold_start=True), toy("other", cold_start=True)])
    state = ServerState(cfg, device="cpu")
    state.build()
    assert twitness.retrace_snapshot()["barrier_declared"]

    async def go():
        await state.start()
        try:
            info = await state.scheduler.warm("cold")
        finally:
            await state.stop()
        return info

    asyncio.run(go())
    snap = twitness.retrace_snapshot()
    assert (snap["sanctioned_compiles"], snap["violations"]) == (3, [])
    other = state.runtimes["other"]
    other.stage_params()
    with pytest.raises(twitness.RetraceViolation, match="tag=other"):
        other.ensure_compiled()


def test_retrace_witness_disabled_is_inert():
    for w in (jwitness, twitness):
        w.force_retrace(False)
        try:
            w.reset_retrace()
            w.declare_warmup_complete()
            w.note_compile("tg", "b4/float32/none/single")  # no raise
            assert w.retrace_snapshot()["violations"] == []
        finally:
            w.force_retrace(None)
            w.reset_retrace()
    twitness.force_retrace(False)
    try:
        twitness.declare_warmup_complete()
        twitness.note_capture("tg", "b4")  # no raise
        assert retrace.arm_sync_guard() is False
    finally:
        twitness.force_retrace(None)
        twitness.reset_retrace()


# ---------------------------------------------------------------------------
# The torch half: the sync guard's window, and host_fetch
# ---------------------------------------------------------------------------

def test_sync_guard_window_is_reference_counted(armed_witness, monkeypatch):
    """Against a recorded device mode (the CPU has no device to guard): arm
    sets "error"; nested windows lift it once and restore it once, each
    counted; disarm restores "default". Off a CUDA-initialized process, or
    with the witness off, nothing is set."""
    modes = []
    monkeypatch.setattr(retrace, "_set_mode", modes.append)
    assert retrace.arm_sync_guard() is False and modes == []  # CUDA never initialized
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    try:
        assert retrace.arm_sync_guard() is True and retrace.sync_guard_armed()
        with retrace.allow_transfers():
            with retrace.allow_transfers():
                pass
        assert modes == ["error", "default", "error"]
        assert twitness.retrace_snapshot()["transfer_windows"] == 2
    finally:
        retrace.disarm_sync_guard()
    assert modes[-1] == "default" and not retrace.sync_guard_armed()
    with retrace.allow_transfers():
        pass
    assert modes == ["error", "default", "error", "default"]
    assert twitness.retrace_snapshot()["transfer_windows"] == 2


def test_host_fetch_on_cpu_trees():
    src = {"a": torch.arange(4.0), "b": (torch.ones(2, dtype=torch.int64), None)}
    out = retrace.host_fetch(src)
    src["a"].add_(1)  # the fetched arrays are the caller's own
    assert isinstance(out["a"], np.ndarray) and out["a"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert out["b"][0].dtype == np.int64 and out["b"][1] is None
    assert retrace.host_fetch(torch.zeros(3)).shape == (3,)
