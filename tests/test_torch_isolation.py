"""The port stands alone: ``tpuserve_torch`` imports with ``jax``, ``flax``
and ``tpuserve`` blocked, no module of it (nor ``chip_smoke.py``) imports
them, and its entry points run on CUDA unless the CPU is asked for —
without CUDA they raise instead of falling back."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "tpuserve_torch"
BLOCKED = ("jax", "jaxlib", "flax", "tpuserve")


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# Subprocesses stay on one thread, like this process (the suite runs in
# parallel workers beside timing-sensitive tests).
ENV = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_flax_or_tpuserve_import(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in BLOCKED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_aiohttp_or_pil(path):
    """The card's machine has neither: a module may reach PIL lazily, inside
    the function that decodes an encoded image, never at import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.module]
    bad = [n for n in names if n.split(".")[0] in ("aiohttp", "PIL")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at module level"


def test_every_module_imports_with_jax_flax_tpuserve_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import tpuserve_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tpuserve_torch.__path__, 'tpuserve_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax') and sys.modules[k] is not None\n"
        "               for k in sys.modules)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15  # every module of the package


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_build_runtime_without_device_needs_cuda(no_cuda):
    from tpuserve_torch.config import ModelConfig
    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    model = build(ModelConfig(name="b", family="bert", parallelism="single",
                              options=dict(layers=1, d_model=16, heads=2, d_ff=32,
                                           vocab_size=256)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_runtime(model)


def test_server_state_without_device_needs_cuda(no_cuda):
    from tpuserve_torch.config import ServerConfig
    from tpuserve_torch.server import ServerState

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServerState(ServerConfig())


def test_server_refuses_unported_sections():
    from tpuserve_torch.config import ServerConfig
    from tpuserve_torch.server import ServerState

    cfg = ServerConfig(unported={"[router] enabled": True})
    with pytest.raises(NotImplementedError, match=r"\[router\]"):
        ServerState(cfg, device="cpu")


MODEL_TOML = '[[model]]\nname = "bert"\nfamily = "bert"\nparallelism = "single"\n'


@pytest.mark.parametrize("toml, named", [
    ("[genserve]\nenabled = true\n", "[genserve] enabled = True"),
    ("[router]\nenabled = false\nworkers = 4\n", "[router] workers = 4"),
    ("[faults]\nenabled = true\n[[faults.rule]]\nkind = \"worker_crash\"\n",
     "[[faults.rule]] kind = 'worker_crash' (not yet ported (router and workers))"),
    ("[events]\ndir = \"/tmp/bb\"\n", "[events] dir = '/tmp/bb'"),
    ("[telemetry]\nfleet_timeout_ms = 2000.0\n", "[telemetry] fleet_timeout_ms = 2000.0"),
    ("[events]\nsnapshot_path = \"s.json\"\n", "[events] snapshot_path = 's.json'"),
    ("[parallel]\nmode = \"replica\"\n", "[parallel] mode = 'replica'"),
    ("profiler_port = 9999\n", "profiler_port = 9999"),
    (MODEL_TOML + "pp = 2\n", "model bert: pp = 2"),
    (MODEL_TOML + "[model.slo]\nlatency_ms = 50.0\n[tenants]\nenabled = true\n",
     "[tenants] enabled = True"),
])
def test_server_refuses_unported_settings(tmp_path, toml, named):
    """A setting the port does not honour is refused by name at startup,
    never quietly ignored; the file itself still parses."""
    from tpuserve_torch.config import load_config
    from tpuserve_torch.server import ServerState

    path = tmp_path / "c.toml"
    path.write_text(toml)
    cfg = load_config(str(path))
    with pytest.raises(NotImplementedError, match="not yet ported") as err:
        ServerState(cfg, device="cpu")
    assert named in str(err.value)


def test_server_accepts_settings_that_switch_unported_features_off(tmp_path):
    from tpuserve_torch.config import load_config, unported_settings

    path = tmp_path / "c.toml"
    path.write_text('ingest_loops = 1\n[adaptive]\nenabled = false\n'
                    '[cache]\nenabled = false\n[parallel]\nmode = "single"\n'
                    + MODEL_TOML + 'session_mode = "direct"\ncold_start = false\n')
    cfg = load_config(str(path), ["scheduler.enabled=false"])
    assert cfg.unported["[scheduler] enabled"] is False
    assert unported_settings(cfg) == []
    for example in ("bert_flash.toml", "bert_long_ring.toml"):
        assert unported_settings(load_config(str(ROOT / "examples" / example))) == []
    with pytest.raises(ValueError, match="unknown ServerConfig keys"):
        path.write_text("no_such_key = 1\n")
        load_config(str(path))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda_or_checkout(tmp_path, alone):
    """No card here: the smoke exits non-zero and prints no result line —
    and so does a copy of it that has no checkout beside it."""
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=ENV, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
