"""The port stands alone: ``tpuserve_torch`` imports with ``jax``, ``flax``
and ``tpuserve`` blocked, no module of it (``workerproc/*.py`` included) nor
``chip_smoke.py`` imports them or ``aiohttp`` (``tpuserve_torch.bench`` and
the router tier import with ``aiohttp`` and PIL blocked too, the router
without initializing CUDA), and its entry points run on CUDA unless the CPU
is asked for — without CUDA they raise instead of falling back."""

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


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_aiohttp_import_anywhere(path):
    """Not even lazily: the load generator and the chaos runner speak HTTP
    through ``tpuserve_torch.bench.client``."""
    bad = [n for n in _imports(path) if n.split(".")[0] == "aiohttp"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_bench_imports_and_builds_payloads_with_aiohttp_blocked():
    """``tpuserve_torch.bench`` (client, loadgen, roofline) and the CLI
    import, and the load generator builds every synthetic body but JPEG,
    with jax, flax, tpuserve, aiohttp and PIL blocked; a JPEG body then
    fails with a clear message."""
    code = (
        "import sys\n"
        f"for name in {(*BLOCKED, 'aiohttp', 'PIL')!r}:\n"
        "    sys.modules[name] = None\n"
        "import tpuserve_torch.cli\n"
        "from tpuserve_torch.bench import client, loadgen, roofline\n"
        "assert loadgen.synthetic_frame(16, 2, 'yuv420')\n"
        "assert loadgen.synthetic_pool('npy', 2, 8) and loadgen.synthetic_prompt_pool(3)\n"
        "try:\n"
        "    loadgen.synthetic_image_jpeg(16)\n"
        "except RuntimeError as e:\n"
        "    print('jpeg:', e)\n"
        "print(sorted(m for m in sys.modules if m.startswith('tpuserve_torch.bench')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "jpeg: synthetic JPEG payloads need PIL" in out.stdout
    assert ("['tpuserve_torch.bench', 'tpuserve_torch.bench.client', "
            "'tpuserve_torch.bench.loadgen', 'tpuserve_torch.bench.roofline']") in out.stdout


def test_sd15_serves_on_host_with_jax_flax_tpuserve_and_pil_blocked():
    """SD 1.5's module, PNG writer, stream frames and seeded init need none
    of them: a tiny txt2img forward on the CPU and its PNG, in a process
    where importing any of them fails."""
    code = (
        "import sys, json\n"
        f"for name in {(*BLOCKED, 'PIL', 'aiohttp')!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from tpuserve_torch.config import ModelConfig\n"
        "from tpuserve_torch.models import build\n"
        "opts = dict(steps=2, vocab_size=128, text_layers=1, text_d_model=16, text_heads=2,\n"
        "            unet_ch=8, unet_mults=[1, 2], unet_res=1, unet_attn_levels=[0],\n"
        "            unet_heads=2, vae_ch=8, vae_mults=[1, 2])\n"
        "m = build(ModelConfig(name='sd', family='sd15', dtype='float32',\n"
        "                      parallelism='single', image_size=16, options=opts))\n"
        "mod = m.build_module()\n"
        "mod.load_state_dict(m.init_params(0))\n"
        "batch = m.assemble([m.host_decode(b'{\"prompt\": \"x\"}', 'application/json')], (1,))\n"
        "with torch.inference_mode():\n"
        "    out = m.forward(mod, tuple(torch.from_numpy(a) for a in batch))\n"
        "png = m.host_postprocess({'image': out['image'].numpy()}, 1)[0]\n"
        "unit = m.encode_stream_unit({'type': 'image', 'image': out['image'][0].numpy()})\n"
        "assert png[:8] == b'\\x89PNG\\r\\n\\x1a\\n' and len(unit) > 16 * 16 * 3\n"
        "print('ok', tuple(out['image'].shape))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "ok (1, 16, 16, 3)"


def test_router_imports_and_builds_without_cuda_or_jax():
    """The router tier (``tpuserve_torch.workerproc``) imports with jax,
    flax, tpuserve and aiohttp blocked, builds its state for a CUDA fleet
    (the supervisor only derives the worker configs) — also with
    ``[tenants]`` and ``[autopilot]`` on (examples/bert_flash_tenants.toml:
    the tenant ledger and the fleet controller, which it runs, take one
    admission, one tick of signals and the /tenants and /debug/autopilot
    bodies) — and CUDA is never initialized in its process."""
    code = (
        "import sys, asyncio\n"
        f"for name in {(*BLOCKED, 'aiohttp')!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from tpuserve_torch.config import load_config\n"
        "from tpuserve_torch.workerproc import drill, router, supervisor, worker\n"
        "cfg = load_config('examples/bert_flash_router.toml')\n"
        "state = router.RouterState(cfg)\n"
        "assert state.supervisor.device == 'cuda' and state.supervisor.n == 2\n"
        "from tpuserve_torch.scheduler import autopilot, tenants\n"
        "state = router.RouterState(load_config('examples/bert_flash_tenants.toml'))\n"
        "assert state.tenants is not None and state.autopilot is not None\n"
        "assert state.tenants.admit(state.tenants.resolve('victim-key')) is None\n"
        "sig = state._collect_signals()\n"
        "assert [d.hid for d in sig.domains] == [0, 1] and sig.models[0].name == 'bert'\n"
        "assert state.autopilot.policy.decide(sig) == []\n"
        "assert set(state.tenants.usage()['tenants']) == {'hostile', 'victim'}\n"
        "assert state.autopilot.describe()['enabled']\n"
        "print('cuda_initialized', torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "cuda_initialized False"


def test_host_and_peer_tiers_build_without_cuda_or_jax():
    """With jax, flax, tpuserve and aiohttp blocked, the host and peer tiers
    build their state for examples/bert_flash_hosts.toml: the primary's
    HostSupervisor (2 hosts x 2 workers on the card, the device handed to
    the agents) and peer supervisor, a peer router's passive view and its
    ring; and CUDA is never initialized in the process."""
    code = (
        "import sys\n"
        f"for name in {(*BLOCKED, 'aiohttp')!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from tpuserve_torch.config import load_config\n"
        "from tpuserve_torch.telemetry import fleet\n"
        "from tpuserve_torch.workerproc import hosts, peers, router\n"
        "cfg = load_config('examples/bert_flash_hosts.toml')\n"
        "state = router.RouterState(cfg)\n"
        "assert isinstance(state.supervisor, hosts.HostSupervisor)\n"
        "assert state.supervisor.n == 4 and state.supervisor.device == 'cuda'\n"
        "assert state.peer_sup.rids == [1] and state.topo is None\n"
        "peer = router.RouterState(cfg, router_id=1, primary_peer_url='http://127.0.0.1:1')\n"
        "assert isinstance(peer.supervisor, peers.PassiveWorkerView) and peer.peer_sup is None\n"
        "assert peers.HashRing({0: 'a', 1: 'b'}).owner('k')[0] in (0, 1)\n"
        "print('cuda_initialized', torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "cuda_initialized False"


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
    """A setting held as unported is refused by name (every table of the
    reference is typed since the mesh modes were ported: this holds the
    refusal itself, on a hand-made entry)."""
    from tpuserve_torch.config import ServerConfig
    from tpuserve_torch.server import ServerState

    cfg = ServerConfig(unported={"[distributed] coordinator_address": "10.0.0.1:1234"})
    with pytest.raises(NotImplementedError, match=r"\[distributed\]"):
        ServerState(cfg, device="cpu")


MODEL_TOML = '[[model]]\nname = "bert"\nfamily = "bert"\nparallelism = "single"\n'


@pytest.mark.parametrize("toml, named", [
    # [genserve] is served, streaming knobs included, and since the mesh
    # modes were ported the engine over replicas (GenEngineGroup) too: its
    # case (keeping its id) holds that the file builds and nothing is
    # refused.
    pytest.param("[genserve]\nenabled = true\nstream_queue = 8\n[parallel]\nmode = \"replica\"\n",
                 None, id="[genserve]\nenabled = true\n-[genserve] enabled = True"),
    # Since the router/worker tier was ported, [router], worker_crash and
    # the black-box keys are served, and since host failure domains, peer
    # routers and the fleet scrape were ported, [router] hosts, peer_port,
    # routers and [telemetry] fleet_timeout_ms too, and since deferred mode
    # was ported its worker_death fault kind: these cases (keeping their
    # ids) hold that those settings are served (``named`` None: the server
    # builds and nothing is refused).
    pytest.param("[router]\nenabled = false\nhosts = 2\n", None,
                 id="[router]\nenabled = false\nworkers = 4\n-[router] workers = 4"),
    pytest.param("[faults]\nenabled = true\n[[faults.rule]]\nkind = \"worker_death\"\n", None,
                 id="[faults]\nenabled = true\n[[faults.rule]]\nkind = \"worker_crash\"\n-"
                    "[[faults.rule]] kind = 'worker_crash' (not yet ported (router and workers))"),
    pytest.param("[router]\npeer_port = 9100\n", None,
                 id="[events]\ndir = \"/tmp/bb\"\n-[events] dir = '/tmp/bb'"),
    pytest.param("[telemetry]\nfleet_timeout_ms = 2000.0\n", None,
                 id="[telemetry]\nfleet_timeout_ms = 2000.0\n-[telemetry] fleet_timeout_ms = 2000.0"),
    pytest.param("[router]\nrouters = 2\n", None,
                 id="[events]\nsnapshot_path = \"s.json\"\n-[events] snapshot_path = 's.json'"),
    # [parallel] and pp are served since the mesh modes were ported: these
    # cases (keeping their ids) hold that the file builds and nothing is
    # refused.
    pytest.param("[parallel]\nmode = \"replica\"\n", None,
                 id="[parallel]\nmode = \"replica\"\n-[parallel] mode = 'replica'"),
    # profiler_port is served since the remote-profile listener was ported:
    # this case (keeping its id) holds that the file builds and nothing is
    # refused.
    pytest.param("profiler_port = 9999\n", None, id="profiler_port = 9999\n-profiler_port = 9999"),
    pytest.param(MODEL_TOML + "pp = 2\n", None, id=MODEL_TOML + "pp = 2\n-model bert: pp = 2"),
    # [tenants] is served since the tenants were ported: this case (keeping
    # its id) holds that the file builds and nothing is refused.
    pytest.param(MODEL_TOML + "[model.slo]\nlatency_ms = 50.0\n[tenants]\nenabled = true\n",
                 None, id=MODEL_TOML + "[model.slo]\nlatency_ms = 50.0\n[tenants]\nenabled = "
                         "true\n-[tenants] enabled = True"),
])
def test_server_refuses_unported_settings(tmp_path, toml, named):
    """A setting the port does not honour is refused by name at startup,
    never quietly ignored; the file itself still parses. A case whose
    setting the port serves now (``named`` None) builds and refuses
    nothing."""
    from tpuserve_torch.config import load_config, unported_settings
    from tpuserve_torch.server import ServerState

    path = tmp_path / "c.toml"
    path.write_text(toml)
    cfg = load_config(str(path))
    if named is None:
        assert unported_settings(cfg) == []
        ServerState(cfg, device="cpu")
        return
    with pytest.raises(NotImplementedError, match="not yet ported") as err:
        ServerState(cfg, device="cpu")
    assert named in str(err.value)


def test_server_accepts_settings_that_switch_unported_features_off(tmp_path):
    from tpuserve_torch.config import load_config, unported_settings

    path = tmp_path / "c.toml"
    path.write_text('ingest_loops = 1\n[adaptive]\nenabled = false\n'
                    '[cache]\nenabled = false\n[parallel]\nmode = "single"\n'
                    + MODEL_TOML + 'session_mode = "direct"\ncold_start = false\n')
    cfg = load_config(str(path), ['distributed.coordinator_address=""'])
    # [distributed] is typed since the mesh modes were ported.
    assert cfg.distributed.coordinator_address == "" and cfg.unported == {}
    assert unported_settings(cfg) == []
    for example in ("bert_flash.toml", "bert_long_ring.toml", "efficientdet.toml"):
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
