"""The port's parallel layer (``tpuserve_torch.parallel``) against the JAX
package's ``tpuserve.parallel`` on the CPU.

The JAX side runs on the 8 fake host devices its conftest provides; the
port's side runs with ``mesh.visible_devices`` patched to ``["cpu"] * 8``:
eight ranks that share the one CPU device, which is how the port's
single-controller mesh stands in for eight devices (and how
``chip_smoke.py`` runs every mesh on one card).

- mesh: plans, shapes, errors, ``select_devices`` (never clamps), the
  host-major grid on fake device records carrying ``process_index``;
- partition: the rules, the unmatched error, and row- and column-split
  products equal to the one-device product (float32, rtol 1e-5, the
  reference's bar);
- pipeline: ``pipeline_forward`` equal to sequential application at
  several (S, n_micro) (atol 1e-6, the reference's), a transformer-block
  stage (rtol/atol 1e-5), and both errors;
- distributed: the no-op, the TOML table, the pinned coordinates, and a
  real two-process gloo all-reduce through ``init_distributed`` in
  subprocesses, each under its own timeout.
"""

import os
import socket
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from tpuserve.config import DistributedConfig as JaxDistributedConfig
from tpuserve.config import ParallelConfig as JaxParallelConfig
from tpuserve.parallel import host_major_grid as jax_host_major_grid
from tpuserve.parallel import make_mesh as jax_make_mesh
from tpuserve.parallel import match_partition_rules as jax_match_partition_rules
from tpuserve.parallel.mesh import MeshPlan as JaxMeshPlan
from tpuserve.parallel.mesh import pad_batch_to_mesh as jax_pad_batch_to_mesh
from tpuserve.parallel.mesh import plan_for as jax_plan_for
from tpuserve.parallel.mesh import select_devices as jax_select_devices
from tpuserve.parallel.pipeline import make_stage_mesh as jax_make_stage_mesh
from tpuserve.parallel.pipeline import pipeline_forward as jax_pipeline_forward
from tpuserve.parallel.pipeline import stack_stage_params as jax_stack_stage_params
from tpuserve_torch.config import DistributedConfig, ParallelConfig, load_config
from tpuserve_torch.parallel import (P, axis_size, can_shard, host_major_grid,
                                     init_distributed, make_mesh, make_stage_mesh,
                                     match_partition_rules, named_leaves,
                                     pad_batch_to_mesh, pipeline_forward, plan_for,
                                     process_info, select_devices, shard_pytree,
                                     stack_stage_params)
from tpuserve_torch.parallel import distributed as tdist
from tpuserve_torch.parallel import mesh as meshlib
from tpuserve_torch.parallel.mesh import MeshPlan, visible_devices

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def eight(monkeypatch):
    """Eight ranks on the CPU, the port's stand-in for 8 devices."""
    monkeypatch.setattr(meshlib, "visible_devices", lambda *a: ["cpu"] * 8)


# -- mesh ----------------------------------------------------------------------

@pytest.mark.parametrize("plan", [MeshPlan(), MeshPlan(tp=2), MeshPlan(tp=2, sp=2),
                                  MeshPlan(dp=2, tp=4), MeshPlan(sp=8)])
def test_make_mesh_shapes_as_reference(eight, plan):
    mesh = make_mesh(plan)
    ref = jax_make_mesh(JaxMeshPlan(plan.dp, plan.tp, plan.sp))
    assert mesh.shape == dict(ref.shape)
    assert mesh.size == 8 and mesh.devices.shape == ref.devices.shape
    assert mesh.distinct_devices() == [torch.device("cpu")]


@pytest.mark.parametrize("plan, n", [(MeshPlan(tp=3), 8), (MeshPlan(dp=3, tp=2), 8)])
def test_mesh_plan_invalid_as_reference(plan, n):
    for p in (plan, JaxMeshPlan(plan.dp, plan.tp, plan.sp)):
        with pytest.raises(ValueError):
            p.resolve(n)


def test_visible_devices_never_the_cpu_on_its_own():
    assert visible_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            visible_devices()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()


@pytest.mark.parametrize("n_chips", [0, 1, 4, 8])
def test_select_devices_as_reference(eight, n_chips):
    assert len(select_devices(n_chips)) == len(jax_select_devices(n_chips))


def test_select_devices_never_clamps(eight):
    for fn in (select_devices, jax_select_devices):
        with pytest.raises(ValueError, match="n_chips=9 but only 8"):
            fn(9)


@pytest.mark.parametrize("data, tp", [(0, 1), (2, 1), (0, 2), (2, 2)])
def test_plan_for_and_axis_helpers(eight, data, tp):
    assert plan_for(ParallelConfig(data=data), tp=tp) == MeshPlan(
        *dataclass_fields(jax_plan_for(JaxParallelConfig(data=data), tp=tp)))
    mesh = make_mesh(plan_for(ParallelConfig(data=data), tp=tp),
                     devices=select_devices(data * tp if data else 0))
    ref = jax_make_mesh(jax_plan_for(JaxParallelConfig(data=data), tp=tp),
                        devices=jax_select_devices(data * tp if data else 0))
    for axis in ("data", "model", "seq", "stage"):
        assert axis_size(mesh, axis) == int(ref.shape.get(axis, 1))
    for b in (1, 3, 8, 9):
        assert pad_batch_to_mesh(b, mesh) == jax_pad_batch_to_mesh(b, ref)
    assert can_shard(mesh, "model", 6) == (tp > 1)
    assert not can_shard(mesh, "model", 5)


def dataclass_fields(plan) -> tuple:
    return plan.dp, plan.tp, plan.sp


@dataclass(frozen=True)
class FakeDev:
    id: int
    process_index: int


def _devs(n_hosts: int, per_host: int) -> list[FakeDev]:
    return [FakeDev(id=h * per_host + i, process_index=h)
            for h in range(n_hosts) for i in range(per_host)]


@pytest.mark.parametrize("hosts, per, dp, tp, sp", [
    (1, 8, 2, 2, 2), (4, 4, 4, 2, 2), (2, 8, 4, 2, 2), (3, 4, 3, 4, 1)])
def test_host_major_grid_as_reference(hosts, per, dp, tp, sp):
    devs = _devs(hosts, per)
    grid = host_major_grid(devs, dp, tp, sp)
    ref = jax_host_major_grid(devs, dp, tp, sp)
    assert [d.id for d in grid.reshape(-1)] == [d.id for d in ref.reshape(-1)]
    for row in grid:  # a tp/sp block never crosses a host
        assert len({d.process_index for d in row.reshape(-1)}) == 1


@pytest.mark.parametrize("devs, dp, match", [
    (_devs(4, 2), 2, "must divide each host"),
    (_devs(2, 4) + [FakeDev(99, 2)], 9, "unequal")])
def test_host_major_grid_errors_as_reference(devs, dp, match):
    tp = sp = 2 if match.startswith("must") else 1
    for fn in (host_major_grid, jax_host_major_grid):
        with pytest.raises(ValueError, match=match):
            fn(devs, dp, tp, sp)


# -- partition -------------------------------------------------------------------

RULES = [(r"head/kernel", (None, "model")), (r".*bias", ()),
         (r".*kernel", ("model", None)), (r".*", ())]


def test_match_partition_rules_as_reference():
    params = {"layer1": {"kernel": np.zeros((4, 8)), "bias": np.zeros((8,))},
              "head": {"kernel": np.zeros((8, 16))}, "scalar": np.float32(1.0)}
    port = match_partition_rules([(r, P(*s)) for r, s in RULES], params)
    ref = jax_match_partition_rules([(r, JP(*s)) for r, s in RULES], params)
    for (pn, ps), (rn, rs) in zip(named_leaves(port), jax.tree_util.tree_leaves_with_path(
            ref, is_leaf=lambda x: isinstance(x, JP))):
        assert tuple(ps) == tuple(rs), pn
    assert port["head"]["kernel"] == P(None, "model") and port["scalar"] == P()
    assert [n for n, _ in named_leaves(params)] == [
        "head/kernel", "layer1/bias", "layer1/kernel", "scalar"]


def test_match_partition_rules_unmatched_raises():
    for fn, spec in ((match_partition_rules, P()), (jax_match_partition_rules, JP())):
        with pytest.raises(ValueError, match="no partition rule"):
            fn([(r"xyz", spec)], {"a": np.zeros((2, 2))})


def test_shard_pytree_splits_per_rank(eight):
    mesh = make_mesh(MeshPlan(tp=2))
    params = {"w": np.arange(64, dtype=np.float32).reshape(16, 4),
              "b": np.zeros((4,), np.float32)}
    ranks = shard_pytree(params, [(r"w", P("model", None)), (r".*", P())], mesh)
    assert len(ranks) == 8
    for i, tree in enumerate(ranks):
        m = i % 2  # (data, model, seq) rank order: model varies second-fastest
        assert tree["w"].device == torch.device("cpu")
        np.testing.assert_array_equal(tree["w"].numpy(), params["w"][m * 8:(m + 1) * 8])
        np.testing.assert_array_equal(tree["b"].numpy(), params["b"])


@pytest.mark.parametrize("spec", [(None, "model"), ("model", None)])
def test_split_products_match_single_device(eight, spec):
    """Column split (outputs gathered) and row split (partials summed, the
    all-reduce) equal the one-device product, as the reference's sharded
    matmul does."""
    mesh = make_mesh(MeshPlan(tp=2), devices=["cpu"] * 2)
    x = np.random.default_rng(0).normal(size=(16, 32)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(32, 64)).astype(np.float32)
    ranks = shard_pytree({"w": w}, [(r"w", P(*spec))], mesh)
    xt = torch.from_numpy(x)
    if spec[1] == "model":
        out = torch.cat([xt @ r["w"] for r in ranks], dim=1)
    else:
        out = sum(xt[:, m * 16:(m + 1) * 16] @ r["w"] for m, r in enumerate(ranks))
    np.testing.assert_allclose(out.numpy(), x @ w, rtol=1e-5, atol=1e-5)


# -- pipeline --------------------------------------------------------------------

def _mlp(rng, d):
    return {"w": (rng.normal(size=(d, d)) * 0.3).astype(np.float32),
            "b": (rng.normal(size=(d,)) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("n_stages, n_micro", [(4, 8), (2, 3), (8, 1), (3, 5)])
def test_pipeline_matches_sequential_and_reference(eight, n_stages, n_micro):
    rng = np.random.default_rng(0)
    d, mb = 16, 4
    per_stage = [_mlp(rng, d) for _ in range(n_stages)]
    xs = rng.normal(size=(n_micro, mb, d)).astype(np.float32)

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    out = pipeline_forward(stage, stack_stage_params(per_stage), torch.from_numpy(xs),
                           make_stage_mesh(n_stages))
    ref = xs
    for p in per_stage:
        ref = np.tanh(ref @ p["w"] + p["b"])
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    jout = jax_pipeline_forward(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                                jax_stack_stage_params(per_stage), jnp.asarray(xs),
                                jax_make_stage_mesh(n_stages))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)


def test_pipeline_transformer_block_stage(eight):
    """A real transformer block (the port's BERT block) as the stage:
    pipelined equals sequential."""
    from tpuserve_torch.models.bert import BertBlock

    torch.manual_seed(2)
    blocks = [BertBlock(16, 2, 32).eval() for _ in range(4)]
    per_stage = [{k: v.detach() for k, v in b.state_dict().items()} for b in blocks]
    x0 = torch.randn(2, 8, 16)
    xs = torch.stack([x0, x0 + 0.5, x0 - 0.5])
    bias = torch.zeros(2, 8)
    shell = BertBlock(16, 2, 32).eval()

    def stage(params, x):
        return torch.func.functional_call(shell, params, (x, bias))

    with torch.inference_mode():
        out = pipeline_forward(stage, stack_stage_params(per_stage), xs, make_stage_mesh(4))
        ref = xs
        for b in blocks:
            ref = torch.stack([b(x, bias) for x in ref])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_pipeline_errors_as_reference(eight):
    for fn in (make_stage_mesh, jax_make_stage_mesh):
        with pytest.raises(ValueError, match="need"):
            fn(99)
    rng = np.random.default_rng(4)
    stacked = stack_stage_params([_mlp(rng, 8) for _ in range(8)])
    with pytest.raises(ValueError, match="8 stages.*4 devices"):
        pipeline_forward(lambda p, x: x, stacked, torch.zeros(2, 2, 8), make_stage_mesh(4))
    with pytest.raises(ValueError, match="8 stages.*4 devices"):
        jax_pipeline_forward(lambda p, x: x, jax_stack_stage_params([_mlp(rng, 8)] * 8),
                             jnp.zeros((2, 2, 8)), jax_make_stage_mesh(4))


def test_pipeline_schedule_ticks_and_idle_stages():
    """n_micro + S - 1 ticks; stage s runs microbatch t - s in tick t and
    nothing in its idle ticks; microbatch j leaves at tick j + S - 1."""
    from tpuserve_torch.parallel.pipeline import run_schedule

    log = []
    fns = [lambda x, s=s: (log.append((s, x)), x + 1)[1] for s in range(3)]
    outs = run_schedule(fns, [torch.tensor(10 * j) for j in range(4)],
                        [torch.device("cpu")] * 3)
    assert [int(o) for o in outs] == [3, 13, 23, 33]
    assert len(log) == 3 * 4  # no work on idle ticks
    assert [s for s, _ in log][:3] == [0, 1, 0]


# -- distributed -----------------------------------------------------------------

def test_init_distributed_disabled_is_noop():
    assert init_distributed(DistributedConfig()) is False
    assert process_info() == {"process_index": 0, "process_count": 1,
                              "global_devices": process_info()["local_devices"],
                              "local_devices": process_info()["local_devices"],
                              "platform": "gpu" if torch.cuda.is_available() else "cpu"}
    assert set(process_info()) == set(__import__("tpuserve.parallel", fromlist=["x"])
                                      .process_info())


def test_distributed_config_from_toml_as_reference(tmp_path):
    from tpuserve.config import load_config as jax_load_config

    p = tmp_path / "c.toml"
    p.write_text('port = 9999\n\n[distributed]\ncoordinator_address = "10.0.0.1:8476"\n'
                 "num_processes = 4\nprocess_id = 2\n")
    cfg, jcfg = load_config(str(p)), jax_load_config(str(p))
    assert (cfg.distributed.coordinator_address, cfg.distributed.num_processes,
            cfg.distributed.process_id) == ("10.0.0.1:8476", 4, 2)
    assert vars(cfg.distributed) == vars(jcfg.distributed)
    assert vars(DistributedConfig()) == vars(JaxDistributedConfig())
    assert load_config(None).distributed.coordinator_address == ""


def test_init_distributed_pins_only_explicit_coordinates(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    assert init_distributed(DistributedConfig(coordinator_address="h:1")) is True
    assert calls[-1] == {"init_method": "tcp://h:1", "backend": backend}
    assert init_distributed(DistributedConfig(coordinator_address="h:1",
                                              num_processes=4, process_id=2)) is True
    assert calls[-1] == {"init_method": "tcp://h:1", "backend": backend,
                         "world_size": 4, "rank": 2}


def test_mesh_of_another_process_is_refused():
    with pytest.raises(NotImplementedError, match="item 10"):
        tdist.check_local_mesh([FakeDev(0, 0), FakeDev(1, 1)])
    tdist.check_local_mesh([torch.device("cpu")] * 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_all_reduce_through_init_distributed(tmp_path):
    """Two OS processes join one group through init_distributed (tcp://
    on localhost, gloo on the CPU) and all-reduce across the process
    boundary; process_info reports each one's coordinates."""
    port = _free_port()
    code = (
        "import sys, torch, torch.distributed as dist\n"
        "rank = int(sys.argv[1])\n"
        "from tpuserve_torch.config import DistributedConfig\n"
        "from tpuserve_torch.parallel import init_distributed, process_info\n"
        f"cfg = DistributedConfig(coordinator_address='127.0.0.1:{port}',"
        " num_processes=2, process_id=rank)\n"
        "assert init_distributed(cfg) is True\n"
        "info = process_info()\n"
        "assert (info['process_index'], info['process_count']) == (rank, 2), info\n"
        "t = torch.arange(4.0) * (rank + 1)\n"
        "dist.all_reduce(t)\n"
        "print(f'RANK{rank} OK {t.tolist()}', flush=True)\n"
        "dist.destroy_process_group()\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stdout=logs[r],
                              stderr=subprocess.STDOUT, env=env) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=90)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for lg in logs:
        lg.seek(0)
        outs.append(lg.read())
        lg.close()
    for r, out in enumerate(outs):
        assert f"RANK{r} OK [0.0, 3.0, 6.0, 9.0]" in out, (r, out[-2000:])
