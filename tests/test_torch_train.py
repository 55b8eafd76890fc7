"""The port's LM train step (``tpuserve_torch.train``) against the
reference's (``tpuserve.train``), on the CPU: the JAX tests' 8 fake devices
are 8 ranks sharing the CPU (``mesh.visible_devices`` patched to ``["cpu"] *
8``), at the reference tests' size (``TrainConfig(n_layers=1, d_model=32,
d_ff=64, vocab=64, max_seq=16)``) and the dry run's defaults.

- Loss and every gradient leaf from the same weights on the reference's
  meshes: dense on (1, 1, 1), Ulysses on ``mesh_plan_for(8)`` = (2, 2, 2),
  and the ``dryrun`` configuration (ring attention + a 4-expert Switch MoE)
  on (2, 2, 2). Loss to rtol 1e-5; each gradient leaf to 1e-4 of its
  largest magnitude plus 1e-7 (the attention key bias's gradient is zero
  in exact arithmetic and ~1e-9 in both packages).
- Each rank's parameter blocks by ``TRAIN_PARTITION_RULES``.
- AdamW on identical gradients equals ``optax.adamw`` to 1e-6.
- A saved and restored state continues bit for bit.
- Ring and Ulysses split rows over data ranks and heads over model ranks
  (forward equal to the reference's ops to 1e-5), and a fully masked key
  block gives finite, zero gradients through the ring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functools import partial

from tpuserve import train as jt
from tpuserve.ops import ring_attention as jax_ring
from tpuserve.ops import ulysses_attention as jax_ulysses
from tpuserve.parallel import make_mesh as jax_make_mesh
from tpuserve.parallel.mesh import MeshPlan as JaxMeshPlan
from tpuserve_torch import train as pt
from tpuserve_torch.ops import flash_attention as fa
from tpuserve_torch.ops.ring_attention import dense_attention, ring_attention
from tpuserve_torch.ops.ulysses import ulysses_attention
from tpuserve_torch.parallel import mesh as meshlib
from tpuserve_torch.parallel.mesh import MeshPlan, make_mesh
from tpuserve_torch.utils.trees import flatten_with_paths

N_DEV = 8
SMALL = dict(n_layers=1, d_model=32, d_ff=64, vocab=64, max_seq=16)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-7


@pytest.fixture(autouse=True)
def cpu_ranks(monkeypatch):
    monkeypatch.setattr(meshlib, "visible_devices", lambda *a: ["cpu"] * N_DEV)


def port_mesh(plan: JaxMeshPlan, n: int):
    return make_mesh(MeshPlan(dp=plan.dp, tp=plan.tp, sp=plan.sp), devices=["cpu"] * n)


def assert_grads_close(got: dict, want: dict) -> None:
    got, want = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(np.asarray(got[path]) - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL, (path, err)


def test_mesh_plan_factors():
    assert pt.mesh_plan_for(8).resolve(8) == (2, 2, 2)
    assert pt.mesh_plan_for(2).resolve(2) == (1, 2, 1)
    assert pt.mesh_plan_for(1).resolve(1) == (1, 1, 1)


@pytest.mark.parametrize("cfg_kw, plan, n", [
    (SMALL, JaxMeshPlan(dp=1), 1),
    (dict(SMALL, seq_attention="ulysses"), jt.mesh_plan_for(8), 8),
    (dict(seq_attention="ring", moe_experts=4), jt.mesh_plan_for(8), 8),
], ids=["dense-1x1x1", "ulysses-2x2x2", "dryrun-ring-moe-2x2x2"])
def test_loss_and_grads_match_reference(cfg_kw, plan, n):
    jmesh = jax_make_mesh(plan, devices=jax.devices()[:n])
    model, params, _, _, _ = jt.make_train_state(jmesh, jt.TrainConfig(**cfg_kw))
    batch = jt.synthetic_batch(jt.TrainConfig(**cfg_kw), 8, seed=1)
    value_and_grad = jax.jit(jax.value_and_grad(partial(jt.loss_fn, model)))
    jloss, jgrads = jax.device_get(value_and_grad(params, batch["tokens"], batch["targets"],
                                                  batch["mask"]))
    state = pt.make_train_state(port_mesh(plan, n), pt.TrainConfig(**cfg_kw),
                                params=jax.device_get(params))
    assert state.mesh.shape == dict(zip(("data", "model", "seq"), plan.resolve(n)))
    loss, grads = pt.loss_and_grads(state, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert_grads_close(pt.to_jax_params(grads), jgrads)


def test_rank_blocks_follow_the_rules():
    """The counterpart of the reference's ``test_tp_params_actually_sharded``:
    each rank's block of every ruled leaf, on the (2, 2, 2) mesh."""
    cfg = pt.TrainConfig(moe_experts=4)
    state = pt.make_train_state(make_mesh(pt.mesh_plan_for(8)), cfg)
    assert len(state.rank_params) == N_DEV
    d, f, v, h, e = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_heads, cfg.moe_experts
    for r, tree in enumerate(state.rank_params):
        b = tree["block0"]
        assert tuple(tree["embed"]["embedding"].shape) == (v // 2, d)
        assert tuple(b["attn"]["query"]["kernel"].shape) == (d, h // 2, d // h)
        assert tuple(b["attn"]["out"]["kernel"].shape) == (h // 2, d // h, d)
        assert tuple(b["moe"]["w_up"].shape) == (e // 2, d, f)
        assert tuple(b["moe"]["router"].shape) == (d, e)              # replicated
        assert tuple(tree["lm_head"]["kernel"].shape) == (d, v // 2)
        assert tuple(tree["pos_embed"].shape) == (cfg.max_seq, d)
    dense = pt.make_train_state(make_mesh(pt.mesh_plan_for(8)), pt.TrainConfig())
    assert tuple(dense.rank_params[0]["block0"]["up"]["kernel"].shape) == (64, 64)
    assert tuple(dense.rank_params[0]["block0"]["down"]["kernel"].shape) == (64, 64)
    # Model rank 1 holds the second half of the up kernel, as P(None, "model").
    full = dense.params()["block0"]["up"]["kernel"]
    rank_m1 = dense.rank_params[2]["block0"]["up"]["kernel"]   # (data 0, model 1, seq 0)
    np.testing.assert_array_equal(rank_m1.detach().numpy(), full[:, 64:])
    # Ranks holding the same block share its master tensor.
    assert dense.rank_params[0]["pos_embed"] is dense.rank_params[7]["pos_embed"]


def test_adamw_matches_optax():
    import optax

    rng = np.random.default_rng(4)
    p0 = rng.normal(0, 1, (5, 7)).astype(np.float32)
    grads = [rng.normal(0, 1, (5, 7)).astype(np.float32) for _ in range(3)]
    tx = optax.adamw(1e-2, weight_decay=1e-4)
    jp, opt = jnp.asarray(p0), None
    opt = tx.init(jp)
    for g in grads:
        updates, opt = tx.update(jnp.asarray(g), opt, jp)
        jp = optax.apply_updates(jp, updates)
    p = torch.tensor(p0, requires_grad=True)
    torch_opt = pt.adamw([p], 1e-2)
    for g in grads:
        p.grad = torch.from_numpy(g)
        torch_opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_loss_decreases_dense_and_ulysses():
    for kind in ("dense", "ulysses"):
        cfg = pt.TrainConfig(**SMALL, seq_attention=kind)
        state = pt.make_train_state(make_mesh(pt.mesh_plan_for(8)), cfg)
        step = pt.make_train_step(state)
        batch = pt.synthetic_batch(cfg, 8, seed=0)
        losses = [float(step(batch)) for _ in range(6)]
        assert losses[-1] < losses[0], (kind, losses)
        assert state.step == 6


def test_dryrun_8dev():
    assert np.isfinite(pt.dryrun(["cpu"] * N_DEV, steps=1))


def test_checkpoint_resume_is_bitwise_continuation(tmp_path):
    """Save at step 2 (twice: the periodic loop overwrites its path),
    restore onto the mesh, and the next step equals the uninterrupted run:
    loss, params and moments."""
    mesh = make_mesh(pt.mesh_plan_for(8))
    cfg = pt.TrainConfig(**SMALL)
    state = pt.make_train_state(mesh, cfg)
    step = pt.make_train_step(state)
    for i in range(2):
        step(pt.synthetic_batch(cfg, 8, seed=i))
    path = str(tmp_path / "ckpt.npz")
    pt.save_train_state(path, state)
    pt.save_train_state(path, state)
    loss_cont = step(pt.synthetic_batch(cfg, 8, seed=2))

    restored = pt.restore_train_state(path, mesh, cfg)
    assert restored.step == 2
    assert tuple(restored.rank_params[0]["block0"]["up"]["kernel"].shape) == (32, 32)
    loss_resumed = pt.make_train_step(restored)(pt.synthetic_batch(cfg, 8, seed=2))
    assert torch.equal(loss_cont, loss_resumed)
    want, got = flatten_with_paths(state.params()), flatten_with_paths(restored.params())
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(want, got))
    for name in state.names:
        for key, t in state.masters[name].items():
            a, b = state.optimizer.state[t], restored.optimizer.state[restored.masters[name][key]]
            assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(
                a["exp_avg_sq"], b["exp_avg_sq"]) and float(a["step"]) == float(b["step"])


def _qkv(seed: int, b=4, s=16, h=4, d=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, s, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("op", ["ring", "ulysses"])
def test_sp_ops_split_rows_and_heads_like_reference(op):
    """spec ("data", "seq", "model", None) on the (2, 2, 2) mesh: the port's
    op equals the reference's, and each rank's local step sees its rows and
    heads only."""
    q, k, v = _qkv(5)
    pad = np.zeros((4, 16), np.float32)
    pad[1, 12:] = -1e9
    jmesh = jax_make_mesh(jt.mesh_plan_for(8))
    jspec = jax.sharding.PartitionSpec("data", "seq", "model", None)
    jfn = jax_ring if op == "ring" else jax_ulysses
    want = np.asarray(jfn(*(jnp.asarray(x) for x in (q, k, v)), jmesh,
                          key_padding=jnp.asarray(pad), spec=jspec, local_impl="dense"))
    mesh = make_mesh(pt.mesh_plan_for(8))
    fn = ring_attention if op == "ring" else ulysses_attention
    for impl in ("dense", "flash"):
        got = fn(*(torch.from_numpy(x) for x in (q, k, v)), mesh, key_padding=torch.from_numpy(pad),
                 spec=("data", "seq", "model", None), local_impl=impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flash_local_steps_per_rank(monkeypatch):
    """The ring's K2 step runs once per (data, model) rank, seq rank and
    ring step on that rank's rows, heads and seq block; Ulysses' K1 step
    once per (data, model) rank and seq rank on its rows, the full sequence
    and its heads divided by sp."""
    calls = []
    for name in ("flash_attention_reference", "flash_attention_stats_reference"):
        plain = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _p=plain, _n=name: calls.append(
            (_n, tuple(a[0].shape))) or _p(*a))
    q, k, v = (torch.from_numpy(x) for x in _qkv(6))
    mesh = make_mesh(pt.mesh_plan_for(8))
    spec = ("data", "seq", "model", None)
    ring_attention(q, k, v, mesh, spec=spec, local_impl="flash")
    assert calls == [("flash_attention_stats_reference", (2, 8, 2, 64))] * (2 * 2 * 2 * 2)
    calls.clear()
    ulysses_attention(q, k, v, mesh, spec=spec, local_impl="flash")
    assert calls == [("flash_attention_reference", (2, 16, 1, 64))] * (2 * 2 * 2)


@pytest.mark.parametrize("impl, masked", [("flash", -1e9), ("flash", -np.inf),
                                          ("dense", -1e9)])
def test_fully_masked_key_block_gives_zero_gradients(impl, masked):
    """Rank 1's key block fully masked for every row: the ring's output
    equals dense attention over the unmasked keys, and the gradients are
    finite, zero on the masked keys and values."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _qkv(7, b=2))
    pad = torch.zeros(2, 16)
    pad[:, 8:] = masked
    mesh = make_mesh(MeshPlan(sp=2), devices=["cpu"] * 2)
    out = ring_attention(q, k, v, mesh, key_padding=pad, local_impl=impl)
    want = dense_attention(q[:, :, :, :].detach(), k[:, :8].detach(), v[:, :8].detach())
    torch.testing.assert_close(out.detach(), want, rtol=1e-5, atol=1e-5)
    g = torch.from_numpy(np.random.default_rng(8).normal(0, 1, out.shape).astype(np.float32))
    (out * g).sum().backward()
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()
    assert torch.count_nonzero(k.grad[:, 8:]) == 0 and torch.count_nonzero(v.grad[:, 8:]) == 0
    assert torch.count_nonzero(k.grad[:, :8]) > 0 and torch.count_nonzero(q.grad) > 0


def test_several_cuda_devices_refused(monkeypatch):
    monkeypatch.setattr(meshlib, "visible_devices", lambda *a: ["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="item 10"):
        pt.make_train_state(make_mesh(), pt.TrainConfig(**SMALL))


def test_steps_with_expert_parallelism_track_reference():
    """The reference's ``test_train_step_with_expert_parallelism`` (4
    experts on the (2, 2, 2) mesh: the expert dim split on "model"), six
    whole steps (AdamW included) from the same weights: the port's losses
    equal the reference's to rtol 1e-4 at every step and fall."""
    from jax.sharding import PartitionSpec as P

    cfg_kw = dict(SMALL, moe_experts=4)
    jmesh = jax_make_mesh(jt.mesh_plan_for(8))
    model, params, tx, opt_state, shardings = jt.make_train_state(jmesh, jt.TrainConfig(**cfg_kw))
    assert params["block0"]["moe"]["w_up"].sharding.spec == P("model", None, None)
    state = pt.make_train_state(make_mesh(pt.mesh_plan_for(8)), pt.TrainConfig(**cfg_kw),
                                params=jax.device_get(params))
    assert tuple(state.rank_params[0]["block0"]["moe"]["w_up"].shape) == (2, 32, 64)
    jstep, _ = jt.make_train_step(model, tx, jmesh, shardings)
    step = pt.make_train_step(state)
    batch = jt.synthetic_batch(jt.TrainConfig(**cfg_kw), 8, seed=0)
    jlosses, losses = [], []
    for _ in range(6):
        params, opt_state, jloss = jstep(params, opt_state, dict(batch))
        jlosses.append(float(jloss))
        losses.append(float(step(batch)))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
