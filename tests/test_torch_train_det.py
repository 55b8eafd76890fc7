"""The port's EfficientDet fine-tune path (``tpuserve_torch.train_det``)
against the reference's (``tpuserve.train_det``), on the CPU at the
reference tests' size (``det_cfg``: 64 px, 5 classes, backbone width 0.25,
depth 0.35, one BiFPN and head repeat, float32).

- Synthetic batches bit-identical; ``encode_boxes`` the exact inverse of the
  port's decode and equal to the reference's to float32 rounding;
  ``match_anchors`` exact against the reference where it is exact (classes,
  positive, ignore and forced masks; box targets to 1e-5) on the
  reference's hand-made cases and on random padded ones.
- One detector step from the reference's weights carried across: the loss
  to rtol 1e-4 and every gradient leaf to 1e-4 of its largest magnitude
  (1e-9 absolute for leaves whose gradient is all but zero).
- Frozen BatchNorm: the running statistics come back bit-identical in the
  checkpoint's ``batch_stats``, and the optimizer holds only ``params``.
- The loss falls over 8 steps on 8 data ranks of the CPU, and
  ``finetune_detector`` writes a ``.npz`` under its manifest that the port's
  runtime serves as the full detector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import train_det as jtd
from tpuserve.config import ModelConfig as JaxModelConfig
from tpuserve.models import build as jax_build
from tpuserve_torch import savedmodel
from tpuserve_torch import train_det as td
from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models import build
from tpuserve_torch.models.efficientdet import decode_boxes
from tpuserve_torch.parallel import mesh as meshlib
from tpuserve_torch.parallel.mesh import make_mesh
from tpuserve_torch.utils.trees import flatten_with_paths

N_DEV = 8
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4       # of the leaf's largest gradient magnitude
GRAD_ATOL = 1e-9


def det_kwargs(**over) -> dict:
    base = dict(
        name="det", family="efficientdet", batch_buckets=[1, 2],
        deadline_ms=2.0, dtype="float32", parallelism="single",
        request_timeout_ms=60_000.0, image_size=64, wire_size=64,
        options=dict(det_classes=5, fpn_channels=16, fpn_repeats=1,
                     head_repeats=1, max_level=5, pre_nms=32, max_dets=8,
                     backbone_width=0.25, backbone_depth=0.35,
                     score_thresh=0.005),
    )
    base.update(over)
    return base


@pytest.fixture
def cpu_ranks(monkeypatch):
    """The reference tests' 8 fake devices: 8 ranks sharing the CPU."""
    monkeypatch.setattr(meshlib, "visible_devices", lambda *a: ["cpu"] * N_DEV)


def test_synthetic_batch_bit_identical():
    for seed in (0, 7):
        got = td.synthetic_det_batch(4, 64, 96, 5, 4, seed=seed)
        want = jtd.synthetic_det_batch(4, 64, 96, 5, 4, seed=seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_encode_decode_roundtrip():
    """encode_boxes is the exact inverse of the port's serving decode, and
    the reference's encode to float32 rounding."""
    rng = np.random.default_rng(0)
    anchors = np.stack([
        rng.uniform(10, 50, 32), rng.uniform(10, 50, 32),
        rng.uniform(8, 24, 32), rng.uniform(8, 24, 32)], axis=-1).astype(np.float32)
    boxes = np.stack([
        rng.uniform(0, 20, 32), rng.uniform(0, 20, 32),
        rng.uniform(30, 60, 32), rng.uniform(30, 60, 32)], axis=-1).astype(np.float32)
    reg = td.encode_boxes(torch.from_numpy(boxes), torch.from_numpy(anchors))
    back = decode_boxes(reg, torch.from_numpy(anchors), image_size=64) * 64
    np.testing.assert_allclose(back.numpy(), boxes, rtol=1e-4, atol=1e-3)
    want = np.asarray(jtd.encode_boxes(jnp.asarray(boxes), jnp.asarray(anchors)))
    np.testing.assert_allclose(reg.numpy(), want, rtol=1e-6, atol=1e-6)


def _hand_cases() -> list:
    """The reference tests' cases: exact / background / ignored band, a
    rescued low-IoU box, and padded slots beside a forced match."""
    a3 = [[16.0, 16.0, 16.0, 16.0], [48.0, 48.0, 16.0, 16.0], [24.0, 16.0, 16.0, 16.0]]
    a2 = [[16.0, 16.0, 32.0, 32.0], [48.0, 48.0, 32.0, 32.0]]
    return [
        (a3, [[8.0, 8.0, 24.0, 24.0], [0, 0, 0, 0]], [3, 0], [True, False], 0.6, 0.3),
        (a2, [[14.0, 14.0, 18.0, 18.0]], [2], [True], 0.5, 0.4),
        (a2, [[14.0, 14.0, 18.0, 18.0], [0.0] * 4, [0.0] * 4], [4, 0, 0],
         [True, False, False], 0.5, 0.4),
        # Two valid boxes sharing their best anchor: the higher index wins.
        (a2, [[14.0, 14.0, 18.0, 18.0], [13.0, 13.0, 19.0, 19.0]], [1, 3], [True, True],
         0.5, 0.4),
    ]


def _random_case(seed: int) -> tuple:
    """The D0 anchor grid at 128 px and a padded synthetic image's boxes."""
    from tpuserve_torch.models.efficientdet import make_anchors

    batch = td.synthetic_det_batch(1, 128, 128, 5, 6, seed=seed)
    return (make_anchors(128, 3, 5).tolist(), batch["boxes"][0].tolist(),
            batch["classes"][0].tolist(), batch["valid"][0].tolist(), 0.5, 0.4)


@pytest.mark.parametrize("case", [*_hand_cases(), *(_random_case(s) for s in range(3))],
                         ids=["exact-bg-ignored", "force-match", "padded-keeps-forced",
                              "shared-best-anchor", "random0", "random1", "random2"])
def test_match_anchors_exact_against_reference(case):
    anchors, boxes, classes, valid, pos_iou, neg_iou = case
    f32 = np.float32
    got = td.match_anchors(torch.tensor(anchors, dtype=torch.float32),
                           torch.tensor(boxes, dtype=torch.float32),
                           torch.tensor(classes, dtype=torch.int32), torch.tensor(valid),
                           num_classes=5, pos_iou=pos_iou, neg_iou=neg_iou)
    want = jtd.match_anchors(jnp.asarray(anchors, f32), jnp.asarray(boxes, f32),
                             jnp.asarray(classes, jnp.int32), jnp.asarray(valid),
                             num_classes=5, pos_iou=pos_iou, neg_iou=neg_iou)
    cls_t, cls_w, box_t, box_w = (t.numpy() for t in got)
    np.testing.assert_array_equal(cls_t, np.asarray(want[0]))   # classes x positives
    np.testing.assert_array_equal(cls_w, np.asarray(want[1]))   # ignored band
    np.testing.assert_array_equal(box_w, np.asarray(want[3]))   # positives, forced
    np.testing.assert_allclose(box_t, np.asarray(want[2]), rtol=1e-5, atol=1e-5)
    assert cls_t.dtype == cls_w.dtype == box_t.dtype == box_w.dtype == np.float32


def test_losses_match_optax():
    import optax

    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (2, 7, 5)).astype(np.float32)
    labels = (rng.random((2, 7, 5)) < 0.3).astype(np.float32)
    np.testing.assert_allclose(
        td.sigmoid_binary_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)),
        np.asarray(optax.sigmoid_binary_cross_entropy(logits, labels)), rtol=1e-6, atol=1e-6)
    pred, tgt = rng.normal(0, 0.2, (2, 7, 4)).astype(np.float32), np.zeros((2, 7, 4), np.float32)
    np.testing.assert_allclose(
        td.huber_loss(torch.from_numpy(pred), torch.from_numpy(tgt), 0.1),
        np.asarray(optax.huber_loss(pred, tgt, delta=0.1)), rtol=1e-6, atol=1e-7)


def test_one_det_step_matches_reference(cpu_ranks):
    """Loss and every gradient leaf of one step, from the reference's seeded
    weights carried across, over 8 data ranks (one image each)."""
    jserving = jax_build(JaxModelConfig(**det_kwargs()))
    serving = build(ModelConfig(**det_kwargs()))
    jparams = jax.device_get(jserving.load_params())
    tcfg = td.DetTrainConfig(lr=3e-3, max_boxes=4)
    jtcfg = jtd.DetTrainConfig(lr=3e-3, max_boxes=4)
    batch = td.synthetic_det_batch(N_DEV, 64, 64, 5, 4, seed=3)

    @jax.jit
    def value_and_grad(trainable, batch):
        return jax.value_and_grad(lambda p: jtd.det_loss_fn(
            jserving, {**jparams, "params": p}, batch, jtcfg))(trainable)

    jloss, jgrads = jax.device_get(value_and_grad(jparams["params"], batch))
    state = td.make_det_train_state(serving, make_mesh(), tcfg, tree=jparams)
    assert state.mesh.shape["data"] == N_DEV
    loss, grads = td.det_loss_and_grads(serving, state, batch, tcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    got = dict(flatten_with_paths(serving.to_jax_params(grads)["params"]))
    want = dict(flatten_with_paths(jgrads))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(got[path] - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL, (path, err)


def test_frozen_batchnorm_and_params_only_optimizer(cpu_ranks, tmp_path):
    serving = build(ModelConfig(**det_kwargs()))
    tree = serving.to_jax_params(serving.init_params(0))
    rng = np.random.default_rng(2)

    def perturb(node):  # non-trivial running statistics, so a drift would show
        if isinstance(node, dict):
            return {k: perturb(v) for k, v in node.items()}
        return (node + rng.uniform(0.1, 0.5, node.shape)).astype(np.float32)

    tree["batch_stats"] = perturb(tree["batch_stats"])
    tcfg = td.DetTrainConfig(lr=3e-3, max_boxes=4)
    state = td.make_det_train_state(serving, make_mesh(), tcfg, tree=tree)
    opt_ids = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert opt_ids == {id(p) for p in state.module.parameters()}
    assert not any(id(b) in opt_ids for b in state.module.buffers())
    step = td.make_det_train_step(serving, state, tcfg)
    for i in range(2):
        step(td.synthetic_det_batch(N_DEV, 64, 64, 5, 4, seed=i))
    out = serving.to_jax_params(state.state_dict())
    got = dict(flatten_with_paths(out["batch_stats"]))
    want = dict(flatten_with_paths(tree["batch_stats"]))
    assert sorted(got) == sorted(want) and got
    assert all(np.array_equal(got[p], want[p]) for p in want)
    moved = dict(flatten_with_paths(out["params"]))
    start = dict(flatten_with_paths(tree["params"]))
    assert not np.array_equal(moved["['class_net']['final']['pw']['kernel']"],
                              start["['class_net']['final']['pw']['kernel']"])


def test_finetune_loss_decreases_and_checkpoint_serves(cpu_ranks, tmp_path):
    """Eight steps on 8 data ranks lower the loss; ``finetune_detector``
    writes a ``.npz`` under its manifest that the port's runtime serves as
    the complete detector (the reference test's checks)."""
    from tpuserve_torch.runtime import ModelRuntime

    cfg = ModelConfig(**det_kwargs())
    serving = build(cfg)
    tcfg = td.DetTrainConfig(lr=3e-3, max_boxes=4)
    state = td.make_det_train_state(serving, make_mesh(), tcfg)
    step = td.make_det_train_step(serving, state, tcfg)
    losses = [float(step(td.synthetic_det_batch(N_DEV, 64, 64, 5, 4, seed=i)))
              for i in range(8)]
    assert losses[-1] < losses[0], losses

    out = str(tmp_path / "det.npz")
    final = td.finetune_detector(cfg, out, steps=2, batch_size=2, tcfg=tcfg, log_every=0)
    assert np.isfinite(final)
    tree = savedmodel.load_npz(out)
    assert savedmodel.verify_manifest_if_present(out, tree, require=True)
    want = serving.to_jax_params(serving.init_params(0))
    assert [p for p, _ in flatten_with_paths(tree)] == [p for p, _ in flatten_with_paths(want)]
    assert all(v.dtype == np.float32 for _, v in flatten_with_paths(tree))

    served = ModelRuntime(build(ModelConfig(**det_kwargs(name="det2", batch_buckets=[2],
                                                         weights=out))), device="cpu")
    served.load_params()
    batch = td.synthetic_det_batch(2, 64, 64, 5, 4, seed=99)
    outp = served.fetch(served.run((2,), (batch["images"],)))
    assert outp["boxes"].shape == (2, 8, 4)
    assert int(outp["n"][0]) >= 0


def test_batch_rounds_up_to_data_axis_and_rgb8_only(cpu_ranks, tmp_path, monkeypatch):
    seen = []
    real = td.make_det_train_step

    def spy(serving, state, tcfg):
        step = real(serving, state, tcfg)
        return lambda batch: seen.append(batch["images"].shape[0]) or step(batch)

    monkeypatch.setattr(td, "make_det_train_step", spy)
    td.finetune_detector(ModelConfig(**det_kwargs()), str(tmp_path / "d.npz"), steps=1,
                         batch_size=3, tcfg=td.DetTrainConfig(max_boxes=4), log_every=0)
    assert seen == [N_DEV]
    with pytest.raises(ValueError, match="rgb8"):
        td.finetune_detector(ModelConfig(**det_kwargs(wire_format="yuv420")),
                             str(tmp_path / "e.npz"), steps=1)


def test_several_cuda_devices_refused(monkeypatch):
    monkeypatch.setattr(meshlib, "visible_devices", lambda *a: ["cuda:0", "cuda:1"])
    serving = build(ModelConfig(**det_kwargs()))
    with pytest.raises(NotImplementedError, match="item 10"):
        td.make_det_train_state(serving, make_mesh(), td.DetTrainConfig(), tree={})


def test_weights_resume_from_npz_and_savedmodel_goes_through_import(cpu_ranks, tmp_path,
                                                                    monkeypatch):
    """``cfg.weights`` takes what the port's loader reads (a fine-tuned
    ``.npz``, held to its manifest: training resumes from its values) and
    routes a TF SavedModel through ``savedmodel.import_tree``, as
    ``import-model`` does."""
    import dataclasses

    cfg = ModelConfig(**det_kwargs())
    tcfg = td.DetTrainConfig(max_boxes=4)
    first = str(tmp_path / "first.npz")
    td.finetune_detector(cfg, first, steps=1, batch_size=N_DEV, tcfg=tcfg, log_every=0)
    start = build(cfg).to_jax_params(build(cfg).init_params(0))
    trained = savedmodel.load_npz(first)
    seen = {}
    real = td.make_det_train_state

    def spy(serving, mesh, tcfg, tree=None):
        state = real(serving, mesh, tcfg, tree)
        seen["state"] = {k: v.clone() for k, v in state.state_dict().items()}
        return state

    monkeypatch.setattr(td, "make_det_train_state", spy)
    td.finetune_detector(dataclasses.replace(cfg, weights=first), str(tmp_path / "second.npz"),
                         steps=1, batch_size=N_DEV, tcfg=tcfg, log_every=0)
    serving = build(cfg)
    got = dict(flatten_with_paths(serving.to_jax_params(seen["state"])))
    assert all(np.array_equal(got[p], v) for p, v in flatten_with_paths(trained))
    assert not all(np.array_equal(got[p], v) for p, v in flatten_with_paths(start))

    saved = tmp_path / "effb0"
    saved.mkdir()
    (saved / "saved_model.pb").write_bytes(b"")
    calls = []
    monkeypatch.setattr(savedmodel, "import_tree",
                        lambda model, path: calls.append(path) or trained)
    td.finetune_detector(dataclasses.replace(cfg, weights=str(saved)),
                         str(tmp_path / "third.npz"), steps=1, batch_size=N_DEV, tcfg=tcfg,
                         log_every=0)
    assert calls == [str(saved)]
