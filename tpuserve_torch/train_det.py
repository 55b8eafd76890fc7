"""EfficientDet fine-tune path, ported from ``tpuserve/train_det.py``: the
way this framework makes a FULL detector checkpoint.

The only importable published EfficientDet artifact is the EfficientNet-B0
*backbone* (a classification checkpoint, ``EfficientDetServing.
import_tf_variables``); BiFPN and the heads have none. So the detector is
transfer-learned from the imported backbone (or from the seeded init),
fine-tuned whole on labeled boxes, and written as the port's ``.npz`` of the
reference's tree under its manifest, which serves end to end through
``weights = <file>.npz``.

As in the reference:

- Target assignment on the device with static shapes: ground truth padded
  to ``max_boxes`` per image with a valid mask; IoU matching, target
  encoding (the exact inverse of ``efficientdet.decode_boxes``), focal and
  Huber losses, all without data-dependent shapes.
- RetinaNet-style assignment: IoU >= ``pos_iou`` positive, < ``neg_iou``
  background, in between ignored; every valid box also claims its best
  anchor (the forced match).
- Sigmoid focal loss (alpha 0.25, gamma 1.5) normalized by the positive
  count; Huber box loss on the positives.
- BatchNorm frozen: the network is the serving model's
  (``EfficientDetServing.logits``), whose BatchNorm is the inference affine
  over running statistics (buffers, never updated); its scale and bias train
  with the rest of the ``params`` collection, the only one the optimizer
  sees.

The trainer keeps float32 master parameters and AdamW moments (optax.adamw's
values, ``tpuserve_torch.train.adamw``) and computes the forward in the
model's compute dtype, every float leaf cast as the serving runtime casts
its module (``module.to(dtype)``), 4-D weights channels_last; the gradient
flows back through the casts to the masters. The batch's rows split over
the mesh's data ranks, each rank running its rows on its device; a mesh over
several CUDA devices is refused (ROADMAP item 10). Synthetic data draws
colored rectangles on noise (bit-identical to the reference's); a ``.npz``
with ``images``/``boxes``/``classes``/``valid`` gives real data.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpuserve_torch.parallel.mesh import DATA_AXIS, Mesh


@dataclass
class DetTrainConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-4
    focal_alpha: float = 0.25
    focal_gamma: float = 1.5
    box_weight: float = 50.0
    huber_delta: float = 0.1
    max_boxes: int = 16
    pos_iou: float = 0.5
    neg_iou: float = 0.4


# -- target assignment -------------------------------------------------------------

def _center_to_corners(a: torch.Tensor) -> torch.Tensor:
    yc, xc, h, w = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    return torch.stack([yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2], dim=-1)


def _iou_matrix(anchors_c: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(A, 4) corners x (M, 4) corners -> (A, M) IoU."""
    area_a = torch.clamp_min(anchors_c[:, 2] - anchors_c[:, 0], 0) * torch.clamp_min(
        anchors_c[:, 3] - anchors_c[:, 1], 0)
    area_b = torch.clamp_min(boxes[:, 2] - boxes[:, 0], 0) * torch.clamp_min(
        boxes[:, 3] - boxes[:, 1], 0)
    lt = torch.maximum(anchors_c[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(anchors_c[:, None, 2:], boxes[None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp_min(union, 1e-9)


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Corner GT boxes -> [ty, tx, th, tw] regression targets: the exact
    inverse of ``efficientdet.decode_boxes`` (in pixels, un-normalized)."""
    yc = (boxes[:, 0] + boxes[:, 2]) / 2
    xc = (boxes[:, 1] + boxes[:, 3]) / 2
    h = torch.clamp_min(boxes[:, 2] - boxes[:, 0], 1e-3)
    w = torch.clamp_min(boxes[:, 3] - boxes[:, 1], 1e-3)
    return torch.stack([
        (yc - anchors[:, 0]) / anchors[:, 2],
        (xc - anchors[:, 1]) / anchors[:, 3],
        torch.log(h / anchors[:, 2]),
        torch.log(w / anchors[:, 3]),
    ], dim=-1)


def match_anchors(anchors: torch.Tensor, boxes: torch.Tensor, classes: torch.Tensor,
                  valid: torch.Tensor, num_classes: int, pos_iou: float, neg_iou: float):
    """Per-image static-shape target assignment.

    anchors (A, 4) center-size pixels; boxes (M, 4) corner pixels; classes
    (M,) int; valid (M,) bool mask of the real GT slots. Returns cls_target
    (A, C), cls_weight (A,), box_target (A, 4), box_weight (A,), float32.

    The forced match is the reference's ``.at[a_star].max(..., mode="drop")``:
    padded slots are routed out of range and dropped before an ``amax``
    scatter that keeps the zero start (``include_self``), so two valid GTs
    sharing a best anchor leave the higher GT index there, deterministically.
    """
    n_anchors = anchors.shape[0]
    anchors_c = _center_to_corners(anchors)
    iou = _iou_matrix(anchors_c, boxes) * valid[None, :].to(torch.float32)
    best_iou = torch.clamp_min(iou.amax(dim=1), 0.0)   # jnp.max(initial=0.0)
    best_gt = torch.argmax(iou, dim=1)                 # first maximum, as jnp
    pos = best_iou >= pos_iou
    neg = best_iou < neg_iou
    keep = valid.to(torch.bool)
    a_star = torch.argmax(iou, dim=0)[keep]            # out-of-range slots dropped
    zeros = torch.zeros(n_anchors, dtype=torch.int64, device=anchors.device)
    forced = zeros.scatter_reduce(0, a_star, torch.ones_like(a_star), "amax",
                                  include_self=True).to(torch.bool)
    gt_index = torch.arange(boxes.shape[0], device=anchors.device)[keep]
    forced_gt = zeros.scatter_reduce(0, a_star, gt_index, "amax", include_self=True)
    pos = pos | forced
    best_gt = torch.where(forced & (best_iou < pos_iou), forced_gt, best_gt)

    cls_of = classes.long()[best_gt]
    # jax.nn.one_hot: a row of zeros for an index out of range.
    cls_target = (cls_of[:, None] == torch.arange(num_classes, device=anchors.device)
                  ).to(torch.float32) * pos[:, None]
    cls_weight = (pos | neg).to(torch.float32)
    box_target = encode_boxes(boxes[best_gt], anchors)
    return cls_target, cls_weight, box_target, pos.to(torch.float32)


# -- losses --------------------------------------------------------------------------

def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's, unreduced: the log-sigmoid form."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def huber_loss(predictions: torch.Tensor, targets: torch.Tensor, delta: float) -> torch.Tensor:
    """optax's, unreduced: 0.5 x^2 for |x| <= delta, else delta (|x| - 0.5 delta)."""
    abs_errors = torch.abs(predictions - targets)
    quadratic = torch.clamp_max(abs_errors, delta)
    return 0.5 * quadratic ** 2 + delta * (abs_errors - quadratic)


def focal_loss(logits, targets, weight, alpha, gamma):  # noqa: ANN001, ANN201
    """Sigmoid focal CE, summed; (B, A, C) logits vs one-hot targets."""
    p = torch.sigmoid(logits)
    ce = sigmoid_binary_cross_entropy(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return torch.sum(a_t * ((1 - p_t) ** gamma) * ce * weight[..., None])


def det_targets(serving, batch: dict, tcfg: DetTrainConfig, device: torch.device) -> tuple:
    """``match_anchors`` over every image of ``batch``: (B, A, C), (B, A),
    (B, A, 4), (B, A) float32 on ``device``."""
    anchors = torch.from_numpy(serving.anchors).to(device)
    boxes = torch.as_tensor(np.asarray(batch["boxes"], np.float32), device=device)
    classes = torch.as_tensor(np.asarray(batch["classes"]), device=device)
    valid = torch.as_tensor(np.asarray(batch["valid"], bool), device=device)
    per_image = [match_anchors(anchors, boxes[b], classes[b], valid[b], serving.det_classes,
                               tcfg.pos_iou, tcfg.neg_iou) for b in range(boxes.shape[0])]
    return tuple(torch.stack(t) for t in zip(*per_image))


def det_loss(cls_logits: torch.Tensor, box_reg: torch.Tensor, targets: tuple,
             tcfg: DetTrainConfig) -> torch.Tensor:
    """The detector loss on the heads' float32 outputs and ``det_targets``."""
    cls_t, cls_w, box_t, box_w = targets
    n_pos = torch.clamp_min(torch.sum(box_w), 1.0)
    cls_loss = focal_loss(cls_logits, cls_t, cls_w, tcfg.focal_alpha, tcfg.focal_gamma) / n_pos
    huber = huber_loss(box_reg, box_t, tcfg.huber_delta)
    box_loss = torch.sum(huber * box_w[..., None]) / n_pos
    return cls_loss + tcfg.box_weight * box_loss


# -- train state / step ------------------------------------------------------------

@dataclass
class DetTrainState:
    """The float32 module (master ``params``, frozen BatchNorm statistics as
    buffers) on the mesh's one device, AdamW over its parameters."""

    module: torch.nn.Module
    mesh: Mesh
    optimizer: torch.optim.AdamW
    device: torch.device

    def state_dict(self) -> dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.module.state_dict().items()}


def _compute_tensors(serving, module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Every float leaf in the compute dtype, as the runtime casts its
    module; 4-D weights channels_last for a convolutional family."""
    fmt = torch.channels_last if serving.channels_last else torch.preserve_format
    out = {}
    for name, t in [*module.named_parameters(), *module.named_buffers()]:
        if t.is_floating_point():
            t = t.to(dtype=serving.dtype, memory_format=fmt if t.dim() == 4 else
                     torch.preserve_format)
        out[name] = t
    return out


def det_logits(serving, state: DetTrainState, images) -> tuple[torch.Tensor, torch.Tensor]:
    """The network on an rgb8 (B, E, E, 3) batch: each data rank's rows
    through ``serving.logits`` in the compute dtype on its device, the
    float32 class logits and box regression joined back in row order."""
    from tpuserve_torch.models.base import rows_gather, rows_split

    tensors = _compute_tensors(serving, state.module)
    devs = state.mesh.axis_devices(DATA_AXIS)
    rgb = torch.as_tensor(np.asarray(images, np.uint8))

    def module(x: torch.Tensor):  # serving.logits calls module(x)
        return torch.func.functional_call(state.module, tensors, (x,))

    outs = [serving.logits(module, tuple(t.to(d, non_blocking=True) for t in rows))
            for rows, d in zip(rows_split((rgb,), len(devs)), devs)]
    return (rows_gather([o[0] for o in outs], state.device),
            rows_gather([o[1] for o in outs], state.device))


def det_loss_fn(serving, state: DetTrainState, batch: dict, tcfg: DetTrainConfig) -> torch.Tensor:
    """Full detector loss for a padded batch dict."""
    cls_logits, box_reg = det_logits(serving, state, batch["images"])
    with torch.no_grad():
        targets = det_targets(serving, batch, tcfg, state.device)
    return det_loss(cls_logits.float(), box_reg.float(), targets, tcfg)


def make_det_train_state(serving, mesh: Mesh, tcfg: DetTrainConfig,
                         tree=None) -> DetTrainState:
    """Params from ``tree`` (the reference's ``{"params", "batch_stats"}``)
    or ``serving.load_tree()`` (cfg.weights under its integrity gate, or the
    seeded init), float32 on the mesh's device; AdamW over ``params`` only
    (the running statistics are buffers)."""
    from tpuserve_torch.train import adamw, mesh_device

    device = mesh_device(mesh)
    tree = serving.load_tree() if tree is None else tree
    with torch.device(device):
        module = serving.build_module()
    module.load_state_dict(serving.from_jax_params(tree))
    module.eval()   # inference BatchNorm: the statistics stay frozen
    optimizer = adamw(list(module.parameters()), tcfg.lr, tcfg.weight_decay)
    return DetTrainState(module, mesh, optimizer, device)


def det_loss_and_grads(serving, state: DetTrainState, batch: dict,
                       tcfg: DetTrainConfig) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The loss of ``batch`` and each parameter's gradient (state_dict
    names), the parameters unchanged."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = det_loss_fn(serving, state, batch, tcfg)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in state.module.named_parameters()}


def make_det_train_step(serving, state: DetTrainState, tcfg: DetTrainConfig):
    """``step(batch) -> loss``: one AdamW step of ``state`` in place."""
    def step(batch: dict) -> torch.Tensor:
        loss, _ = det_loss_and_grads(serving, state, batch, tcfg)
        state.optimizer.step()
        return loss

    return step


# -- data ----------------------------------------------------------------------------

def synthetic_det_batch(batch_size: int, wire: int, image_size: int,
                        num_classes: int, max_boxes: int, seed: int = 0) -> dict:
    """Colored rectangles on noise: class = color index. Box coords are in
    MODEL pixels (image_size), images at the wire shape — matching serving,
    where the host ships wire-sized uint8 and the device resizes."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 64, (batch_size, wire, wire, 3), np.uint8)
    boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
    classes = np.zeros((batch_size, max_boxes), np.int32)
    valid = np.zeros((batch_size, max_boxes), bool)
    palette = np.linspace(96, 255, max(num_classes, 2)).astype(np.uint8)
    for b in range(batch_size):
        for m in range(rng.integers(1, min(3, max_boxes) + 1)):
            c = int(rng.integers(0, num_classes))
            h = int(rng.integers(wire // 4, wire // 2))
            w = int(rng.integers(wire // 4, wire // 2))
            y0 = int(rng.integers(0, wire - h))
            x0 = int(rng.integers(0, wire - w))
            images[b, y0:y0 + h, x0:x0 + w] = palette[c]
            scale = image_size / wire
            boxes[b, m] = (y0 * scale, x0 * scale,
                           (y0 + h) * scale, (x0 + w) * scale)
            classes[b, m] = c
            valid[b, m] = True
    return {"images": images, "boxes": boxes, "classes": classes,
            "valid": valid}


def load_npz_dataset(path: str) -> dict:
    """User data: .npz with images (N,E,E,3 u8), boxes (N,M,4 f32, model-pixel
    corners), classes (N,M i32), valid (N,M bool)."""
    z = np.load(path)
    need = {"images", "boxes", "classes", "valid"}
    missing = need - set(z.files)
    if missing:
        raise ValueError(f"npz dataset missing arrays: {sorted(missing)}")
    return {k: z[k] for k in need}


# -- entry point -----------------------------------------------------------------

def finetune_detector(cfg, out_path: str, steps: int = 50, batch_size: int = 8,
                      tcfg: DetTrainConfig | None = None,
                      dataset: str | None = None, log_every: int = 10,
                      mesh: Mesh | None = None, device: str | None = None) -> float:
    """Fine-tune the detector and write the full checkpoint to ``out_path``
    (a ``.npz`` of the reference's tree, with its manifest).

    cfg: an EfficientDet ModelConfig; cfg.weights may name what the port's
    loader reads (a ``.npz``, a torch checkpoint) or an EfficientNet-B0 TF
    SavedModel / GraphDef (imported through ``savedmodel.import_tree``, as
    ``import-model`` does: the backbone transfers, BiFPN and heads keep the
    seeded init), or be unset (the seeded init). The mesh defaults to every
    visible CUDA device (``device`` names one, ``"cpu"`` included). Returns
    the final loss.
    """
    import dataclasses

    from tpuserve_torch import savedmodel
    from tpuserve_torch.models import build
    from tpuserve_torch.parallel.mesh import make_mesh

    tcfg = tcfg or DetTrainConfig()
    if cfg.wire_format != "rgb8":
        # device_preprocess would read the single (B, E, E, 3) training
        # array as YUV planes.
        raise ValueError(
            "finetune_detector trains on rgb8 wire batches; set "
            'wire_format = "rgb8" for training (the serving config can still '
            "use yuv420 — weights are wire-format independent)")
    tree = None
    if cfg.weights and savedmodel.import_format(cfg.weights) in ("saved_model", "graphdef"):
        serving = build(dataclasses.replace(cfg, weights=None))
        tree = savedmodel.import_tree(serving, cfg.weights)
    else:
        serving = build(cfg)
    if mesh is None:
        mesh = make_mesh(devices=[device]) if device is not None else make_mesh()
    # Batch splits over the mesh "data" axis; round up so it divides.
    d = int(mesh.shape[DATA_AXIS])
    batch_size = max(d, -(-batch_size // d) * d)
    state = make_det_train_state(serving, mesh, tcfg, tree)
    step = make_det_train_step(serving, state, tcfg)

    data = load_npz_dataset(dataset) if dataset else None
    n = data["images"].shape[0] if data else 0
    loss = float("nan")
    for i in range(steps):
        if data:
            idx = np.random.default_rng(i).integers(0, n, batch_size)
            batch = {k: v[idx] for k, v in data.items()}
        else:
            batch = synthetic_det_batch(
                batch_size, cfg.wire_size, cfg.image_size,
                serving.det_classes, tcfg.max_boxes, seed=i)
        loss = step(batch)
        if log_every and (i + 1) % log_every == 0:
            print(f"# det finetune step {i + 1}/{steps}: loss {float(loss):.4f}")
    savedmodel.save_npz(out_path, serving.to_jax_params(state.state_dict()))
    return float(loss)
