"""Training step over a (data, model, seq) mesh, ported from ``tpuserve/train.py``.

The model is the reference's compact pre-LN transformer encoder LM, trained
with masked-token cross-entropy under AdamW at optax's values. Its modules
keep flax's parameter names and layouts (``DenseGeneral`` q/k/v kernels
``(d_model, heads, head_dim)``, the out kernel ``(heads, head_dim,
d_model)``, ``embed/embedding``, ``pos_embed``, ``ln*``, ``lm_head``, the
Switch-MoE leaves of ``tpuserve_torch.ops.moe``), so ``from_jax_params`` /
``to_jax_params`` are a renaming and both packages start from the same
weights. Kept from flax: LayerNorm's epsilon 1e-6 and its one-pass variance
(``mean(x^2) - mean(x)^2``, floored at 0), the query scaled before the
score product, the tanh GELU.

The mesh, single-controller as every mesh of the port:

- ``make_train_state`` splits every parameter by ``TRAIN_PARTITION_RULES``
  with ``parallel.partition.shard_pytree``: one tree per mesh rank, each
  leaf that rank's block on its device. The ranks that hold the same block
  of a leaf (every rank, for a replicated leaf) share one tensor, its
  master, with one AdamW state: the ranks of a mesh share one device (the
  CPU tests' eight ranks, ``chip_smoke.py``'s ranks on one card), and a
  mesh over several CUDA devices is refused (ROADMAP item 10).
- The step computes the reference's math, which is GSPMD's: the unsharded
  step. Each leaf is gathered from its blocks (``torch.cat``, whose
  backward splits the gradient back onto the blocks), the forward runs on
  the whole batch, and with ``seq_attention`` "ring" or "ulysses" the
  attention runs through ``tpuserve_torch.ops.ring_attention`` /
  ``ulysses_attention`` with the reference's spec ``("data", "seq",
  head_axis, None)``: each (data, model) rank takes its rows and heads and
  runs the exchange over its seq ranks, kernel K2 (ring) or K1 (Ulysses)
  as its local step once ``auto_local_impl`` picks "flash". Both kernels'
  backward is the reference's dense recompute.

The optimizer is ``torch.optim.AdamW`` at optax.adamw's values (b1 0.9, b2
0.999, eps 1e-8, eps_root 0, weight decay 1e-4 on every leaf): the same
update, the decay applied before the step where optax adds it to the update.
A torch optimizer updates in place, so ``make_train_step`` returns
``step(batch) -> loss`` over a ``TrainState`` instead of the reference's
``step(params, opt_state, batch) -> (params, opt_state, loss)``.
``save_train_state`` / ``restore_train_state`` write and read the whole
state (``params``, ``opt_state`` = AdamW's ``mu``, ``nu`` and ``count``,
``step``) as one ``.npz`` of the reference's trees, where the reference
writes orbax.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuserve_torch.ops.moe import SwitchFFN
from tpuserve_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, MeshPlan
from tpuserve_torch.parallel.partition import (P, PartitionSpec, match_partition_rules,
                                               named_leaves, shard_pytree, split_leaf)


@dataclass
class TrainConfig:
    vocab: int = 512
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 128
    max_seq: int = 32
    lr: float = 1e-3
    remat: bool = False
    # Sequence-parallel attention over the mesh "seq" axis: "dense" (no SP),
    # "ring" (tpuserve_torch.ops.ring_attention) or "ulysses"
    # (tpuserve_torch.ops.ulysses).
    seq_attention: str = "dense"
    # Mixture-of-experts FFN: 0 = dense MLP; N > 0 = Switch top-1 routing
    # over N experts (tpuserve_torch.ops.moe), expert dim split on "model".
    moe_experts: int = 0
    moe_capacity: float = 1.25
    moe_aux_weight: float = 0.01


# optax.adamw's values, which the reference's TrainConfig and
# DetTrainConfig inherit.
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-4


def adamw(params: list[torch.Tensor], lr: float,
          weight_decay: float = WEIGHT_DECAY) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=weight_decay)``'s counterpart."""
    return torch.optim.AdamW(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                             weight_decay=weight_decay)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm``: epsilon 1e-6, one-pass variance, ``scale``
    and ``bias``."""

    def __init__(self, d: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * mul + self.bias


class Dense(nn.Module):
    """flax's ``nn.Dense`` / ``DenseGeneral``: ``kernel`` of shape ``in_shape
    + out_shape`` (contracted over the input's last ``len(in_shape)`` dims)
    and ``bias`` of ``out_shape``."""

    def __init__(self, in_shape: tuple, out_shape: tuple) -> None:
        super().__init__()
        self.n_in = len(in_shape)
        self.kernel = nn.Parameter(torch.zeros(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(x, self.kernel, dims=self.n_in) + self.bias


class Attention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (self-attention, no mask):
    q/k/v ``DenseGeneral`` to (heads, head_dim), attention, ``out`` back to
    d_model."""

    def __init__(self, cfg: TrainConfig, mesh: Mesh | None) -> None:
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        self.cfg, self.mesh = cfg, mesh
        self.query = Dense((d,), (h, d // h))
        self.key = Dense((d,), (h, d // h))
        self.value = Dense((d,), (h, d // h))
        self.out = Dense((h, d // h), (d,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)     # (B, S, H, D)
        kind = self.cfg.seq_attention
        if kind == "dense":
            # nn.dot_product_attention: the query scaled first.
            s = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(q.shape[-1]), k)
            a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        else:
            if self.mesh is None:
                raise ValueError(f"TrainConfig.seq_attention={kind!r} requires "
                                 "passing mesh= to the module")
            from tpuserve_torch.ops.ring_attention import ring_attention
            from tpuserve_torch.ops.ulysses import ulysses_attention

            # Heads stay tensor-parallel where tp divides them, else
            # replicated (still seq- and data-parallel), as in the reference.
            head_axis = MODEL_AXIS if self.cfg.n_heads % self.mesh.shape[MODEL_AXIS] == 0 else None
            sp_attn = ring_attention if kind == "ring" else ulysses_attention
            a = sp_attn(q, k, v, self.mesh, spec=(DATA_AXIS, SEQ_AXIS, head_axis, None))
        return self.out(a)


class Block(nn.Module):
    """Pre-LN block: attention, then a dense GELU MLP or a Switch-MoE FFN
    whose load-balance aux the block keeps in ``aux`` for ``loss_fn``."""

    def __init__(self, cfg: TrainConfig, mesh: Mesh | None = None) -> None:
        super().__init__()
        c = cfg
        if c.seq_attention not in ("dense", "ring", "ulysses"):
            raise ValueError(f"unknown seq_attention {c.seq_attention!r}")
        self.cfg = c
        self.ln1 = LayerNorm(c.d_model)
        self.attn = Attention(c, mesh)
        self.ln2 = LayerNorm(c.d_model)
        if c.moe_experts:
            self.moe = SwitchFFN(c.d_model, c.moe_experts, c.d_ff, c.moe_capacity)
        else:
            self.up = Dense((c.d_model,), (c.d_ff,))
            self.down = Dense((c.d_ff,), (c.d_model,))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        """-> ``(x, aux)``: aux is the MoE load-balance loss, or None."""
        x = x + self.attn(self.ln1(x))
        h = self.ln2(x)
        aux = None
        if self.cfg.moe_experts:
            # mask: pad tokens claim no expert capacity.
            h, aux = self.moe(h, mask)
        else:
            h = self.down(F.gelu(self.up(h), approximate="tanh"))
        return x + h, aux


class TransformerLM(nn.Module):
    def __init__(self, cfg: TrainConfig, mesh: Mesh | None = None) -> None:
        super().__init__()
        c = cfg
        self.cfg = c
        self.embed = nn.Module()
        self.embed.embedding = nn.Parameter(torch.zeros(c.vocab, c.d_model))
        self.pos_embed = nn.Parameter(torch.zeros(c.max_seq, c.d_model))
        for i in range(c.n_layers):
            self.add_module(f"block{i}", Block(c, mesh))
        self.ln_f = LayerNorm(c.d_model)
        self.lm_head = Dense((c.d_model,), (c.vocab,))

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor | None = None):
        """-> ``(logits, aux)``: float32 logits (B, S, vocab) and the MoE
        blocks' aux losses (the reference's ``sow``'d ``losses``)."""
        x = self.embed.embedding[tokens] + self.pos_embed[: tokens.shape[1]][None]
        auxes = []
        for i in range(self.cfg.n_layers):
            block = getattr(self, f"block{i}")
            if self.cfg.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                x, aux = checkpoint(block, x, mask, use_reentrant=False)
            else:
                x, aux = block(x, mask)
            if aux is not None:
                auxes.append(aux)
        return self.lm_head(self.ln_f(x)).float(), auxes


# Tensor-parallel rules: attention QKV/out and MLP kernels split on "model";
# embeddings split on the vocab dim; MoE expert dims split on "model";
# everything else replicated.
TRAIN_PARTITION_RULES: list[tuple[str, PartitionSpec]] = [
    (r"embed/embedding", P("model", None)),
    (r"attn/(query|key|value)/kernel", P(None, "model", None)),
    (r"attn/out/kernel", P("model", None, None)),
    (r"moe/w_(up|down)", P("model", None, None)),
    (r"up/kernel", P(None, "model")),
    (r"down/kernel", P("model", None)),
    (r"lm_head/kernel", P(None, "model")),
    (r".*", P()),
]


def from_jax_params(tree: Any) -> dict[str, torch.Tensor]:
    """The reference's ``params`` tree (numpy or jax leaves) -> the float32
    state_dict of ``TransformerLM``: '/' becomes '.', layouts stay."""
    return {name.replace("/", "."): torch.from_numpy(np.array(leaf, dtype=np.float32))
            for name, leaf in named_leaves(tree)}


def to_jax_params(state_dict: dict[str, torch.Tensor]) -> dict:
    """``from_jax_params`` inverted, bit for bit: nested dicts of float32
    numpy arrays."""
    return to_tree({name: t.detach().to(torch.float32).cpu().contiguous().numpy()
                    for name, t in state_dict.items()})


def to_tree(flat: dict[str, Any]) -> dict:
    """{'a.b.c': leaf} -> nested dicts, leaves as they are."""
    tree: dict = {}
    for name, leaf in flat.items():
        *mods, key = name.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[key] = leaf
    return tree


def init_params(cfg: TrainConfig, seed: int = 0) -> dict:
    """A seeded reference-layout ``params`` tree from numpy with flax's
    initializer families (it cannot reproduce jax.random's bits): LeCun
    normal kernels (fan-in = the contracted dims), normal(0.02) position
    embeddings and MoE leaves, normal(1 / sqrt(d_model)) token embeddings,
    zero biases, unit LayerNorm scales."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in TransformerLM(cfg).state_dict().items()}
    flat = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = shape[0] if not name.endswith("out.kernel") else shape[0] * shape[1]
            x = rng.normal(0.0, fan_in ** -0.5, shape)
        elif leaf in ("pos_embed", "router", "w_up", "w_down"):
            x = rng.normal(0.0, 0.02, shape)
        elif leaf == "embedding":
            x = rng.normal(0.0, cfg.d_model ** -0.5, shape)
        elif leaf == "scale":
            x = np.ones(shape)
        else:
            x = np.zeros(shape)
        flat[name] = torch.from_numpy(x.astype(np.float32))
    return to_jax_params(flat)


# -- the state on the mesh -------------------------------------------------------

def _spec_axes(spec: PartitionSpec) -> list[tuple[int, str]]:
    """(dim, axis) of every dim a spec splits, in dim order."""
    return [(dim, axis) for dim, axis in enumerate(spec) if axis is not None]


@dataclass
class TrainState:
    """The train state on a mesh: ``rank_params`` (one tree per mesh rank, in
    the mesh's flat rank order, each leaf that rank's block), whose distinct
    blocks ``masters`` (leaf name -> {block coordinate: tensor}) the
    optimizer updates, and the step count. ``params()`` gathers the full
    tree."""

    model: TransformerLM
    mesh: Mesh
    specs: dict[str, PartitionSpec]
    masters: dict[str, dict[tuple, torch.Tensor]]
    rank_params: list[dict]
    optimizer: torch.optim.AdamW
    step: int = 0

    @property
    def names(self) -> list[str]:
        """The leaves' '.'-joined names."""
        return list(self.masters)

    def gathered(self) -> dict[str, torch.Tensor]:
        """Every leaf whole ('.'-joined names), gathered from its blocks by
        ``torch.cat`` (differentiable)."""
        return {name: _gather(self.masters[name], self.specs[name], self.mesh)
                for name in self.names}

    def params(self) -> dict:
        """The full reference-layout ``params`` tree, float32 numpy."""
        with torch.no_grad():
            return to_jax_params(self.gathered())


def _gather(blocks: dict[tuple, torch.Tensor], spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """A leaf from its blocks: concatenated along each split dim, the last
    split dim innermost."""
    split = _spec_axes(spec)

    def join(prefix: tuple, i: int) -> torch.Tensor:
        if i == len(split):
            return blocks[prefix]
        dim, axis = split[i]
        parts = [join(prefix + (r,), i + 1) for r in range(mesh.shape[axis])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

    return join((), 0)


def mesh_device(mesh: Mesh) -> torch.device:
    """The one device a train mesh's ranks share; a mesh over several CUDA
    devices is refused."""
    distinct = mesh.distinct_devices()
    if len(distinct) > 1:
        raise NotImplementedError(
            f"a train mesh over {len(distinct)} CUDA devices needs collectives between "
            "cards, which is not yet ported to tpuserve_torch (ROADMAP.md queue 1: "
            "item 10, several GPUs); its ranks may share one card")
    return distinct[0]


def make_train_state(mesh: Mesh, cfg: TrainConfig, seed: int = 0,
                     params: Any = None) -> TrainState:
    """Params (``params``, a reference-layout tree, or ``init_params(cfg,
    seed)``) split by the TP rules over ``mesh``, and AdamW over their
    distinct blocks."""
    mesh_device(mesh)
    tree = params if params is not None else init_params(cfg, seed)
    tree = to_jax_params(from_jax_params(tree))   # float32 numpy leaves
    specs = {name.replace("/", "."): spec for name, spec in named_leaves(
        match_partition_rules(TRAIN_PARTITION_RULES, tree),
        is_leaf=lambda x: isinstance(x, PartitionSpec))}
    ranks = shard_pytree(tree, TRAIN_PARTITION_RULES, mesh)
    coords = [dict(zip(mesh.axis_names, idx)) for idx in np.ndindex(*mesh.devices.shape)]
    masters: dict[str, dict[tuple, torch.Tensor]] = {}
    rank_params = []
    for coord, rank_tree in zip(coords, ranks):
        flat = {}
        for path, leaf in named_leaves(rank_tree):
            name = path.replace("/", ".")
            key = tuple(coord[axis] for _, axis in _spec_axes(specs[name]))
            own = masters.setdefault(name, {})
            if key not in own:
                own[key] = leaf.detach().clone().requires_grad_(True)
            flat[name] = own[key]
        rank_params.append(to_tree(flat))
    # The module holds no weights of its own: every step passes the gathered
    # leaves in (torch.func.functional_call).
    with torch.device("meta"):
        model = TransformerLM(cfg, mesh)
    optimizer = adamw([t for own in masters.values() for t in own.values()], cfg.lr)
    return TrainState(model, mesh, specs, masters, rank_params, optimizer)


def loss_fn(model: TransformerLM, params: dict[str, torch.Tensor], tokens: torch.Tensor,
            targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked token cross-entropy (unreduced, then the masked mean) plus
    ``moe_aux_weight`` x the blocks' summed MoE aux."""
    logits, auxes = torch.func.functional_call(model, params, (tokens, mask))
    losses = -torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None].long())[..., 0]
    loss = (losses * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    aux = sum((a.sum() for a in auxes), torch.zeros((), device=loss.device))
    return loss + model.cfg.moe_aux_weight * aux


def _batch_tensors(batch: dict, device: torch.device) -> tuple:
    tok = torch.as_tensor(np.asarray(batch["tokens"]), device=device).long()
    tgt = torch.as_tensor(np.asarray(batch["targets"]), device=device).long()
    mask = torch.as_tensor(np.asarray(batch["mask"]), device=device).float()
    return tok, tgt, mask


def loss_and_grads(state: TrainState, batch: dict) -> tuple[torch.Tensor, dict]:
    """The loss of ``batch`` and every leaf's gradient, whole, at the
    state's parameters; the state is not changed (the blocks' ``.grad``
    hold the gradient after)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state.model, state.gathered(), *_batch_tensors(batch, mesh_device(state.mesh)))
    loss.backward()
    with torch.no_grad():
        grads = {name: _gather({k: t.grad for k, t in state.masters[name].items()},
                               state.specs[name], state.mesh) for name in state.names}
    return loss.detach(), grads


def make_train_step(state: TrainState):
    """``step(batch, with_grads=False) -> loss`` (``(loss, grads)`` with
    ``with_grads``): one AdamW step of ``state`` in place; the batch's rows
    split over the data ranks and its sequence over the seq ranks inside the
    attention."""
    def step(batch: dict, with_grads: bool = False):
        loss, grads = loss_and_grads(state, batch)
        state.optimizer.step()
        state.step += 1
        return (loss, grads) if with_grads else loss

    return step


# -- checkpoints -------------------------------------------------------------------

def save_train_state(path: str, state: TrainState) -> None:
    """The whole train state as one ``.npz`` (``tpuserve_torch.savedmodel.
    save_npz``, manifest included): ``params``, ``opt_state`` (``mu``,
    ``nu``: AdamW's moments gathered whole as the params; ``count``) and
    ``step``. Overwrites ``path`` atomically."""
    from tpuserve_torch import savedmodel

    opt = state.optimizer.state

    def moments(key: str) -> dict:
        return to_jax_params({name: _gather({k: opt[t][key] for k, t in state.masters[name].items()},
                                            state.specs[name], state.mesh)
                              for name in state.names})

    first = state.masters[state.names[0]]
    count = float(opt[next(iter(first.values()))]["step"]) if opt else 0.0
    with torch.no_grad():
        tree = {"params": state.params(),
                "opt_state": ({"mu": moments("exp_avg"), "nu": moments("exp_avg_sq"),
                               "count": np.asarray(count, np.float32)} if opt else {}),
                "step": np.asarray(state.step, np.int64)}
    savedmodel.save_npz(path, tree)


def restore_train_state(path: str, mesh: Mesh, cfg: TrainConfig) -> TrainState:
    """Resume from ``save_train_state``'s file (held to its manifest): the
    params split over ``mesh`` by the rules, the moments split as their
    params, the step count restored."""
    from tpuserve_torch import savedmodel

    tree = savedmodel.load_npz(path)
    savedmodel.verify_manifest_if_present(path, tree)
    state = make_train_state(mesh, cfg, params=tree["params"])
    state.step = int(tree["step"])
    opt = tree.get("opt_state") or {}
    if opt:
        mu, nu = from_jax_params(opt["mu"]), from_jax_params(opt["nu"])
        count = torch.tensor(float(opt["count"]), dtype=torch.float32)
        for name in state.names:
            axes = [axis for _, axis in _spec_axes(state.specs[name])]
            for key, t in state.masters[name].items():
                block = {m: split_leaf(full[name], state.specs[name], mesh.shape,
                                       dict(zip(axes, key))).to(t.device).contiguous()
                         for m, full in (("exp_avg", mu), ("exp_avg_sq", nu))}
                state.optimizer.state[t] = {"step": count.clone(), **block}
    return state


# -- data, mesh plan, dry run ---------------------------------------------------------

def synthetic_batch(cfg: TrainConfig, batch_size: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch_size, cfg.max_seq)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    mask = np.ones((batch_size, cfg.max_seq), np.float32)
    return {"tokens": tokens, "targets": targets, "mask": mask}


def mesh_plan_for(n_devices: int) -> MeshPlan:
    """Factor n into dp*tp*sp, exercising every axis that fits."""
    tp = 2 if n_devices % 2 == 0 else 1
    sp = 2 if n_devices % 4 == 0 else 1
    return MeshPlan(tp=tp, sp=sp)


def dryrun(devices: list, steps: int = 1) -> float:
    """Real train step(s) over a mesh of ``devices`` (one entry per rank;
    ranks may share a device): with a "seq" axis (sp > 1) the attention runs
    through ring attention, with a "model" axis (tp > 1) the FFN is a Switch
    MoE with the expert dim split over it."""
    from tpuserve_torch.parallel.mesh import make_mesh

    plan = mesh_plan_for(len(devices))
    mesh = make_mesh(plan, devices=devices)
    cfg = TrainConfig(seq_attention="ring" if plan.sp > 1 else "dense",
                      moe_experts=2 * plan.tp if plan.tp > 1 else 0)
    state = make_train_state(mesh, cfg)
    step = make_train_step(state)
    batch_size = max(4, 2 * mesh.shape[DATA_AXIS])
    loss = None
    for i in range(steps):
        loss = step(synthetic_batch(cfg, batch_size, seed=i))
    return float(loss)
