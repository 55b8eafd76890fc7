"""BERT-base text classification, ported from ``tpuserve/models/bert.py``.

The network is the reference's: post-LN residual blocks (original BERT),
exact (erf) GELU FFN, LayerNorm eps 1e-12, tanh pooler on [CLS] in the
compute dtype and a float32 linear classifier. Padding is an additive -1e9
per-key bias, so padded lanes cannot perturb real lanes, and the serving
forward ends in softmax and top-k on the device.

``options.attention`` picks the attention core:

- ``"dense"``: ``masked_attention``, the reference's ``_masked_attention``
  (f32 softmax, P cast to the compute dtype before P.V);
- ``"flash"``: ``tpuserve_torch.ops.flash_attention`` — kernel K1 on CUDA,
  its plain version on the CPU (P stays f32, as in the reference's kernel);
- ``"ring"`` / ``"ulysses"``: sequence-parallel attention over the serving
  mesh's ``seq`` axis (``tpuserve_torch.ops.ring_attention`` /
  ``ulysses_attention``), whose local step ``local_impl="auto"`` picks by
  memory: dense, or kernel K2 (ring) / K1 (Ulysses) once the dense score
  tile passes 2 GiB. They need the mesh: the runtime calls ``bind_mesh``
  before it builds the module; a forward without one raises.

The mesh modes (``tpuserve_torch.runtime``), single-controller:

- ``parallelism = "sharded"`` with a data axis: each data rank runs its
  rows on its own copy of the parameters (``ServingModel.mesh_forward``);
- ``tp > 1`` (the reference's partition rules, ``partition_rules``): each
  model rank holds its heads of Q/K/V and its rows of the out projection,
  its columns of ``mlp_up`` and rows of ``mlp_down``, and runs K1 on its own
  heads; after each row-split product the ranks' partial sums are added on
  the first rank's device (the all-reduce over "model") and the sum goes
  back to every rank. The reference's replicated biases are sliced with
  their kernels (q/k/v and ``mlp_up``), and the row-split products' biases
  are added once, by model rank 0. Under ``quantize`` the whole tree is
  quantized first and then split (``quantize.specs_for_tree``), so each
  rank's scales are the whole weight's;
- ``parallelism = "pipeline"`` (``pp`` stages): the reference's GPipe trunk
  — the layers split into S equal stages, one per rank of a ("stage",)
  mesh, each stage's module holding its layers and the replicated
  embedding and head; embed on stage 0, ``_pp_micro`` microbatches through
  ``parallel.pipeline.run_schedule``, head on the last stage. The
  reference composes pipelining with dense attention only; the port's
  stages also run K1 (``attention = "flash"``), which needs no mesh.

Ring and Ulysses attention serve beside a data and a model axis too
(the reference's spec ``("data", "seq", head_axis, None)``): each rank
module of the split forward (one per data rank, or per (data, model) rank
under tp > 1) holds its rows and its heads, and its attention runs over
that rank's own seq ranks (``parallel.mesh.seq_mesh``), never splitting
them again. A seq axis alone keeps one module over the whole mesh.

``quantize = "int8"`` stores the large weights int8 (weight-only, as the
reference) and ``"int8c"`` also multiplies the q/k/v/out projections and
the FFN int8 x int8 -> int32 (``quantize.Int8Linear``, the reference's
``Int8SelfAttention`` and ``Int8Dense``); ``reference_layout`` tells the
quantizer the reference's layout of each leaf, so q/k/v keep one scale per
head_dim index shared by all heads and the embedding tables one per column
of d, as in the reference.

``options.moe_experts`` = E > 0 replaces every block's FFN with the
reference's top-1 Switch FFN (``tpuserve_torch.ops.moe.SwitchFFN``, routed
per batch row with capacity ``ceil(S / E * options.moe_capacity_factor)``,
default 1.25; padded tokens, recovered from the attention mask, never claim
capacity). Its GELU is the tanh approximation, as flax's ``nn.gelu``
default that the reference's ``SwitchFFN`` calls, where the dense FFN's is
the exact one. The reference's refusals come with it: no pipeline mode, an
expert count the tensor-parallel width divides, no imported weights, and
no int8c (the MoE FFN has no int8-native kernels).

``from_jax_params`` converts the reference's flax parameter tree (numpy
leaves) into this module's state_dict, which is how the tests hold the port
to the JAX package on the same weights, and ``to_jax_params`` converts
back. ``cfg.weights`` names a ``.npz`` of that tree; without it the model
serves a seeded init. ``import_tf_variables`` maps an HF
``TFBertForSequenceClassification`` SavedModel onto the tree
(``import-model``).

Sizes come from ``cfg.options`` (layers/d_model/heads/d_ff/vocab_size) with
BERT-base defaults; the vocabulary is ``synthetic_vocab`` or a standard
``vocab.txt`` (``options.vocab_file``).
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models.base import (MeshModule, ServingModel, TensorSpec, not_ported,
                                        partial_sum, rows_gather, rows_split, to_device,
                                        tp_bias_share)
from tpuserve_torch.ops.flash_attention import flash_attention
from tpuserve_torch.ops.moe import SwitchFFN
from tpuserve_torch.ops.ring_attention import ring_attention
from tpuserve_torch.ops.ulysses import ulysses_attention
from tpuserve_torch.quantize import Int8Linear, activation_scale
from tpuserve_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh,
                                          batch_sharding, seq_mesh)
from tpuserve_torch.parallel.partition import P, PartitionSpec
from tpuserve_torch.parallel.pipeline import STAGE_AXIS, run_schedule
from tpuserve_torch.text import WordPieceTokenizer, synthetic_vocab

ATTENTION_IMPLS = ("dense", "flash", "ring", "ulysses")


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_bias: torch.Tensor) -> torch.Tensor:
    """(B,S,H,D) attention with an additive (B, S) f32 key bias, f32
    softmax; the probabilities drop to the compute dtype before P.V."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = s + key_bias[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class SelfAttention(nn.Module):
    """Multi-head self-attention with the reference's projections
    (flax ``MultiHeadDotProductAttention``: query/key/value/out).
    ``head_dim`` defaults to d_model // heads; a tensor-parallel rank holds
    fewer heads of the full head_dim."""

    def __init__(self, d_model: int, heads: int, attention: str,
                 mesh: Mesh | None = None, head_dim: int | None = None) -> None:
        super().__init__()
        self.heads = heads
        self.head_dim = head_dim or d_model // heads
        self.attention = attention
        self.mesh = mesh  # required for "ring" / "ulysses"
        inner = heads * self.head_dim
        self.query = Int8Linear(d_model, inner)
        self.key = Int8Linear(d_model, inner)
        self.value = Int8Linear(d_model, inner)
        self.out = Int8Linear(inner, d_model)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        return self.out(self.core(x, key_bias))

    def core(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        """The attention before the out projection: (B, S, heads * head_dim)."""
        b, s, _ = x.shape
        shape = (b, s, self.heads, self.head_dim)
        q = self.query(x).view(shape)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        if self.attention == "flash":
            a = flash_attention(q, k, v, key_bias)
        elif self.attention in ("ring", "ulysses"):
            if self.mesh is None:
                raise ValueError(
                    f"attention={self.attention!r} needs the serving mesh: the "
                    "runtime calls bind_mesh(mesh); do the same before forward")
            sp_attn = ring_attention if self.attention == "ring" else ulysses_attention
            a = sp_attn(q, k, v, self.mesh, key_padding=key_bias,
                        spec=(DATA_AXIS, SEQ_AXIS, MODEL_AXIS, None))
        else:
            a = masked_attention(q, k, v, key_bias)
        return a.reshape(b, s, self.heads * self.head_dim)


class BertBlock(nn.Module):
    def __init__(self, d_model: int, heads: int, d_ff: int,
                 attention: str = "dense", ln_eps: float = 1e-12,
                 mesh: Mesh | None = None, moe_experts: int = 0,
                 moe_capacity_factor: float = 1.25,
                 head_dim: int | None = None) -> None:
        super().__init__()
        self.attn = SelfAttention(d_model, heads, attention, mesh, head_dim)
        self.ln_attn = nn.LayerNorm(d_model, eps=ln_eps)
        if moe_experts:
            self.moe = SwitchFFN(d_model, moe_experts, d_ff, moe_capacity_factor)
        else:
            self.mlp_up = Int8Linear(d_model, d_ff)
            self.mlp_down = Int8Linear(d_ff, d_model)
        self.ln_mlp = nn.LayerNorm(d_model, eps=ln_eps)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        # Post-LN (original BERT): sublayer -> add -> LayerNorm.
        x = self.ln_attn(x + self.attn(x, key_bias))
        if hasattr(self, "moe"):
            # The (B, S) token mask from the additive key bias, as the
            # reference recovers it; the serving forward drops the aux loss.
            h, _aux = self.moe(x, (key_bias == 0.0).float())
        else:
            h = self.ffn(x)
        return self.ln_mlp(x + h)

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp_down(F.gelu(self.mlp_up(x)))  # exact (erf) GELU


class BertClassifier(nn.Module):
    def __init__(self, vocab_size: int, layers: int, d_model: int, heads: int,
                 d_ff: int, max_seq: int, num_classes: int,
                 attention: str = "dense", ln_eps: float = 1e-12,
                 mesh: Mesh | None = None, moe_experts: int = 0,
                 moe_capacity_factor: float = 1.25,
                 head_dim: int | None = None) -> None:
        super().__init__()
        # nn.Embedding's own N(0, 1) init, skipped on the meta device (where
        # init_params only reads shapes): normal_ on a meta tensor imports
        # torch._dynamo, seconds of every BERT process's boot.
        weight = torch.empty(vocab_size, d_model)
        if not weight.is_meta:
            nn.init.normal_(weight)
        self.embed = nn.Embedding(vocab_size, d_model, _weight=weight)
        self.pos_embed = nn.Parameter(torch.zeros(max_seq, d_model))
        self.ln_embed = nn.LayerNorm(d_model, eps=ln_eps)
        self.layers = nn.ModuleList(
            BertBlock(d_model, heads, d_ff, attention, ln_eps, mesh,
                      moe_experts, moe_capacity_factor, head_dim)
            for _ in range(layers))
        self.pooler = nn.Linear(d_model, d_model)
        self.classifier = nn.Linear(d_model, num_classes)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.embed_tokens(ids)
        key_bias = key_bias_of(mask)
        for layer in self.layers:
            x = layer(x, key_bias)
        return self.head(x)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.embed(ids)
        x = x + self.pos_embed[: ids.shape[1]].to(x.dtype)
        return self.ln_embed(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        pooled = torch.tanh(self.pooler(x[:, 0]))
        # The classifier runs in f32 whatever the compute dtype.
        return F.linear(pooled.float(), self.classifier.weight.float(),
                        self.classifier.bias.float())


def key_bias_of(mask: torch.Tensor) -> torch.Tensor:
    """The additive (B, S) f32 key bias of a padding mask."""
    return (1.0 - mask.float()) * -1e9


def row_split_product(mods: list[Int8Linear], xs: list[torch.Tensor],
                      devices: list[torch.device]) -> torch.Tensor:
    """A product whose weight rows (its input dim) are split over the model
    ranks: each rank's partial from its block of the input, then the sum
    over the ranks on the first rank's device. Under int8c every rank
    quantizes its block with the whole row's activation scale (the max of
    the ranks' absmax), as the reference's partitioned ``int8_matmul``
    does."""
    scales = [None] * len(mods)
    if mods[0].weight_scale is not None:
        amax = torch.stack([x.float().abs().amax(dim=-1, keepdim=True).to(devices[0])
                            for x in xs]).amax(dim=0)
        scales = [activation_scale(amax).to(d) for d in devices]
    return partial_sum([m(x, s_x=s) for m, x, s in zip(mods, xs, scales)], devices[0])


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """The reference's flax tree (``{"params": ...}``, numpy or jax leaves)
    -> this port's float32 state_dict.

    Layouts: q/k/v kernels (D, H, hd) -> (H*hd, D) and their biases
    (H, hd) -> (H*hd,); the out kernel (H, hd, D) -> (D, H*hd); Dense
    kernels (in, out) -> (out, in); LayerNorm scale/bias -> weight/bias;
    the embedding table, pos_embed (max_seq, D) and the MoE FFN's
    ``moe/{router, w_up, w_down}`` carry over unchanged."""
    p = tree["params"] if "params" in tree else tree

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def dense(prefix: str, node) -> dict:
        return {f"{prefix}.weight": t(node["kernel"]).T.contiguous(),
                f"{prefix}.bias": t(node["bias"])}

    def norm(prefix: str, node) -> dict:
        return {f"{prefix}.weight": t(node["scale"]),
                f"{prefix}.bias": t(node["bias"])}

    sd = {"embed.weight": t(p["embed"]["embedding"]),
          "pos_embed": t(p["pos_embed"]),
          **norm("ln_embed", p["ln_embed"]),
          **dense("pooler", p["pooler"]),
          **dense("classifier", p["classifier"])}
    i = 0
    while f"layer{i}" in p:
        lp = p[f"layer{i}"]
        pre = f"layers.{i}"
        for name in ("query", "key", "value"):
            kern = t(lp["attn"][name]["kernel"])           # (D, H, hd)
            sd[f"{pre}.attn.{name}.weight"] = kern.reshape(kern.shape[0], -1).T.contiguous()
            sd[f"{pre}.attn.{name}.bias"] = t(lp["attn"][name]["bias"]).reshape(-1)
        out = t(lp["attn"]["out"]["kernel"])               # (H, hd, D)
        sd[f"{pre}.attn.out.weight"] = out.reshape(-1, out.shape[-1]).T.contiguous()
        sd[f"{pre}.attn.out.bias"] = t(lp["attn"]["out"]["bias"])
        sd.update(norm(f"{pre}.ln_attn", lp["ln_attn"]))
        if "moe" in lp:
            sd.update({f"{pre}.moe.{w}": t(lp["moe"][w])
                       for w in ("router", "w_up", "w_down")})
        else:
            sd.update(dense(f"{pre}.mlp_up", lp["mlp_up"]))
            sd.update(dense(f"{pre}.mlp_down", lp["mlp_down"]))
        sd.update(norm(f"{pre}.ln_mlp", lp["ln_mlp"]))
        i += 1
    return sd


def to_jax_params(state_dict: dict[str, torch.Tensor], heads: int) -> dict:
    """This port's state_dict -> the reference's flax tree ``{"params":
    ...}`` of float32 numpy arrays: ``from_jax_params`` inverted, bit for
    bit (``heads`` splits the q/k/v and out projections back into (H, hd))."""
    sd = {k: v.detach().to(torch.float32).cpu() for k, v in state_dict.items()}

    def n(t: torch.Tensor) -> np.ndarray:
        return t.contiguous().numpy()

    def dense(prefix: str) -> dict:
        return {"kernel": n(sd[f"{prefix}.weight"].T), "bias": n(sd[f"{prefix}.bias"])}

    def norm(prefix: str) -> dict:
        return {"scale": n(sd[f"{prefix}.weight"]), "bias": n(sd[f"{prefix}.bias"])}

    p = {"embed": {"embedding": n(sd["embed.weight"])},
         "pos_embed": n(sd["pos_embed"]),
         "ln_embed": norm("ln_embed"),
         "pooler": dense("pooler"),
         "classifier": dense("classifier")}
    i = 0
    while f"layers.{i}.attn.query.weight" in sd:
        pre = f"layers.{i}"
        attn = {}
        for name in ("query", "key", "value"):
            w = sd[f"{pre}.attn.{name}.weight"]            # (H*hd, D)
            attn[name] = {"kernel": n(w.T.reshape(w.shape[1], heads, -1)),
                          "bias": n(sd[f"{pre}.attn.{name}.bias"].reshape(heads, -1))}
        out = sd[f"{pre}.attn.out.weight"]                  # (D, H*hd)
        attn["out"] = {"kernel": n(out.T.reshape(heads, -1, out.shape[0])),
                       "bias": n(sd[f"{pre}.attn.out.bias"])}
        if f"{pre}.moe.router" in sd:
            ffn = {"moe": {w: n(sd[f"{pre}.moe.{w}"])
                           for w in ("router", "w_up", "w_down")}}
        else:
            ffn = {"mlp_up": dense(f"{pre}.mlp_up"),
                   "mlp_down": dense(f"{pre}.mlp_down")}
        p[f"layer{i}"] = {"attn": attn, "ln_attn": norm(f"{pre}.ln_attn"),
                          **ffn, "ln_mlp": norm(f"{pre}.ln_mlp")}
        i += 1
    return {"params": p}


class BertServing(ServingModel):
    def __init__(self, cfg: ModelConfig) -> None:
        # The option checks read the config alone and run first, as the
        # reference's do: an MoE config with weights= is refused for that,
        # whatever the weights' form.
        opt = cfg.options
        attention = str(opt.get("attention", "dense"))
        if attention not in ATTENTION_IMPLS:
            raise ValueError("options.attention must be 'dense', 'flash', "
                             f"'ring', or 'ulysses', got {attention!r}")
        if attention in ("ring", "ulysses"):
            if cfg.parallelism == "replica":
                # One shared module can't close over N per-replica meshes;
                # SP over a 1-device replica is pointless anyway.
                raise ValueError(
                    f"options.attention={attention!r} requires parallelism="
                    "'sharded' or 'single' (replica mode has one mesh per "
                    "device)")
            bad = [s for s in cfg.seq_buckets if s % cfg.sp]
            if bad:
                raise ValueError(
                    f"{attention} attention shards the seq dim over "
                    f"sp={cfg.sp}; seq buckets {bad} are not divisible")
        if attention == "ulysses":
            # The all-to-all deals LOCAL heads (after any tp split) across
            # the seq axis; mirror the op's check at build time.
            heads = int(opt.get("heads", 12))
            local = heads // cfg.tp if heads % cfg.tp == 0 else heads
            if local % cfg.sp:
                raise ValueError(
                    f"ulysses attention deals heads over sp={cfg.sp}; "
                    f"local heads {local} (heads={heads}, tp={cfg.tp}) "
                    "are not divisible")
        moe_experts = int(opt.get("moe_experts", 0))
        # The reference's refusals, with its reasons, ahead of the port's
        # own (item 10 below).
        if cfg.parallelism == "pipeline":
            if attention not in ("dense", "flash"):
                # The reference takes "dense" only; the port's stages also
                # run K1, which closes over no mesh.
                raise ValueError(
                    "parallelism='pipeline' supports options.attention="
                    f"'dense' or 'flash', got {attention!r}")
            if moe_experts:
                raise ValueError(
                    "parallelism='pipeline' does not compose with "
                    "options.moe_experts")
        if moe_experts and cfg.parallelism == "sharded" and cfg.tp > 1 \
                and moe_experts % cfg.tp:
            raise ValueError(
                f"options.moe_experts={moe_experts} shards the expert dim "
                f"over the model axis (tp={cfg.tp}); it must divide evenly")
        if moe_experts and cfg.weights:
            raise ValueError(
                "options.moe_experts cannot be combined with weights=: no "
                "TF import mapping exists for the MoE FFN; serve it with "
                "seeded weights or an orbax checkpoint trained in-framework")
        if moe_experts and cfg.parallelism == "sharded" and cfg.tp > 1:
            raise not_ported(f"options.moe_experts with tp={cfg.tp} (experts on the "
                             "model axis)", "item 10, expert parallelism")
        super().__init__(cfg)
        self.attention = attention
        self.moe_experts = moe_experts
        self.moe_capacity_factor = float(opt.get("moe_capacity_factor", 1.25))
        self.mesh: Mesh | None = None
        self.max_seq = max(cfg.seq_buckets)
        vocab_file = opt.get("vocab_file")
        if vocab_file:
            self.tokenizer = WordPieceTokenizer.from_vocab_file(vocab_file)
        else:
            self.tokenizer = WordPieceTokenizer(
                synthetic_vocab(int(opt.get("vocab_size", 8192))))
        self.vocab_size = max(self.tokenizer.vocab.values()) + 1
        self.layers = int(opt.get("layers", 12))
        self.d_model = int(opt.get("d_model", 768))
        self.heads = int(opt.get("heads", 12))
        self.d_ff = int(opt.get("d_ff", 3072))
        self.head_dim = self.d_model // self.heads
        self.top_k = min(5, cfg.num_classes)

    # -- params --------------------------------------------------------------
    def build_module(self) -> BertClassifier:
        return BertClassifier(
            vocab_size=self.vocab_size, layers=self.layers,
            d_model=self.d_model, heads=self.heads, d_ff=self.d_ff,
            max_seq=self.max_seq, num_classes=self.cfg.num_classes,
            attention=self.attention, mesh=self.mesh,
            moe_experts=self.moe_experts,
            moe_capacity_factor=self.moe_capacity_factor, head_dim=self.head_dim)

    def reference_layout(self, name: str, shape: tuple) -> tuple[tuple, tuple]:
        """The reference's layouts of BERT's leaves (``from_jax_params``):
        q/k/v kernels (D, H, hd) of the port's (H*hd, D) and their biases
        (H, hd); the out kernel (H, hd, D) of the port's (D, H*hd); the
        embedding tables (rows, D) in both; Dense kernels (in, out)."""
        h = self.heads
        parts = name.split(".")
        if len(parts) > 2 and parts[-3] == "attn":
            if parts[-2] in ("query", "key", "value"):
                if parts[-1] == "weight":
                    return (h, shape[0] // h, shape[1]), (2, 0, 1)
                return (h, shape[0] // h), (0, 1)
            if parts[-2] == "out" and parts[-1] == "weight":
                return (shape[0], h, shape[1] // h), (1, 2, 0)
        if name in ("embed.weight", "pos_embed") or ".moe." in name:
            return tuple(shape), tuple(range(len(shape)))
        return super().reference_layout(name, shape)

    def int8c_native_kernel_paths(self) -> list[str]:
        """The weights the int8c modules consume natively: the FFN matmuls
        (2/3 of a block's matmul FLOPs) and the q/k/v/out projections (the
        remaining 1/3) — the reference's ``mlp_(up|down)/kernel$`` and
        ``attn/(query|key|value|out)/kernel$`` under the port's names. The
        MoE variant has no mlp kernels, so it names none and the runtime
        refuses int8c for it, as the reference's does."""
        if self.moe_experts:
            return []
        return [r"mlp_(up|down)\.weight$", r"attn\.(query|key|value|out)\.weight$"]

    pipeline_capable = True

    def bind_mesh(self, mesh: Mesh) -> None:
        """Ring/Ulysses attention closes over the serving mesh; modules
        built after this call carry it (the runtime binds before it builds
        the module and warms up). A ("stage",) mesh checks the layer split
        (the stage count is known only once the mesh exists). A split
        forward's rank modules take their own seq meshes (``mesh_module``)."""
        if STAGE_AXIS in mesh.shape:
            s = mesh.shape[STAGE_AXIS]
            if self.layers % s:
                raise ValueError(
                    f"pipeline: layers={self.layers} must split evenly over "
                    f"{s} stages; adjust options.layers or pp")
            self.mesh = None
            return
        self.mesh = mesh

    # -- the mesh modes --------------------------------------------------------
    def partition_rules(self) -> list[tuple[str, PartitionSpec]]:
        """The reference's rules over its tree: under tp > 1 Q/K/V by heads
        and the out projection by rows, ``mlp_up`` by columns and
        ``mlp_down`` by rows (the expert dim on "model" for MoE, which the
        port refuses under tp > 1); pipeline mode stacks the trunk on
        "stage"; else replicated."""
        if self.cfg.parallelism == "pipeline":
            return [(r"^staged/", P(STAGE_AXIS)), (r".*", P())]
        if self.cfg.tp <= 1:
            return [(".*", P())]
        return [
            (r"attn/(query|key|value)/kernel", P(None, MODEL_AXIS, None)),
            (r"attn/out/kernel", P(MODEL_AXIS, None, None)),
            (r"mlp_up/kernel", P(None, MODEL_AXIS)),
            (r"mlp_down/kernel", P(MODEL_AXIS, None)),
            (r"moe/w_(up|down)", P(MODEL_AXIS, None, None)),
            (r".*", P()),
        ]

    def mesh_module(self, tree: Any, mesh: Mesh, prepare) -> MeshModule:
        """One module per data rank (tp = 1: the whole tree), or per (data,
        model) rank (tp > 1: the rank's blocks by ``partition_rules``), or
        per pipeline stage. The seq ranks of a (data, model) rank share its
        parameters, so they are not built as modules of their own: the
        rank's ring or Ulysses attention runs over them (its ``seq_mesh``)."""
        if STAGE_AXIS in mesh.shape:
            return self._stage_module(tree, mesh, prepare)
        dp, tp = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
        if tp == 1:
            return MeshModule([prepare(self._with(mesh=seq_mesh(mesh, d)), tree,
                                       mesh.devices[d, 0, 0]) for d in range(dp)],
                              mesh, (dp,))
        if self.heads % tp or self.d_ff % tp:
            raise ValueError(f"tp={tp} must divide heads={self.heads} and "
                             f"d_ff={self.d_ff}")
        ranks = []
        for coord, rank_tree, dev in self.model_rank_trees(tree, mesh):
            d, m = coord[DATA_AXIS], coord[MODEL_AXIS]
            rank_model = self._with(heads=self.heads // tp, d_ff=self.d_ff // tp,
                                    mesh=seq_mesh(mesh, d, m))
            ranks.append(prepare(rank_model, self._tp_biases(rank_tree, m, tp), dev))
        return MeshModule(ranks, mesh, (dp, tp))

    @staticmethod
    def _tp_biases(tree: dict, m: int, tp: int) -> dict:
        """A model rank's block of the biases the reference keeps replicated:
        q/k/v's (H, hd) by heads and ``mlp_up``'s by columns; the row-split
        products' (out, ``mlp_down``) on rank 0 alone."""
        return tp_bias_share(tree, m, tp, cols=("query", "key", "value", "mlp_up"),
                             rows=("out", "mlp_down"))

    def _stage_module(self, tree: Any, mesh: Mesh, prepare) -> MeshModule:
        """One module per stage: its L/S layers (layer i of the tree in
        stage i // (L/S), place i % (L/S), as the reference's stacking) and
        the replicated embedding, pooler and classifier."""
        s = mesh.shape[STAGE_AXIS]
        per = self.layers // s
        p = tree["params"]
        unstaged = {k: v for k, v in p.items() if not k.startswith("layer")}
        stage_model = self._with(layers=per)
        ranks = [prepare(stage_model,
                         {"params": {**unstaged, **{f"layer{j}": p[f"layer{st * per + j}"]
                                                   for j in range(per)}}}, dev)
                 for st, dev in enumerate(mesh.axis_devices(STAGE_AXIS))]
        return MeshModule(ranks, mesh, (s,))

    def mesh_forward(self, module: MeshModule, batch: tuple) -> dict:
        mesh = module.mesh
        if STAGE_AXIS not in mesh.shape and mesh.shape[MODEL_AXIS] == 1:
            return super().mesh_forward(module, batch)
        return self.top_k_outputs(self.mesh_logits(module, batch))

    def mesh_logits(self, module: MeshModule, batch: tuple) -> torch.Tensor:
        """The logits over the pipeline's stages, or over each data rank's
        model ranks (rows gathered on the first data rank's device)."""
        mesh = module.mesh
        if STAGE_AXIS in mesh.shape:
            return self._pipeline_logits(module, batch)
        if mesh.shape[MODEL_AXIS] == 1:
            return super().mesh_logits(module, batch)
        devs = batch_sharding(mesh)
        dp, tp = module.grid
        parts = []
        for d, rows in enumerate(rows_split(batch, dp)):
            ranks = [module.rank(d, m) for m in range(tp)]
            rank_devs = [next(r.parameters()).device for r in ranks]
            ids, mask = self.device_preprocess(to_device(rows, rank_devs[0]))
            parts.append(self._tp_logits(ranks, rank_devs, ids, mask))
        return rows_gather(parts, devs[0])

    @staticmethod
    def _tp_logits(ranks: list[BertClassifier], devs: list[torch.device],
                   ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``BertClassifier.forward`` over the model ranks of one data
        rank: the replicated embedding and head on rank 0, each block's
        attention and FFN split over the ranks with an all-reduce after
        each row-split product."""
        r0 = ranks[0]
        x = r0.embed_tokens(ids)
        biases = [key_bias_of(mask).to(d) for d in devs]
        for i, blk in enumerate(r0.layers):
            xs = [x.to(d) for d in devs]
            a = [r.layers[i].attn.core(xm, b) for r, xm, b in zip(ranks, xs, biases)]
            a = row_split_product([r.layers[i].attn.out for r in ranks], a, devs)
            x = blk.ln_attn(x + a)
            xs = [x.to(d) for d in devs]
            u = [F.gelu(r.layers[i].mlp_up(xm)) for r, xm in zip(ranks, xs)]
            h = row_split_product([r.layers[i].mlp_down for r in ranks], u, devs)
            x = blk.ln_mlp(x + h)
        return r0.head(x)

    def _pp_micro(self, b: int, s: int) -> int:
        """Microbatch count: options.pp_micro, else the largest divisor of
        the bucket batch <= 2*S (the reference's rule)."""
        override = int(self.cfg.options.get("pp_micro", 0))
        if override:
            if b % override:
                raise ValueError(
                    f"options.pp_micro={override} must divide every batch "
                    f"bucket; {b} is not divisible")
            return override
        return max(d for d in range(1, b + 1) if b % d == 0 and d <= 2 * s)

    def _pipeline_logits(self, module: MeshModule, batch: tuple) -> torch.Tensor:
        """Embed on stage 0, the GPipe trunk over the stages (each
        microbatch carries its key bias along), the head on the last
        stage; the logits come back to stage 0's device."""
        stages = list(module.ranks)
        devs = module.mesh.axis_devices(STAGE_AXIS)
        ids, mask = self.device_preprocess(to_device(batch, devs[0]))
        x = stages[0].embed_tokens(ids)
        key_bias = key_bias_of(mask)
        n_micro = self._pp_micro(ids.shape[0], len(stages))
        micro = list(zip(x.chunk(n_micro), key_bias.chunk(n_micro)))

        def stage_fn(stage: BertClassifier):
            def run(xb):
                h, kb = xb
                for layer in stage.layers:
                    h = layer(h, kb)
                return h, kb
            return run

        outs = run_schedule([stage_fn(st) for st in stages], micro, devs)
        h = torch.cat([o[0] for o in outs])
        return stages[-1].head(h).to(devs[0])

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Seeded init with the reference's initializer families (it cannot
        reproduce jax.random's bits): LeCun-normal kernels, zero biases,
        unit LayerNorm scales, N(0, 1/d_model) embeddings, N(0, 0.02)
        position table, and the MoE FFN's N(0, 0.02) (flax's
        ``SwitchFFN`` initializer)."""
        rng = np.random.default_rng(seed)
        sd = {}
        with torch.device("meta"):
            shapes = {k: tuple(v.shape) for k, v in self.build_module().state_dict().items()}
        for name, shape in shapes.items():
            if name == "embed.weight":
                x = rng.normal(0.0, self.d_model ** -0.5, shape)
            elif name == "pos_embed":
                x = rng.normal(0.0, 0.02, shape)
            elif ".moe." in name:
                # float32 draws: the expert stacks are ~E x the FFN's size.
                x = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
            elif name.startswith("ln") or ".ln_" in name:
                x = np.ones(shape) if name.endswith("weight") else np.zeros(shape)
            elif name.endswith(".weight"):                 # Linear (out, in)
                x = rng.normal(0.0, shape[1] ** -0.5, shape)
            else:                                          # Linear bias
                x = np.zeros(shape)
            sd[name] = torch.from_numpy(x.astype(np.float32))
        return sd

    # -- shapes --------------------------------------------------------------
    def buckets(self) -> list[tuple]:
        return [(b, s) for b in self.cfg.batch_buckets for s in self.cfg.seq_buckets]

    def bucket_for(self, n: int, group=None) -> tuple:
        s = group if group is not None else max(self.cfg.seq_buckets)
        for b in self.cfg.batch_buckets:
            if b >= n:
                return (b, s)
        return (self.cfg.batch_buckets[-1], s)

    def input_signature(self, bucket: tuple) -> tuple[TensorSpec, ...]:
        b, s = bucket
        return (TensorSpec((b, s), np.dtype(np.int32)),
                TensorSpec((b, s), np.dtype(np.int32)))

    def from_jax_params(self, tree) -> dict[str, torch.Tensor]:
        return from_jax_params(tree)

    def to_jax_params(self, state_dict: dict[str, torch.Tensor]) -> dict:
        return to_jax_params(state_dict, self.heads)

    def import_tf_variables(self, flat: dict) -> dict:
        """HF transformers TFBert(ForSequenceClassification) -> the
        reference's tree.

        Source scheme (``transformers.TFBertForSequenceClassification``
        SavedModel): ``<root>/bert/embeddings/{word_embeddings/weight,
        position_embeddings/embeddings, token_type_embeddings/embeddings,
        LayerNorm}``, per-layer ``bert/encoder/layer_._{i}/{attention/self/
        query|key|value, attention/output/dense, attention/output/LayerNorm,
        intermediate/dense, output/dense, output/LayerNorm}``, then
        ``bert/pooler/dense`` and ``<root>/classifier``.

        Layout translations: HF fuses heads into (d, d) attention kernels;
        the tree wants (d, heads, head_dim) for Q/K/V and (heads, head_dim,
        d) for the out projection — pure reshapes, head-major on both sides.
        The serving path is single-segment (classify one text), so the
        token-type table collapses to its segment-0 row, folded into the
        position embeddings (both are added before the embedding LayerNorm).
        The embedding table must match the serving tokenizer's vocabulary,
        the classifier ``num_classes``, the position table the longest seq
        bucket (ValueError otherwise)."""
        d, heads = self.d_model, self.heads
        head_dim = d // heads
        f: dict[str, np.ndarray] = {}
        for k, v in flat.items():
            k = k.split(":")[0]
            k = k.split("/", 1)[1] if "/" in k else k  # drop the root name
            f[k] = np.asarray(v)

        emb = "bert/embeddings"
        words = f[f"{emb}/word_embeddings/weight"]
        if words.shape[0] != self.vocab_size:
            raise ValueError(
                f"imported embedding table has {words.shape[0]} rows but the "
                f"serving tokenizer implies vocab_size {self.vocab_size}; pair "
                "the checkpoint with its matching vocab_file")
        n_cls = f["classifier/kernel"].shape[1]
        if n_cls != self.cfg.num_classes:
            raise ValueError(
                f"imported classifier has {n_cls} classes but cfg.num_classes "
                f"is {self.cfg.num_classes}")
        pos = f[f"{emb}/position_embeddings/embeddings"]
        if pos.shape[0] < self.max_seq:
            raise ValueError(
                f"imported position table covers {pos.shape[0]} positions "
                f"but max seq bucket is {self.max_seq}")
        pos = pos[: self.max_seq]
        tt = f.get(f"{emb}/token_type_embeddings/embeddings")
        if tt is not None:
            pos = pos + tt[0][None, :]

        params: dict = {
            "embed": {"embedding": words},
            "pos_embed": pos,
            "ln_embed": {"scale": f[f"{emb}/LayerNorm/gamma"],
                         "bias": f[f"{emb}/LayerNorm/beta"]},
            "pooler": {"kernel": f["bert/pooler/dense/kernel"],
                       "bias": f["bert/pooler/dense/bias"]},
            "classifier": {"kernel": f["classifier/kernel"],
                           "bias": f["classifier/bias"]},
        }
        for i in range(self.layers):
            lyr = f"bert/encoder/layer_._{i}"

            def qkv(name: str) -> dict:
                return {
                    "kernel": f[f"{lyr}/attention/self/{name}/kernel"].reshape(
                        d, heads, head_dim),
                    "bias": f[f"{lyr}/attention/self/{name}/bias"].reshape(
                        heads, head_dim),
                }

            def ln(name: str) -> dict:
                return {"scale": f[f"{lyr}/{name}/gamma"],
                        "bias": f[f"{lyr}/{name}/beta"]}

            def dense(name: str) -> dict:
                return {"kernel": f[f"{lyr}/{name}/kernel"],
                        "bias": f[f"{lyr}/{name}/bias"]}

            params[f"layer{i}"] = {
                "attn": {
                    "query": qkv("query"),
                    "key": qkv("key"),
                    "value": qkv("value"),
                    "out": {
                        "kernel": f[f"{lyr}/attention/output/dense/kernel"]
                        .reshape(heads, head_dim, d),
                        "bias": f[f"{lyr}/attention/output/dense/bias"],
                    },
                },
                "ln_attn": ln("attention/output/LayerNorm"),
                "mlp_up": dense("intermediate/dense"),
                "mlp_down": dense("output/dense"),
                "ln_mlp": ln("output/LayerNorm"),
            }
        return {"params": params}

    # -- device side ---------------------------------------------------------
    def logits(self, module: BertClassifier, batch) -> torch.Tensor:
        ids, mask = self.device_preprocess(batch)
        return module(ids, mask)

    # -- host side -----------------------------------------------------------
    def host_decode(self, payload: bytes, content_type: str) -> np.ndarray:
        """Request body -> unpadded int32 token ids (incl. [CLS]/[SEP])."""
        return self.host_decode_items(payload, content_type)[0][0]

    def host_decode_items(self, payload: bytes, content_type: str) -> tuple[list, bool]:
        """One JSON parse: {"text": str} is single, {"texts": [...]} a batch;
        non-JSON bodies are one plain-text item."""
        if not content_type.startswith("application/json"):
            return [self._encode(payload.decode("utf-8"))], False
        body = json.loads(payload.decode("utf-8"))
        texts = body.get("texts")
        if texts is not None:
            if not isinstance(texts, list) or not all(isinstance(t, str) for t in texts):
                raise ValueError('"texts" must be a list of strings')
            if len(texts) > self.MAX_ITEMS_PER_REQUEST:
                raise ValueError(
                    f"batch of {len(texts)} exceeds the per-request limit "
                    f"({self.MAX_ITEMS_PER_REQUEST})")
            return [self._encode(t) for t in texts], True
        text = body.get("text")
        if not isinstance(text, str):
            raise ValueError('JSON body must contain "text": str')
        return [self._encode(text)], False

    def _encode(self, text: str) -> np.ndarray:
        tok = self.tokenizer
        pieces = tok.tokenize(text)  # once; encode() would re-tokenize
        ids = [tok.cls_id] + [tok.vocab.get(t, tok.unk_id) for t in pieces]
        ids = ids[: self.max_seq - 1] + [tok.sep_id]
        return np.asarray(ids, np.int32)  # unpadded; assemble pads per bucket

    def group_key(self, item: np.ndarray):
        """Seq bucket for an unpadded id array -> batching group."""
        for s in self.cfg.seq_buckets:
            if s >= item.shape[0]:
                return s
        return max(self.cfg.seq_buckets)

    def canary_item(self) -> np.ndarray:
        return self.host_decode(b'{"text": "canary"}', "application/json")

    def assemble(self, items: list[np.ndarray], bucket: tuple):
        b, s = bucket
        ids = np.full((b, s), self.tokenizer.pad_id, np.int32)
        mask = np.zeros((b, s), np.int32)
        return self._fill_ids_mask(items, s, ids, mask)

    def assemble_into(self, items: list[np.ndarray], bucket: tuple, out):
        ids, mask = out
        ids[:] = self.tokenizer.pad_id
        mask[:] = 0
        return self._fill_ids_mask(items, bucket[1], ids, mask)

    @staticmethod
    def _fill_ids_mask(items, s, ids, mask):
        for i, it in enumerate(items):
            n = min(it.shape[0], s)
            ids[i, :n] = it[:n]
            mask[i, :n] = 1
        return ids, mask

    def host_postprocess(self, outputs: dict, n_valid: int) -> list[dict]:
        return self.format_top_k(outputs, n_valid)


def create(cfg: ModelConfig) -> BertServing:
    return BertServing(cfg)
