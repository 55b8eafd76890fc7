"""Autoregressive text generation, ported from ``tpuserve/models/textgen.py``
— the token-by-token family the iteration-level engine exists for.

A prefix-LM decoder: the prompt is encoded **bidirectionally** in one
prefill pass (the per-key-bias shape of kernel K1 — ``options.attention =
"flash"`` routes the prefill through ``tpuserve_torch.ops.flash_attention``,
K1 on the card and its plain version on the CPU); generated tokens then
decode strictly left-to-right against the KV cache. Sampling is seeded and
positional: Gumbel-max with noise from ``fold_in(fold_in(key(0), seed),
position)``, drawn by ``tpuserve_torch.ops.threefry`` bit for bit as the
reference's ``jax.random`` draws it, so identical (prompt, seed,
temperature, max_new_tokens) requests give the reference's tokens, and the
same tokens across batch compositions and across the TWO serving paths:

- ``forward`` — the locked-batch twin: prefill + a loop over the FULL
  ``max_new_tokens`` cap for every lane (what the batcher serves with
  ``[genserve]`` off): a 2-token completion pays the full loop.
- ``init_state`` / ``step`` / ``extract`` — the engine decomposition:
  prefill is the once-per-request insert, each step decodes ONE token for
  every active slot against the per-slot KV cache
  (slots, layers, ctx, heads, head_dim), and a finished slot's token buffer
  is extracted the moment its own ``done`` flag flips.

Both paths share ``_prefill`` and ``_decode_step``, so engine == locked-batch
token parity holds by construction. The decode step and the paged programs
update the state block in place (the engine's captured graphs bind its
addresses); ``_prefill`` returns fresh tensors.

The network is the reference's: pre-LN blocks with LayerNorm in float32
(eps 1e-5), bias-free projections, the tanh-approximate GELU
(``jax.nn.gelu``'s default), a float32 logits GEMM (TF32 stays off, as
PyTorch's default). Tokenization is the port's WordPiece over the
deterministic synthetic vocabulary (or ``options.vocab_file``); [SEP]
doubles as EOS.

The paged KV path (``kv_page_signature`` ... ``_paged_decode_step``) keeps
KV in one global pool of fixed-size pages addressed through a per-slot
block table of page indices held in a tensor, so one captured step serves
every page assignment. Global position p of a slot lives at
(bt[slot, p // page_tokens], p % page_tokens). Page 0 is the write-sink
sentinel: free and frozen lanes scribble there instead of into pages the
ledger may have re-handed to another request.

``options.moe_experts`` = E >= 2 replaces every layer's MLP with the
reference's top-1 Switch FFN (``_moe_ffn`` over
``tpuserve_torch.ops.moe.switch_route``) with GROUP SIZE ONE: every token
routes alone with capacity 1, so no token is ever dropped and a lane's
output depends on that lane alone. The one ``_mlp`` seam is shared by all
four forward bodies (prefill, decode, paged chunk, paged decode).

Streaming (``stream_units``): each step's new tokens become ``token`` units
whose ``text`` is an incremental detokenize, so the concatenated stream
text equals the unary ``text`` byte for byte.

Sizes come from ``cfg.options`` (layers/d_model/heads/d_ff/vocab_size/
prompt_len/max_new_tokens/moe_experts) with the reference's small defaults.
"""

from __future__ import annotations

import copy
import json
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuserve_torch.config import ModelConfig
from tpuserve_torch.genserve.model import GenerativeModel
from tpuserve_torch.models.base import DTYPES, MeshModule, TensorSpec, check_mesh, not_ported
from tpuserve_torch.models.bert import masked_attention
from tpuserve_torch.ops import threefry
from tpuserve_torch.ops.moe import switch_route
from tpuserve_torch.ops.flash_attention import flash_attention
from tpuserve_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh
from tpuserve_torch.parallel.partition import (P, PartitionSpec, match_partition_rules,
                                               rank_coords, split_tree)
from tpuserve_torch.text import WordPieceTokenizer, synthetic_vocab

I32 = np.dtype(np.int32)
F32 = np.dtype(np.float32)
# The per-slot lanes of both state blocks besides the KV storage.
LANES = ("pos", "tokens", "n_new", "last", "done", "seed", "max_new", "temp")


def _norm(x: torch.Tensor, ln: "_Norm", eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32, cast back to the compute dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * ln.scale + ln.bias).to(x.dtype)


class _Norm(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


class _Layer(nn.Module):
    """One decoder block's weights in the reference's layout: (in, out)
    matrices; with ``experts`` the Switch FFN's router (d, E) and expert
    stacks (E, d, f) / (E, f, d) in place of the dense MLP. ``inner`` is
    the q/k/v width (d; a tensor-parallel rank's heads x head_dim)."""

    def __init__(self, d: int, f: int, experts: int = 0, inner: int | None = None) -> None:
        super().__init__()
        inner = inner or d
        self.ln1 = _Norm(d)
        self.wq = nn.Parameter(torch.zeros(d, inner))
        self.wk = nn.Parameter(torch.zeros(d, inner))
        self.wv = nn.Parameter(torch.zeros(d, inner))
        self.wo = nn.Parameter(torch.zeros(inner, d))
        self.ln2 = _Norm(d)
        if experts:
            self.router = nn.Parameter(torch.zeros(d, experts))
            self.moe_up = nn.Parameter(torch.zeros(experts, d, f))
            self.moe_down = nn.Parameter(torch.zeros(experts, f, d))
        else:
            self.w_up = nn.Parameter(torch.zeros(d, f))
            self.w_down = nn.Parameter(torch.zeros(f, d))


class TextGenModule(nn.Module):
    """The decoder's parameters; ``TextGenServing`` holds the math. A
    tensor-parallel rank's module holds its ``inner`` q/k/v columns, its
    block of ``f`` and its ``head_cols`` vocab columns."""

    def __init__(self, vocab: int, d: int, f: int, layers: int, max_ctx: int,
                 experts: int = 0, inner: int | None = None,
                 head_cols: int | None = None) -> None:
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(vocab, d))
        self.pos = nn.Parameter(torch.zeros(max_ctx, d))
        self.ln_f = _Norm(d)
        self.head = nn.Parameter(torch.zeros(d, head_cols or vocab))
        self.layers = nn.ModuleList(_Layer(d, f, experts, inner) for _ in range(layers))


class _TPLayer:
    """One decoder block over the model ranks of a tensor-parallel mesh:
    each rank's column block of wq/wk/wv and ``w_up`` and row block of
    ``wo`` and ``w_down`` (the reference's ``partition_rules``). q/k/v come
    back as every rank's heads side by side; each row-split product's
    partials are summed on the first rank's device (the all-reduce over
    "model")."""

    def __init__(self, parts: list, devices: list) -> None:
        self.parts, self.devices = parts, devices
        self.ln1, self.ln2 = parts[0].ln1, parts[0].ln2
        self.inner = [p.wq.shape[1] for p in parts]

    def _sum(self, partials: list) -> torch.Tensor:
        total = partials[0]
        for p in partials[1:]:
            total = total + p.to(self.devices[0])
        return total

    def qkv(self, hx: torch.Tensor, shape: tuple) -> tuple:
        return tuple(torch.cat([(hx.to(d) @ getattr(p, w)).to(self.devices[0])
                                for p, d in zip(self.parts, self.devices)], dim=-1)
                     .reshape(shape) for w in ("wq", "wk", "wv"))

    def out(self, a: torch.Tensor) -> torch.Tensor:
        return self._sum([blk.to(d) @ p.wo for blk, p, d in
                          zip(a.split(self.inner, dim=-1), self.parts, self.devices)])

    def mlp(self, hx: torch.Tensor) -> torch.Tensor:
        return self._sum([F.gelu(hx.to(d) @ p.w_up, approximate="tanh") @ p.w_down
                          for p, d in zip(self.parts, self.devices)])


class _TPView:
    """``TextGenModule``'s surface over a ``MeshModule`` of model ranks (one
    data rank's): the replicated embedding, positions and final norm from
    rank 0, each block a ``_TPLayer``, and the vocab head's column blocks
    (``logits`` concatenates them)."""

    def __init__(self, mesh_module: MeshModule) -> None:
        ranks = list(mesh_module.ranks)
        self.devices = [r.embed.device for r in ranks]
        r0 = ranks[0]
        self.embed, self.pos, self.ln_f = r0.embed, r0.pos, r0.ln_f
        self.heads = [r.head for r in ranks]
        self.layers = [_TPLayer([r.layers[i] for r in ranks], self.devices)
                       for i in range(len(r0.layers))]

    def logits(self, xn: torch.Tensor) -> torch.Tensor:
        return torch.cat([(xn.to(d) @ h.float()).to(self.devices[0])
                          for h, d in zip(self.heads, self.devices)], dim=-1)


def _lane_write(state: dict, slot: torch.Tensor, lane: dict) -> None:
    """Write one slot's lanes (no slot dim) into the state block in place;
    ``slot`` is a one-element int64 tensor."""
    for name, value in lane.items():
        dst = state[name]
        dst.index_copy_(0, slot, value.to(dst.dtype).reshape((1,) + dst.shape[1:]))


class TextGenServing(GenerativeModel):
    """Decoder-only generation over HTTP: JSON {"prompt", "seed"?,
    "max_new_tokens"?, "temperature"?} in, {"text", "tokens", "n_tokens"}
    out. Every sampling parameter rides inside the decoded item, so the
    result cache can never alias two requests differing only in seed."""

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__(cfg)
        o = cfg.options
        self.layers = int(o.get("layers", 4))
        self.d_model = int(o.get("d_model", 256))
        self.heads = int(o.get("heads", 4))
        self.d_ff = int(o.get("d_ff", 4 * self.d_model))
        # Prompt bucket (the host pads every prompt to it) and the generation
        # cap; the KV cache spans their sum.
        self.max_prompt = int(o.get("prompt_len", 32))
        self.max_new = int(o.get("max_new_tokens", 64))
        self.max_ctx = self.max_prompt + self.max_new
        if self.d_model % self.heads:
            raise ValueError(
                f"options.d_model={self.d_model} must divide by "
                f"heads={self.heads}")
        self.head_dim = self.d_model // self.heads
        self.attention = str(o.get("attention", "dense"))
        if self.attention not in ("dense", "flash"):
            raise ValueError("options.attention must be 'dense' or 'flash', "
                             f"got {self.attention!r}")
        # Switch-MoE FFN: 0 = dense MLP; >= 2 replaces every layer's MLP
        # with top-1 routing over ops.moe.switch_route.
        self.moe_experts = int(o.get("moe_experts", 0))
        if self.moe_experts == 1 or self.moe_experts < 0:
            raise ValueError("options.moe_experts must be 0 (dense MLP) "
                             f"or >= 2 experts, got {self.moe_experts}")
        if self.attention == "flash" and self.max_prompt % 8:
            raise ValueError(
                f"options.attention='flash' needs prompt_len "
                f"({self.max_prompt}) divisible by 8 (TPU tile rows)")
        if self.moe_experts and cfg.parallelism == "sharded" and cfg.tp > 1:
            raise not_ported(f"options.moe_experts with tp={cfg.tp} (experts on the "
                             "model axis)", "item 10, expert parallelism")
        if cfg.parallelism == "sharded" and cfg.tp > 1 and self.heads % cfg.tp:
            raise ValueError(f"tp={cfg.tp} must divide heads={self.heads}: each "
                             "model rank decodes whole heads")
        # A seq axis (the reference's KV context on "seq",
        # state_partition_specs) is refused by check_mesh, item 9b.
        check_mesh(cfg, tp_ok=True)
        # A tensor-parallel rank's widths (see mesh_module): q/k/v columns,
        # FFN block and vocab head columns; the whole model's by default.
        self.inner: int | None = None
        self.head_cols: int | None = None
        vocab_file = o.get("vocab_file")
        if vocab_file:
            self.tokenizer = WordPieceTokenizer.from_vocab_file(vocab_file)
        else:
            self.tokenizer = WordPieceTokenizer(
                synthetic_vocab(int(o.get("vocab_size", 8192))))
        self.vocab_size = max(self.tokenizer.vocab.values()) + 1
        self.eos_id = self.tokenizer.sep_id
        if cfg.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {cfg.dtype!r}")
        # The compute dtype the runtime casts the module to.
        self.dtype = DTYPES[cfg.dtype]

    # -- params ---------------------------------------------------------------
    def build_module(self) -> TextGenModule:
        return TextGenModule(self.vocab_size, self.d_model, self.d_ff,
                             self.layers, self.max_ctx, self.moe_experts,
                             self.inner, self.head_cols)

    # -- the mesh (the reference's sharded decode) -----------------------------
    # The engine's programs run on a split mesh's MeshModule (the runtime
    # allows a generative family that says so).
    mesh_programs = True

    def partition_rules(self) -> list[tuple[str, PartitionSpec]]:
        """The reference's rules: under tp > 1 the q/k/v and vocab head
        columns (heads / vocab) and ``w_up``'s on "model", ``wo`` and
        ``w_down`` by rows; the rest replicated."""
        if self.cfg.tp <= 1:
            return [(".*", P())]
        return [(r"w[qkv]$", P(None, MODEL_AXIS)), (r"wo$", P(MODEL_AXIS, None)),
                (r"w_up$", P(None, MODEL_AXIS)), (r"w_down$", P(MODEL_AXIS, None)),
                (r"router$", P()), (r"moe_(up|down)$", P(MODEL_AXIS, None, None)),
                (r"head$", P(None, MODEL_AXIS)), (r".*", P())]

    def mesh_module(self, tree: Any, mesh: Mesh, prepare) -> MeshModule:
        """The sharded decode's parameters: one module per model rank of
        data rank 0, its blocks by ``partition_rules`` (the vocab head in
        contiguous blocks, the first ``vocab % tp`` one column wider). The
        state block is the reference's: KV heads on "model" (each rank's
        heads a block of the one KV tensor the ranks share on their card)
        and every lane replicated over "data", so the data ranks' copies
        would compute the same slots and are not made."""
        specs = match_partition_rules(self.partition_rules(), tree)
        ranks = []
        for coord, rank_tree, dev in zip(rank_coords(mesh), split_tree(tree, specs, mesh),
                                         mesh.devices.flat):
            if coord.get(DATA_AXIS, 0) or coord.get(SEQ_AXIS, 0):
                continue
            view = self._with(inner=rank_tree["layer0"]["wq"].shape[1],
                              d_ff=rank_tree["layer0"]["w_up"].shape[1],
                              head_cols=rank_tree["head"].shape[1])
            ranks.append(prepare(view, rank_tree, dev))
        return MeshModule(ranks, mesh, (1, len(ranks)))

    def _with(self, **attrs) -> "TextGenServing":
        view = copy.copy(self)
        view.__dict__.update(attrs)
        return view

    @staticmethod
    def _math(module: Any) -> Any:
        """The module the math reads: a MeshModule as its ``_TPView``."""
        if isinstance(module, MeshModule):
            view = module.__dict__.get("tp_view")
            if view is None:
                view = module.__dict__["tp_view"] = _TPView(module)
            return view
        return module

    def mesh_forward(self, module: MeshModule, batch: Any) -> dict:
        return self.forward(module, batch)

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Seeded init with the reference's initializer families (it cannot
        reproduce jax.random's normal draws): N(0, 1/fan_in) matrices,
        N(0, 0.02) embeddings, N(0, 0.01) positions, unit LayerNorm scales,
        zero biases; expert stacks N(0, 1/fan_in) over their (d or f) input
        axis."""
        rng = np.random.default_rng(seed)
        sd = {}
        with torch.device("meta"):
            shapes = {k: tuple(v.shape) for k, v in self.build_module().state_dict().items()}
        for name, shape in shapes.items():
            if name == "embed":
                x = rng.normal(0.0, 0.02, shape)
            elif name == "pos":
                x = rng.normal(0.0, 0.01, shape)
            elif name.endswith(".scale"):
                x = np.ones(shape)
            elif name.endswith(".bias"):
                x = np.zeros(shape)
            elif name.endswith((".moe_up", ".moe_down")):
                # float32 draws: the stacks are ~E x the dense MLP's size.
                x = rng.standard_normal(shape, dtype=np.float32) * np.float32(
                    1.0 / math.sqrt(shape[1]))
            else:
                x = rng.normal(0.0, 1.0 / math.sqrt(shape[0]), shape)
            sd[name] = torch.from_numpy(x.astype(np.float32))
        return sd

    def _ffn_names(self) -> tuple[str, ...]:
        return (("router", "moe_up", "moe_down") if self.moe_experts
                else ("w_up", "w_down"))

    def from_jax_params(self, tree: Any) -> dict[str, torch.Tensor]:
        """The reference's parameter tree (numpy leaves) -> this module's
        float32 state_dict; the layouts are the same: (in, out) matrices,
        the MoE layers' router (d, E) and expert stacks (E, in, out)."""
        def t(x) -> torch.Tensor:
            return torch.from_numpy(np.array(x, dtype=np.float32))

        sd = {"embed": t(tree["embed"]), "pos": t(tree["pos"]),
              "ln_f.scale": t(tree["ln_f"]["scale"]),
              "ln_f.bias": t(tree["ln_f"]["bias"]), "head": t(tree["head"])}
        i = 0
        while f"layer{i}" in tree:
            lp = tree[f"layer{i}"]
            for ln in ("ln1", "ln2"):
                sd[f"layers.{i}.{ln}.scale"] = t(lp[ln]["scale"])
                sd[f"layers.{i}.{ln}.bias"] = t(lp[ln]["bias"])
            for w in ("wq", "wk", "wv", "wo") + self._ffn_names():
                sd[f"layers.{i}.{w}"] = t(lp[w])
            i += 1
        return sd

    def to_jax_params(self, state_dict: dict[str, torch.Tensor]) -> dict:
        """``from_jax_params`` inverted, bit for bit."""
        sd = {k: v.detach().to(torch.float32).cpu().contiguous().numpy()
              for k, v in state_dict.items()}
        tree: dict = {"embed": sd["embed"], "pos": sd["pos"],
                      "ln_f": {"scale": sd["ln_f.scale"], "bias": sd["ln_f.bias"]},
                      "head": sd["head"]}
        for i in range(self.layers):
            p = f"layers.{i}."
            tree[f"layer{i}"] = {
                "ln1": {"scale": sd[p + "ln1.scale"], "bias": sd[p + "ln1.bias"]},
                "ln2": {"scale": sd[p + "ln2.scale"], "bias": sd[p + "ln2.bias"]},
                **{w: sd[p + w] for w in ("wq", "wk", "wv", "wo") + self._ffn_names()}}
        return tree

    def reference_layout(self, name: str, shape: tuple) -> tuple[tuple, tuple]:
        """Every leaf lies as it does in the reference's tree."""
        return tuple(shape), tuple(range(len(shape)))

    # -- shapes ---------------------------------------------------------------
    def input_signature(self, bucket: tuple) -> tuple[TensorSpec, ...]:
        (b,) = bucket
        return (TensorSpec((b, self.max_prompt), I32),   # padded prompt ids
                TensorSpec((b,), I32),                   # prompt length
                TensorSpec((b,), I32),                   # seed
                TensorSpec((b,), I32),                   # max_new_tokens
                TensorSpec((b,), F32))                   # temperature

    def gen_item_signature(self) -> tuple[TensorSpec, ...]:
        return (TensorSpec((self.max_prompt,), I32), TensorSpec((), I32),
                TensorSpec((), I32), TensorSpec((), I32), TensorSpec((), F32))

    def _lane_signature(self, slots: int) -> dict:
        return {"pos": TensorSpec((slots,), I32),
                "tokens": TensorSpec((slots, self.max_new), I32),
                "n_new": TensorSpec((slots,), I32),
                "last": TensorSpec((slots,), I32),
                "done": TensorSpec((slots,), np.dtype(np.bool_)),
                "seed": TensorSpec((slots,), I32),
                "max_new": TensorSpec((slots,), I32),
                "temp": TensorSpec((slots,), F32)}

    def state_signature(self, slots: int) -> dict:
        ln, c, h, hd = self.layers, self.max_ctx, self.heads, self.head_dim
        kv = TensorSpec((slots, ln, c, h, hd), self.dtype)
        return {"k": kv, "v": kv, **self._lane_signature(slots)}

    # -- shared device math ---------------------------------------------------
    def _attend_prefill(self, q, k, v, key_bias):
        """(B, P, H, hd) bidirectional attention with an additive per-key
        padding bias (B, P) — kernel K1 (flash) or the dense twin."""
        if self.attention == "flash":
            return flash_attention(q, k, v, key_bias)
        return masked_attention(q, k, v, key_bias)

    def _sample(self, logits, seed, position, temp):
        """Per-lane seeded sampling at a cache ``position``: greedy when
        temp == 0, Gumbel-max otherwise — deterministic either way, and
        identical between the locked-batch loop and the engine because the
        fold key is (seed, target cache position)."""
        lg = logits.float()
        k0, k1 = threefry.key(torch.zeros_like(seed))
        k0, k1 = threefry.fold_in(k0, k1, seed)
        k0, k1 = threefry.fold_in(k0, k1, position)
        g = threefry.gumbel(threefry.bits32(k0, k1, lg.shape[-1]))
        safe_t = torch.where(temp > 0, temp, torch.ones_like(temp))
        sampled = torch.argmax(lg / safe_t[:, None] + g, dim=-1)
        return torch.where(temp > 0, sampled, torch.argmax(lg, dim=-1)).to(torch.int32)

    def _logits(self, module: TextGenModule, x: torch.Tensor) -> torch.Tensor:
        # float32 GEMM, as the reference's: TF32 must stay off for parity.
        if isinstance(module, _TPView):
            return module.logits(_norm(x, module.ln_f).float())
        return _norm(x, module.ln_f).float() @ module.head.float()

    def _mlp(self, lp: _Layer, hx: torch.Tensor) -> torch.Tensor:
        """The position-wise FFN delta for a normed hidden block ``hx``
        (..., d): the dense MLP (tanh-approximate GELU, as ``jax.nn.gelu``'s
        default), or the Switch-MoE twin with ``options.moe_experts``."""
        if isinstance(lp, _TPLayer):
            return lp.mlp(hx)
        if not self.moe_experts:
            return F.gelu(hx @ lp.w_up, approximate="tanh") @ lp.w_down
        return self._moe_ffn(lp, hx)

    @staticmethod
    def _out(lp: _Layer, a: torch.Tensor) -> torch.Tensor:
        """The attention output's projection ``a @ wo``."""
        if isinstance(lp, _TPLayer):
            return lp.out(a)
        return a @ lp.wo

    @staticmethod
    def _moe_ffn(lp: _Layer, hx: torch.Tensor) -> torch.Tensor:
        """Top-1 Switch FFN with GROUP SIZE ONE: every token routes alone
        with capacity 1, so no token is ever dropped and a lane's output is
        a function of that lane alone (a batch-global capacity would let
        one slot's routing evict another's token). The reference's dense
        formulation: one-hot dispatch and gate-weighted combine in the
        compute dtype, every expert's product over every token — static
        shapes throughout, so the step stays one CUDA graph."""
        lead, d = hx.shape[:-1], hx.shape[-1]
        dt = hx.dtype
        xt = hx.reshape(-1, d)
        logits = xt.float() @ lp.router.float()
        dispatch, combine, _aux = switch_route(logits[:, None, :], 1)
        dispatch = dispatch[:, 0, :, 0].to(dt)   # (T, E) 0/1 routing
        combine = combine[:, 0, :, 0].to(dt)     # (T, E) gate-weighted
        xe = torch.einsum("te,td->etd", dispatch, xt)
        up = F.gelu(torch.bmm(xe, lp.moe_up), approximate="tanh")
        down = torch.bmm(up, lp.moe_down)
        out = torch.einsum("te,etd->td", combine, down)
        return out.reshape(*lead, d).to(dt)

    def _qkv(self, lp: _Layer, hx: torch.Tensor, shape: tuple):
        if isinstance(lp, _TPLayer):
            return lp.qkv(hx, shape)
        return ((hx @ lp.wq).reshape(shape), (hx @ lp.wk).reshape(shape),
                (hx @ lp.wv).reshape(shape))

    def _embed(self, module: TextGenModule, ids, positions) -> torch.Tensor:
        return (module.embed[ids.long()] + module.pos[positions.long()]).to(self.dtype)

    def _prefill(self, module: TextGenModule, ids, n, seed, max_new, temp) -> dict:
        """Batched prompt prefill -> a fresh decode state (leading dim B):
        per-layer KV for the prompt, plus the FIRST sampled token. Shared
        by forward (locked batch) and init_state (engine)."""
        b, p = ids.shape
        ln, c, h, hd = self.layers, self.max_ctx, self.heads, self.head_dim
        dt = self.dtype
        dev = ids.device
        x = self._embed(module, ids, torch.arange(p, device=dev)[None, :])
        key_bias = (torch.arange(p, device=dev)[None, :] >= n[:, None]).float() * -1e9
        kc = torch.zeros((b, ln, c, h, hd), dtype=dt, device=dev)
        vc = torch.zeros((b, ln, c, h, hd), dtype=dt, device=dev)
        for i, lp in enumerate(module.layers):
            hx = _norm(x, lp.ln1)
            q, k, v = self._qkv(lp, hx, (b, p, h, hd))
            kc[:, i, :p] = k
            vc[:, i, :p] = v
            a = self._attend_prefill(q, k, v, key_bias).reshape(b, p, h * hd)
            x = x + self._out(lp, a.to(dt))
            x = x + self._mlp(lp, _norm(x, lp.ln2))
        last = torch.clamp_min(n - 1, 0).long()
        h_last = x[torch.arange(b, device=dev), last]
        first = self._sample(self._logits(module, h_last), seed, n, temp)
        tokens = torch.zeros((b, self.max_new), dtype=torch.int32, device=dev)
        tokens[:, 0] = first
        # pos is advanced in place by the decode steps: never alias the input.
        return {"k": kc, "v": vc, "pos": n.to(torch.int32).clone(), "tokens": tokens,
                "n_new": torch.ones((b,), dtype=torch.int32, device=dev),
                "last": first, "done": (first == self.eos_id) | (max_new <= 1),
                "seed": seed, "max_new": max_new, "temp": temp}

    def _advance(self, state: dict, logits: torch.Tensor) -> dict:
        """Sample every lane's next token from ``logits`` (for cache
        position pos + 1) and advance the lanes in place: a finished (or
        free) lane keeps its tokens, counters and position. Returns the
        step's out dict."""
        c = self.max_ctx
        pos, done, n_new = state["pos"], state["done"], state["n_new"]
        rows = torch.arange(pos.shape[0], device=pos.device)
        sampled = self._sample(logits, state["seed"], torch.clamp(pos + 1, 0, c - 1),
                               state["temp"])
        write_idx = torch.clamp(n_new, 0, self.max_new - 1).long()
        tokens = state["tokens"]
        tokens[rows, write_idx] = torch.where(done, tokens[rows, write_idx], sampled)
        n_new2 = torch.where(done, n_new, n_new + 1)
        done2 = done | (sampled == self.eos_id) | (n_new2 >= state["max_new"])
        pos.copy_(torch.where(done, pos, torch.clamp(pos + 1, 0, c - 1)))
        state["last"].copy_(torch.where(done, state["last"], sampled))
        n_new.copy_(n_new2)
        done.copy_(done2)
        return {"done": done2, "n_new": n_new2, "tokens": tokens}

    def _decode_step(self, module: TextGenModule, state: dict) -> dict:
        """One decode iteration over every lane, in place: process ``last``
        at cache index ``pos`` (writing its K/V), sample the token for
        pos + 1. Finished (and free, zero-initialized) lanes freeze via
        ``done``."""
        kc, vc = state["k"], state["v"]
        b = kc.shape[0]
        ln, h, hd, c = self.layers, self.heads, self.head_dim, self.max_ctx
        dev = kc.device
        pos = state["pos"]
        rows = torch.arange(b, device=dev)
        cp = torch.clamp(pos, 0, c - 1).long()
        x = self._embed(module, state["last"], cp)
        mask = (torch.arange(c, device=dev)[None, :] > pos[:, None]).float() * -1e9
        for i, lp in enumerate(module.layers):
            hx = _norm(x, lp.ln1)
            q, k, v = self._qkv(lp, hx, (b, h, hd))
            kc[rows, i, cp] = k
            vc[rows, i, cp] = v
            x = x + self._out(lp, self._decode_attention(q, kc[:, i], vc[:, i], mask))
            x = x + self._mlp(lp, _norm(x, lp.ln2))
        return self._advance(state, self._logits(module, x))

    def _decode_attention(self, q, kc, vc, mask) -> torch.Tensor:
        """One query per lane against its cached (B, C, H, hd) keys and
        values with an additive (B, C) mask -> (B, H*hd)."""
        b, h, hd = q.shape
        s = torch.einsum("bhd,bchd->bhc", q, kc).float() * (hd ** -0.5) + mask[:, None, :]
        a = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhc,bchd->bhd", a, vc).reshape(b, h * hd)

    # -- one-shot path (locked batch) -----------------------------------------
    def forward(self, module: TextGenModule, batch: Any) -> dict:
        module = self._math(module)
        ids, n, seed, max_new, temp = batch
        state = self._prefill(module, ids, n, seed, max_new, temp)
        # The locked batch runs the FULL cap for every lane — max_new only
        # freezes a lane's outputs, never shortens the loop. That cost gap
        # is precisely what the iteration-level engine removes.
        for _ in range(self.max_new - 1):
            self._decode_step(module, state)
        return {"tokens": state["tokens"], "n_new": state["n_new"]}

    def logits(self, module: TextGenModule, batch: Any) -> torch.Tensor:
        raise TypeError("textgen's forward returns tokens, not class logits")

    # -- engine decomposition (tpuserve_torch.genserve) -----------------------
    def init_state(self, module: TextGenModule, item: tuple) -> dict:
        module = self._math(module)
        ids, n, seed, max_new, temp = item
        state = self._prefill(module, ids[None], n[None], seed[None],
                              max_new[None], temp[None])
        return {k: v[0] for k, v in state.items()}

    def step(self, module: TextGenModule, state: dict) -> dict:
        # The state block's own keys select the path: a paged engine
        # allocates the kv_page_signature block, a dense one the
        # state_signature block.
        module = self._math(module)
        if "kp" in state:  # tps-ok[TPS503]: dict structure check at capture time
            return self._paged_decode_step(module, state)
        return self._decode_step(module, state)

    def extract(self, module: TextGenModule, state: dict, slot: torch.Tensor) -> dict:
        return {"tokens": state["tokens"].index_select(0, slot)[0],
                "n_new": state["n_new"].index_select(0, slot)[0]}

    def gen_max_steps(self) -> int:
        return self.max_new

    # -- paged KV path --------------------------------------------------------
    supports_kv_paging = True

    def kv_pages_per_slot(self, page_tokens: int) -> int:
        return -(-self.max_ctx // int(page_tokens))

    def kv_page_signature(self, slots: int, pages: int, page_tokens: int) -> dict:
        ln, h, hd = self.layers, self.heads, self.head_dim
        pool = TensorSpec((pages, ln, page_tokens, h, hd), self.dtype)
        return {"kp": pool, "vp": pool,
                "bt": TensorSpec((slots, self.kv_pages_per_slot(page_tokens)), I32),
                **self._lane_signature(slots)}

    def pages_needed(self, item: Any, page_tokens: int) -> int:
        _ids, n, _seed, max_new, _temp = item
        return -(-(int(n) + int(max_new)) // int(page_tokens))

    def prompt_tokens(self, item: Any) -> int:
        return int(item[1])

    def kv_prefill_chunk(self, requested: int) -> int:
        if requested <= 0 or requested >= self.max_prompt:
            return self.max_prompt
        return int(requested)

    def prefill_chunk(self, module: TextGenModule, state: dict, slot: torch.Tensor,
                      item: tuple, start: torch.Tensor, pages: torch.Tensor, *,
                      chunk: int) -> None:
        # The whole-prompt chunk (the prefill_chunk = 0 default) routes
        # through init_state and only changes where K/V is stored, so
        # paged == dense token parity holds by construction.
        module = self._math(module)
        if chunk >= self.max_prompt:
            self._prefill_paged_single(module, state, slot, item, pages)
        else:
            self._prefill_paged_chunk(module, state, slot, item, start, pages, chunk)

    def _page_rows(self, state: dict, pages: torch.Tensor, n: torch.Tensor,
                   positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(page, offset) of each position of one slot; positions >= n
        (padding) divert to the sentinel page 0."""
        P = state["kp"].shape[2]
        pps = state["bt"].shape[1]
        page = pages.long()[torch.clamp(positions // P, max=pps - 1)]
        return torch.where(positions < n, page, torch.zeros_like(page)), positions % P

    def _scatter_pages(self, state: dict, pages: torch.Tensor, n: torch.Tensor,
                       positions: torch.Tensor,
                       per_layer_kv: Callable[[int], tuple]) -> None:
        """Write per-position K/V rows into the page pool in place: position
        p goes to (pages[p // P], p % P); positions >= n go to the sentinel.
        ``per_layer_kv(i) -> (k, v)`` each (len(positions), h, hd)."""
        w_pages, offs = self._page_rows(state, pages, n, positions)
        for i in range(self.layers):
            k, v = per_layer_kv(i)
            # Several padding positions may land on one sentinel row: the
            # order of index_put_'s duplicate writes is undefined, which is
            # harmless only because no live lane ever attends to page 0.
            state["kp"][w_pages, i, offs] = k
            state["vp"][w_pages, i, offs] = v

    def _prefill_paged_single(self, module, state, slot, item, pages) -> None:
        n = item[1]
        lane = self.init_state(module, item)  # dense prefill, b=1
        p = self.max_prompt
        positions = torch.arange(p, device=n.device)
        self._scatter_pages(state, pages, n, positions,
                            lambda i: (lane["k"][i, :p], lane["v"][i, :p]))
        _lane_write(state, slot, {"bt": pages, **{f: lane[f] for f in LANES}})

    def _prefill_paged_chunk(self, module, state, slot, item, start, pages,
                             chunk: int) -> None:
        """One chunk of an incremental prompt prefill: BIDIRECTIONAL within
        the chunk, causal across chunks (earlier chunks' K/V are final by
        the time later chunks attend through them). Multi-chunk encoding is
        therefore NOT bit-identical to the one-pass bidirectional prefill —
        it is a deterministic function of (prompt, seed, chunk width) alone,
        independent of batch composition and of what else the engine
        interleaves. Non-final chunks leave the lane frozen (done=True,
        pos=0) so interleaved decode steps skip it; the final chunk samples
        the first token and arms the lane exactly like init_state does."""
        ids, n, seed, max_new, temp = item
        C = int(chunk)
        h, hd = self.heads, self.head_dim
        kp, vp = state["kp"], state["vp"]
        P = kp.shape[2]
        pps = state["bt"].shape[1]
        c_pad = pps * P
        dev = ids.device
        _lane_write(state, slot, {"bt": pages})
        cpos = start + torch.arange(C, device=dev)
        cids = ids[torch.clamp(cpos, max=self.max_prompt - 1).long()]
        x = self._embed(module, cids, torch.clamp(cpos, max=self.max_ctx - 1))
        kv_limit = torch.minimum(start + C, n)
        w_pages, offs = self._page_rows(state, pages, n, cpos)
        mask = (torch.arange(c_pad, device=dev)[None, :] >= kv_limit).float() * -1e9
        page_idx = pages.long()
        for i, lp in enumerate(module.layers):
            hx = _norm(x, lp.ln1)
            q, k, v = self._qkv(lp, hx, (C, h, hd))
            # Padding positions share sentinel rows: see _scatter_pages.
            kp[w_pages, i, offs] = k
            vp[w_pages, i, offs] = v
            # Gather THIS slot's context (earlier chunks + the rows just
            # written) back out of the pool; sentinel rows sit past
            # kv_limit and are masked.
            kall = kp[:, i][page_idx].reshape(c_pad, h, hd)
            vall = vp[:, i][page_idx].reshape(c_pad, h, hd)
            s = torch.einsum("qhd,khd->hqk", q, kall).float() * (hd ** -0.5) + mask
            a = torch.softmax(s, dim=-1).to(q.dtype)
            o = torch.einsum("hqk,khd->qhd", a, vall).reshape(C, h * hd)
            x = x + self._out(lp, o)
            x = x + self._mlp(lp, _norm(x, lp.ln2))
        last_off = torch.clamp(n - 1 - start, 0, C - 1).long().reshape(1)
        h_last = x.index_select(0, last_off)
        first = self._sample(self._logits(module, h_last), seed[None], n[None], temp[None])[0]
        is_final = (start + C) >= n
        zero = torch.zeros_like(first)
        first_tok = torch.where(is_final, first, zero)
        tokens = torch.zeros((self.max_new,), dtype=torch.int32, device=dev)
        tokens[0] = first_tok
        _lane_write(state, slot, {
            "pos": torch.where(is_final, n, zero), "tokens": tokens,
            "n_new": is_final.to(torch.int32), "last": first_tok,
            "done": torch.where(is_final, (first == self.eos_id) | (max_new <= 1),
                                torch.ones_like(is_final)),
            "seed": seed, "max_new": max_new, "temp": temp})

    def _paged_decode_step(self, module: TextGenModule, state: dict) -> dict:
        """The paged twin of _decode_step: identical math and sampling, but
        K/V reads gather through the block table and writes go to (page,
        offset) — frozen/free lanes' writes divert to the sentinel so a
        released slot can never scribble into re-handed pages."""
        kp, vp, bt = state["kp"], state["vp"], state["bt"]
        b, pps = bt.shape
        P = kp.shape[2]
        h, hd, c = self.heads, self.head_dim, self.max_ctx
        c_pad = pps * P
        dev = kp.device
        pos, done = state["pos"], state["done"]
        cp = torch.clamp(pos, 0, c - 1).long()
        x = self._embed(module, state["last"], cp)
        mask = (torch.arange(c_pad, device=dev)[None, :] > pos[:, None]).float() * -1e9
        page_of = bt.long().gather(1, (cp // P)[:, None])[:, 0]
        w_page = torch.where(done, torch.zeros_like(page_of), page_of)
        offs = cp % P
        bt_idx = bt.long()
        for i, lp in enumerate(module.layers):
            hx = _norm(x, lp.ln1)
            q, k, v = self._qkv(lp, hx, (b, h, hd))
            # Every frozen or free lane writes to page 0: duplicate indices
            # whose write order is undefined, harmless because the sentinel
            # is always masked.
            kp[w_page, i, offs] = k
            vp[w_page, i, offs] = v
            kc = kp[:, i][bt_idx].reshape(b, c_pad, h, hd)
            vc = vp[:, i][bt_idx].reshape(b, c_pad, h, hd)
            x = x + self._out(lp, self._decode_attention(q, kc, vc, mask))
            x = x + self._mlp(lp, _norm(x, lp.ln2))
        return self._advance(state, self._logits(module, x))

    # -- host side ------------------------------------------------------------
    def host_decode(self, payload: bytes, content_type: str) -> Any:
        if content_type.startswith("application/json"):
            body = json.loads(payload.decode("utf-8"))
            prompt = body.get("prompt")
            if not isinstance(prompt, str):
                raise ValueError('JSON body must contain "prompt": str')
            seed = int(body.get("seed", 0))
            max_new = int(body.get("max_new_tokens", self.max_new))
            temp = float(body.get("temperature", 0.0))
        else:
            prompt, seed, max_new, temp = payload.decode("utf-8"), 0, \
                self.max_new, 0.0
        if not 1 <= max_new <= self.max_new:
            raise ValueError(
                f"max_new_tokens must be in [1, {self.max_new}], "
                f"got {max_new}")
        if temp < 0:
            raise ValueError(f"temperature must be >= 0, got {temp}")
        tok = self.tokenizer
        pieces = tok.tokenize(prompt)
        ids = [tok.vocab.get(t, tok.unk_id) for t in pieces][: self.max_prompt]
        ids = ids or [tok.cls_id]  # an empty prompt still needs one position
        arr = np.full((self.max_prompt,), tok.pad_id, np.int32)
        arr[: len(ids)] = ids
        # Every sampling parameter is part of the item ON PURPOSE: the
        # result cache digests the whole tuple, so (prompt, seed=1) and
        # (prompt, seed=2) can never share a key.
        return (arr, np.int32(len(ids)), np.int32(seed), np.int32(max_new),
                np.float32(temp))

    def canary_item(self) -> Any:
        return self.host_decode(
            b'{"prompt": "canary", "seed": 1, "max_new_tokens": 2}',
            "application/json")

    def detokenize(self, token_ids: "list[int]") -> str:
        """WordPiece pieces back to text: '##' continuations merge, EOS and
        pads drop."""
        inv = self.tokenizer.inv
        words: list[str] = []
        for t in token_ids:
            piece = inv.get(int(t), "")
            if not piece or piece in ("[SEP]", "[PAD]", "[CLS]"):
                continue
            if piece.startswith("##") and words:
                words[-1] += piece[2:]
            else:
                words.append(piece)
        return " ".join(words)

    def _result(self, tokens: np.ndarray, n_new: int) -> dict:
        toks = [int(t) for t in np.asarray(tokens)[: int(n_new)]]
        return {"text": self.detokenize(toks), "tokens": toks,
                "n_tokens": len(toks)}

    def finalize(self, extracted: Any, item: Any) -> Any:
        return self._result(extracted["tokens"], int(extracted["n_new"]))

    def result_units(self, result: Any) -> float:
        """Tokens generated — the tokens/s headline unit."""
        return float(result.get("n_tokens", 1))

    # -- streaming ------------------------------------------------------------
    def stream_units(self, step_out: dict, slot: int, stream: dict) -> list:
        """Token units newly landed for one slot this iteration, read from
        the step's host out-block. The text delta is an incremental
        detokenize: detokenize() is append-only under WordPiece merges (a
        new word appends " w", a "##" continuation its suffix, EOS and PAD
        nothing), so the concatenation of every unit's "text" equals the
        unary result's "text" byte for byte."""
        n = int(step_out["n_new"][slot])
        sent = int(stream.get("sent", 0))
        if n <= sent:
            return []
        toks = [int(t) for t in step_out["tokens"][slot][:n]]
        prev = stream.get("text", "")
        units = []
        for i in range(sent, n):
            text = self.detokenize(toks[: i + 1])
            units.append({"type": "token", "text": text[len(prev):],
                          "token": toks[i], "index": i})
            prev = text
        stream["sent"] = n
        stream["text"] = prev
        return units

    def stream_finish_reason(self, result: Any) -> str:
        toks = result.get("tokens") or []
        return "stop" if toks and toks[-1] == self.eos_id else "length"

    def stream_usage(self, result: Any) -> dict:
        return {"completion_tokens": int(result.get("n_tokens", 0))}

    def host_postprocess(self, outputs: dict, n_valid: int) -> list[dict]:
        return [self._result(outputs["tokens"][r], outputs["n_new"][r])
                for r in range(n_valid)]


def create(cfg: ModelConfig) -> TextGenServing:
    return TextGenServing(cfg)
