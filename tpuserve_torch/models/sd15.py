"""Stable Diffusion 1.5 txt2img, ported from ``tpuserve/models/sd15.py``
(BASELINE.json config 5) — the multi-step, large-activation generative
family.

The network is the reference's: the CLIP ViT-L/14 text tower (pre-LN causal
transformer over 77 tokens, quick-gelu), the 860M UNet (320 channels, mults
1/2/4/4, two res blocks a level, one spatial transformer with self- and
cross-attention at the three highest resolutions, 8 heads, a GEGLU
feed-forward whose FIRST half is the gate) and the AutoencoderKL decoder
(128 channels, mults 1/2/4/4, single-head mid attention), all overridable
through ``cfg.options`` so the tests run a tiny variant on the CPU. Details
that move numbers are kept: GroupNorm with ``gcd(32, C)`` groups in float32
with flax's fast variance ``E[x^2] - E[x]^2`` (eps 1e-5 in the UNet's res
blocks and ``norm_out``, 1e-6 in the spatial transformers and the VAE),
LayerNorm in float32 (eps 1e-5), explicit (1, 1) padding on the stride-2
downsampling convolutions, nearest 2x upsampling, ``conv_out`` of the UNet
and of the VAE in float32. Activations are (B, C, H, W) over channels_last
memory (NHWC, the reference's layout), and every convolution of more than
one image is one GEMM over its shifted windows (``conv2d``), so an image
does not depend on its lane in a batch or its slot in an engine step.

``options.unet_attention = "flash"`` runs the spatial self-attention of 1,024
tokens and more through kernel K1 (``tpuserve_torch.ops.flash_attention``)
as the reference's ``_flash_unet_attention_fn`` does: the head dim zero-padded
to the next multiple of 64 (40 -> 64 at 4,096 tokens, 80 -> 128 at 1,024 at
512 px) and q pre-scaled by ``(dp / d) ** 0.5``, since the kernel scales by
the padded dim. Smaller token counts and every 77-key cross-attention stay
dense torch ops, as in the reference. At SD 1.5's widths one UNet call
launches K1 ten times.

Two serving shapes, deterministic in (prompt, negative prompt, seed):

- ``forward`` — the locked batch: one 2B text-encoder call (the negative
  prompts, then the prompts), latents from ``jax.random.normal``'s draw
  (``tpuserve_torch.ops.threefry``), the whole DDIM loop with classifier-free
  guidance as one 2B UNet call per step, the VAE decode and uint8
  quantization. The runtime captures all of it as ONE CUDA graph per
  (bucket, parameter slot), the reference's one ``fori_loop`` executable.
- ``init_state`` / ``step`` / ``extract`` — the engine decomposition: the
  insert text-encodes and seeds one slot, each step is one DDIM iteration
  over the slot block with every slot at its own schedule index (``done``
  freezes finished and free slots), and ``extract`` decodes one slot's
  latent. Streamed requests get progress events, previews through the
  captured extract program and the final image as binary frames
  (``tpuserve_torch.frame``).

Tokenization, fixed to 77 ids: CLIP's byte-level BPE
(``tpuserve_torch.text.CLIPBPETokenizer``) with ``options.bpe_vocab`` /
``bpe_merges`` (the published artifact's ``vocab.json`` and
``merges.txt``), else the port's WordPiece over the synthetic vocabulary
(or ``options.vocab_file``) with its [CLS]/[SEP] framing; the text tower's
vocabulary is sized from the tokenizer's. Weights: the seeded init, the
port's ``.npz``, or a published single-file LDM checkpoint
(``.safetensors`` / ``.ckpt``) named in ``weights``, mapped onto the tree by
``models/sd15_import.py`` (``import_torch_variables``). PNGs are written
with ``zlib`` and ``struct`` (``encode_png``).
"""

from __future__ import annotations

import json
import math
import struct
import warnings
import zlib
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuserve_torch import frame as frame_wire
from tpuserve_torch.config import ModelConfig
from tpuserve_torch.genserve.model import GenerativeModel
from tpuserve_torch.models.base import DTYPES, TensorSpec, check_mesh
from tpuserve_torch.ops import threefry
from tpuserve_torch.ops.flash_attention import flash_attention
from tpuserve_torch.text import CLIPBPETokenizer, WordPieceTokenizer, synthetic_vocab

MAX_TOKENS = 77  # CLIP text context length; SD conditions on all 77 states.
LATENT_SCALE = 0.18215
I32 = np.dtype(np.int32)
F32 = np.dtype(np.float32)
# Self-attention of at least this many tokens takes K1 under "flash".
FLASH_MIN_TOKENS = 1024


# -- parameter holders (flax names; torch layouts) ------------------------------

class Dense(nn.Module):
    """flax ``Dense`` / ``DenseGeneral``: ``weight`` (out, in) holds the
    transposed kernel; an attention projection's (d, heads, hd) or
    (heads, hd, d) kernel is held flattened the same way."""

    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           stride: int = 1) -> torch.Tensor:
    """A k x k convolution with symmetric k // 2 padding ("SAME" at stride 1,
    the downsampling convolutions' explicit (1, 1) at stride 2) of
    (B, C, H, W) over channels_last memory, as ONE GEMM of the shifted
    windows (im2col, (B*Ho*Wo, k*k*C)) against the (Cout, k*k*C) kernel.

    cuDNN's convolutions at the UNet's 640- and 1,280-channel shapes give an
    image a result that depends on its position in the batch (on the H100,
    34 of the 65 at 16 rows), so an engine step would make a request's
    image depend on its slot; a GEMM row depends on its own input row only,
    so the image is a function of (prompt, seed) wherever it lands. A
    batch of one image has no position to depend on and takes cuDNN's
    convolution (the VAE decode of the engine's extract and of the bucket-1
    locked batch) — unless it is float32 (the two ``conv_out``): cuDNN runs
    float32 in TF32 by PyTorch's default, cuBLAS's GEMM in float32."""
    k = weight.shape[-1]
    b = x.shape[0]
    if b == 1 and x.dtype != torch.float32:
        return F.conv2d(x, weight, bias, stride=stride, padding=k // 2)
    xh = x.permute(0, 2, 3, 1)
    if k > 1:
        p = k // 2
        xh = F.pad(xh, (0, 0, p, p, p, p)).unfold(1, k, stride).unfold(2, k, stride)
        xh = xh.permute(0, 1, 2, 4, 5, 3)                 # (B, Ho, Wo, kh, kw, C)
    ho, wo = xh.shape[1], xh.shape[2]
    w = weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)
    out = F.linear(xh.reshape(b * ho * wo, -1), w, bias)
    return out.view(b, ho, wo, -1).permute(0, 3, 1, 2)


class Conv(nn.Module):
    """flax ``Conv`` with a bias: OIHW ``weight`` of the HWIO kernel."""

    def __init__(self, cin: int, cout: int, k: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, stride)


class Norm(nn.Module):
    """A LayerNorm's or GroupNorm's per-channel ``scale`` and ``bias``."""

    def __init__(self, c: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention``: query from ``cq`` features,
    key and value from ``ckv``, ``cq`` qkv features over ``heads`` heads."""

    def __init__(self, cq: int, ckv: int, heads: int) -> None:
        super().__init__()
        self.heads = heads
        self.query = Dense(cq, cq)
        self.key = Dense(ckv, cq)
        self.value = Dense(ckv, cq)
        self.out = Dense(cq, cq)


# -- shared math ------------------------------------------------------------------

def group_norm(x: torch.Tensor, norm: Norm, eps: float) -> torch.Tensor:
    """flax ``GroupNorm(gcd(32, C))`` of (B, C, H, W) in float32 with the fast
    variance ``max(E[x^2] - E[x]^2, 0)``; the result is float32, (B, C, H, W)
    over channels_last memory."""
    b, c, h, w = x.shape
    g = math.gcd(32, c)
    v = x.float().permute(0, 2, 3, 1).reshape(b, h * w, g, c // g)
    mean = v.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp_min((v * v).mean(dim=(1, 3), keepdim=True) - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps) * norm.scale.float().view(g, c // g)
    y = (v - mean) * mul + norm.bias.float().view(g, c // g)
    return y.reshape(b, h, w, c).permute(0, 3, 1, 2)


def layer_norm(x: torch.Tensor, norm: Norm, eps: float = 1e-5) -> torch.Tensor:
    """flax ``LayerNorm`` over the last dim in float32 (fast variance);
    float32 result."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mean * mean, 0.0)
    return (xf - mean) * (torch.rsqrt(var + eps) * norm.scale.float()) + norm.bias.float()


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as ``jnp.asarray(value, dtype)``."""
    return float(torch.tensor(value, dtype=dtype, device="cpu"))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """flax's dense attention on (B, S, H, D): q divided by sqrt(D) (rounded
    to the compute dtype), scores in the compute dtype, a causal mask as
    the dtype's lowest value, softmax in float32, P.V in the compute dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q / _rounded(math.sqrt(q.shape[-1]), q.dtype), k)
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def pad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, d) zero-padded to the next multiple of 64 in d."""
    d = x.shape[-1]
    dp = -(-d // 64) * 64
    return x if d == dp else F.pad(x, (0, dp - d))


def flash_unet_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The reference's ``_flash_unet_attention_fn`` for a mask-free
    self-attention: q, k, v padded to the next multiple of 64 in the head
    dim, q times ``(dp / d) ** 0.5`` (rounded to its dtype) so that K1's
    ``dp ** -0.5`` lands on ``d ** -0.5``, and the output sliced back to d.
    The zero lanes add nothing to q.k and yield output columns that are cut."""
    d = q.shape[-1]
    qf, kf, vf = pad_head_dim(q), pad_head_dim(k), pad_head_dim(v)
    qf = qf * _rounded((qf.shape[-1] / d) ** 0.5, q.dtype)
    return flash_attention(qf, kf, vf)[..., :d]


def attend(attn: Attention, xq: torch.Tensor, xkv: torch.Tensor, *,
           causal: bool = False, flash: bool = False) -> torch.Tensor:
    """Multi-head attention of (B, N, Cq) queries over (B, M, Ckv) keys and
    values; ``flash`` sends a mask-free self-attention of at least
    ``FLASH_MIN_TOKENS`` tokens to K1."""
    b, n, _ = xq.shape
    m, h = xkv.shape[1], attn.heads
    q = attn.query(xq).view(b, n, h, -1)
    k = attn.key(xkv).view(b, m, h, -1)
    v = attn.value(xkv).view(b, m, h, -1)
    if flash and not causal and n >= FLASH_MIN_TOKENS:
        o = flash_unet_attention(q, k, v)
    else:
        o = dot_product_attention(q, k, v, causal)
    return attn.out(o.reshape(b, n, -1))


def nhwc_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) channels_last -> its (B, H*W, C) rows (a view)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def from_rows(rows: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H*W, C) rows -> (B, C, H, W) over channels_last memory."""
    b, _, c = rows.shape
    return rows.reshape(b, h, w, c).permute(0, 3, 1, 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x, as ``jax.image.resize(..., method="nearest")``."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding in float32: (B,) int -> (B, dim), cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# -- CLIP text encoder ----------------------------------------------------------------

class CLIPBlock(nn.Module):
    def __init__(self, d: int, heads: int) -> None:
        super().__init__()
        self.ln1 = Norm(d)
        self.attn = Attention(d, d, heads)
        self.ln2 = Norm(d)
        self.mlp_up = Dense(d, 4 * d)
        self.mlp_down = Dense(4 * d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = layer_norm(x, self.ln1).to(x.dtype)
        x = x + attend(self.attn, h, h, causal=True)
        h = self.mlp_up(layer_norm(x, self.ln2).to(x.dtype))
        return x + self.mlp_down(h * torch.sigmoid(1.702 * h))   # quick-gelu


class CLIPTextEncoder(nn.Module):
    """(B, 77) int ids -> (B, 77, d) final hidden states."""

    def __init__(self, vocab: int, layers: int, d: int, heads: int) -> None:
        super().__init__()
        self.token_embed = nn.Module()
        self.token_embed.embedding = nn.Parameter(torch.empty(vocab, d))
        self.pos_embed = nn.Parameter(torch.empty(MAX_TOKENS, d))
        for i in range(layers):
            self.add_module(f"layer{i}", CLIPBlock(d, heads))
        self.layers = layers
        self.ln_final = Norm(d)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        emb = self.token_embed.embedding
        x = emb[ids.long()] + self.pos_embed[: ids.shape[1]].to(emb.dtype)
        for i in range(self.layers):
            x = getattr(self, f"layer{i}")(x)
        return layer_norm(x, self.ln_final).to(emb.dtype)


# -- UNet ------------------------------------------------------------------------------

class ResBlock(nn.Module):
    """The UNet's res block (GroupNorm eps 1e-5) or, with ``temb`` 0, the
    VAE's (eps 1e-6, no time projection)."""

    def __init__(self, cin: int, cout: int, temb: int = 0) -> None:
        super().__init__()
        self.eps = 1e-5 if temb else 1e-6
        self.norm1 = Norm(cin)
        self.conv1 = Conv(cin, cout, 3)
        if temb:
            self.temb_proj = Dense(temb, cout)
        self.norm2 = Norm(cout)
        self.conv2 = Conv(cout, cout, 3)
        if cin != cout:
            self.skip = Conv(cin, cout, 1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None) -> torch.Tensor:
        dt = self.conv1.weight.dtype
        h = self.conv1(F.silu(group_norm(x, self.norm1, self.eps)).to(dt))
        if temb is not None:
            h = h + self.temb_proj(F.silu(temb).to(dt))[:, :, None, None]
        h = self.conv2(F.silu(group_norm(h, self.norm2, self.eps)).to(dt))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class TransformerBlock(nn.Module):
    """LN -> self-attention, LN -> cross-attention (text), LN -> GEGLU."""

    def __init__(self, c: int, ctx: int, heads: int, flash: bool) -> None:
        super().__init__()
        self.flash = flash
        self.ln1 = Norm(c)
        self.self_attn = Attention(c, c, heads)
        self.ln2 = Norm(c)
        self.cross_attn = Attention(c, ctx, heads)
        self.ln3 = Norm(c)
        self.ff_up = Dense(c, 8 * c)
        self.ff_down = Dense(4 * c, c)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        h = layer_norm(x, self.ln1).to(dt)
        x = x + attend(self.self_attn, h, h, flash=self.flash)
        h = layer_norm(x, self.ln2).to(dt)
        x = x + attend(self.cross_attn, h, ctx)
        gate, val = self.ff_up(layer_norm(x, self.ln3).to(dt)).chunk(2, dim=-1)
        return x + self.ff_down(val * F.gelu(gate))


class SpatialTransformer(nn.Module):
    def __init__(self, c: int, ctx: int, heads: int, flash: bool) -> None:
        super().__init__()
        self.norm = Norm(c)
        self.proj_in = Conv(c, c, 1)
        self.block = TransformerBlock(c, ctx, heads, flash)
        self.proj_out = Conv(c, c, 1)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        h_, w_ = x.shape[-2:]
        h = nhwc_rows(self.proj_in(group_norm(x, self.norm, 1e-6).to(x.dtype)))
        return x + self.proj_out(from_rows(self.block(h, ctx), h_, w_))


class UNet(nn.Module):
    """SD 1.5's epsilon predictor: (B, h, w, 4) float32 latents, (B,) int
    timesteps and (B, 77, D) text states -> (B, h, w, 4) float32."""

    def __init__(self, ctx: int, ch: int, mults: Sequence[int], num_res: int,
                 attn_levels: Sequence[int], heads: int, flash: bool) -> None:
        super().__init__()
        self.ch, self.mults, self.num_res = ch, tuple(mults), num_res
        self.attn_levels = tuple(attn_levels)
        self.time1 = Dense(ch, 4 * ch)
        self.time2 = Dense(4 * ch, 4 * ch)
        self.conv_in = Conv(4, ch, 3)
        t, c, skips = 4 * ch, ch, [ch]
        for i, m in enumerate(self.mults):
            for j in range(num_res):
                self.add_module(f"down{i}_res{j}", ResBlock(c, ch * m, t))
                c = ch * m
                if i in self.attn_levels:
                    self.add_module(f"down{i}_attn{j}", SpatialTransformer(c, ctx, heads, flash))
                skips.append(c)
            if i != len(self.mults) - 1:
                self.add_module(f"down{i}_ds", Conv(c, c, 3))
                skips.append(c)
        self.mid_res1 = ResBlock(c, c, t)
        self.mid_attn = SpatialTransformer(c, ctx, heads, flash)
        self.mid_res2 = ResBlock(c, c, t)
        for i, m in reversed(list(enumerate(self.mults))):
            for j in range(num_res + 1):
                self.add_module(f"up{i}_res{j}", ResBlock(c + skips.pop(), ch * m, t))
                c = ch * m
                if i in self.attn_levels:
                    self.add_module(f"up{i}_attn{j}", SpatialTransformer(c, ctx, heads, flash))
            if i != 0:
                self.add_module(f"up{i}_us", Conv(c, c, 3))
        self.norm_out = Norm(c)
        self.conv_out = Conv(c, 4, 3)

    def forward(self, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        dt = self.conv_in.weight.dtype
        temb = self.time1(timestep_embedding(t, self.ch).to(dt))
        temb = self.time2(F.silu(temb))
        h = self.conv_in(x.permute(0, 3, 1, 2).to(dt))
        skips = [h]
        for i in range(len(self.mults)):
            for j in range(self.num_res):
                h = getattr(self, f"down{i}_res{j}")(h, temb)
                if i in self.attn_levels:
                    h = getattr(self, f"down{i}_attn{j}")(h, ctx)
                skips.append(h)
            if i != len(self.mults) - 1:
                h = getattr(self, f"down{i}_ds")(h, stride=2)
                skips.append(h)
        h = self.mid_res2(self.mid_attn(self.mid_res1(h, temb), ctx), temb)
        for i in reversed(range(len(self.mults))):
            for j in range(self.num_res + 1):
                h = getattr(self, f"up{i}_res{j}")(torch.cat([h, skips.pop()], dim=1), temb)
                if i in self.attn_levels:
                    h = getattr(self, f"up{i}_attn{j}")(h, ctx)
            if i != 0:
                h = getattr(self, f"up{i}_us")(upsample2x(h))
        h = F.silu(group_norm(h, self.norm_out, 1e-5)).to(dt)
        w = self.conv_out
        return conv2d(h.float(), w.weight.float(), w.bias.float()).permute(0, 2, 3, 1)


# -- VAE decoder -----------------------------------------------------------------------

class VAEAttn(nn.Module):
    """Single-head full self-attention over spatial positions."""

    def __init__(self, c: int) -> None:
        super().__init__()
        self.norm = Norm(c)
        self.q, self.k, self.v, self.proj = (Dense(c, c) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, h_, w_ = x.shape[1:]
        h = nhwc_rows(group_norm(x, self.norm, 1e-6).to(x.dtype))
        q, k, v = self.q(h), self.k(h), self.v(h)
        s = torch.bmm(q, k.transpose(1, 2)).float() * (c ** -0.5)
        a = torch.softmax(s, dim=-1).to(x.dtype)
        return x + from_rows(self.proj(torch.bmm(a, v)), h_, w_)


class VAEDecoder(nn.Module):
    """AutoencoderKL decoder: (B, h, w, 4) float32 latents -> (B, 8h, 8w, 3)
    float32 in about [-1, 1] (for 4 levels)."""

    def __init__(self, ch: int, mults: Sequence[int]) -> None:
        super().__init__()
        self.mults = tuple(mults)
        top = ch * self.mults[-1]
        self.post_quant = Conv(4, 4, 1)
        self.conv_in = Conv(4, top, 3)
        self.mid_res1 = ResBlock(top, top)
        self.mid_attn = VAEAttn(top)
        self.mid_res2 = ResBlock(top, top)
        c = top
        for i, m in reversed(list(enumerate(self.mults))):
            for j in range(3):
                self.add_module(f"up{i}_res{j}", ResBlock(c, ch * m))
                c = ch * m
            if i != 0:
                self.add_module(f"up{i}_us", Conv(c, c, 3))
        self.norm_out = Norm(c)
        self.conv_out = Conv(c, 3, 3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.conv_in.weight.dtype
        h = self.conv_in(self.post_quant(z.permute(0, 3, 1, 2).to(dt)))
        h = self.mid_res2(self.mid_attn(self.mid_res1(h)))
        for i in reversed(range(len(self.mults))):
            for j in range(3):
                h = getattr(self, f"up{i}_res{j}")(h)
            if i != 0:
                h = getattr(self, f"up{i}_us")(upsample2x(h))
        h = F.silu(group_norm(h, self.norm_out, 1e-6)).to(dt)
        w = self.conv_out
        return conv2d(h.float(), w.weight.float(), w.bias.float()).permute(0, 2, 3, 1)


class SD15Module(nn.Module):
    """The three networks of one parameter slot."""

    def __init__(self, text: CLIPTextEncoder, unet: UNet, vae: VAEDecoder) -> None:
        super().__init__()
        self.text, self.unet, self.vae = text, unet, vae


# -- DDIM schedule (host-side numpy) ------------------------------------------------

def ddim_schedule(steps: int, train_steps: int = 1000,
                  beta_start: float = 0.00085, beta_end: float = 0.012):
    """SD's scaled-linear schedule -> per-step (t, alpha_t, alpha_prev) arrays
    of static length `steps`, ordered from t=high noise down to 0."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, train_steps,
                        dtype=np.float64) ** 2
    acum = np.cumprod(1.0 - betas)
    ts = np.linspace(0, train_steps - 1, steps).round().astype(np.int64)[::-1]
    a_t = acum[ts]
    a_prev = np.concatenate([acum[ts[1:]], [1.0]])
    return (ts.astype(np.int32), a_t.astype(np.float32),
            a_prev.astype(np.float32))


# -- PNG ------------------------------------------------------------------------------

def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG: IHDR, one IDAT of the
    zlib-compressed scanlines (filter 0, none, on every row), IEND."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {arr.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


# -- serving ------------------------------------------------------------------------

class SD15Serving(GenerativeModel):
    """txt2img over HTTP: JSON {"prompt", "negative_prompt"?, "seed"?} in,
    PNG bytes out. The negative prompt rides the classifier-free-guidance
    uncond lane (the empty prompt when unset), steering generation away
    from it. Fixed ``steps`` per request keep every shape static."""

    channels_last = True

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__(cfg)
        o = cfg.options
        if cfg.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {cfg.dtype!r}")
        self.dtype = DTYPES[cfg.dtype]
        self.device = torch.device("cpu")
        self.steps = int(o.get("steps", 20))
        self.guidance = float(o.get("guidance", 7.5))
        # Streamed responses emit a decoded preview image every N denoise
        # steps (0 disables); each reuses the captured extract program.
        self.preview_every = int(o.get("preview_every", 0))
        if self.preview_every < 0:
            raise ValueError(
                f"options.preview_every must be >= 0, got {self.preview_every}")
        # The VAE upsamples 2x per level past the first.
        self.vae_mults = tuple(o.get("vae_mults", (1, 2, 4, 4)))
        self.latent = cfg.image_size // (2 ** (len(self.vae_mults) - 1))
        if bool(o.get("bpe_vocab")) != bool(o.get("bpe_merges")):
            raise ValueError(
                "bpe_vocab and bpe_merges must be set together "
                "(CLIP BPE needs vocab.json + merges.txt)")
        # Replicas, or one mesh whose forward is not split (the runtime
        # refuses a split mesh for this generative family).
        check_mesh(cfg)
        vocab_file = o.get("vocab_file")
        if o.get("bpe_vocab"):
            # Real SD/CLIP artifacts: byte-level BPE (vocab.json + merges.txt).
            self.tokenizer = CLIPBPETokenizer(o["bpe_vocab"], o["bpe_merges"])
        elif vocab_file:
            self.tokenizer = WordPieceTokenizer.from_vocab_file(vocab_file)
        else:
            self.tokenizer = WordPieceTokenizer(
                synthetic_vocab(int(o.get("vocab_size", 8192))))
        self.vocab_size = max(self.tokenizer.vocab.values()) + 1
        self.text_layers = int(o.get("text_layers", 12))
        self.text_d_model = int(o.get("text_d_model", 768))
        self.text_heads = int(o.get("text_heads", 12))
        self.unet_attention = str(o.get("unet_attention", "dense"))
        if self.unet_attention not in ("dense", "flash"):
            raise ValueError("options.unet_attention must be 'dense' or "
                             f"'flash', got {self.unet_attention!r}")
        self.unet_ch = int(o.get("unet_ch", 320))
        self.unet_mults = tuple(o.get("unet_mults", (1, 2, 4, 4)))
        self.unet_res = int(o.get("unet_res", 2))
        self.unet_attn_levels = tuple(o.get("unet_attn_levels", (0, 1, 2)))
        self.unet_heads = int(o.get("unet_heads", 8))
        self.vae_ch = int(o.get("vae_ch", 128))
        self.schedule = ddim_schedule(self.steps)
        self._schedules: dict[torch.device, tuple] = {}

    # -- params ---------------------------------------------------------------
    def build_module(self) -> SD15Module:
        return SD15Module(
            CLIPTextEncoder(self.vocab_size, self.text_layers, self.text_d_model,
                            self.text_heads),
            UNet(self.text_d_model, self.unet_ch, self.unet_mults, self.unet_res,
                 self.unet_attn_levels, self.unet_heads, self.unet_attention == "flash"),
            VAEDecoder(self.vae_ch, self.vae_mults))

    def bind_mesh(self, mesh) -> None:
        """The serving device, where the seeded parameters are drawn."""
        self.device = mesh.devices.flat[0]

    def init_params(self, seed: int = 0,
                    device: "str | torch.device" = "cpu") -> dict[str, torch.Tensor]:
        """Seeded float32 parameters drawn on ``device`` with flax's
        initializer families (jax.random's draws are not reproduced):
        LeCun-normal kernels (a normal truncated at two standard deviations,
        its std sqrt(1 / fan_in) / 0.8796, fan_in the kernel's input dims),
        zero biases, unit norm scales, ``pos_embed`` N(0, 0.01) and the token
        embedding N(0, 1 / d). The draws depend on the device's generator."""
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.device("meta"):
            shapes = {k: tuple(v.shape) for k, v in self.build_module().state_dict().items()}
        sd = {}
        for name, shape in shapes.items():
            if name.endswith(".bias"):
                x = torch.zeros(shape, device=device)
            elif name.endswith(".scale"):
                x = torch.ones(shape, device=device)
            elif name.endswith("pos_embed"):
                x = torch.randn(shape, generator=g, device=device) * 0.01
            elif name.endswith("embedding"):
                x = torch.randn(shape, generator=g, device=device) * shape[1] ** -0.5
            else:
                std = (1.0 / math.prod(shape[1:])) ** 0.5 / 0.87962566103423978
                x = _truncated_normal(shape, g, device) * std
            sd[name] = x
        return sd

    def load_tree(self, verify_integrity: bool = True,
                  require_manifest: bool = False) -> dict:
        if not self.cfg.weights:
            return self.to_jax_params(self.init_params(0, self.device))
        return super().load_tree(verify_integrity, require_manifest)

    def load_params(self) -> dict[str, torch.Tensor]:
        """The seeded init drawn on the serving device (no host round trip),
        or ``cfg.weights`` through ``load_tree``'s integrity gate."""
        if not self.cfg.weights:
            return self.init_params(0, self.device)
        return super().load_params()

    def _heads(self, name: str) -> int:
        return self.text_heads if name.startswith("text.") else self.unet_heads

    def from_jax_params(self, tree: Any) -> dict[str, torch.Tensor]:
        """The reference's ``{"text", "unet", "vae"}`` tree of ``{"params":
        ...}`` -> this module's float32 state_dict: conv kernels HWIO ->
        OIHW, Dense kernels (in, out) -> (out, in), attention query/key/value
        kernels (d, heads, hd) -> (heads*hd, d) with biases (heads, hd) ->
        (heads*hd,), out kernels (heads, hd, d) -> (d, heads*hd).

        Each leaf is copied once, into the layout the module holds: a leaf
        that is a view (an imported checkpoint's transposed memory map) is
        read through the view, and nothing of the state_dict aliases it."""
        sd: dict[str, torch.Tensor] = {}

        def walk(node: Any, prefix: str) -> None:
            for key, val in node.items():
                if hasattr(val, "items"):
                    walk(val, f"{prefix}{key}.")
                    continue
                with warnings.catch_warnings():
                    # Read-only leaves (a memory-mapped checkpoint) are only
                    # read: the clone below copies them.
                    warnings.filterwarnings("ignore", "The given NumPy array is not writable")
                    t = torch.from_numpy(np.asarray(val, dtype=np.float32))
                if key == "kernel":
                    key = "weight"
                    t = (t.permute(3, 2, 0, 1) if t.dim() == 4
                         else t.reshape(t.shape[0], -1).T if prefix.endswith(
                             (".query.", ".key.", ".value.")) else t.reshape(-1, t.shape[-1]).T)
                elif key == "bias":
                    t = t.reshape(-1)
                sd[prefix + key] = t.clone(memory_format=torch.contiguous_format)

        for net in ("text", "unet", "vae"):
            walk(tree[net]["params"], f"{net}.")
        return sd

    def to_jax_params(self, state_dict: dict[str, torch.Tensor]) -> dict:
        """``from_jax_params`` inverted, bit for bit (each leaf laid out where
        the state_dict lies — on the card, the transposes run there — then
        copied to the host)."""
        return self._reference_tree(state_dict, lambda t: t.contiguous().cpu().numpy())

    def reference_tree_meta(self) -> dict:
        """The reference's tree of this model with ``meta`` tensors for
        leaves (their shapes are the leaves' shapes): ``to_jax_params`` of
        the module's state_dict, built on the meta device, so that nothing is
        allocated. The LDM import validates its tree against it."""
        with torch.device("meta"):
            state_dict = self.build_module().state_dict()
        return self._reference_tree(state_dict, lambda t: t)

    def import_torch_variables(self, flat: dict) -> Any:
        """Published SD 1.5 single-file checkpoint (LDM layout, safetensors
        or .ckpt) -> the reference's tree; see ``models/sd15_import.py``.
        Pair with options bpe_vocab/bpe_merges for the real CLIP tokenizer."""
        from tpuserve_torch.models.sd15_import import import_ldm_checkpoint

        return import_ldm_checkpoint(self, flat)

    def _reference_tree(self, state_dict: dict[str, torch.Tensor], finish) -> dict:
        tree: dict = {net: {"params": {}} for net in ("text", "unet", "vae")}
        for name, v in state_dict.items():
            t = v.detach().to(torch.float32)
            net, *mods, leaf = name.split(".")
            h = self._heads(name)
            parent = mods[-1] if mods else ""
            if leaf == "weight":
                leaf = "kernel"
                if t.dim() == 4:
                    t = t.permute(2, 3, 1, 0)
                elif parent in ("query", "key", "value"):
                    t = t.T.reshape(t.shape[1], h, -1)
                elif parent == "out":
                    t = t.T.reshape(h, -1, t.shape[0])
                else:
                    t = t.T
            elif leaf == "bias" and parent in ("query", "key", "value"):
                t = t.reshape(h, -1)
            node = tree[net]["params"]
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = finish(t)
        return tree

    def reference_layout(self, name: str, shape: tuple) -> tuple[tuple, tuple]:
        """The reference's layouts (``from_jax_params``): query/key/value
        weights (heads*hd, d) as (d, heads, hd) and their biases as (heads,
        hd); out weights (d, heads*hd) as (heads, hd, d); embeddings as they
        are; conv and Dense kernels by the default."""
        *_, parent, leaf = ("", *name.split("."))
        h = self._heads(name)
        if parent in ("query", "key", "value"):
            if leaf == "weight":
                return (h, shape[0] // h, shape[1]), (2, 0, 1)
            return (h, shape[0] // h), (0, 1)
        if parent == "out" and leaf == "weight":
            return (shape[0], h, shape[1] // h), (1, 2, 0)
        if leaf in ("embedding", "pos_embed"):
            return tuple(shape), tuple(range(len(shape)))
        return super().reference_layout(name, shape)

    # -- shapes ---------------------------------------------------------------
    def input_signature(self, bucket: tuple) -> tuple[TensorSpec, ...]:
        (b,) = bucket
        return (TensorSpec((b, MAX_TOKENS), I32),   # prompt ids
                TensorSpec((b, MAX_TOKENS), I32),   # negative prompt ids
                TensorSpec((b,), I32))              # seed

    def gen_item_signature(self) -> tuple[TensorSpec, ...]:
        return (TensorSpec((MAX_TOKENS,), I32), TensorSpec((MAX_TOKENS,), I32),
                TensorSpec((), I32))

    def state_signature(self, slots: int) -> dict:
        return {"lat": TensorSpec((slots, self.latent, self.latent, 4), F32),
                "ctx": TensorSpec((slots, 2, MAX_TOKENS, self.text_d_model), self.dtype),
                "step_i": TensorSpec((slots,), I32),
                "done": TensorSpec((slots,), np.dtype(np.bool_))}

    # -- device side ----------------------------------------------------------
    def _schedule_on(self, device: torch.device) -> tuple:
        """(ts, a_t, a_prev) as tensors on ``device``, made once per device
        on the first (eager) call: a captured graph reads them in place."""
        sched = self._schedules.get(device)
        if sched is None:
            sched = self._schedules[device] = tuple(
                torch.from_numpy(a).to(device) for a in self.schedule)
        return sched

    def latents(self, seeds: torch.Tensor) -> torch.Tensor:
        """``jax.random.normal(fold_in(key(0), seed), (h, w, 4), float32)``
        per seed: (B,) -> (B, h, w, 4)."""
        k0, k1 = threefry.key(torch.zeros_like(seeds))
        k0, k1 = threefry.fold_in(k0, k1, seeds)
        n = self.latent * self.latent * 4
        return threefry.normal(threefry.bits32(k0, k1, n)).reshape(
            -1, self.latent, self.latent, 4)

    def _ddim(self, lat, eps2, at, ap) -> torch.Tensor:
        """Guidance over the (uncond, cond) halves of eps2, then one DDIM
        update of the float32 latents."""
        eps_u, eps_c = eps2.chunk(2)
        eps = eps_u + self.guidance * (eps_c - eps_u)
        x0 = (lat - torch.sqrt(1.0 - at) * eps) / torch.sqrt(at)
        return torch.sqrt(ap) * x0 + torch.sqrt(1.0 - ap) * eps

    @staticmethod
    def _decode(module: SD15Module, lat: torch.Tensor) -> torch.Tensor:
        """VAE decode of (B, h, w, 4) latents -> (B, H, W, 3) uint8."""
        img = module.vae(lat / LATENT_SCALE)
        return torch.clamp((img + 1.0) * 127.5, 0.0, 255.0).to(torch.uint8)

    def forward(self, module: SD15Module, batch: Any) -> dict:
        ids, neg_ids, seeds = batch
        b = ids.shape[0]
        # One 2B text-encoder call covers cond + per-item uncond.
        ctx2 = module.text(torch.cat([neg_ids, ids], dim=0))
        lat = self.latents(seeds)
        ts, a_t, a_prev = self._schedule_on(ids.device)
        for i in range(self.steps):
            eps2 = module.unet(torch.cat([lat, lat], dim=0), ts[i].expand(2 * b), ctx2)
            lat = self._ddim(lat, eps2, a_t[i], a_prev[i])
        return {"image": self._decode(module, lat)}

    def logits(self, module: SD15Module, batch: Any) -> torch.Tensor:
        raise TypeError("sd15's forward returns images, not class logits")

    # -- engine decomposition (tpuserve_torch.genserve) -----------------------
    def init_state(self, module: SD15Module, item: tuple) -> dict:
        """Once-per-request work: text-encode the uncond + cond pair, seed
        the latent. Same math as forward's prologue."""
        ids, neg_ids, seed = item
        ctx2 = module.text(torch.stack([neg_ids, ids]))
        return {"lat": self.latents(seed[None])[0], "ctx": ctx2,
                "step_i": torch.zeros((), dtype=torch.int32, device=ids.device),
                "done": torch.zeros((), dtype=torch.bool, device=ids.device)}

    def step(self, module: SD15Module, state: dict) -> dict:
        """One DDIM iteration over the whole slot block, in place, each slot
        at its OWN schedule index; finished and free slots freeze via
        ``done``."""
        lat, ctx, step_i, done = state["lat"], state["ctx"], state["step_i"], state["done"]
        ts, a_t, a_prev = self._schedule_on(lat.device)
        idx = torch.clamp(step_i, 0, self.steps - 1).long()
        t = ts[idx]
        eps2 = module.unet(torch.cat([lat, lat], dim=0), torch.cat([t, t]),
                           torch.cat([ctx[:, 0], ctx[:, 1]], dim=0))
        new_lat = self._ddim(lat, eps2, a_t[idx][:, None, None, None],
                             a_prev[idx][:, None, None, None])
        lat.copy_(torch.where(done[:, None, None, None], lat, new_lat))
        step2 = torch.where(done, step_i, step_i + 1)
        done2 = step2 >= self.steps
        step_i.copy_(step2)
        done.copy_(done2)
        return {"done": done2, "step_i": step2}

    def extract(self, module: SD15Module, state: dict, slot: torch.Tensor) -> dict:
        """VAE decode + uint8 of the one slot's latent."""
        return {"image": self._decode(module, state["lat"].index_select(0, slot))[0]}

    def gen_max_steps(self) -> int:
        return self.steps

    def finalize(self, extracted: Any, item: Any) -> bytes:
        return encode_png(np.asarray(extracted["image"]))

    # -- streaming --------------------------------------------------------------
    # Over the chunked binary frame wire: KIND_EVENT frames carry the
    # progress/done/error JSON, single-item KIND_RGB8 frames the previews and
    # the final image. Everything but the final image and the terminal is
    # droppable: a slow reader loses progress, never the image.
    def stream_units(self, step_out: dict, slot: int, stream: dict) -> list:
        s = int(step_out["step_i"][slot])
        sent = int(stream.get("sent", 0))
        if s <= sent:
            return []
        stream["sent"] = s
        return [{"type": "progress", "step": i, "steps": self.steps,
                 "droppable": True} for i in range(sent + 1, s + 1)]

    def stream_wants_preview(self, step_out: dict, slot: int, stream: dict) -> bool:
        if not self.preview_every or bool(step_out["done"][slot]):
            return False
        s = int(step_out["step_i"][slot])
        return s - int(stream.get("previewed", 0)) >= self.preview_every

    def stream_preview_unit(self, extracted: Any, stream: dict) -> dict:
        stream["previewed"] = int(stream.get("sent", 0))
        return {"type": "preview", "image": np.asarray(extracted["image"]),
                "droppable": True}

    def stream_final_units(self, extracted: Any, result: Any) -> list:
        return ([{"type": "image", "image": np.asarray(extracted["image"])}]
                + super().stream_final_units(extracted, result))

    def stream_usage(self, result: Any) -> dict:
        return {"images": 1}

    def stream_content_type(self) -> str:
        return frame_wire.CONTENT_TYPE

    def encode_stream_unit(self, unit: dict) -> bytes:
        if unit["type"] in ("image", "preview"):
            return frame_wire.encode_frame(
                [unit["image"]], frame_wire.KIND_RGB8, self.cfg.image_size)
        data = {k: v for k, v in unit.items() if k != "droppable"}
        return frame_wire.encode_stream_event(json.dumps(data).encode("utf-8"))

    def stream_heartbeat(self) -> bytes:
        return frame_wire.encode_stream_event(b'{"type": "hb"}')

    # -- host side --------------------------------------------------------------
    def _tokenize(self, prompt: str) -> np.ndarray:
        """Prompt -> fixed (77,) int32: BOS + BPE pieces + EOS, EOS-padded
        (CLIP's BPE), or [CLS] + pieces + [SEP], pad-id padded (WordPiece)."""
        ids, _ = self.tokenizer.encode(prompt, MAX_TOKENS)
        return ids

    def host_decode(self, payload: bytes, content_type: str) -> Any:
        if content_type.startswith("application/json"):
            body = json.loads(payload.decode("utf-8"))
            prompt = body.get("prompt")
            if not isinstance(prompt, str):
                raise ValueError('JSON body must contain "prompt": str')
            negative = body.get("negative_prompt", "")
            if not isinstance(negative, str):
                raise ValueError('"negative_prompt" must be a string')
            seed = int(body.get("seed", 0))
        else:
            prompt, negative, seed = payload.decode("utf-8"), "", 0
        return self._tokenize(prompt), self._tokenize(negative), np.int32(seed)

    def canary_item(self) -> Any:
        return self.host_decode(b'{"prompt": "canary", "seed": 1}', "application/json")

    def host_postprocess(self, outputs: dict, n_valid: int) -> list[bytes]:
        return [encode_png(np.asarray(outputs["image"][r])) for r in range(n_valid)]


def _truncated_normal(shape: tuple, g: torch.Generator,
                      device: "str | torch.device") -> torch.Tensor:
    """Standard normal draws truncated to [-2, 2] (inverse-CDF sampling)."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(shape, generator=g, device=device) * (hi - lo) + lo
    return torch.clamp(torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0), -2.0, 2.0)


def create(cfg: ModelConfig) -> SD15Serving:
    return SD15Serving(cfg)
