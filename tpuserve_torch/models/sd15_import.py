"""LDM-checkpoint -> parameter-tree mapping for the SD 1.5 family, ported
from ``tpuserve/models/sd15_import.py``.

Published SD 1.5 artifacts ship as single-file torch checkpoints
(``v1-5-pruned-emaonly.safetensors`` / ``.ckpt``) in the original
CompVis/LDM state_dict layout:

- ``cond_stage_model.transformer.text_model.*`` — CLIP ViT-L/14 text tower
  (transformers naming underneath: ``encoder.layers.{i}.self_attn.q_proj``…)
- ``model.diffusion_model.*`` — the UNet (``input_blocks.{k}``,
  ``middle_block``, ``output_blocks.{k}``; each block is a numbered list of
  [ResBlock, SpatialTransformer?, Up/Downsample?])
- ``first_stage_model.*`` — the VAE; serving only needs ``post_quant_conv``
  and ``decoder.*`` (the encoder and any ``model_ema`` copies are ignored).

The mappers produce the reference's flax tree (numpy leaves), which
``SD15Serving.from_jax_params`` turns into the module's state_dict as it
does every ``.npz``. Layout translations (torch -> flax):

- conv ``(O, I, kh, kw)`` -> ``(kh, kw, I, O)``; linear ``(O, I)`` -> ``(I, O)``
- norm ``weight`` -> ``scale``
- attention q/k/v/out linears -> ``nn.MultiHeadDotProductAttention``'s
  DenseGeneral shapes ``(d_in, heads, head_dim)`` / ``(heads, head_dim, d)``;
  SD's UNet attention has no q/k/v bias, so those biases are zeros
  (numerically identical).
- GEGLU half-swap: LDM computes ``x, gate = proj(h).chunk(2)`` while the
  tree's ``ff_up`` splits ``gate, val`` — the two output halves of the
  projection swap places on import. (An unswapped import still runs but
  produces garbage images.)
- VAE mid attention q/k/v/proj_out are 1x1 convs in LDM; the tree's are
  Dense — squeeze the spatial dims and transpose.

Transposes are numpy views: a tensor read through ``np.memmap`` stays a
view of the file until ``from_jax_params`` copies it.

Everything is validated at the end against the tree of the model's own
module — ``to_jax_params`` of its state_dict, built on the ``meta`` device
so that nothing is allocated (the reference asks ``jax.eval_shape``): tree
structure and every leaf shape must match, so a config/artifact mismatch
(wrong unet_ch, the synthetic vocabulary vs the 49,408-token CLIP BPE)
fails at import time with guidance instead of at the first forward.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from tpuserve_torch.utils.trees import flatten_with_paths


def _conv(f: dict, src: str) -> dict:
    return {"kernel": f[f"{src}.weight"].transpose(2, 3, 1, 0),
            "bias": f[f"{src}.bias"]}


def _lin(f: dict, src: str) -> dict:
    return {"kernel": f[f"{src}.weight"].T, "bias": f[f"{src}.bias"]}


def _norm(f: dict, src: str) -> dict:
    return {"scale": f[f"{src}.weight"], "bias": f[f"{src}.bias"]}


def _mha_from_linears(f: dict, heads: int, q: str, k: str, v: str, o: str,
                      qkv_bias: bool) -> dict:
    """Four torch linears -> one flax MultiHeadDotProductAttention subtree."""
    wq, wk, wv, wo = (f[f"{n}.weight"] for n in (q, k, v, o))
    d_inner = wq.shape[0]
    head_dim = d_inner // heads

    def in_proj(w, name):
        b = (f[f"{name}.bias"] if qkv_bias
             else np.zeros((d_inner,), w.dtype))
        return {"kernel": w.T.reshape(w.shape[1], heads, head_dim),
                "bias": b.reshape(heads, head_dim)}

    return {
        "query": in_proj(wq, q),
        "key": in_proj(wk, k),
        "value": in_proj(wv, v),
        "out": {"kernel": wo.T.reshape(heads, head_dim, wo.shape[0]),
                "bias": f[f"{o}.bias"]},
    }


def _geglu_up(f: dict, src: str) -> dict:
    """LDM GEGLU proj (x-half first, gate-half second) -> the tree's ff_up
    (gate-half first, val-half second)."""
    w = f[f"{src}.weight"]  # (2*inner, d)
    b = f[f"{src}.bias"]
    inner = w.shape[0] // 2
    return {"kernel": np.concatenate([w[inner:], w[:inner]], axis=0).T,
            "bias": np.concatenate([b[inner:], b[:inner]], axis=0)}


# -- tower mappers ------------------------------------------------------------

def map_clip_text(f: dict, prefix: str, layers: int, heads: int) -> dict:
    """transformers CLIPTextModel naming (the layout inside LDM checkpoints
    under ``cond_stage_model.transformer.``) -> the CLIP encoder's tree."""
    p: dict = {
        "token_embed": {
            "embedding": f[f"{prefix}embeddings.token_embedding.weight"]},
        "pos_embed": f[f"{prefix}embeddings.position_embedding.weight"],
        "ln_final": _norm(f, f"{prefix}final_layer_norm"),
    }
    for i in range(layers):
        lp = f"{prefix}encoder.layers.{i}."
        p[f"layer{i}"] = {
            "ln1": _norm(f, f"{lp}layer_norm1"),
            "attn": _mha_from_linears(
                f, heads, f"{lp}self_attn.q_proj", f"{lp}self_attn.k_proj",
                f"{lp}self_attn.v_proj", f"{lp}self_attn.out_proj",
                qkv_bias=True),
            "ln2": _norm(f, f"{lp}layer_norm2"),
            "mlp_up": _lin(f, f"{lp}mlp.fc1"),
            "mlp_down": _lin(f, f"{lp}mlp.fc2"),
        }
    return p


def _map_unet_resblock(f: dict, src: str, has_skip: bool) -> dict:
    p = {
        "norm1": _norm(f, f"{src}.in_layers.0"),
        "conv1": _conv(f, f"{src}.in_layers.2"),
        "temb_proj": _lin(f, f"{src}.emb_layers.1"),
        "norm2": _norm(f, f"{src}.out_layers.0"),
        "conv2": _conv(f, f"{src}.out_layers.3"),
    }
    if has_skip:
        p["skip"] = _conv(f, f"{src}.skip_connection")
    return p


def _map_spatial_transformer(f: dict, src: str, heads: int) -> dict:
    tb = f"{src}.transformer_blocks.0"
    return {
        "norm": _norm(f, f"{src}.norm"),
        "proj_in": _conv(f, f"{src}.proj_in"),
        "block": {
            "ln1": _norm(f, f"{tb}.norm1"),
            "self_attn": _mha_from_linears(
                f, heads, f"{tb}.attn1.to_q", f"{tb}.attn1.to_k",
                f"{tb}.attn1.to_v", f"{tb}.attn1.to_out.0", qkv_bias=False),
            "ln2": _norm(f, f"{tb}.norm2"),
            "cross_attn": _mha_from_linears(
                f, heads, f"{tb}.attn2.to_q", f"{tb}.attn2.to_k",
                f"{tb}.attn2.to_v", f"{tb}.attn2.to_out.0", qkv_bias=False),
            "ln3": _norm(f, f"{tb}.norm3"),
            "ff_up": _geglu_up(f, f"{tb}.ff.net.0.proj"),
            "ff_down": _lin(f, f"{tb}.ff.net.2"),
        },
        "proj_out": _conv(f, f"{src}.proj_out"),
    }


def map_unet(f: dict, prefix: str, model_ch: int, mults, num_res: int,
             attn_levels, heads: int) -> dict:
    """LDM ``model.diffusion_model.*`` -> the UNet's tree. The traversal
    mirrors the UNet's loop structure exactly, so the input_blocks /
    output_blocks numbering is derived, not hard-coded."""
    p: dict = {
        "time1": _lin(f, f"{prefix}time_embed.0"),
        "time2": _lin(f, f"{prefix}time_embed.2"),
        "conv_in": _conv(f, f"{prefix}input_blocks.0.0"),
        "norm_out": _norm(f, f"{prefix}out.0"),
        "conv_out": _conv(f, f"{prefix}out.2"),
    }
    # Down path: channel bookkeeping decides which ResBlocks carry a skip
    # projection (present iff in_ch != out_ch).
    k = 1
    ch = model_ch
    for i, m in enumerate(mults):
        out_ch = model_ch * m
        for j in range(num_res):
            p[f"down{i}_res{j}"] = _map_unet_resblock(
                f, f"{prefix}input_blocks.{k}.0", has_skip=ch != out_ch)
            ch = out_ch
            if i in attn_levels:
                p[f"down{i}_attn{j}"] = _map_spatial_transformer(
                    f, f"{prefix}input_blocks.{k}.1", heads)
            k += 1
        if i != len(mults) - 1:
            p[f"down{i}_ds"] = _conv(f, f"{prefix}input_blocks.{k}.0.op")
            k += 1
    # Middle.
    p["mid_res1"] = _map_unet_resblock(f, f"{prefix}middle_block.0", False)
    p["mid_attn"] = _map_spatial_transformer(f, f"{prefix}middle_block.1", heads)
    p["mid_res2"] = _map_unet_resblock(f, f"{prefix}middle_block.2", False)
    # Up path: every ResBlock consumes a skip concat, so in_ch != out_ch
    # always and the skip projection is always present.
    k = 0
    for i, m in reversed(list(enumerate(mults))):
        for j in range(num_res + 1):
            p[f"up{i}_res{j}"] = _map_unet_resblock(
                f, f"{prefix}output_blocks.{k}.0", has_skip=True)
            idx = 1
            if i in attn_levels:
                p[f"up{i}_attn{j}"] = _map_spatial_transformer(
                    f, f"{prefix}output_blocks.{k}.1", heads)
                idx = 2
            if i != 0 and j == num_res:
                p[f"up{i}_us"] = _conv(f, f"{prefix}output_blocks.{k}.{idx}.conv")
            k += 1
    return p


def _map_vae_resblock(f: dict, src: str, has_skip: bool) -> dict:
    p = {
        "norm1": _norm(f, f"{src}.norm1"),
        "conv1": _conv(f, f"{src}.conv1"),
        "norm2": _norm(f, f"{src}.norm2"),
        "conv2": _conv(f, f"{src}.conv2"),
    }
    if has_skip:
        p["skip"] = _conv(f, f"{src}.nin_shortcut")
    return p


def _vae_attn_dense(f: dict, src: str) -> dict:
    """1x1 conv (C, C, 1, 1) -> Dense kernel (C, C)."""
    w = f[f"{src}.weight"]
    return {"kernel": w.reshape(w.shape[0], w.shape[1]).T,
            "bias": f[f"{src}.bias"]}


def map_vae_decoder(f: dict, prefix: str, ch: int, mults) -> dict:
    """LDM ``first_stage_model.{post_quant_conv,decoder.*}`` -> the VAE
    decoder's tree. LDM indexes ``decoder.up.{i}`` by resolution level
    (up.3 runs first), matching the tree's ``up{i}_*`` naming directly."""
    d = f"{prefix}decoder."
    top = ch * mults[-1]
    p: dict = {
        "post_quant": _conv(f, f"{prefix}post_quant_conv"),
        "conv_in": _conv(f, f"{d}conv_in"),
        "mid_res1": _map_vae_resblock(f, f"{d}mid.block_1", False),
        "mid_attn": {
            "norm": _norm(f, f"{d}mid.attn_1.norm"),
            "q": _vae_attn_dense(f, f"{d}mid.attn_1.q"),
            "k": _vae_attn_dense(f, f"{d}mid.attn_1.k"),
            "v": _vae_attn_dense(f, f"{d}mid.attn_1.v"),
            "proj": _vae_attn_dense(f, f"{d}mid.attn_1.proj_out"),
        },
        "mid_res2": _map_vae_resblock(f, f"{d}mid.block_2", False),
        "norm_out": _norm(f, f"{d}norm_out"),
        "conv_out": _conv(f, f"{d}conv_out"),
    }
    in_ch = top
    for i, m in reversed(list(enumerate(mults))):
        out_ch = ch * m
        for j in range(3):
            p[f"up{i}_res{j}"] = _map_vae_resblock(
                f, f"{d}up.{i}.block.{j}", has_skip=in_ch != out_ch)
            in_ch = out_ch
        if i != 0:
            p[f"up{i}_us"] = _conv(f, f"{d}up.{i}.upsample.conv")
    return p


# -- entry point --------------------------------------------------------------

LDM_PREFIXES = ("cond_stage_model.transformer.",
                "model.diffusion_model.",
                "first_stage_model.")


def import_ldm_checkpoint(model, flat: dict[str, np.ndarray]) -> Any:
    """Single-file LDM/CompVis SD checkpoint -> the ``SD15Serving`` tree."""
    missing = [p for p in LDM_PREFIXES
               if not any(k.startswith(p) for k in flat)]
    if missing:
        raise ValueError(
            "torch checkpoint is not a single-file SD/LDM artifact (no keys "
            f"under {missing}); SD 1.5 import expects the published "
            "v1-5-pruned*.safetensors / .ckpt layout")

    try:
        params = {
            "text": {"params": map_clip_text(
                flat, "cond_stage_model.transformer.text_model.",
                layers=model.text_layers, heads=model.text_heads)},
            "unet": {"params": map_unet(
                flat, "model.diffusion_model.",
                model_ch=model.unet_ch, mults=tuple(model.unet_mults),
                num_res=model.unet_res, attn_levels=tuple(model.unet_attn_levels),
                heads=model.unet_heads)},
            "vae": {"params": map_vae_decoder(
                flat, "first_stage_model.", ch=model.vae_ch,
                mults=tuple(model.vae_mults))},
        }
    except KeyError as e:
        raise ValueError(
            f"SD checkpoint is missing expected tensor {e}; the model's "
            "unet_ch/unet_mults/text_layers options must describe the same "
            "architecture as the artifact (defaults = SD 1.5)") from e

    got = list(flatten_with_paths(params))
    want = list(flatten_with_paths(model.reference_tree_meta()))
    if [p for p, _ in got] != [p for p, _ in want]:
        raise ValueError(
            "imported SD tree structure does not match the module "
            "(config options must describe the artifact's architecture)")
    for (name, g), (_, w) in zip(got, want):
        if tuple(g.shape) != tuple(w.shape):
            hint = ""
            if "token_embed" in name:
                hint = (" — vocabulary mismatch: real SD weights need the "
                        "real CLIP BPE tokenizer (options bpe_vocab + "
                        "bpe_merges), not the synthetic vocab")
            raise ValueError(
                f"imported SD leaf {name} has shape {tuple(g.shape)}, module "
                f"expects {tuple(w.shape)}{hint}")
    return params
