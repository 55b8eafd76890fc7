"""Ulysses sequence parallelism: all-to-all head resharding, ported from
``tpuserve/ops/ulysses.py``.

Ring attention's twin (``tpuserve_torch.ops.ring_attention``). Where the ring
keeps queries resident and rotates K/V blocks in ``n`` steps, Ulysses pays
one exchange each way: an all-to-all reshards activations from
sequence-split/heads-whole to heads-split/sequence-complete, every rank then
runs ordinary attention for its head slice over the FULL sequence (dense, or
kernel K1), and the inverse all-to-all restores the sequence split.

The port runs it single-controller, as the ring: rank r's head slice of
every rank's sequence block moves to rank r's device
(``.to(device, non_blocking=True)``, a no-op when the ranks share a device),
the per-key bias is gathered whole onto every rank, and the inverse deal
sends each rank's output rows back to the rank that owns them.

A spec that names a data or model axis splits the rows and heads first, as
the ring does (``ring_attention.rank_blocks``): each (data, model) rank
runs the exchange over its own seq ranks.

Constraint: attention heads (after any tensor-parallel split of the heads
dim) must divide by the seq-axis size, because the all-to-all deals heads
out across it.
"""

from __future__ import annotations

import torch

from tpuserve_torch.ops.flash_attention import flash_attention
from tpuserve_torch.ops.ring_attention import (_check_spec, _spec_axis_size, _split,
                                               auto_local_impl, dense_attention, per_rank,
                                               rank_blocks)
from tpuserve_torch.parallel.mesh import Mesh


def _ulysses(q_blks: list, k_blks: list, v_blks: list, bias_blks: list,
             devices: list[torch.device], local_impl: str) -> list[torch.Tensor]:
    """Per rank: reshard seq -> heads, attend the full sequence, reshard back."""
    n = len(devices)

    def a2a(blks: list, split_dim: int, cat_dim: int) -> list[torch.Tensor]:
        # Rank r receives chunk r of every rank's block along split_dim,
        # concatenated in rank order along cat_dim (tiled all_to_all).
        return [torch.cat([b.narrow(split_dim, r * (b.shape[split_dim] // n),
                                    b.shape[split_dim] // n).to(dev, non_blocking=True)
                           for b in blks], dim=cat_dim)
                for r, dev in enumerate(devices)]

    # (B, S/n, H, D) -> (B, S, H/n, D): split the heads dim across the axis,
    # concatenate the sequence back together.
    qh, kh, vh = (a2a(blks, 2, 1) for blks in (q_blks, k_blks, v_blks))
    # The per-key bias needs the full sequence on every rank (all-gather).
    bias = [torch.cat([b.to(dev, non_blocking=True) for b in bias_blks], dim=1)
            for dev in devices]
    outs = []
    for r in range(n):
        if local_impl == "flash":
            out = flash_attention(qh[r], kh[r], vh[r], bias[r].float())
        else:
            out = dense_attention(qh[r], kh[r], vh[r], bias[r][:, None, None, :].float())
        # Cast back first: the f32 bias promoted the dense scores, but the
        # op's contract (shared with ring_attention) is out.dtype == q.dtype.
        outs.append(out.to(q_blks[r].dtype))
    # (B, S, H/n, D) -> (B, S/n, H, D): the inverse deal.
    return a2a(outs, 1, 2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, axis_name: str = "seq",
                      key_padding: torch.Tensor | None = None,
                      spec: tuple | None = None,
                      local_impl: str = "auto") -> torch.Tensor:
    """Sequence-parallel attention via head all-to-all; ring_attention's twin.

    Args:
      q, k, v: (batch, seq, heads, head_dim); seq splits over ``axis_name``.
      mesh: device mesh holding ``axis_name``.
      key_padding: optional (batch, seq) additive per-key bias (0 = attend,
        -1e9 = masked), split like K's seq dim.
      spec: optional tuple of axis names for q/k/v's dims (position 1 must
        be ``axis_name``), e.g. ``("data", "seq", "model", None)``: each
        (data, model) rank takes its rows and heads.
      local_impl: "dense", "flash" (kernel K1) or "auto"
        (``auto_local_impl`` on the full sequence and the rank's heads).

    Returns (batch, seq, heads, head_dim) in q's dtype, on q's device.
    """
    if key_padding is None:
        key_padding = torch.zeros(k.shape[:2], dtype=torch.float32, device=k.device)
    qkv_spec = _check_spec(spec, axis_name)
    n = int(mesh.shape[axis_name])
    h = q.shape[2] // _spec_axis_size(mesh, qkv_spec[2])
    if h % n:
        raise ValueError(
            f"ulysses needs local heads ({h}) divisible by the {axis_name!r} "
            f"axis size ({n}); use ring_attention for this shape")
    if local_impl == "auto":
        # Memory-derived, shared with ring_attention: Ulysses' local
        # attention sees the FULL sequence with h/n heads per rank.
        b_loc = q.shape[0] // _spec_axis_size(mesh, qkv_spec[0])
        local_impl = auto_local_impl(b_loc, h // n, q.shape[1], q.shape[-1])
    elif local_impl not in ("dense", "flash"):
        raise ValueError(f"unknown local_impl {local_impl!r}")

    def run(q, k, v, key_padding, devices):  # noqa: ANN001, ANN202
        outs = _ulysses(_split(q, devices), _split(k, devices), _split(v, devices),
                        _split(key_padding, devices), devices, local_impl)
        return torch.cat([o.to(q.device, non_blocking=True) for o in outs], dim=1)

    return per_rank(q, k, v, key_padding,
                    rank_blocks(mesh, qkv_spec, axis_name, q.shape[0], q.shape[2]), run)
