"""Ring attention: sequence-parallel attention over a mesh axis, ported from
``tpuserve/ops/ring_attention.py``.

The sequence dim is split over the mesh's ``"seq"`` axis: each rank holds
one block of Q/K/V. K/V blocks then rotate around the ring, and every rank
folds each visiting block into its queries' result with an online softmax
(running max ``m``, normalizer ``l``, weighted accumulator ``acc`` — the
recurrence flash attention runs inside one kernel). After ``n`` steps every
query has attended to the full sequence while no rank ever materialized more
than a (q_local, k_local) score tile.

The reference runs the schedule in ``shard_map`` with ``ppermute``; the port
runs the same schedule single-controller. It cuts the sequence into ``n``
rank blocks, each on its rank's device (``Mesh.axis_devices``). In each of
``n`` steps every rank folds its visiting K/V/bias block into its state, and
the visiting blocks move one rank along ``perm = (i -> i+1)`` with
``.to(device, non_blocking=True)`` — a no-op when the ranks share a device,
as they do on one card and in the CPU tests. Placing the ranks on several
GPUs over NCCL is ROADMAP.md queue 1, item 10.

Layouts: (batch, seq, heads, head_dim) throughout, seq split and heads
whole. Bidirectional (encoder) attention; an additive per-key bias (e.g. a
padding mask) is split like K.
"""

from __future__ import annotations

import torch

from tpuserve_torch.ops.flash_attention import flash_attention
from tpuserve_torch.parallel.mesh import Mesh

# Dense-vs-flash local-math threshold: the per-rank f32 score tile (x2 for
# the softmax temporary). The 2 GiB figure is the reference's, chosen on a
# 16 GiB TPU v5e where dense measured faster whenever it fit; it is kept so
# that the same shapes pick the same local math in both packages.
DENSE_SCORE_BYTES_MAX = 2 << 30


def auto_local_impl(b_loc: int, h_loc: int, s_loc: int, d: int) -> str:
    """Memory-derived per-rank attention impl choice: "flash" (kernel K2 or
    K1) once the dense score tile would pass DENSE_SCORE_BYTES_MAX and the
    shape suits the kernel (head_dim % 64 == 0, s_loc % 8 == 0), else
    "dense"."""
    kernel_ok = d % 64 == 0 and s_loc % 8 == 0
    dense_score_bytes = 2 * 4 * b_loc * h_loc * s_loc * s_loc
    return ("flash" if kernel_ok and dense_score_bytes > DENSE_SCORE_BYTES_MAX
            else "dense")


def _spec_axis_size(mesh: Mesh, entry) -> int:
    """Product of the mesh-axis sizes a spec entry splits over."""
    if entry is None:
        return 1
    axes = entry if isinstance(entry, (tuple, list)) else [entry]
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])
    return n


def _check_spec(spec: tuple | None, axis_name: str) -> tuple:
    """A spec is a plain tuple of axis names per dim (the reference's
    ``PartitionSpec``); the seq dim must be split on ``axis_name``."""
    qkv_spec = tuple(spec) if spec is not None else (None, axis_name, None, None)
    if len(qkv_spec) != 4 or qkv_spec[1] != axis_name:
        raise ValueError(f"spec {qkv_spec} must put {axis_name!r} on the seq dim")
    return qkv_spec


def _split(x: torch.Tensor, devices: list[torch.device]) -> list[torch.Tensor]:
    """Rank i's block of x's seq dim (dim 1), on rank i's device."""
    n = len(devices)
    if x.shape[1] % n:
        raise ValueError(f"seq length {x.shape[1]} does not split over {n} ranks")
    return [blk.to(dev, non_blocking=True)
            for blk, dev in zip(x.split(x.shape[1] // n, dim=1), devices)]


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain single-device attention, (B, S, H, D) layout; ``bias`` is
    additive on the scores, shaped (B, 1|H, Sq, Sk). Scores are computed in
    the input dtype and promote with the bias, as in the reference."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    dt = torch.promote_types(p.dtype, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(dt), v.to(dt))


def _fold(state: tuple, q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
          bias_blk: torch.Tensor, local_impl: str) -> tuple:
    """Fold one visiting K/V/bias block into a rank's (m, l, acc) state,
    step for step as the reference's ``_ring_body.step``."""
    m, l, acc = state                                   # (B,H,Sq) x2, (B,Sq,H,D)
    if local_impl == "flash":
        # K2 returns the unnormalized f32 accumulator and (m, l): the merge
        # folds raw triples in f32, so a fully masked visiting block is a
        # zero contribution (not 0/0) and partial results never round to
        # the input dtype.
        acc_blk, m_blk, l_blk = flash_attention(q, k_blk, v_blk, bias_blk,
                                                return_stats=True)
        m_blk = m_blk.transpose(1, 2)                   # (B, H, Sq)
        l_blk = l_blk.transpose(1, 2)
        m_new = torch.maximum(m, m_blk)
        a_prev = torch.exp(m - m_new)
        a_blk = torch.exp(m_blk - m_new)
        l = l * a_prev + l_blk * a_blk
        acc = (acc * a_prev.transpose(1, 2)[..., None]
               + acc_blk * a_blk.transpose(1, 2)[..., None])
    else:
        # Scores in the input dtype, then f32 (the reference's rounding).
        s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * q.shape[-1] ** -0.5
        s = s + bias_blk[:, None, None, :]             # (B, Sk) per-key bias
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)                    # rescale of the state
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, v_blk.float())
    return m_new, l, acc


def _ring(q_blks: list, k_blks: list, v_blks: list, bias_blks: list,
          devices: list[torch.device], local_impl: str) -> list[torch.Tensor]:
    """Every rank's output block: local Q stays, K/V (+ per-key bias) rotate."""
    n = len(devices)
    states = []
    for q in q_blks:
        b, sq, h, d = q.shape
        f32 = dict(dtype=torch.float32, device=q.device)
        states.append((torch.full((b, h, sq), -torch.inf, **f32),
                       torch.zeros((b, h, sq), **f32),
                       torch.zeros((b, sq, h, d), **f32)))
    visiting = list(zip(k_blks, v_blks, bias_blks))
    for step in range(n):
        # Issue the rotation (perm i -> i+1) first, as the reference does,
        # so a copy between devices overlaps the blocks' math.
        arriving = None
        if step < n - 1:
            arriving = [tuple(t.to(devices[i], non_blocking=True)
                              for t in visiting[(i - 1) % n]) for i in range(n)]
        states = [_fold(states[i], q_blks[i], *visiting[i], local_impl)
                  for i in range(n)]
        visiting = arriving
    return [(acc / l.transpose(1, 2)[..., None]).to(q.dtype)
            for (_, l, acc), q in zip(states, q_blks)]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis_name: str = "seq",
                   key_padding: torch.Tensor | None = None,
                   spec: tuple | None = None,
                   local_impl: str = "auto") -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``axis_name``.

    Args:
      q, k, v: (batch, seq, heads, head_dim); seq splits over ``axis_name``.
      mesh: the device mesh holding ``axis_name``.
      key_padding: optional (batch, seq) additive bias per key position
        (0 = attend, -inf/-1e9 = masked), split like K's seq dim.
      spec: optional tuple of axis names for q/k/v's dims, e.g.
        ``("data", "seq", "model", None)`` (position 1 must be
        ``axis_name``); it sizes the per-rank batch and heads that
        ``local_impl="auto"`` decides on. Default splits only the seq dim.
      local_impl: per-rank block math — "dense" (einsum, materializes the
        local score tile), "flash" (kernel K2 with a merge in f32), or
        "auto" (``auto_local_impl`` on the per-rank shape).

    Returns (batch, seq, heads, head_dim) in q's dtype, on q's device.
    """
    if key_padding is None:
        key_padding = torch.zeros(k.shape[:2], dtype=torch.float32, device=k.device)
    qkv_spec = _check_spec(spec, axis_name)
    n = int(mesh.shape[axis_name])
    if local_impl == "auto":
        # The decision models the PER-RANK tile: batch and heads divided by
        # the axes the spec splits them over.
        b, _, h, d = q.shape
        b_loc = b // _spec_axis_size(mesh, qkv_spec[0])
        h_loc = h // _spec_axis_size(mesh, qkv_spec[2])
        local_impl = auto_local_impl(b_loc, h_loc, q.shape[1] // n, d)
    elif local_impl not in ("dense", "flash"):
        raise ValueError(f"unknown local_impl {local_impl!r}")
    devices = mesh.axis_devices(axis_name)
    outs = _ring(_split(q, devices), _split(k, devices), _split(v, devices),
                 _split(key_padding, devices), devices, local_impl)
    return torch.cat([o.to(q.device, non_blocking=True) for o in outs], dim=1)
