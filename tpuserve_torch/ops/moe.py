"""Switch-style mixture-of-experts FFN, ported from ``tpuserve/ops/moe.py``
(Fedus et al. 2021, "Switch Transformers": top-1 routing).

The reference's static-shape formulation, kept as it is:

- **Everything static.** Top-1 routing with a fixed per-expert capacity:
  dispatch and combine are dense one-hot tensors, the expert compute is
  batched products — no gather, no scatter, no data-dependent sizes, so a
  forward that holds it captures as one CUDA graph. Tokens past an
  expert's capacity are dropped (they contribute zero; the caller's
  residual connection passes them through).
- **Group-wise routing.** Each group (a batch row) routes independently
  with capacity ``C = ceil(S / E * capacity_factor)``, S the group's padded
  length, so the (group, S, E, C) routing tensors stay linear in tokens.
- **Padding-aware.** Masked tokens never claim expert capacity and do not
  drive the load-balancing aux loss.

Routing runs in float32 (the softmax, argmax and gate); ``dispatch`` and
``combine`` are cast to the compute dtype before the products, so
``combine`` carries the compute-dtype-rounded gate, as in the reference.
Expert parallelism over several cards (the reference shards the expert dim
over its mesh's "model" axis) is not ported: on one card every expert is
local.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def switch_route(logits: torch.Tensor, capacity: int,
                 token_mask: torch.Tensor | None = None):
    """Top-1 routing of groups of tokens -> static dispatch and combine.

    ``logits`` (..., T, E): each leading index is one group of T tokens.
    ``token_mask`` (..., T): 0-tokens (padding) never claim capacity and
    are excluded from the aux statistics. Returns ``(dispatch, combine,
    aux)``: ``dispatch`` (..., T, E, C) is the 0/1 routing of token t to
    (expert e, queue slot c), first come first served along T; ``combine``
    also carries the gate probability; ``aux`` (...) is the load-balancing
    loss (fraction routed x gate mass per expert, scaled by E — Switch
    eq. 4). Float32 throughout."""
    n_experts = logits.shape[-1]
    lg = logits.float()
    # jax.nn.softmax's formulation: exp(x - max) / sum.
    ex = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    gates = ex / ex.sum(dim=-1, keepdim=True)                    # (..., T, E)
    expert = torch.argmax(gates, dim=-1)                          # first max
    gate = gates.amax(dim=-1)                                     # (..., T)
    experts = torch.arange(n_experts, device=logits.device)
    onehot = (expert[..., None] == experts).to(gates.dtype)
    if token_mask is None:
        token_mask = torch.ones(logits.shape[:-1], dtype=gates.dtype,
                                device=logits.device)
    token_mask = token_mask.to(gates.dtype)
    onehot = onehot * token_mask[..., None]
    # Position of each token in its expert's queue, -1 where unrouted.
    pos = torch.cumsum(onehot, dim=-2) * onehot - 1.0
    pos = pos.amax(dim=-1).to(torch.int32)                        # (..., T)
    keep = (pos >= 0) & (pos < capacity)
    slots = torch.arange(capacity, device=logits.device)
    slot_hot = (pos.clamp(0, capacity - 1)[..., None] == slots).to(gates.dtype)
    dispatch = (onehot * keep[..., None])[..., None] * slot_hot[..., None, :]
    combine = dispatch * gate[..., None, None]
    # Load-balance aux over REAL tokens only.
    n_real = token_mask.sum(dim=-1).clamp_min(1.0)[..., None]
    frac_routed = onehot.sum(dim=-2) / n_real
    gate_mass = (gates * token_mask[..., None]).sum(dim=-2) / n_real
    aux = n_experts * torch.sum(frac_routed * gate_mass, dim=-1)
    return dispatch, combine, aux


class SwitchFFN(nn.Module):
    """Drop-in MoE replacement for a transformer FFN block (the reference's
    flax ``SwitchFFN``): ``router`` (d, E), ``w_up`` (E, d, f), ``w_down``
    (E, f, d), the reference's leaf layouts. The GELU is the tanh
    approximation (flax's ``nn.gelu`` default)."""

    def __init__(self, d_model: int, experts: int, d_ff: int,
                 capacity_factor: float = 1.25) -> None:
        super().__init__()
        self.experts = experts
        self.capacity_factor = capacity_factor
        self.router = nn.Parameter(torch.zeros(d_model, experts))
        self.w_up = nn.Parameter(torch.zeros(experts, d_model, d_ff))
        self.w_down = nn.Parameter(torch.zeros(experts, d_ff, d_model))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        """``x`` (B, S, d) in the compute dtype, ``mask`` (B, S) 1 for real
        tokens -> ``(y, aux)``: y (B, S, d) in x's dtype and the
        token-weighted load-balance aux (a float32 scalar)."""
        b, s, d = x.shape
        dt = x.dtype
        # Per-group (batch-row) routing keeps the routing tensors linear in
        # tokens; capacity from the bucket's padded length.
        capacity = int(math.ceil(s / self.experts * self.capacity_factor))
        logits = torch.einsum("gsd,de->gse", x.float(), self.router.float())
        if mask is None:
            mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
        dispatch, combine, aux = switch_route(logits, capacity, mask)
        dispatch = dispatch.to(dt)   # (g, s, E, C)
        combine = combine.to(dt)
        xe = torch.einsum("gsec,gsd->gecd", dispatch, x)
        h = F.gelu(torch.einsum("gecd,edf->gecf", xe, self.w_up.to(dt)),
                   approximate="tanh")
        ye = torch.einsum("gecf,efd->gecd", h, self.w_down.to(dt))
        y = torch.einsum("gsec,gecd->gsd", combine, ye)
        # Token-weighted aux: mostly padded rows must not dilute it.
        n_real = mask.float().sum(dim=1)
        aux = torch.sum(aux * n_real) / torch.clamp_min(torch.sum(n_real), 1.0)
        return y.to(dt), aux
