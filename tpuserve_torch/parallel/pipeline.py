"""Pipeline parallelism over a ("stage",) mesh, ported from
``tpuserve/parallel/pipeline.py``.

For a layer stack too deep for one device, the stack splits into S equal
stages, one per rank of a ``"stage"`` axis, and microbatches stream
through them GPipe-style:

- stage parameters are a stacked tree — every leaf gains a leading
  ``(S, ...)`` dim, and each rank holds only its own stage's slice;
- the schedule runs ``n_micro + S - 1`` ticks: each tick every stage hands
  what it computed last tick to the next stage and runs the stage function
  on what arrived, stage 0 feeding microbatch t; microbatch j leaves the
  last stage at tick j + S - 1, and the pipeline bubble is the usual
  ``(S - 1) / (n_micro + S - 1)``.

The port is single-controller: one process walks the ticks and the stages,
the hand-off between stages is a copy onto the next stage's device, and a
stage that is idle in a tick (the pipeline filling or draining) computes
nothing, where the reference's SPMD program computes on zeros and masks the
result; the outputs are the same. ``stage_fn`` must keep its input's shape
and dtype (the homogeneous-transformer case).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from tpuserve_torch.parallel import mesh as meshlib
from tpuserve_torch.parallel.mesh import Mesh

STAGE_AXIS = "stage"


def make_stage_mesh(n_stages: int, devices: list | None = None) -> Mesh:
    """A 1-D ("stage",) mesh over the first n_stages devices."""
    devices = meshlib.visible_devices() if devices is None else devices
    if len(devices) < n_stages:
        raise ValueError(f"need {n_stages} devices, have {len(devices)}")
    grid = np.empty(n_stages, dtype=object)
    grid[:] = [torch.device(d) for d in devices[:n_stages]]
    return Mesh(grid, (STAGE_AXIS,))


def _tree_map(fn: Callable, *trees: Any) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    return [tree]


def stack_stage_params(per_stage: list[Any]) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with leading (S, ...)
    leaves (all stages share one tree structure)."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack(xs)

    return _tree_map(stack, *per_stage)


def pipeline_forward(stage_fn: Callable, stacked_params: Any, xs: Any,
                     mesh: Mesh, axis_name: str = STAGE_AXIS) -> Any:
    """Pipelined application of S stacked stages to microbatched input.

    ``stage_fn(stage_params, x) -> y`` with ``y`` shaped as ``x``;
    ``stacked_params`` has leading dim S on every leaf (each rank reads its
    own slice, moved to its device); ``xs`` is ``(n_micro, microbatch,
    ...)`` (a tensor, or a sequence of microbatches). Returns the
    ``(n_micro, microbatch, ...)`` outputs on the first stage's device."""
    n_stages = mesh.shape[axis_name]
    for leaf in _leaves(stacked_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"stacked params have {leaf.shape[0]} stages but the "
                f"{axis_name!r} axis has {n_stages} devices")
    devices = mesh.axis_devices(axis_name)
    stages = [_tree_map(lambda x, s=s: torch.as_tensor(x[s]).to(devices[s]),
                        stacked_params) for s in range(n_stages)]
    outs = run_schedule([lambda x, s=s: stage_fn(stages[s], x) for s in range(n_stages)],
                        list(xs), devices)
    if isinstance(xs, torch.Tensor):
        return torch.stack([o.to(devices[0]) for o in outs])
    return outs


def run_schedule(stage_fns: list[Callable], micro: list[Any],
                 devices: list[torch.device]) -> list[Any]:
    """The GPipe schedule over S stage callables: ``n_micro + S - 1`` ticks;
    in tick t stage s runs microbatch t - s when that is one (idle
    otherwise), on what stage s - 1 handed over in tick t - 1 (stage 0 reads
    microbatch t). A microbatch is a tensor or a tuple of tensors; each
    hand-off copies it onto the next stage's device. Returns the last
    stage's outputs in microbatch order."""
    n_stages, n_micro = len(stage_fns), len(micro)
    carry: list[Any] = [None] * n_stages  # what each stage made last tick
    outs: list[Any] = [None] * n_micro

    def to(x, dev):
        return tuple(t.to(dev) for t in x) if isinstance(x, tuple) else x.to(dev)

    for t in range(n_micro + n_stages - 1):
        # Descending stage order: stage s reads stage s - 1's previous tick.
        for s in reversed(range(n_stages)):
            j = t - s
            if not 0 <= j < n_micro:
                carry[s] = None
                continue
            x = micro[j] if s == 0 else carry[s - 1]
            y = stage_fns[s](to(x, devices[s]))
            carry[s] = y
            if s == n_stages - 1:
                outs[j] = y
    return outs
