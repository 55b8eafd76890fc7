"""Device meshes, ported from ``tpuserve/parallel/mesh.py``.

Axis conventions, as in the JAX package:

- ``"data"``  — data parallel: batches split across it, params replicated.
- ``"model"`` — tensor parallel: weight matrices split across it.
- ``"seq"``   — sequence parallel (ring and Ulysses attention) for long inputs.

A ``Mesh`` is a (data, model, seq) grid of ``torch.device``s; axes of size 1
are still present, so a spec that names them stays valid in every
configuration. The port's sequence-parallel ops run single-controller: one
process walks the ranks of the ``seq`` axis and places each rank's block on
that rank's device. The ranks of an axis may share one device: that is how
the CPU tests stand in for the JAX tests' 8 fake host devices
(``devices=["cpu"] * 4``) and how ``chip_smoke.py`` runs a 4-rank ring on one
card. Serving in ``parallelism = "single"`` binds a 1-device mesh.

Not ported yet (ROADMAP.md queue 1: mesh modes): a data or model axis larger
than 1, the host-major multi-host grid, and the sharding helpers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)


@dataclass(frozen=True)
class MeshPlan:
    """How to carve the device list into named axes."""

    dp: int = -1  # -1 = "everything not claimed by other axes"
    tp: int = 1
    sp: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        tp, sp = self.tp, self.sp
        if n_devices % (tp * sp) != 0:
            raise ValueError(f"{n_devices} devices not divisible by tp*sp={tp * sp}")
        dp = self.dp if self.dp != -1 else n_devices // (tp * sp)
        if dp * tp * sp != n_devices:
            raise ValueError(f"dp*tp*sp={dp * tp * sp} != device count {n_devices}")
        return dp, tp, sp


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model, seq) grid of devices; ``shape`` maps each axis name to
    its size, as ``jax.sharding.Mesh.shape`` does."""

    devices: np.ndarray  # (dp, tp, sp) object array of torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The device of each rank along ``axis`` (the other axes at rank 0)."""
        index = [0] * len(AXES)
        index[AXES.index(axis)] = slice(None)
        return list(self.devices[tuple(index)])


def make_mesh(plan: MeshPlan | None = None, devices: list | None = None) -> Mesh:
    """Build a Mesh with axes (data, model, seq) over ``devices`` (torch
    devices or their names; one entry per rank, and entries may repeat).
    ``devices=None`` takes every visible CUDA device and raises without
    CUDA — the port never falls back to the CPU on its own."""
    plan = plan or MeshPlan()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass devices= "
                               "(e.g. ['cpu']) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    dp, tp, sp = plan.resolve(len(devices))
    if dp > 1 or tp > 1:
        raise NotImplementedError(
            f"a mesh with data axis {dp} and model axis {tp} is not yet ported to "
            "tpuserve_torch (ROADMAP.md queue 1: mesh modes); only the seq axis "
            "may be larger than 1")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, tp, sp))
