"""Device meshes, ported from ``tpuserve/parallel/mesh.py``.

Axis conventions, as in the JAX package:

- ``"data"``  — data parallel: batches split across it, params replicated.
- ``"model"`` — tensor parallel: weight matrices split across it.
- ``"seq"``   — sequence parallel (ring and Ulysses attention) for long inputs.

A ``Mesh`` is a (data, model, seq) grid of ``torch.device``s; axes of size 1
are still present, so a spec that names them stays valid in every
configuration. The port runs every mesh single-controller: one process walks
the ranks of each axis, places each rank's block on that rank's device, and
a collective between ranks is a tensor operation on their devices. The ranks
of an axis may share one device: that is how the CPU tests stand in for the
JAX tests' 8 fake host devices (``visible_devices`` patched to
``["cpu"] * 8``) and how ``chip_smoke.py`` runs every mesh mode on one card.
``torch.distributed`` is only the cross-host seam
(``tpuserve_torch.parallel.distributed``), as ``jax.distributed`` is the
reference's.

``visible_devices`` is the counterpart of ``jax.devices()``: every CUDA
device of this process, and never the CPU unless the caller serves on it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)


def visible_devices(platform: str = "cuda") -> list:
    """The devices a mesh may span, in a stable order (so replica indices in
    metrics map to the same cards across restarts): every CUDA device of this
    process, raising without CUDA; ``platform="cpu"`` gives the one CPU
    device. Tests patch this function (to ``["cpu"] * 8``, the reference's
    8 fake host devices), and ``chip_smoke.py`` to ranks on ``cuda:0``."""
    if platform == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("visible_devices: CUDA is not available; serve on the "
                           "CPU with device='cpu' (serve --device cpu)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_device_count(platform: str = "cuda") -> int:
    return len(visible_devices(platform))


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
    """A grid of devices with named axes; ``shape`` maps each axis name to
    its size, as ``jax.sharding.Mesh.shape`` does. ``make_mesh`` builds the
    (data, model, seq) grid, ``pipeline.make_stage_mesh`` a ("stage",) one."""

    devices: np.ndarray  # object array of torch.device, one axis per name
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The device of each rank along ``axis`` (the other axes at rank 0)."""
        index = [0] * len(self.axis_names)
        index[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(index)])

    def distinct_devices(self) -> list[torch.device]:
        """The mesh's devices without repeats, in rank order."""
        out: list[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def host_major_grid(devices: list, dp: int, tp: int, sp: int) -> np.ndarray:
    """(dp, tp, sp) device grid with every (tp, sp) block inside one host.

    The data axis is host-major — hosts ordered by ``process_index``, each
    host's devices filling whole dp rows — so tensor- and sequence-parallel
    traffic stays inside a host and only data-parallel traffic crosses
    hosts. Input whose devices all carry one ``process_index`` (or none, as
    a ``torch.device`` does) reduces to a plain reshape in device order."""
    hosts: dict[int, list] = {}
    for d in devices:
        hosts.setdefault(getattr(d, "process_index", 0), []).append(d)
    counts = {len(v) for v in hosts.values()}
    if len(counts) != 1:
        raise ValueError("hosts contribute unequal device counts: "
                         f"{ {h: len(v) for h, v in sorted(hosts.items())} }")
    if counts.pop() % (tp * sp) != 0:
        raise ValueError(
            f"tp*sp={tp * sp} must divide each host's device count "
            f"({len(devices) // len(hosts)}): tensor/sequence axes must not "
            "cross hosts")
    ordered = [d for _, host in sorted(hosts.items()) for d in host]
    grid = np.empty(len(ordered), dtype=object)
    grid[:] = ordered
    return grid.reshape(dp, tp, sp)


def make_mesh(plan: MeshPlan | None = None, devices: list | None = None) -> Mesh:
    """Build a Mesh with axes (data, model, seq) over ``devices`` (torch
    devices or their names; one entry per rank, and entries may repeat).
    ``devices=None`` takes ``visible_devices()``, which raises without
    CUDA — the port never falls back to the CPU on its own."""
    plan = plan or MeshPlan()
    devices = visible_devices() if devices is None else devices
    devices = [torch.device(d) for d in devices]
    dp, tp, sp = plan.resolve(len(devices))
    return Mesh(host_major_grid(devices, dp, tp, sp))


def batch_sharding(mesh: Mesh) -> list[torch.device]:
    """Inputs/outputs: the leading (batch) dim split over the data axis —
    the device of each data rank, in row order."""
    return mesh.axis_devices(DATA_AXIS)


def replicated_sharding(mesh: Mesh) -> list[torch.device]:
    """Params (data-parallel mode): one full copy on every rank's device."""
    return list(mesh.devices.flat)


def pad_batch_to_mesh(batch_size: int, mesh: Mesh) -> int:
    """Smallest batch >= batch_size divisible by the data-axis size."""
    d = mesh.shape[DATA_AXIS]
    return ((batch_size + d - 1) // d) * d


def axis_size(mesh: Mesh, axis: str) -> int:
    """Size of a named mesh axis (1 when the axis is absent)."""
    return int(mesh.shape.get(axis, 1))


def can_shard(mesh: Mesh, axis: str, dim: int) -> bool:
    """True when ``dim`` divides evenly over a >1-sized mesh axis."""
    n = axis_size(mesh, axis)
    return n > 1 and dim % n == 0


def select_devices(n_chips: int = 0, devices: list | None = None) -> list:
    """The device set a ``[parallel]`` plan serves on: every visible device
    for ``n_chips = 0``, else the first ``n_chips``. Asking for more devices
    than exist is a configuration error, never a silent clamp."""
    devs = list(devices) if devices is not None else visible_devices()
    if n_chips <= 0:
        return devs
    if n_chips > len(devs):
        raise ValueError(
            f"parallel.n_chips={n_chips} but only {len(devs)} device(s) "
            "visible")
    return devs[:n_chips]


def plan_for(parallel: "object", tp: int = 1, sp: int = 1) -> MeshPlan:
    """MeshPlan for a sharded-batch serving mesh from a ``[parallel]``
    block: an explicit ``data`` pins the data-axis size, otherwise it
    derives from the device count (dp = -1)."""
    data = int(getattr(parallel, "data", 0) or 0)
    return MeshPlan(dp=data if data > 0 else -1, tp=tp, sp=sp)
