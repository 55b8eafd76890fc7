"""Multi-process initialization, ported from ``tpuserve/parallel/distributed.py``.

The port is single-controller on a host: one process owns every local
device, and a collective between its ranks is a tensor operation on their
devices. ``torch.distributed`` is the counterpart of ``jax.distributed``:
the cross-host seam, and nothing more.

- ``init_distributed(cfg)`` — call once, before the serving path touches a
  device. A no-op unless ``DistributedConfig.coordinator_address`` is set;
  then ``torch.distributed.init_process_group`` joins ``tcp://<address>``
  with only the coordinates the config pins (``num_processes`` as the world
  size, ``process_id`` as the rank; -1 leaves each to the launcher's
  environment), over NCCL when CUDA is up and gloo otherwise.
- ``process_info()`` — rank and device facts for ``/stats`` and logs.

A mesh whose devices belong to another process is refused
(``check_local_mesh``): serving across processes needs NCCL collectives
between cards, which is ROADMAP item 10.
"""

from __future__ import annotations

import logging

import torch

log = logging.getLogger("tpuserve_torch.distributed")


def init_distributed(cfg) -> bool:
    """Join the multi-process group if configured; True when
    ``init_process_group`` was called."""
    if not cfg.coordinator_address:
        return False
    import torch.distributed as dist

    kwargs: dict = {"init_method": f"tcp://{cfg.coordinator_address}",
                    "backend": "nccl" if torch.cuda.is_available() else "gloo"}
    # -1 means "take it from the launcher's environment": pin only what the
    # config sets explicitly.
    if cfg.num_processes >= 0:
        kwargs["world_size"] = cfg.num_processes
    if cfg.process_id >= 0:
        kwargs["rank"] = cfg.process_id
    dist.init_process_group(**kwargs)
    log.info("distributed runtime up: process %d/%d, %d local devices",
             dist.get_rank(), dist.get_world_size(), _local_devices())
    return True


def _local_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def process_info() -> dict:
    """This process's coordinates in the process group (0/1 alone) and the
    devices it sees (global: every process's, when each owns as many) and
    owns (local); ``platform`` is "gpu" or "cpu"."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    index = dist.get_rank() if up else 0
    count = dist.get_world_size() if up else 1
    local = _local_devices()
    return {
        "process_index": index,
        "process_count": count,
        "global_devices": local * count,
        "local_devices": local,
        "platform": "gpu" if torch.cuda.is_available() else "cpu",
    }


def check_local_mesh(devices: list) -> None:
    """Refuse a mesh holding a device of another process (one that carries
    a ``process_index`` other than this process's)."""
    me = process_info()["process_index"]
    foreign = sorted({getattr(d, "process_index", me) for d in devices} - {me})
    if foreign:
        raise NotImplementedError(
            f"a mesh over devices of processes {foreign} needs NCCL collectives "
            "between processes, which is not yet ported to tpuserve_torch "
            "(ROADMAP.md queue 1: item 10, several GPUs)")
