"""Parallelism layer of the port, mirroring ``tpuserve/parallel``.

Ported: ``mesh`` — the named device grid (data, model, seq) that ring and
Ulysses attention run over. Meshes whose data or model axis is larger than 1,
partition rules, multi-process setup and pipelining are not ported yet
(ROADMAP.md queue 1: mesh modes).
"""

from tpuserve_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    MeshPlan,
    make_mesh,
)
