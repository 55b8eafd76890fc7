"""Parallelism layer of the port, mirroring ``tpuserve/parallel``.

- ``mesh``        — the named device grid (data, model, seq), host-major
- ``partition``   — regex partition rules -> per-rank parameter blocks
- ``distributed`` — the ``torch.distributed`` seam for several processes
- ``pipeline``    — GPipe over a ("stage",) axis

Every mesh runs single-controller: one process walks the ranks, which may
share one device (``mesh.visible_devices``).
"""

from tpuserve_torch.parallel.distributed import init_distributed, process_info  # noqa: F401
from tpuserve_torch.parallel.mesh import (  # noqa: F401
    AXES,
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    MeshPlan,
    axis_size,
    batch_sharding,
    can_shard,
    host_major_grid,
    local_device_count,
    make_mesh,
    pad_batch_to_mesh,
    plan_for,
    replicated_sharding,
    select_devices,
    visible_devices,
)
from tpuserve_torch.parallel.partition import (  # noqa: F401
    REPLICATED_RULES,
    P,
    PartitionSpec,
    match_partition_rules,
    named_leaves,
    shard_pytree,
    spec_for_name,
)
from tpuserve_torch.parallel.pipeline import (  # noqa: F401
    make_stage_mesh,
    pipeline_forward,
    stack_stage_params,
)
