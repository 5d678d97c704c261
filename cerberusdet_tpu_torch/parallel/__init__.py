from cerberusdet_tpu_torch.parallel.mesh import (  # noqa: F401
    all_gather_rows,
    all_reduce_sum,
    broadcast_decision,
    broadcast_object,
    group_rank,
    group_size,
    init_distributed,
    make_mesh,
    pad_batch_to,
    rank_device,
    replicate,
    shard_batch,
    shard_task_batches,
)
from cerberusdet_tpu_torch.parallel.spatial import (  # noqa: F401
    SPATIAL_AXIS,
    SpatialMesh,
    check_spatial_shape,
    make_data_spatial_mesh,
    make_spatial_forward,
    make_spatial_mesh,
)
