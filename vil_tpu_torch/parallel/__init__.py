"""Parallel strategies: spatial (chunk-row) parallelism of the sliding-chunk
attention, the process-group set-up and the cross-process helpers
(counterpart of ``vil_tpu/parallel``)."""
from .collectives import (
    all_gather,
    all_gather_arrays,
    get_rank,
    get_world_size,
    is_main_process,
    reduce_dict,
    synchronize,
)
from .mesh import create_mesh, init_process_group, shard_image, spatial_forward
from .spatial import (
    SpatialContext,
    halo_rows,
    neighborhood_spatial,
    spatial_global_branch,
    spatial_local_attention,
    spatial_local_attention_kernel,
)

__all__ = [
    "SpatialContext",
    "all_gather",
    "all_gather_arrays",
    "create_mesh",
    "get_rank",
    "get_world_size",
    "halo_rows",
    "init_process_group",
    "is_main_process",
    "neighborhood_spatial",
    "reduce_dict",
    "shard_image",
    "spatial_forward",
    "spatial_global_branch",
    "spatial_local_attention",
    "spatial_local_attention_kernel",
    "synchronize",
]
