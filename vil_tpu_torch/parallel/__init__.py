"""Parallel strategies: data parallelism and spatial (chunk-row) parallelism
over a ('data', 'spatial') mesh, the process-group set-up and the
cross-process helpers (counterpart of ``vil_tpu/parallel``)."""
from .collectives import (
    accumulate_predictions,
    all_gather,
    all_gather_arrays,
    get_rank,
    get_world_size,
    is_main_process,
    reduce_dict,
    synchronize,
)
from .mesh import (
    Mesh,
    average_gradients,
    create_mesh,
    init_process_group,
    mesh_from_cfg,
    shard_image,
    spatial_forward,
)
from .spatial import (
    RowSplit,
    SpatialContext,
    halo_rows,
    neighborhood_spatial,
    spatial_global_branch,
    spatial_local_attention,
    spatial_local_attention_kernel,
    row_split,
)

__all__ = [
    "Mesh",
    "RowSplit",
    "SpatialContext",
    "accumulate_predictions",
    "all_gather",
    "all_gather_arrays",
    "average_gradients",
    "create_mesh",
    "get_rank",
    "get_world_size",
    "halo_rows",
    "init_process_group",
    "is_main_process",
    "mesh_from_cfg",
    "neighborhood_spatial",
    "reduce_dict",
    "row_split",
    "shard_image",
    "spatial_forward",
    "spatial_global_branch",
    "spatial_local_attention",
    "spatial_local_attention_kernel",
    "synchronize",
]
