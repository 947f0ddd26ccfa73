from .mesh_utils import (
    BlockMesh,
    GridSharding,
    grid_sharding,
    make_device_mesh,
    pad_bbox_for_sharding,
    pick_mesh_shape,
    replicated,
    validate_divisible,
)
from .sharded import (
    carve_views_sharded,
    carve_views_warp_sharded,
    extract_mesh_fused_sharded,
    extract_mesh_sharded,
    halo_exchange,
    initialize_distributed,
    marching_cubes_fused_sharded,
    marching_cubes_sharded,
    pick_transport,
)
