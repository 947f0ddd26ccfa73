from .extract_voxel import extract_voxel_mesh, occupancy_mask, surface_flags
from .fusion import carve_masks, carve_views, sample_sdf_bilinear, sample_sdf_nn
from .fusion_warp import carve_views_warp
from .marching_cubes import extract_mesh, marching_cubes_dense
from .sdf2d import (
    distance_transform_l1,
    make_signed_distance_field,
    signed_distance_to_color,
)
