from .fusion_warp import carve_views_warp
from .marching_cubes import extract_mesh
from .sdf2d import distance_transform_l1, make_signed_distance_field
