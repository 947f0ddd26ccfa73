from .image import (
    convert_image,
    depth_to_gray,
    face_id_to_random_color,
    load_image,
    load_mask,
    normal_to_color,
    write_png,
)
from .meshio import (
    load_obj,
    load_ply,
    write_obj,
    write_obj_textured,
    write_ply,
)
from .tum import load_tum_format, load_tum_poses, quat_to_rotmat
