"""vacancy_tpu_torch: the shape-from-silhouette engine on PyTorch and CUDA.

A port of ``vacancy_tpu`` (JAX on a TPU) to PyTorch on one NVIDIA H100:
the same grid state, cameras and options, plain PyTorch for the tensor
code, and hand-written CUDA kernels (``csrc/``) where the JAX package
wrote Pallas kernels. It imports no JAX; each module's counterpart sits
under the same path in ``vacancy_tpu``, and this package binds every name
that ``vacancy_tpu`` binds.
"""

from .camera import OrthoCamera, PinholeCamera, stack_cameras
from .carver import VoxelCarver
from .config import (
    INVALID_SDF,
    SdfInterpolation,
    ShardingConfig,
    UpdateOutsideImage,
    VoxelCarverOption,
    VoxelUpdate,
    VoxelUpdateOption,
)
from .grid import GridSpec, VoxelGridState, state_from_numpy, state_to_numpy
from .mesh import Mesh, MeshStats, make_cube, set_random_vertex_color
from .metrics import chamfer_distance, hausdorff_distance
from .utils import LogLevel, Timer, set_log_level, zfill

__version__ = "0.1.0"
