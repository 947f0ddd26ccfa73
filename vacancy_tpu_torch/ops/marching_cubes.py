"""Marching-cubes extraction (``vacancy_tpu/ops/marching_cubes.py``).

Every vertex lies on a unique canonical grid edge ``(axis, owner voxel)``,
so vertices are welded by construction and their order is structural:
axis-major, then flat (z, y, x) order of the owner voxel. ``extract_mesh``
runs the fused marching-cubes kernel (``ops/mc_fused.py``) and assembles
the mesh on the host, in the same vertex and face order as the JAX
package's drivers.
"""

from __future__ import annotations

import numpy as np

from ..grid import GridSpec, VoxelGridState
from ..mesh import Mesh
from .mc_fused import assemble_fused_streams, marching_cubes_fused


def extract_mesh(
    state: VoxelGridState,
    grid: GridSpec,
    iso_level: float = 0.0,
    linear_interp: bool = True,
) -> Mesh:
    """The iso-surface of ``state`` as a host ``Mesh``: the fused
    marching-cubes kernel on a CUDA state (its plain version on a CPU
    state), one copy of the four streams to the host, and the host
    assembly."""
    nz, ny, nx = state.sdf.shape
    dev = state.sdf.device
    st = marching_cubes_fused(
        state.sdf, state.update_num, grid.axis_centers_t(0, dev),
        grid.axis_centers_t(1, dev), grid.axis_centers_t(2, dev),
        iso_level, linear_interp,
    )
    host = [t.cpu().numpy() for t in st.as_tuple()[:8]]
    vpos_parts = host[0:6:2]
    vlin_parts = [v.astype(np.int64) for v in host[1:6:2]]
    return assemble_fused_streams(
        vpos_parts, vlin_parts, host[6], host[7], ny, nx, grid
    )
