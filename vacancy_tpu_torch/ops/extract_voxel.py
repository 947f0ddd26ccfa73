"""Voxel-face mesh extraction, a cube per kept voxel
(``vacancy_tpu/ops/extract_voxel.py``; reference
``src/vacancy/extract_voxel.cc:258-317``).

The keep mask and the surface flags are dense boolean ops on the state's
device; cube instancing (24 vertices and 12 faces per kept voxel) is
numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import GridSpec, VoxelGridState
from ..mesh import Mesh, make_cube


def surface_flags(state: VoxelGridState) -> torch.Tensor:
    """Axis-sweep sign-change surface detection (``UpdateOnSurface``,
    extract_voxel.cc:15-79): for each axis, a voxel (at the higher index
    of the pair) is flagged when it and its -axis neighbor are both
    updated and their sdf signs differ; voxels with |sdf| < FLT_MIN are
    also flagged."""
    sdf, un = state.sdf, state.update_num
    tiny = float(np.finfo(np.float32).tiny)
    flag = torch.zeros(sdf.shape, dtype=torch.bool, device=sdf.device)
    for axis in range(3):  # array axes: 0=z, 1=y, 2=x
        n = sdf.shape[axis]
        cur_s, prev_s = sdf.narrow(axis, 1, n - 1), sdf.narrow(axis, 0, n - 1)
        cur_u, prev_u = un.narrow(axis, 1, n - 1), un.narrow(axis, 0, n - 1)
        both = (cur_u >= 1) & (prev_u >= 1)
        change = (cur_s * prev_s < 0) | (torch.abs(cur_s) < tiny)
        flag.narrow(axis, 1, n - 1).logical_or_(both & change)
    return flag


def occupancy_mask(state: VoxelGridState) -> torch.Tensor:
    """Keep rule: sdf <= 0 and update_num >= 1 (extract_voxel.cc:285-288)."""
    return (state.sdf <= 0) & (state.update_num >= 1)


def extract_voxel_mesh(
    state: VoxelGridState, grid: GridSpec, inside_empty: bool = False
) -> Mesh:
    """Emit a translated cube per kept voxel (extract_voxel.cc:258-317):
    the surface voxels with ``inside_empty``, else every occupied one."""
    keep = surface_flags(state) if inside_empty else occupancy_mask(state)
    zz, yy, xx = (a.cpu().numpy() for a in torch.nonzero(keep, as_tuple=True))
    n = len(zz)
    if n == 0:
        return Mesh()
    cube = make_cube(float(grid.resolution))
    centers = np.stack(
        [
            grid.axis_centers(0)[xx],
            grid.axis_centers(1)[yy],
            grid.axis_centers(2)[zz],
        ],
        axis=-1,
    )  # [n, 3] in xyz

    verts = (cube.vertices[None, :, :] + centers[:, None, :]).reshape(-1, 3)
    offsets = (np.arange(n, dtype=np.int64) * 24)[:, None, None]
    faces = (cube.faces[None, :, :] + offsets).reshape(-1, 3)
    if faces.size and faces.max() > np.iinfo(np.int32).max:
        raise ValueError("voxel mesh exceeds int32 indexing")
    return Mesh(vertices=verts.astype(np.float32), faces=faces.astype(np.int32))
