"""Voxel grid: geometry spec (numpy) + the fusion state (torch tensors).

The state is two dense tensors on one device

    sdf:        f32[Z, Y, X]
    update_num: i32[Z, Y, X]

with flat index ``z*ny*nx + y*nx + x`` (the reference voxel id,
``voxel_carver.cc:333``), exactly as ``vacancy_tpu/grid.py`` lays it out.
Voxel centers are recomputed from indices; ``GridSpec`` keeps the JAX
package's formulas verbatim so the centers are bitwise the same.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import INVALID_SDF


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static geometry of a voxel grid.

    Parity notes (reference ``voxel_carver.cc:276-345``):
      * ``voxel_num[i] = int(float(bb_max - bb_min)[i] / resolution)``
        -- truncating float32 division, so the effective per-axis pitch
        ``diff[i] / voxel_num[i]`` is >= resolution (anisotropic).
      * voxel center = ``diff * (i / n) + bb_min + resolution / 2``
        -- NOT ``i * resolution`` (the offset uses resolution, the pitch
        uses diff/n).
    """

    bb_min: Tuple[float, float, float]
    bb_max: Tuple[float, float, float]
    resolution: float

    def __post_init__(self):
        if self.resolution <= 0.0:
            raise ValueError(f"resolution must be positive: {self.resolution}")
        if any(mx <= mn for mn, mx in zip(self.bb_min, self.bb_max)):
            raise ValueError("input bounding box is invalid")

    @property
    def diff(self) -> np.ndarray:
        return np.asarray(self.bb_max, np.float32) - np.asarray(
            self.bb_min, np.float32
        )

    @property
    def voxel_num(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) -- truncating f32 division like the reference."""
        n = (self.diff / np.float32(self.resolution)).astype(np.int32)
        return int(n[0]), int(n[1]), int(n[2])

    @property
    def shape_zyx(self) -> Tuple[int, int, int]:
        nx, ny, nz = self.voxel_num
        return nz, ny, nx

    @property
    def num_voxels(self) -> int:
        nx, ny, nz = self.voxel_num
        return nx * ny * nz

    def axis_centers(self, axis: int) -> np.ndarray:
        """Voxel-center coordinates along one axis (0=x, 1=y, 2=z), f32."""
        n = self.voxel_num[axis]
        i = np.arange(n, dtype=np.float32)
        diff = self.diff[axis]
        offset = np.float32(self.resolution) * np.float32(0.5)
        return (
            diff * (i / np.float32(n)) + np.float32(self.bb_min[axis]) + offset
        ).astype(np.float32)

    def axis_centers_t(self, axis: int, device) -> torch.Tensor:
        """``axis_centers`` as an f32 tensor on ``device``."""
        return torch.from_numpy(self.axis_centers(axis)).to(device)

    def centers_zyx(self, device) -> torch.Tensor:
        """Voxel centers as f32[Z, Y, X, 3] (xyz in the last axis) on
        ``device``."""
        cx, cy, cz = (self.axis_centers_t(a, device) for a in range(3))
        zz, yy, xx = torch.meshgrid(cz, cy, cx, indexing="ij")
        return torch.stack([xx, yy, zz], dim=-1)


@dataclasses.dataclass
class VoxelGridState:
    """The complete fusion state: per-voxel running SDF and update count."""

    sdf: torch.Tensor  # f32[Z, Y, X]
    update_num: torch.Tensor  # i32[Z, Y, X]

    @staticmethod
    def create(grid: GridSpec, device) -> "VoxelGridState":
        if grid.num_voxels > np.iinfo(np.int32).max:
            raise ValueError("too many voxels")  # voxel_carver.cc:298-302
        shape = grid.shape_zyx
        return VoxelGridState(
            sdf=torch.full(
                shape, float(INVALID_SDF), dtype=torch.float32, device=device
            ),
            update_num=torch.zeros(shape, dtype=torch.int32, device=device),
        )


def state_from_numpy(sdf: np.ndarray, update_num: np.ndarray,
                     device) -> VoxelGridState:
    """Load a state given as numpy arrays (e.g. a JAX ``VoxelGridState``
    passed through ``np.asarray``) onto ``device``. Always a copy: the
    state is updated in place by ``carve_views_warp_blocked``, and must
    not write through to the caller's arrays."""
    sdf = np.require(sdf, np.float32, ["C", "W"])
    update_num = np.require(update_num, np.int32, ["C", "W"])
    if sdf.ndim != 3 or sdf.shape != update_num.shape:
        raise ValueError(f"state shapes differ: {sdf.shape} {update_num.shape}")
    return VoxelGridState(
        sdf=torch.from_numpy(sdf).to(device, copy=True),
        update_num=torch.from_numpy(update_num).to(device, copy=True),
    )


def state_to_numpy(state: VoxelGridState) -> Tuple[np.ndarray, np.ndarray]:
    """(sdf f32[Z, Y, X], update_num i32[Z, Y, X]) as host numpy arrays."""
    return state.sdf.cpu().numpy(), state.update_num.cpu().numpy()
