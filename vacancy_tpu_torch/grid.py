"""Voxel grid: geometry spec (numpy) + the fusion state (torch tensors).

The state is two dense tensors on one device

    sdf:        f32[Z, Y, X]
    update_num: i32[Z, Y, X]

with flat index ``z*ny*nx + y*nx + x`` (the reference voxel id,
``voxel_carver.cc:333``), exactly as ``vacancy_tpu/grid.py`` lays it out.
Voxel centers are recomputed from indices; ``GridSpec`` keeps the JAX
package's formulas verbatim so the centers are bitwise the same.

A block-sharded state (``ShardedGridState``) is the same grid cut into
equal blocks over a ``parallel.BlockMesh``: this process's blocks, each a
``VoxelGridState`` of its own on its block's device, keyed by
(bz, by, bx), plus the global shape -- the port's counterpart of a JAX
array with a ``NamedSharding``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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

    def world_to_index(self, points: np.ndarray) -> np.ndarray:
        """Continuous voxel index of world points (inverse of axis_centers)."""
        points = np.asarray(points, np.float32)
        n = np.asarray(self.voxel_num, np.float32)
        diff = self.diff
        offset = np.float32(self.resolution) * np.float32(0.5)
        return (points - np.asarray(self.bb_min, np.float32) - offset) * n / diff


@dataclasses.dataclass
class VoxelGridState:
    """The complete fusion state: per-voxel running SDF and update count."""

    sdf: torch.Tensor  # f32[Z, Y, X]
    update_num: torch.Tensor  # i32[Z, Y, X]

    @staticmethod
    def create(grid: GridSpec, device=None, sharding=None):
        """The untouched state of ``grid`` on ``device``, or, with a
        ``parallel.grid_sharding(mesh)``, a ``ShardedGridState`` whose
        blocks lie on the mesh's devices."""
        if grid.num_voxels > np.iinfo(np.int32).max:
            raise ValueError("too many voxels")  # voxel_carver.cc:298-302
        if sharding is not None:
            if device is not None:
                raise ValueError("a sharded state takes its devices from "
                                 "the mesh: pass device or sharding")
            shape = sharding.block_shape(grid.shape_zyx)
            return ShardedGridState(
                blocks={b: _empty_state(shape, sharding.device_of(b))
                        for b in sharding.local_blocks()},
                sharding=sharding, shape=grid.shape_zyx)
        if device is None:
            raise ValueError("VoxelGridState.create needs a device or a "
                             "sharding")
        return _empty_state(grid.shape_zyx, device)


def _empty_state(shape, device) -> VoxelGridState:
    return VoxelGridState(
        sdf=torch.full(shape, float(INVALID_SDF), dtype=torch.float32,
                       device=device),
        update_num=torch.zeros(shape, dtype=torch.int32, device=device),
    )


@dataclasses.dataclass
class ShardedGridState:
    """The fusion state cut into equal blocks over a block mesh.

    ``blocks`` holds THIS process's blocks, each a contiguous
    ``VoxelGridState`` on its block's device, keyed by (bz, by, bx);
    ``sharding`` is the ``parallel.GridSharding`` that places them and
    ``shape`` the global (nz, ny, nx)."""

    blocks: Dict[Tuple[int, int, int], VoxelGridState]
    sharding: object
    shape: Tuple[int, int, int]

    @staticmethod
    def from_dense(state: VoxelGridState, sharding) -> "ShardedGridState":
        """Cut a dense state into this process's blocks (copies, each on
        its block's device)."""
        shape = tuple(state.sdf.shape)
        blocks = {}
        for b in sharding.local_blocks():
            sl = sharding.slices(b, shape)
            dev = sharding.device_of(b)
            blocks[b] = VoxelGridState(
                sdf=state.sdf[sl].to(dev, copy=True).contiguous(),
                update_num=state.update_num[sl].to(dev, copy=True)
                .contiguous())
        return ShardedGridState(blocks, sharding, shape)

    def gather(self, device=None) -> VoxelGridState:
        """One dense state on ``device`` (default: the first block's).
        Every block must be local: a state that spans processes has no
        dense form on any of them."""
        missing = [b for b in self.sharding.blocks() if b not in self.blocks]
        if missing:
            raise ValueError(f"blocks {missing} live on other processes")
        if device is None:
            device = next(iter(self.blocks.values())).sdf.device
        sdf = torch.empty(self.shape, dtype=torch.float32, device=device)
        un = torch.empty(self.shape, dtype=torch.int32, device=device)
        for b, st in self.blocks.items():
            sl = self.sharding.slices(b, self.shape)
            sdf[sl] = st.sdf.to(device)
            un[sl] = st.update_num.to(device)
        return VoxelGridState(sdf=sdf, update_num=un)


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


def sharded_state_from_numpy(sdf: np.ndarray, update_num: np.ndarray,
                             mesh) -> ShardedGridState:
    """A state given as global numpy arrays, cut into this process's
    blocks of ``mesh`` (a ``parallel.BlockMesh``): the same arrays a JAX
    run shards with ``jax.device_put(a, grid_sharding(mesh))``."""
    from .parallel.mesh_utils import grid_sharding

    return ShardedGridState.from_dense(
        state_from_numpy(sdf, update_num, "cpu"), grid_sharding(mesh))


def sharded_state_to_numpy(
        state: ShardedGridState) -> Tuple[np.ndarray, np.ndarray]:
    """``state_to_numpy`` of a sharded state whose blocks are all local."""
    return state_to_numpy(state.gather("cpu"))


def state_to_numpy(state: VoxelGridState) -> Tuple[np.ndarray, np.ndarray]:
    """(sdf f32[Z, Y, X], update_num i32[Z, Y, X]) as host numpy arrays."""
    return state.sdf.cpu().numpy(), state.update_num.cpu().numpy()
