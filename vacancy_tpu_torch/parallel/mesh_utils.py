"""Block-mesh and sharding helpers (``vacancy_tpu/parallel/mesh_utils.py``).

The voxel grid is block-partitioned over a ``BlockMesh`` whose axes are
named after grid axes: "z" (the slowest array dim), "y", "x". A 1-D z
mesh is the default; 2-D (z, y) and 3-D (z, y, x) meshes generalize it,
so flat or wide grids can shard and block counts are not capped by nz.
Fusion is embarrassingly parallel per block; the only cross-block
dependency in the whole pipeline is marching cubes reading a one-voxel
neighbourhood, resolved by a per-axis halo exchange
(``parallel/sharded.py``). Cameras and SDF images are copied to every
block's device.

``BlockMesh`` is the port's counterpart of ``jax.sharding.Mesh``: one
``torch.device`` per block, in z-major order, and the process (rank) that
holds each block. Devices may repeat: four blocks on ``cuda:0``, or eight
on the CPU, are the counterpart of JAX's virtual device mesh
(``--xla_force_host_platform_device_count``) and are how one card, or a
machine with none, runs and checks the sharded path. Blocks on one device
run in turn.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..grid import GridSpec

# grid-axis names in array-dim order: dim 0 = z, dim 1 = y, dim 2 = x
GRID_AXES = ("z", "y", "x")

Block = Tuple[int, int, int]  # (bz, by, bx)


@dataclasses.dataclass(frozen=True)
class BlockMesh:
    """Blocks laid out row-major over named axes. ``devices[k]`` holds
    block k for the blocks of this process and is None for a peer's;
    ``ranks[k]`` is the process that holds it."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[Optional[torch.device], ...]
    ranks: Tuple[int, ...]
    rank: int = 0
    world_size: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.ranks)


def rank_and_world(rank: Optional[int] = None,
                   world_size: Optional[int] = None):
    """(rank, world size): the arguments, or ``torch.distributed``'s where
    a process group is up, or (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        default = (dist.get_rank(), dist.get_world_size())
    else:
        default = (0, 1)
    return (default[0] if rank is None else int(rank),
            default[1] if world_size is None else int(world_size))


def default_devices(rank: int = 0, world_size: int = 1) -> List[torch.device]:
    """This process's cards: every visible one for a single process, the
    card ``rank % count`` for a rank of several (ranks fill a host's cards
    in order). Raises without a card: a CPU mesh is asked for by name
    (``devices=["cpu"] * n``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass devices=['cpu', ...] for a mesh of CPU "
            "blocks")
    count = torch.cuda.device_count()
    if world_size > 1:
        return [torch.device("cuda", rank % count)]
    return [torch.device("cuda", i) for i in range(count)]


def make_device_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    axis_name: str = "z",
    config=None,
    shape: Optional[Tuple[int, ...]] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> BlockMesh:
    """A block mesh over the grid's axes.

    Default: a 1-D mesh named ``axis_name`` of ``n_devices`` blocks (one
    per device by default). Pass ``shape`` -- a tuple of 1 to 3 ints --
    for a multi-axis mesh; its dims map onto grid axes ("z",), ("z", "y"),
    ("z", "y", "x") in order. Pass a ``config.ShardingConfig`` to drive
    the axis name and block count from configuration instead.

    ``devices`` are THIS process's devices, one per block it holds, and
    may repeat (module docstring); the default is ``default_devices``.
    With several processes the mesh spans them: every rank passes as many
    devices, block k lives on rank ``k // len(devices)``, and ``rank`` /
    ``world_size`` default to ``torch.distributed``'s."""
    if config is not None:
        axis_name = config.axis_name
        if config.n_devices is not None and n_devices is None:
            n = config.n_devices
            if isinstance(n, tuple) and len(n) > 1 and shape is None:
                shape = tuple(int(v) for v in n)
            else:
                n_devices = int(n[0]) if isinstance(n, tuple) else int(n)
    rank, world_size = rank_and_world(rank, world_size)
    if devices is None:
        devices = default_devices(rank, world_size)
    devices = [torch.device(d) for d in devices]
    have = len(devices) * world_size
    if shape is not None:
        if not 1 <= len(shape) <= 3:
            raise ValueError(f"mesh shape must have 1-3 dims: {shape}")
        sizes = tuple(int(v) for v in shape)
        names = GRID_AXES[: len(sizes)]
        total = int(np.prod(sizes))
        if total > have:
            raise ValueError(
                f"mesh shape {shape} needs {total} devices, have {have}")
    else:
        total = have if n_devices is None else int(n_devices)
        if total > have:
            raise ValueError(f"{total} devices asked for, have {have}")
        sizes, names = (total,), (axis_name,)
    if total < 1 or total % world_size:
        raise ValueError(f"{total} blocks do not divide over {world_size} "
                         "processes")
    per_rank = total // world_size
    ranks = tuple(k // per_rank for k in range(total))
    return BlockMesh(
        axis_names=tuple(names), axis_sizes=sizes,
        devices=tuple(devices[k % per_rank] if r == rank else None
                      for k, r in enumerate(ranks)),
        ranks=ranks, rank=rank, world_size=world_size)


def mesh_grid_axes(mesh: BlockMesh) -> Tuple[int, int, int]:
    """Partition counts (nz_shards, ny_shards, nx_shards) of a grid mesh:
    the size of each grid-named mesh axis, 1 where absent."""
    shape = mesh.shape
    return tuple(int(shape[a]) if a in shape else 1 for a in GRID_AXES)


@dataclasses.dataclass(frozen=True)
class GridSharding:
    """How [Z, Y, X] grid-state arrays are cut over a mesh: ``parts`` =
    (pz, py, px) equal blocks, block (bz, by, bx) being the mesh's block
    ``(bz * py + by) * px + bx``."""

    mesh: BlockMesh
    parts: Tuple[int, int, int]

    def blocks(self) -> List[Block]:
        """Every block, z-major: ascending mesh order."""
        pz, py, px = self.parts
        return [(bz, by, bx) for bz in range(pz) for by in range(py)
                for bx in range(px)]

    def index(self, block: Block) -> int:
        _, py, px = self.parts
        return (block[0] * py + block[1]) * px + block[2]

    def rank_of(self, block: Block) -> int:
        return self.mesh.ranks[self.index(block)]

    def device_of(self, block: Block) -> torch.device:
        """The device of one of THIS process's blocks."""
        dev = self.mesh.devices[self.index(block)]
        if dev is None:
            raise ValueError(f"block {block} lives on rank "
                             f"{self.rank_of(block)}, not {self.mesh.rank}")
        return dev

    def local_blocks(self) -> List[Block]:
        return [b for b in self.blocks()
                if self.rank_of(b) == self.mesh.rank]

    def block_shape(self, shape_zyx) -> Tuple[int, int, int]:
        for a, n, d in zip(GRID_AXES, self.parts, shape_zyx):
            if d % n:
                raise ValueError(
                    f"grid {a} extent {d} not divisible by {n} shards; "
                    "use pad_bbox_for_sharding()")
        return tuple(d // n for n, d in zip(self.parts, shape_zyx))

    def slices(self, block: Block, shape_zyx) -> Tuple[slice, slice, slice]:
        """The block's index range in the global [Z, Y, X] array."""
        ls = self.block_shape(shape_zyx)
        return tuple(slice(b * n, (b + 1) * n) for b, n in zip(block, ls))


def grid_sharding(mesh: BlockMesh, axis_name: str = "z") -> GridSharding:
    """Sharding for [Z, Y, X] grid-state arrays: block-partitioned on
    every grid-named mesh axis present."""
    if set(mesh.axis_names) <= set(GRID_AXES):
        return GridSharding(mesh, mesh_grid_axes(mesh))
    # legacy: a custom 1-D axis name partitions z
    return GridSharding(mesh, (int(mesh.shape[axis_name]), 1, 1))


def replicated(mesh: BlockMesh) -> GridSharding:
    """The sharding of an array kept whole: one block, the mesh's first."""
    return GridSharding(mesh, (1, 1, 1))


def pick_mesh_shape(
    shape_zyx: Tuple[int, int, int], n_devices: int
) -> Tuple[int, int, int]:
    """A (pz, py, px) block-mesh shape for ``n_devices`` blocks over a
    (nz, ny, nx) grid, with the JAX package's axis preference: shard z
    first (fully work-proportional), then x (pass 1 of the warp is
    separable in x), and use y only as a last resort -- a y split repeats
    the warp's pass-1 resample per y block. Each factor of n_devices
    lands on the best axis that can still take it (axis shard count <=
    extent); raises if the count exceeds the voxel count bound. Axes need
    not divide evenly -- pad with pad_bbox_for_sharding."""
    nz, ny, nx = (int(v) for v in shape_zyx)
    parts = [1, 1, 1]  # (pz, py, px)
    caps = [nz, ny, nx]
    rem = int(n_devices)
    for f in _prime_factors(rem):
        for axis in (0, 2, 1):  # z, then x, then y
            if parts[axis] * f <= caps[axis]:
                parts[axis] *= f
                break
        else:
            raise ValueError(
                f"cannot place {n_devices} devices on grid {shape_zyx}: "
                f"stuck at {tuple(parts)} with factor {f}"
            )
    return tuple(parts)


def _prime_factors(n: int):
    """Prime factors of n, largest first (greedy placement packs big
    factors onto z while it has room)."""
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


def _parts_of(n_shards) -> Tuple[int, int, int]:
    if isinstance(n_shards, BlockMesh):
        return mesh_grid_axes(n_shards)
    return (int(n_shards), 1, 1)


def validate_divisible(grid: GridSpec, n_shards, axis: str = "z") -> int:
    """The axis extent must divide evenly across shards; returns the
    block. n_shards may be an int (1-D z mesh) or a BlockMesh."""
    out = None
    for a, n, d in zip(GRID_AXES, _parts_of(n_shards), grid.shape_zyx):
        if d % n != 0:
            raise ValueError(
                f"grid {a} extent {d} not divisible by {n} shards; "
                "use pad_bbox_for_sharding()"
            )
        if a == axis:
            out = d // n
    return out


def pad_bbox_for_sharding(grid: GridSpec, n_shards) -> GridSpec:
    """Grow bb_max so each sharded axis's voxel count divides its shard
    count. n_shards: an int (z only, the 1-D default) or a BlockMesh.

    Extending the bounding box adds real voxels above the volume of
    interest -- they take part in carving normally and simply get carved
    away (or stay outside the silhouette cones), so results in the
    original volume are unchanged.
    """
    parts = _parts_of(n_shards)
    dims = grid.shape_zyx  # (nz, ny, nx)
    res = np.float32(grid.resolution)
    bb_min = grid.bb_min
    bb_max = list(grid.bb_max)
    changed = False
    for a, (n, d) in enumerate(zip(parts, dims)):
        if d % n == 0:
            continue
        target = ((d + n - 1) // n) * n
        # voxel_num = int(f32(diff) / res): nudge diff just past target*res
        world_axis = 2 - a  # array dim 0 = world z = bb component 2
        bb_max[world_axis] = float(
            np.float32(bb_min[world_axis])
            + res * (target + np.float32(0.5))
        )
        changed = True
    if not changed:
        return grid
    new_grid = GridSpec(
        bb_min=bb_min, bb_max=tuple(bb_max), resolution=grid.resolution
    )
    want = tuple(((d + n - 1) // n) * n for n, d in zip(parts, dims))
    if new_grid.shape_zyx != want:
        raise AssertionError((new_grid.shape_zyx, want))
    return new_grid
