"""Sharded fusion + marching cubes over a block mesh
(``vacancy_tpu/parallel/sharded.py``).

The grid is cut into equal blocks over a ``BlockMesh`` with 1, 2 or 3
grid-named axes ("z"), ("z", "y"), ("z", "y", "x"), so flat or wide grids
can shard and block counts are not capped by nz:

  * **fusion**: pure data parallel over grid blocks -- zero
    communication; cameras and SDF images are copied to each block's
    device, voxel centres are sliced per axis for each block. Blocks on
    one device run in turn.
  * **marching cubes**: needs a one-voxel neighbourhood across block
    seams, resolved with a SEQUENTIAL per-axis halo exchange: each axis
    sends one boundary slice of the already-extended block -- sdf AND
    update_num, cube validity needs both -- so later axes carry earlier
    axes' halos along and the edge and corner voxels of the block arrive
    without any diagonal sends. Each block is then extracted with its
    halo through the fused MC kernel with its emission windows and
    global-id bases (``marching_cubes_fused_sharded``; any mesh rank),
    the port's one marching-cubes engine. Vertices are keyed by their
    canonical edge's global owner id and faces name vertices by global
    edge key, so the host assembly reproduces the dense mesh EXACTLY --
    same vertex order, same face order, watertight seams by construction.

Where a neighbour block lives decides how its boundary slice travels: on
the same process, a device copy (peer to peer between two cards); on
another process, ``torch.distributed`` point-to-point. ``pick_transport``
chooses by an explicit rule and every sharded extraction names the
transport it used (``halo_exchange.last``).

The JAX package runs its kernels into fixed capacities and retries; the
CUDA kernel sizes its outputs from its own count pass, so the capacity
loop, the y-partition choice and the bucketed device slices have no
counterpart here, and piece files carry exact counts only.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import INVALID_SDF, VoxelUpdateOption
from ..grid import GridSpec, ShardedGridState, VoxelGridState
from ..mesh import Mesh as TriMesh
from ..ops.exact_fused import exact_fold
from ..ops.fusion_warp import warp_carve_centers
from ..ops.marching_cubes import check_engine
from ..ops.mc_fused import (
    McStreams,
    assemble_fused_streams,
    marching_cubes_fused,
)
from ..utils.timing import span
from .mesh_utils import (
    GRID_AXES,
    Block,
    BlockMesh,
    grid_sharding,
    mesh_grid_axes,
)

# the NCCL group over every rank, made by initialize_distributed when each
# rank has a card of its own; None otherwise (torch.distributed keeps its
# default group in module state of its own, and this sits beside it)
_NCCL_GROUP = None


def _grid_parts(mesh: BlockMesh) -> Tuple[int, int, int]:
    """(pz, py, px) shard counts; grid-named mesh axes only."""
    if mesh is None:
        raise ValueError("the sharded routines need a mesh")
    if not set(mesh.axis_names) <= set(GRID_AXES):
        raise ValueError(
            f"sharded routines need grid-named mesh axes {GRID_AXES}, "
            f"got {mesh.axis_names}"
        )
    return mesh_grid_axes(mesh)


def _as_sharded(state, mesh: BlockMesh) -> ShardedGridState:
    """``state`` as this process's blocks of ``mesh``: a sharded state as
    it is (it must be cut the same way), a dense one cut here."""
    parts = _grid_parts(mesh)
    if isinstance(state, ShardedGridState):
        if tuple(state.sharding.parts) != parts:
            raise ValueError(f"state is cut {state.sharding.parts}, the "
                             f"mesh {parts}")
        return state
    return ShardedGridState.from_dense(state, grid_sharding(mesh))


def _block_centers(grid: GridSpec, sh: ShardedGridState, block: Block,
                   device) -> Tuple[torch.Tensor, ...]:
    """(cx, cy, cz) of one block: its slices of the grid's centres."""
    sz, sy, sx = sh.sharding.slices(block, sh.shape)
    return tuple(
        torch.from_numpy(grid.axis_centers(a)[s].copy()).to(device)
        for a, s in ((0, sx), (1, sy), (2, sz)))


def _batched(w2c, *per_view):
    if w2c.ndim == 2:
        return (w2c[None], *(a[None] for a in per_view))
    return (w2c, *per_view)


class _PerDevice:
    """The view tensors on each block's device, copied once per device."""

    def __init__(self, *tensors):
        self._tensors = tensors
        self._on: Dict[torch.device, tuple] = {}

    def on(self, device) -> tuple:
        if device not in self._on:
            self._on[device] = tuple(
                None if t is None else t.to(device) for t in self._tensors)
        return self._on[device]


# ----------------------------------------------------------------------
# sharded fusion
# ----------------------------------------------------------------------


def carve_views_sharded(
    state,
    grid: GridSpec,
    w2c: torch.Tensor,
    principal_point: torch.Tensor,
    focal_length: torch.Tensor,
    sdf_images: torch.Tensor,
    roi: Optional[Tuple[int, int, int, int]] = None,
    opt: VoxelUpdateOption = VoxelUpdateOption(),
    mesh: Optional[BlockMesh] = None,
    projection: str = "pinhole",
) -> ShardedGridState:
    """Multi-view fusion through the exact engine, block by block.

    Zero-communication data parallelism over space: every voxel's update
    depends only on its own position plus the cameras and images. Any
    grid mesh rank (z / (z, y) / (z, y, x) blocks). ``state`` is a
    ``ShardedGridState`` or a dense state, which is cut first. Each block
    folds through ``exact_fold`` with its own axis centres: one launch of
    kernel E on a CUDA block, the plain fold on a CPU one."""
    sh = _as_sharded(state, mesh)
    w2c, principal_point, focal_length, sdf_images = _batched(
        w2c, principal_point, focal_length, sdf_images)
    _, h, w = sdf_images.shape
    if roi is None:
        roi = (0, 0, w - 1, h - 1)
    views = _PerDevice(w2c, principal_point, focal_length, sdf_images,
                       sdf_images.amax(dim=(1, 2)))
    blocks = {}
    for b, st in sh.blocks.items():
        dev = st.sdf.device
        sdf, un = exact_fold(st.sdf, st.update_num,
                             *_block_centers(grid, sh, b, dev),
                             *views.on(dev), roi, opt, projection)
        blocks[b] = VoxelGridState(sdf=sdf, update_num=un)
    return ShardedGridState(blocks, sh.sharding, sh.shape)


def carve_views_warp_sharded(
    state,
    grid: GridSpec,
    w2c: torch.Tensor,
    principal_point: torch.Tensor,
    focal_length: torch.Tensor,
    sdf_images: torch.Tensor,
    opt: VoxelUpdateOption = VoxelUpdateOption(),
    linear: bool = True,
    mesh: Optional[BlockMesh] = None,
    roi: Optional[Tuple[int, int, int, int]] = None,
    ortho_rows: Optional[torch.Tensor] = None,
) -> ShardedGridState:
    """Sharded multi-view fusion through the projective-warp engine.

    The warp is a per-voxel closed form in the (cx, cy, cz) centre
    vectors, so each block warps against its own per-axis centre slices
    -- still zero communication on ANY grid mesh rank, the same bits as
    the single-device warp engine restricted to the block. Each block
    takes the engine ``carve_views_warp`` would pick (the fused warp
    kernel whenever its launch plan takes the block's shapes, views of any
    height included, else the two-pass engine), and a block
    of more than 128 planes is fused z-chunk by z-chunk IN PLACE, as
    ``carve_views_warp_blocked`` does. ``roi`` is the reference's
    inclusive image-space (x0, y0, x1, y1) Carve window: purely
    image-space, so every block clamps its taps to the same window.
    ``ortho_rows``: the real camera-z rows of orthographic views, with
    ``ops.fusion_warp.ortho_homography``'s synthetic cameras."""
    sh = _as_sharded(state, mesh)
    w2c, principal_point, focal_length, sdf_images = _batched(
        w2c, principal_point, focal_length, sdf_images)
    views = _PerDevice(w2c, principal_point, focal_length, sdf_images,
                       ortho_rows)
    blocks = {}
    for b, st in sh.blocks.items():
        dev = st.sdf.device
        with span("warp"):
            *cams, z_rows = views.on(dev)
            sdf, un = warp_carve_centers(
                st.sdf, st.update_num, *_block_centers(grid, sh, b, dev),
                *cams, opt, linear, roi, chunk_nz=128, z_rows=z_rows)
        blocks[b] = VoxelGridState(sdf=sdf, update_num=un)
    return ShardedGridState(blocks, sh.sharding, sh.shape)


# ----------------------------------------------------------------------
# transports and the halo exchange
# ----------------------------------------------------------------------


class _DeviceCopy:
    """One process holds every block: a neighbour's slice is a device copy
    (``tensor.to(device)``, peer to peer between two cards), and there is
    no peer process to exchange with."""

    name = "device copy"

    def exchange(self, sends, recvs):
        if sends or recvs:
            raise RuntimeError("a mesh of one process has no peer to "
                               "exchange halos with")
        return []


class _P2P:
    """``torch.distributed`` point-to-point between processes, one batch
    per axis. ``staged``: CUDA slices go through pinned host memory (two
    ranks that share one card cannot use NCCL, which refuses a duplicate
    device, so they exchange over gloo, which moves host memory)."""

    def __init__(self, name: str, group=None, staged: bool = False):
        self.name, self.group, self.staged = name, group, staged

    def _host(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def exchange(self, sends, recvs):
        """Post every send ``(tensor, dst rank)`` and receive
        ``(shape, dtype, device, src rank)`` of one axis, wait for all,
        and return the received tensors on their devices. Both sides list
        their messages in the same global order, so the messages of one
        pair of ranks match up."""
        import torch.distributed as dist

        ops, bufs = [], []
        for t, dst in sends:
            t = t.contiguous()
            if self.staged and t.device.type == "cuda":
                t = self._host(t.shape, t.dtype).copy_(t)
            ops.append(dist.P2POp(dist.isend, t, dst, group=self.group))
        for shape, dtype, dev, src in recvs:
            stage = self.staged and torch.device(dev).type == "cuda"
            buf = (self._host(shape, dtype) if stage
                   else torch.empty(shape, dtype=dtype, device=dev))
            bufs.append((buf, dev))
            ops.append(dist.P2POp(dist.irecv, buf, src, group=self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [buf.to(dev) for buf, dev in bufs]


def pick_transport(mesh: BlockMesh):
    """How halo slices travel between the processes of ``mesh``, by rule:
    one process -> device copies only; CPU blocks -> gloo on the CPU
    tensors; CUDA blocks with an NCCL group (every rank has a card of its
    own: ``initialize_distributed`` made one, or the default group is
    NCCL) -> NCCL on the CUDA tensors; CUDA blocks otherwise -> gloo with
    the slices staged through pinned host memory. Never a retry with
    another transport."""
    import torch.distributed as dist

    if mesh.world_size == 1:
        return _DeviceCopy()
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh over several processes needs "
                           "initialize_distributed first")
    local = {d.type for d in mesh.devices if d is not None}
    if local == {"cpu"}:
        return _P2P("gloo")
    if _NCCL_GROUP is not None:
        return _P2P("nccl", group=_NCCL_GROUP)
    if dist.get_backend() == "nccl":
        return _P2P("nccl")
    return _P2P("gloo, host-staged: ranks share a card", staged=True)


def _barrier(mesh: BlockMesh) -> None:
    if mesh.world_size > 1:
        import torch.distributed as dist

        dist.barrier()


_FIELDS = (("sdf", float(INVALID_SDF)), ("update_num", 0))


def _fill_extended(raw: torch.Tensor, halos, upto: int) -> torch.Tensor:
    """``raw`` with the halo slabs of the axes below ``upto`` put around
    it, in (z, y, x) order: ``halos[d]`` is None for an unsharded axis or
    (prev, next), each as wide as the block extended over the axes before
    d and one voxel thick along d."""
    ext_axes = [d for d in range(upto) if halos[d] is not None]
    if not ext_axes:
        return raw
    shape = list(raw.shape)
    own = [slice(None)] * 3
    for d in ext_axes:
        own[d] = slice(1, shape[d] + 1)
        shape[d] += 2
    ext = raw.new_empty(shape)
    ext[tuple(own)] = raw
    for d in ext_axes:
        at = [slice(None)] * d + [None] + own[d + 1:]
        for side, slab in zip((slice(0, 1), slice(shape[d] - 1, shape[d])),
                              halos[d]):
            at[d] = side
            ext[tuple(at)] = slab
    return ext


def halo_exchange(sh: ShardedGridState):
    """The one-voxel halos of every local block, sequentially per axis.

    For each sharded grid axis in (z, y, x) order every block hands one
    boundary slice of its CURRENT block (already extended on the earlier
    axes) to each neighbour -- so a later axis's slices carry the earlier
    axes' halos along, and the extended block's edge and corner voxels
    (needed by MC's 4-cube edge adjacency, e.g. the cube based at
    (k-1, j-1, i)) arrive without diagonal sends. A block at the grid's
    boundary gets the InvalidSdf sentinel (update_num 0) instead: an
    out-of-grid neighbour IS an invalid voxel, so dense semantics hold.

    Only the slices are kept (``_fill_extended`` builds one block's
    extended copy when it is extracted), so the state is never held
    twice. Returns {block: {"sdf": [per axis None or (prev, next)],
    "update_num": ...}} and records bytes, milliseconds and the
    transport's name in ``halo_exchange.last``."""
    sharding = sh.sharding
    mesh = sharding.mesh
    parts = sharding.parts
    transport = pick_transport(mesh)
    lshape = sharding.block_shape(sh.shape)
    halos = {b: {f: [None, None, None] for f, _ in _FIELDS}
             for b in sh.blocks}
    dtypes = {"sdf": torch.float32, "update_num": torch.int32}
    moved = 0
    t0 = time.perf_counter()

    def boundary(b, field, dim, idx):
        """Slice ``idx`` along ``dim`` of block b extended over the axes
        before ``dim``."""
        raw = getattr(sh.blocks[b], field).narrow(dim, idx, 1)
        hs = [h if h is None else tuple(s.narrow(dim, idx, 1) for s in h)
              for h in halos[b][field]]
        return _fill_extended(raw, hs, dim)

    for dim in range(3):
        if parts[dim] == 1:
            continue
        slab_shape = [n + 2 if (d < dim and parts[d] > 1) else n
                      for d, n in enumerate(lshape)]
        slab_shape[dim] = 1
        sends, recvs, slots = [], [], []
        got: Dict[tuple, torch.Tensor] = {}
        for field, sentinel in _FIELDS:
            for b in sharding.blocks():
                mine = sharding.rank_of(b) == mesh.rank
                for side, step in ((0, -1), (1, 1)):
                    nb = list(b)
                    nb[dim] += step
                    nb = tuple(nb)
                    key = (field, b, side)
                    if not 0 <= nb[dim] < parts[dim]:
                        if mine:
                            dev = sharding.device_of(b)
                            got[key] = torch.full(
                                slab_shape, sentinel, dtype=dtypes[field],
                                device=dev)
                        continue
                    theirs = sharding.rank_of(nb) == mesh.rank
                    # the neighbour's last slice for my prev halo, its
                    # first for my next
                    idx = lshape[dim] - 1 if side == 0 else 0
                    if mine and theirs:
                        slab = boundary(nb, field, dim, idx)
                        got[key] = slab.to(sharding.device_of(b), copy=True)
                        moved += slab.numel() * slab.element_size()
                    elif theirs:
                        slab = boundary(nb, field, dim, idx)
                        sends.append((slab, sharding.rank_of(b)))
                        moved += slab.numel() * slab.element_size()
                    elif mine:
                        recvs.append((slab_shape, dtypes[field],
                                      sharding.device_of(b),
                                      sharding.rank_of(nb)))
                        slots.append(key)
        for key, t in zip(slots, transport.exchange(sends, recvs)):
            got[key] = t
        for b in sh.blocks:
            for field, _ in _FIELDS:
                halos[b][field][dim] = (got[(field, b, 0)],
                                        got[(field, b, 1)])
    for dev in {st.sdf.device for st in sh.blocks.values()}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    halo_exchange.last = {
        "bytes": moved, "ms": (time.perf_counter() - t0) * 1e3,
        "transport": transport.name}
    return halos


halo_exchange.last = {}


def _extended_centers(grid: GridSpec, sh: ShardedGridState, block: Block,
                      device):
    """(cx, cy, cz) of the halo-extended block: each sharded axis's slice
    of the grid's centres with its neighbours' boundary centres around it
    (c -+ 1 at the grid's boundary: a sentinel that a valid path never
    reads)."""
    parts = sh.sharding.parts
    out = []
    for dim, s in enumerate(sh.sharding.slices(block, sh.shape)):
        full = grid.axis_centers(2 - dim)
        c = full[s]
        if parts[dim] > 1:
            prev = full[s.start - 1] if s.start > 0 else c[0] - np.float32(1)
            nxt = (full[s.stop] if s.stop < len(full)
                   else c[-1] + np.float32(1))
            c = np.concatenate([[prev], c, [nxt]]).astype(np.float32)
        out.append(torch.from_numpy(np.ascontiguousarray(c)).to(device))
    cz, cy, cx = out
    return cx, cy, cz


def _extended_block(sh: ShardedGridState, halos, block: Block):
    st = sh.blocks[block]
    return tuple(
        _fill_extended(getattr(st, f), halos[block][f], 3).contiguous()
        for f, _ in _FIELDS)


# ----------------------------------------------------------------------
# sharded marching cubes
# ----------------------------------------------------------------------


def marching_cubes_fused_sharded(
    state,
    grid: GridSpec,
    iso_level: float = 0.0,
    linear_interp: bool = True,
    mesh: Optional[BlockMesh] = None,
) -> Dict[Block, McStreams]:
    """Sharded marching cubes through the FUSED kernel.

    Each block is extended by its halos (``halo_exchange``: one
    sequential exchange per sharded axis) and goes through
    ``ops.mc_fused.marching_cubes_fused``: the kernel's emission windows
    (own_k / own_j / own_i) silence every halo plane, row and lane, and
    the z / (y, x) bases make linear ids GLOBAL. A z-only mesh's streams,
    block after block, are already in global (z, y, x) order; multi-axis
    meshes interleave and the assembly restores order with a stable sort
    on the global ids (``assemble_fused_streams``) -- the mesh is
    byte-identical to the single-device extraction either way. Returns
    the streams of each local block; one extended copy of one block is
    alive at a time."""
    _grid_parts(mesh)
    sh = _as_sharded(state, mesh)
    nz, ny, nx = sh.shape
    if nz * ny * nx >= 2**31:
        raise ValueError("linear ids are int32: the global grid is too "
                         "large")
    halos = halo_exchange(sh)
    out = {}
    for b in sh.blocks:
        sdf_ext, un_ext = _extended_block(sh, halos, b)
        with span("mc_b"):
            out[b] = marching_cubes_fused(
                sdf_ext, un_ext,
                *_extended_centers(grid, sh, b, sdf_ext.device),
                float(iso_level), bool(linear_interp),
                **block_window(sh.sharding, sh.shape, b))
        del sdf_ext, un_ext
    return out


def marching_cubes_sharded(state, grid: GridSpec, iso_level: float = 0.0,
                           linear_interp: bool = True,
                           mesh: Optional[BlockMesh] = None):
    """The JAX package's name: the port has one engine, so this is
    ``marching_cubes_fused_sharded``."""
    return marching_cubes_fused_sharded(state, grid, iso_level,
                                        linear_interp, mesh)


def block_window(sharding, shape_zyx, block: Block) -> dict:
    """``marching_cubes_fused``'s window keywords for one halo-extended
    block: on each sharded axis the emission window skips the halo at
    local index 0 and l + 1, and the global coordinate of local
    (0, 0, 0) is the block's origin less that halo."""
    parts = sharding.parts
    lshape = sharding.block_shape(shape_zyx)
    own = [(1, n + 1) if p > 1 else None for p, n in zip(parts, lshape)]
    base = [i * n - (1 if p > 1 else 0)
            for i, p, n in zip(block, parts, lshape)]
    return dict(own_k=own[0], own_j=own[1], own_i=own[2], zb=base[0],
                yx_base=(base[1], base[2]), gdims=tuple(shape_zyx[1:]))


def _check_pieces(mesh: BlockMesh, piece_dir: Optional[str]) -> None:
    if mesh.world_size > 1 and piece_dir is None:
        # before any launch: the precondition is knowable at entry
        raise ValueError(
            "sharded extraction with multiple processes needs a piece_dir "
            "reachable from every host")


def extract_mesh_fused_sharded(
    state,
    grid: GridSpec,
    mesh: BlockMesh,
    iso_level: float = 0.0,
    linear_interp: bool = True,
    piece_dir: Optional[str] = None,
) -> Optional[TriMesh]:
    """Sharded fused-kernel MC -> the unsharded extraction's exact mesh.

    Single process: copies the per-block streams to the host and
    assembles them. Multi-process: every process writes its blocks' exact
    streams as a piece file under ``piece_dir``, and process 0
    concatenates the pieces in ascending block order and assembles
    (others return None)."""
    _check_pieces(mesh, piece_dir)
    parts = _grid_parts(mesh)
    sh = _as_sharded(state, mesh)
    streams = marching_cubes_fused_sharded(
        sh, grid, iso_level, linear_interp, mesh=mesh)
    # positions travel as their f32 bit patterns beside the i32 streams
    host = {
        sh.sharding.index(b): [
            t.cpu().numpy().view(np.int32) for t in st.as_tuple()[:8]]
        for b, st in streams.items()}
    _, ny, nx = sh.shape
    multi = parts[1] > 1 or parts[2] > 1
    if mesh.world_size > 1:
        pieces = _exchange_pieces(
            mesh, piece_dir, {f"k{k}_s{i}": s for k, ss in host.items()
                              for i, s in enumerate(ss)})
        if pieces is None:
            return None
        host = {k: [pieces[f"k{k}_s{i}"] for i in range(8)]
                for k in range(mesh.size)}
    cat = [np.concatenate([host[k][i] for k in range(mesh.size)])
           for i in range(8)]
    return assemble_fused_streams(
        [s.view(np.float32) for s in cat[0:6:2]],
        [s.astype(np.int64) for s in cat[1:6:2]], cat[6], cat[7], ny, nx,
        grid, sort=multi)


def _exchange_pieces(mesh: BlockMesh, piece_dir: str, payload: dict):
    """Multi-process finish: write this process's pieces to
    ``piece_dir/mc_fused_pieces_proc{rank}.npz``, barrier, and on process
    0 read every process's file and return their arrays by key (None
    elsewhere). The trailing barrier keeps a process that enters a second
    extraction from rewriting its file while process 0 still reads the
    first."""
    os.makedirs(piece_dir, exist_ok=True)
    np.savez(os.path.join(piece_dir, f"mc_fused_pieces_proc{mesh.rank}.npz"),
             **payload)
    _barrier(mesh)
    pieces = None
    if mesh.rank == 0:
        pieces = {}
        for p in range(mesh.world_size):
            f = os.path.join(piece_dir, f"mc_fused_pieces_proc{p}.npz")
            with np.load(f, allow_pickle=False) as z:
                for key in z.files:
                    pieces[key] = z[key]
    _barrier(mesh)
    return pieces


def extract_mesh_sharded(
    state,
    grid: GridSpec,
    mesh: BlockMesh,
    iso_level: float = 0.0,
    linear_interp: bool = True,
    piece_dir: Optional[str] = None,
    engine: str = "auto",
) -> Optional[TriMesh]:
    """Host wrapper: sharded MC -> the unsharded extraction's exact mesh,
    through ``extract_mesh_fused_sharded`` in any process count and on any
    grid mesh. ``engine`` is any of ``ops.marching_cubes.ENGINES``, the JAX
    package's names, which all name the one fused engine.

    Single process: gathers every block directly. Multi-process: each
    process writes ONLY its own blocks' streams as a piece file under
    ``piece_dir`` (a filesystem all hosts can reach), processes barrier,
    and process 0 assembles and returns the mesh (other processes return
    None)."""
    check_engine(engine)
    return extract_mesh_fused_sharded(
        state, grid, mesh, iso_level=iso_level, linear_interp=linear_interp,
        piece_dir=piece_dir)


# ----------------------------------------------------------------------
# process group
# ----------------------------------------------------------------------


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Process-group setup for runs of N >= 2 processes.

    ``torch.distributed.init_process_group`` over
    ``tcp://coordinator_address`` (HOST:PORT of process 0) with the gloo
    backend, which every host has and which carries the barriers and the
    CPU exchanges; nothing on a machine tells a process of a cluster, so
    all three arguments are required. Then, when every rank has a card of
    its own (the (host, ``rank % cards``) pairs are all distinct), an
    NCCL group over all ranks for the halo exchange between cards; ranks
    that share a card stay on gloo (``pick_transport``). After this,
    ``make_device_mesh`` spans all processes.

    One small collective primes each group NOW, while every process is
    aligned from the rendezvous, instead of inside the first fusion or
    halo exchange, where per-process skew would eat into its timeout."""
    import torch.distributed as dist

    global _NCCL_GROUP
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("initialize_distributed needs coordinator_address "
                         "(HOST:PORT), num_processes and process_id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    dist.all_reduce(torch.zeros(1))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    mine = (socket.gethostname(),
            int(process_id) % cards if cards else None)
    every: List = [None] * int(num_processes)
    dist.all_gather_object(every, mine)
    if (all(c is not None for _, c in every)
            and len(set(every)) == int(num_processes)):
        torch.cuda.set_device(mine[1])
        _NCCL_GROUP = dist.new_group(backend="nccl")
        dist.all_reduce(torch.zeros(1, device="cuda"), group=_NCCL_GROUP)
