"""Fused marching cubes: the kernel's wrapper, its plain version, and the
host assembly (``vacancy_tpu/ops/mc_fused.py``).

The kernel (``csrc/mc_fused.cu``) replaces
``vacancy_tpu/ops/mc_fused.py::_mc_fused_kernel``. For every voxel it
decides the x/y/z canonical-edge flags (the edge straddles the iso level
and one of its 4 adjacent cubes is valid) with the vertex position along
the edge, and the active-cube flag (valid cube, case not 0 or 255) with
the case index; each of the four streams is compacted in flat (z, y, x)
order. A count pass, a scan over tiles (block sums, a scan of those, the
tiles of each block) and an emit pass into exactly sized buffers, which
leaves a tile without flags after reading its offsets, take the place of
the TPU kernel's shift ladder and capacity retry. ``mc_streams_plain``
computes the same streams densely in PyTorch, compacted by boolean-mask
indexing (which yields flat order).
The count and scan passes have wrappers of their own (``mc_tile_counts``,
``mc_scan``) with plain versions beside them, so each pass can be held
against its plain version alone.

A sharded caller (``parallel/sharded.py``) hands over a halo-extended
LOCAL block with the JAX kernel's keywords: ``own_k`` / ``own_j`` /
``own_i`` are (lo, hi) windows on local planes, rows and lanes outside
which nothing is emitted (every mask still reads the halo voxels), and
``zb``, ``yx_base`` = (yb, xb) and ``gdims`` = (NY, NX) of the global grid
turn the linear ids into GLOBAL ones. With the defaults the streams are
the unsharded ones.

The triangle table never enters kernel B: the streams carry each active
cube's (lin, case) pair, and the faces are expanded from it afterwards,
each corner's canonical-edge key resolved against the per-axis vertex
streams by binary search, so vertex and face order equal the JAX
package's exactly. On a CUDA state the kernels of ``ops/mesh_assembly.py``
do that on the card. On the host ``assemble_fused_streams`` does it, for
a CPU state and for the sharded extraction (``parallel/sharded.py``),
whose streams cross processes as host pieces: its faces come from
``expand_faces`` (the C++ single pass of ``io/native.py``, with the numpy
``_expand_faces`` as its plain version), and with ``native=False`` it is
the plain version the card's assembly is held against.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..config import INVALID_SDF
from ..grid import GridSpec
from ..io.native import native_expand_faces
from ..mesh import Mesh
from ..utils.timing import span
from .mc_tables import (
    CORNER_OFFSETS,
    EDGE_AXIS,
    EDGE_OWNER,
    TRI_COUNT,
    TRI_TABLE,
)

_SNAP_EPS = np.float32(1e-5)  # reference marching_cubes.cc:28-39


def _edge_vertex_interp(
    s0: torch.Tensor,
    s1: torch.Tensor,
    p0: torch.Tensor,
    p1: torch.Tensor,
    iso: float,
) -> torch.Tensor:
    """1D vertex interpolation along a grid edge with the reference's
    epsilon snapping (marching_cubes.cc:25-57). Positions differ only in
    the edge-axis coordinate, so only that scalar is interpolated."""
    dev = s0.device

    def f32(v):
        return torch.tensor(np.float32(v), device=dev)

    iso_t, eps = f32(iso), f32(_SNAP_EPS)
    denom = s1 - s0
    mu = torch.where(torch.abs(denom) < eps, f32(0.0), (iso_t - s0) / denom)
    t = torch.where(torch.abs(iso_t - s0) < eps, f32(0.0), mu)
    t = torch.where(torch.abs(iso_t - s1) < eps, f32(1.0), t)
    return p0 + t * (p1 - p0)


@dataclasses.dataclass
class McStreams:
    """Compacted kernel output, each stream in flat (z, y, x) order."""

    vx_pos: torch.Tensor  # f32[Nx] x coordinate of each x-edge vertex
    vx_lin: torch.Tensor  # i32[Nx] owner voxel's flat id
    vy_pos: torch.Tensor
    vy_lin: torch.Tensor
    vz_pos: torch.Tensor
    vz_lin: torch.Tensor
    c_lin: torch.Tensor  # i32[Nc] active cube's base voxel flat id
    c_case: torch.Tensor  # i32[Nc] its case index (1..254)
    plane_counts: torch.Tensor  # i32[nz, 4] x/y/z-edge and cube counts

    def as_tuple(self):
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def _dense_flags(sdf, un, iso_level: float):
    """Dense per-voxel flags of the four streams, the case index and the
    adjacent-cube validities the no-interp rule reads (reference
    semantics marching_cubes.cc:88-133)."""
    nz, ny, nx = sdf.shape
    dev = sdf.device
    inv = float(INVALID_SDF)
    iso = torch.tensor(np.float32(iso_level), device=dev)

    # out-of-grid corners are invalid voxels
    sp = torch.full((nz + 1, ny + 1, nx + 1), inv, dtype=torch.float32,
                    device=dev)
    sp[:nz, :ny, :nx] = sdf
    corners = [
        sp[dz : dz + nz, dy : dy + ny, dx : dx + nx]
        for dx, dy, dz in CORNER_OFFSETS.tolist()
    ]
    inside = [c < iso for c in corners]
    case = torch.zeros((nz, ny, nx), dtype=torch.int32, device=dev)
    for q in range(8):
        case |= inside[q].to(torch.int32) << q
    valid = corners[0] != inv
    for c in corners[1:]:
        valid &= c != inv
    # the cube's corner 6 = (k+1, j+1, i+1) must have update_num >= 1
    upd = torch.zeros((nz + 1, ny + 1, nx + 1), dtype=torch.bool,
                      device=dev)
    upd[:nz, :ny, :nx] = un >= 1
    cv = valid & upd[1:, 1:, 1:]

    cvp = torch.zeros((nz + 1, ny + 1, nx + 1), dtype=torch.bool, device=dev)
    cvp[1:, 1:, 1:] = cv

    def cube(dk, dj, di):  # validity of cube (k+dk, j+dj, i+di), d <= 0
        return cvp[1 + dk : 1 + dk + nz, 1 + dj : 1 + dj + ny,
                   1 + di : 1 + di + nx]

    p_0, p_jm, p_im = cube(-1, 0, 0), cube(-1, -1, 0), cube(-1, 0, -1)
    v_jm, v_im, v_jmim = cube(0, -1, 0), cube(0, 0, -1), cube(0, -1, -1)
    jj = torch.arange(ny, device=dev).reshape(1, ny, 1)
    ii = torch.arange(nx, device=dev).reshape(1, 1, nx)
    flags = (
        (inside[0] != inside[1]) & (ii < nx - 1) & (p_jm | p_0 | v_jm | cv),
        (inside[0] != inside[3]) & (jj < ny - 1) & (p_im | p_0 | v_im | cv),
        (inside[0] != inside[4]) & (v_jmim | v_jm | v_im | cv),
        cv & (case != 0) & (case != 255),
    )
    return flags, case, (cv, p_0, p_jm, p_im, v_jm, v_im)


Window = Optional[Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class _Emission:
    """Which voxels of a local array emit, and the global ids they get:
    the (lo, hi) windows per local (k, j, i), the global coordinate of
    local (0, 0, 0) and the global plane dims."""

    lo: Tuple[int, int, int]
    hi: Tuple[int, int, int]
    base: Tuple[int, int, int]  # (zb, yb, xb)
    gny: int
    gnx: int

    def as_ints(self):
        """The 11 ints of csrc/mc_fused.cu's ``win`` argument."""
        return (self.lo[0], self.hi[0], self.lo[1], self.hi[1], self.lo[2],
                self.hi[2], *self.base, self.gny, self.gnx)


def _emission(shape, own_k: Window, own_j: Window, own_i: Window, zb: int,
              yx_base, gdims) -> _Emission:
    """Validate the JAX kernel's window keywords against the local
    ``shape``. Linear ids are int32, so the largest id an owned voxel can
    get -- an id of the GLOBAL grid -- must stay below 2**31."""
    wins = []
    for name, w, n in zip(("own_k", "own_j", "own_i"),
                          (own_k, own_j, own_i), shape):
        lo, hi = (0, n) if w is None else (int(w[0]), int(w[1]))
        if not 0 <= lo <= hi <= n:
            raise ValueError(f"{name}={w} outside the local extent {n}")
        wins.append((lo, hi))
    yb, xb = (0, 0) if yx_base is None else (int(yx_base[0]),
                                             int(yx_base[1]))
    gny, gnx = shape[1:] if gdims is None else (int(gdims[0]), int(gdims[1]))
    base = (int(zb), yb, xb)
    top = [hi - 1 + b for (_, hi), b in zip(wins, base)]
    bottom = [lo + b for (lo, _), b in zip(wins, base)]
    if all(lo < hi for lo, hi in wins):
        if min(bottom) < 0 or top[1] >= gny or top[2] >= gnx:
            raise ValueError(
                f"owned voxels {wins} at base {base} leave the global "
                f"plane {gny}x{gnx}")
        if (top[0] * gny + top[1]) * gnx + top[2] >= 2**31:
            raise ValueError("linear ids are int32: the global grid is too "
                             "large")
    return _Emission(tuple(w[0] for w in wins), tuple(w[1] for w in wins),
                     base, gny, gnx)


def _owned_mask(em: _Emission, shape, device) -> torch.Tensor:
    """bool[nz, ny, nx]: the voxels inside the emission window."""
    axes = []
    for d, n in enumerate(shape):
        i = torch.arange(n, device=device)
        view = [1, 1, 1]
        view[d] = n
        axes.append(((i >= em.lo[d]) & (i < em.hi[d])).reshape(view))
    return axes[0] & axes[1] & axes[2]


def _windowed_flags(sdf, un, iso_level, em: _Emission):
    """``_dense_flags`` with the four flags cleared outside the window."""
    flags, case, cubes = _dense_flags(sdf, un, iso_level)
    if em.lo != (0, 0, 0) or em.hi != tuple(sdf.shape):
        owned = _owned_mask(em, sdf.shape, sdf.device)
        flags = tuple(f & owned for f in flags)
    return flags, case, cubes


def mc_streams_plain(
    sdf: torch.Tensor,  # f32[nz, ny, nx]
    un: torch.Tensor,  # i32[nz, ny, nx]
    cx: torch.Tensor,
    cy: torch.Tensor,
    cz: torch.Tensor,
    iso_level: float = 0.0,
    linear_interp: bool = True,
    own_k: Window = None,
    own_j: Window = None,
    own_i: Window = None,
    zb: int = 0,
    yx_base: Optional[Tuple[int, int]] = None,
    gdims: Optional[Tuple[int, int]] = None,
) -> McStreams:
    """The fused MC kernel's plain version: dense flags over the grid,
    compacted by boolean-mask indexing (reference semantics
    marching_cubes.cc:25-57, 88-133). The window keywords as in the
    module docstring: flags outside the window are cleared after every
    mask was computed array-locally, and the emitted ids are global."""
    nz, ny, nx = sdf.shape
    em = _emission(sdf.shape, own_k, own_j, own_i, zb, yx_base, gdims)
    flags, case, (cv, p_0, p_jm, p_im, v_jm, v_im) = _windowed_flags(
        sdf, un, iso_level, em)
    plane_counts = torch.stack(
        [f.sum(dim=(1, 2)) for f in flags], dim=1
    ).to(torch.int32)

    flat = sdf.reshape(-1)
    steps = (1, nx, ny * nx)  # flat stride to the +axis neighbour
    centers = (cx, cy, cz)
    pos, lins = [], []
    for a in range(3):
        m = flags[a].reshape(-1)
        lin = torch.nonzero(m).squeeze(1)
        idx = (lin // steps[a]) % (nx, ny, nz)[a]
        p0 = centers[a][idx]
        if linear_interp:
            p1 = centers[a][torch.clamp_max(idx + 1, len(centers[a]) - 1)]
            pos.append(_edge_vertex_interp(
                flat[lin], flat[lin + steps[a]], p0, p1, iso_level
            ))
        elif a == 2:
            pos.append(p0)  # z-edges take the lower end
        else:
            p1 = centers[a][idx + 1]
            # first cube referencing the edge in scan order: x-edge roles
            # U,L,U,L over (k-1,j-1) (k-1,j) (k,j-1) (k,j); y-edge roles
            # L,U,L,U over (k-1,i-1) (k-1,i) (k,i-1) (k,i)
            if a == 0:
                c0, c1, c2 = p_jm, p_0, v_jm
                up = c0 | (~c0 & ~c1 & c2)
            else:
                c0, c1, c2 = p_im, p_0, v_im
                up = (~c0 & c1) | (~c0 & ~c1 & ~c2 & cv)
            pos.append(torch.where(up.reshape(-1)[m], p1, p0))
        lins.append(_global_lin(lin, ny, nx, em))
    mc = flags[3].reshape(-1)
    return McStreams(
        pos[0], lins[0], pos[1], lins[1], pos[2], lins[2],
        _global_lin(torch.nonzero(mc).squeeze(1), ny, nx, em),
        case.reshape(-1)[mc],
        plane_counts,
    )


def _global_lin(lin: torch.Tensor, ny: int, nx: int,
                em: _Emission) -> torch.Tensor:
    """Local flat ids i64 -> the global grid's flat ids i32."""
    if em.base != (0, 0, 0) or (em.gny, em.gnx) != (ny, nx):
        k, rem = lin // (ny * nx), lin % (ny * nx)
        lin = (((k + em.base[0]) * em.gny + (rem // nx + em.base[1]))
               * em.gnx + (rem % nx + em.base[2]))
    return lin.to(torch.int32)


# voxels per tile of csrc/mc_fused.cu (TILE): a tile is a run of
# consecutive voxels of one plane, the unit of the count and scan passes
TILE = 1024


# tiles per block of the scan pass (SCAN_BLOCK): each block sums, then
# scans, its own tiles; one CTA scans the block sums between the two
SCAN_BLOCK = 1024


def tiles_per_plane(ny: int, nx: int) -> int:
    return -(-(ny * nx) // TILE)


def scan_blocks(n_tiles: int) -> int:
    """Blocks (CTAs) of the scan pass over ``n_tiles`` tiles; its scratch
    array holds four int32 for each."""
    return -(-n_tiles // SCAN_BLOCK)


def _check_state(sdf, un, cx, cy, cz):
    nz, ny, nx = sdf.shape
    if sdf.numel() >= 2**31:
        raise ValueError(f"the MC kernel indexes a state with int32: "
                         f"{nz}x{ny}x{nx} voxels are too many")
    _kernels.check_tensor("sdf", sdf, torch.float32, (nz, ny, nx))
    _kernels.check_tensor("update_num", un, torch.int32, (nz, ny, nx))
    _kernels.check_tensor("cx", cx, torch.float32, (nx,))
    _kernels.check_tensor("cy", cy, torch.float32, (ny,))
    _kernels.check_tensor("cz", cz, torch.float32, (nz,))


def _geometry_args(sdf, un, cx, cy, cz, iso_level, linear_interp,
                   em: _Emission):
    nz, ny, nx = sdf.shape
    return (sdf.data_ptr(), un.data_ptr(), cx.data_ptr(), cy.data_ptr(),
            cz.data_ptr(), nz, ny, nx, float(np.float32(iso_level)),
            int(bool(linear_interp)), (ctypes.c_int * 11)(*em.as_ints()))


def mc_tile_counts_plain(sdf, un, iso_level: float = 0.0,
                         own_k: Window = None, own_j: Window = None,
                         own_i: Window = None) -> torch.Tensor:
    """The count pass's plain version: the dense flags (inside the
    emission window) summed over each tile,
    i32[nz * tiles_per_plane, 4]."""
    nz, ny, nx = sdf.shape
    tpp = tiles_per_plane(ny, nx)
    em = _emission(sdf.shape, own_k, own_j, own_i, 0, None, None)
    flags, _, _ = _windowed_flags(sdf, un, iso_level, em)
    per = torch.stack([f.reshape(nz, ny * nx) for f in flags], dim=2)
    per = torch.nn.functional.pad(per.to(torch.int32),
                                  (0, 0, 0, tpp * TILE - ny * nx))
    return per.reshape(nz * tpp, TILE, 4).sum(dim=1).to(torch.int32)


def mc_tile_counts(sdf, un, cx, cy, cz, iso_level: float = 0.0,
                   linear_interp: bool = True, own_k: Window = None,
                   own_j: Window = None, own_i: Window = None,
                   zb: int = 0, yx_base=None, gdims=None) -> torch.Tensor:
    """Pass 1 of the fused MC kernel: each stream's flags counted per
    tile, i32[nz * tiles_per_plane, 4]; the window keywords as in
    ``marching_cubes_fused``. CPU tensors take the plain version; CUDA
    tensors launch the count pass (``mc_tile_counts.launches``) or
    raise."""
    if sdf.device.type == "cpu":
        return mc_tile_counts_plain(sdf, un, iso_level, own_k, own_j, own_i)
    _check_state(sdf, un, cx, cy, cz)
    em = _emission(sdf.shape, own_k, own_j, own_i, zb, yx_base, gdims)
    nz, ny, nx = sdf.shape
    lib = _kernels.load()
    if lib.vt_mc_tiles(ny, nx) != tiles_per_plane(ny, nx):
        # the kernel writes one row of counts per tile of ITS size
        raise RuntimeError("TILE differs from csrc/mc_fused.cu's")
    counts = torch.empty((nz * tiles_per_plane(ny, nx), 4),
                         dtype=torch.int32, device=sdf.device)
    _kernels.check(
        lib.vt_mc_count(
            *_geometry_args(sdf, un, cx, cy, cz, iso_level, linear_interp,
                            em),
            counts.data_ptr(), _kernels.stream_ptr(sdf.device)),
        "mc_fused count launch")
    mc_tile_counts.launches += 1
    return counts


mc_tile_counts.launches = 0


def mc_scan_plain(tile_counts: torch.Tensor, tpp: int):
    """The scan pass's plain version, by ``torch.cumsum``: (exclusive
    offsets i32[n_tiles, 4], totals i32[4], per-plane counts i32[nz, 4])
    of ``tile_counts`` i32[nz * tpp, 4]."""
    incl = torch.cumsum(tile_counts, dim=0, dtype=torch.int32)
    return (incl - tile_counts, incl[-1].clone(),
            tile_counts.reshape(-1, tpp, 4).sum(dim=1).to(torch.int32))


def mc_scan(tile_counts: torch.Tensor, tpp: int):
    """Pass 2 of the fused MC kernel on its own: the exclusive offset of
    every tile per stream, the four totals and the per-plane counts of
    ``tile_counts`` i32[nz * tpp, 4]. CPU tensors take the plain version;
    CUDA tensors launch the scan's kernels over ``scan_blocks(n_tiles)``
    blocks (``mc_scan.launches`` counts each such scan) or raise."""
    if tile_counts.device.type == "cpu":
        return mc_scan_plain(tile_counts, tpp)
    n_tiles = tile_counts.shape[0]
    _kernels.check_tensor("tile_counts", tile_counts, torch.int32,
                          (n_tiles, 4))
    if tpp < 1 or n_tiles < 1 or n_tiles % tpp:
        raise ValueError(f"{n_tiles} tiles are not planes of {tpp} tiles")
    dev = tile_counts.device
    nz = n_tiles // tpp
    lib = _kernels.load()
    if lib.vt_mc_scan_blocks(n_tiles) != scan_blocks(n_tiles):
        raise RuntimeError("SCAN_BLOCK differs from csrc/mc_fused.cu's")
    offsets = torch.empty_like(tile_counts)
    totals = torch.empty(4, dtype=torch.int32, device=dev)
    plane_counts = torch.empty((nz, 4), dtype=torch.int32, device=dev)
    scratch = torch.empty((scan_blocks(n_tiles), 4), dtype=torch.int32,
                          device=dev)
    _kernels.check(
        lib.vt_mc_scan(
            tile_counts.data_ptr(), offsets.data_ptr(), totals.data_ptr(),
            plane_counts.data_ptr(), n_tiles, tpp, nz, scratch.data_ptr(),
            _kernels.stream_ptr(dev)),
        "mc_fused scan launch")
    mc_scan.launches += 1
    return offsets, totals, plane_counts


mc_scan.launches = 0


def mc_emit(sdf, un, cx, cy, cz, tile_offsets: torch.Tensor, totals,
            iso_level: float = 0.0, linear_interp: bool = True,
            own_k: Window = None, own_j: Window = None, own_i: Window = None,
            zb: int = 0, yx_base=None, gdims=None):
    """Pass 3 of the fused MC kernel on CUDA tensors: the count pass's
    flags again, each written at its rank into buffers of exactly
    ``totals`` (four host ints: x/y/z-edge and cube counts) elements, from
    the scan's exclusive ``tile_offsets``; a tile whose offsets equal the
    next tile's (the totals, for the last) has no flag and is left at
    once. The window keywords must be the count pass's. Returns the eight
    stream tensors, or raises."""
    _check_state(sdf, un, cx, cy, cz)
    em = _emission(sdf.shape, own_k, own_j, own_i, zb, yx_base, gdims)
    dev = sdf.device
    _kernels.check_tensor("tile_offsets", tile_offsets, torch.int32,
                          (sdf.shape[0] * tiles_per_plane(*sdf.shape[1:]), 4))

    def i32(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    totals = [int(t) for t in totals]
    ne, ny_, nz_, nc = totals
    outs = []
    for n in (ne, ny_, nz_):
        outs += [torch.empty(n, dtype=torch.float32, device=dev), i32(n)]
    outs += [i32(nc), i32(nc)]
    _kernels.check(
        _kernels.load().vt_mc_emit(
            *_geometry_args(sdf, un, cx, cy, cz, iso_level, linear_interp,
                            em),
            tile_offsets.data_ptr(), (ctypes.c_int * 4)(*totals),
            *(o.data_ptr() for o in outs),
            _kernels.stream_ptr(dev),
        ),
        "mc_fused emit launch",
    )
    return outs


def marching_cubes_fused(
    sdf: torch.Tensor,  # f32[nz, ny, nx]
    un: torch.Tensor,  # i32[nz, ny, nx]
    cx: torch.Tensor,  # f32[nx]
    cy: torch.Tensor,  # f32[ny]
    cz: torch.Tensor,  # f32[nz]
    iso_level: float = 0.0,
    linear_interp: bool = True,
    own_k: Window = None,
    own_j: Window = None,
    own_i: Window = None,
    zb: int = 0,
    yx_base: Optional[Tuple[int, int]] = None,
    gdims: Optional[Tuple[int, int]] = None,
) -> McStreams:
    """The four compacted MC streams plus per-plane counts.

    ``own_k`` / ``own_j`` / ``own_i``: (lo, hi) emission windows on the
    local planes, rows and lanes (None: all); ``zb`` and ``yx_base`` =
    (yb, xb): the global coordinate of local (0, 0, 0); ``gdims`` = (NY,
    NX) of the global grid, for the linear ids and nothing else (module
    docstring). ``plane_counts`` stays per LOCAL plane.

    CPU tensors take the plain version. CUDA tensors run the kernel's
    count, scan and emit passes (``marching_cubes_fused.launches`` counts
    each such run), reading the four totals back once to size the
    outputs, or raise on inputs the kernel does not take or a non-zero
    cudaError_t. ``marching_cubes_fused.cubes`` adds up the active cubes
    emitted: the fourth of those totals, or the plain cube stream's
    length."""
    window = (own_k, own_j, own_i, zb, yx_base, gdims)
    if sdf.device.type == "cpu":
        st = mc_streams_plain(sdf, un, cx, cy, cz, iso_level, linear_interp,
                              *window)
        marching_cubes_fused.cubes += len(st.c_case)
        return st
    _check_state(sdf, un, cx, cy, cz)
    nz, ny, nx = sdf.shape
    tile_counts = mc_tile_counts(sdf, un, cx, cy, cz, iso_level,
                                 linear_interp, *window)
    tile_offsets, totals, plane_counts = mc_scan(
        tile_counts, tiles_per_plane(ny, nx))
    totals = totals.tolist()
    outs = mc_emit(sdf, un, cx, cy, cz, tile_offsets, totals,
                   iso_level, linear_interp, *window)
    marching_cubes_fused.launches += 1
    marching_cubes_fused.cubes += totals[3]
    return McStreams(*outs, plane_counts)


marching_cubes_fused.launches = 0
marching_cubes_fused.cubes = 0


_EDGE_OFF_XYZ = CORNER_OFFSETS[EDGE_OWNER]  # [12, 3] (dx, dy, dz)


def _expand_faces(
    clin: np.ndarray,
    ccase: np.ndarray,
    ny: int,
    nx: int,
    vlin_by_axis,
    bases,
) -> np.ndarray:
    """Expand active cubes into faces on the host, in numpy: the plain
    version of the native expansion.

    Cube-major then slot order with the reference's reversed winding
    (vertex j reads table slot 3t + (2 - j), marching_cubes.cc:199-218);
    each corner's canonical-edge key (axis, owner lin) resolves to a
    global vertex id by binary search over the per-axis lin streams."""
    ntri = TRI_COUNT[ccase]
    total = int(ntri.sum())
    if total == 0:
        return np.zeros((0, 3), np.int32)
    starts_excl = np.concatenate([[0], np.cumsum(ntri, dtype=np.int64)])
    off_lin = _edge_off_lin(ny, nx)
    cube_idx = np.repeat(np.arange(len(ccase), dtype=np.int64), ntri)
    slot = np.arange(total, dtype=np.int64) - np.repeat(starts_excl[:-1], ntri)
    rows = TRI_TABLE[ccase[cube_idx]]  # [T, 16]
    base_lin = clin[cube_idx].astype(np.int64)
    faces = np.empty((total, 3), np.int32)
    tt = np.arange(total)
    for j in range(3):
        e = rows[tt, 3 * slot + (2 - j)]
        ax = EDGE_AXIS[e]
        key = base_lin + off_lin[e]
        fid = np.zeros(total, np.int64)
        for a in range(3):
            sel = ax == a
            fid[sel] = bases[a] + np.searchsorted(vlin_by_axis[a], key[sel])
        faces[:, j] = fid
    return faces


def _edge_off_lin(ny: int, nx: int) -> np.ndarray:
    """i64[12]: each cube edge's owner voxel as a flat-id offset from the
    cube's base voxel."""
    return (
        _EDGE_OFF_XYZ[:, 2].astype(np.int64) * (ny * nx)
        + _EDGE_OFF_XYZ[:, 1] * nx
        + _EDGE_OFF_XYZ[:, 0]
    )


def expand_faces(clin, ccase, ny: int, nx: int, vlin_by_axis, bases,
                 native: bool = True) -> np.ndarray:
    """Active cubes -> i32[total, 3] faces: the C++ single pass of
    ``io/native.py`` (which raises if the library cannot be built), or,
    for a caller that passes ``native=False``, its plain version
    ``_expand_faces``. Both give the same bytes."""
    if not native:
        return _expand_faces(clin, ccase, ny, nx, vlin_by_axis, bases)
    starts = np.concatenate(
        [[0], np.cumsum(TRI_COUNT[ccase], dtype=np.int64)])
    if starts[-1] == 0:
        return np.zeros((0, 3), np.int32)
    return native_expand_faces(clin, ccase, starts, TRI_TABLE, EDGE_AXIS,
                               _edge_off_lin(ny, nx), vlin_by_axis)


def assemble_fused_streams(vpos_parts, vlin_parts, clin, ccase,
                           ny: int, nx: int, grid: GridSpec,
                           native: bool = True, sort: bool = False) -> Mesh:
    """Host assembly of the compacted streams (numpy, flat (z, y, x) order
    per stream): the interpolated coordinate comes from the kernel, the
    two fixed coordinates are recomputed from the owner id, and faces
    expand from (cube id, case) pairs (``expand_faces``).

    A z-sharded caller concatenates its blocks' streams in ascending z,
    which is that order already. The blocks of a multi-axis mesh
    interleave in y and x: such a caller passes ``sort=True``, and since
    each block's sub-stream ascends in its global owner id (unique per
    stream), a stable argsort by id restores the dense order exactly."""
    with span("assemble"):
        if sort:
            vpos_parts, vlin_parts = list(vpos_parts), list(vlin_parts)
            for a in range(3):
                order = np.argsort(vlin_parts[a], kind="stable")
                vlin_parts[a] = np.asarray(vlin_parts[a])[order]
                vpos_parts[a] = np.asarray(vpos_parts[a])[order]
            order = np.argsort(clin, kind="stable")
            clin, ccase = np.asarray(clin)[order], np.asarray(ccase)[order]
        centers = [grid.axis_centers(a) for a in range(3)]
        bases = np.cumsum([0] + [len(v) for v in vlin_parts[:2]])
        verts = np.empty((sum(len(v) for v in vlin_parts), 3), np.float32)
        at = 0
        for a in range(3):
            lin = np.asarray(vlin_parts[a], np.int64)
            n = len(lin)
            i = lin % nx
            j = (lin // nx) % ny
            kk = lin // (nx * ny)
            comps = [centers[0][i], centers[1][j], centers[2][kk]]
            comps[a] = vpos_parts[a]
            verts[at : at + n] = np.stack(comps, axis=-1)
            at += n
        with span("expand_faces"):
            faces = expand_faces(clin, ccase, ny, nx, vlin_parts, bases,
                                 native)
        return Mesh(vertices=verts, faces=faces)
