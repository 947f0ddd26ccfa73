"""Fused marching cubes: the kernel's wrapper, its plain version, and the
host assembly (``vacancy_tpu/ops/mc_fused.py``).

The kernel (``csrc/mc_fused.cu``) replaces
``vacancy_tpu/ops/mc_fused.py::_mc_fused_kernel``. For every voxel it
decides the x/y/z canonical-edge flags (the edge straddles the iso level
and one of its 4 adjacent cubes is valid) with the vertex position along
the edge, and the active-cube flag (valid cube, case not 0 or 255) with
the case index; each of the four streams is compacted in flat (z, y, x)
order. A count pass, a scan over tiles and an emit pass into exactly
sized buffers take the place of the TPU kernel's shift ladder and
capacity retry. ``mc_streams_plain`` computes the same streams densely in
PyTorch, compacted by boolean-mask indexing (which yields flat order).

The triangle table never enters the kernel: the host expands each active
cube's faces from its (lin, case) pair and resolves each corner's
canonical-edge key against the per-axis vertex streams by searchsorted,
so vertex and face order equal the JAX package's exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _kernels
from ..config import INVALID_SDF
from ..grid import GridSpec
from ..mesh import Mesh
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


def mc_streams_plain(
    sdf: torch.Tensor,  # f32[nz, ny, nx]
    un: torch.Tensor,  # i32[nz, ny, nx]
    cx: torch.Tensor,
    cy: torch.Tensor,
    cz: torch.Tensor,
    iso_level: float = 0.0,
    linear_interp: bool = True,
) -> McStreams:
    """The fused MC kernel's plain version: dense flags over the grid,
    compacted by boolean-mask indexing (reference semantics
    marching_cubes.cc:25-57, 88-133)."""
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
        lins.append(lin.to(torch.int32))
    mc = flags[3].reshape(-1)
    return McStreams(
        pos[0], lins[0], pos[1], lins[1], pos[2], lins[2],
        torch.nonzero(mc).squeeze(1).to(torch.int32),
        case.reshape(-1)[mc],
        plane_counts,
    )


def marching_cubes_fused(
    sdf: torch.Tensor,  # f32[nz, ny, nx]
    un: torch.Tensor,  # i32[nz, ny, nx]
    cx: torch.Tensor,  # f32[nx]
    cy: torch.Tensor,  # f32[ny]
    cz: torch.Tensor,  # f32[nz]
    iso_level: float = 0.0,
    linear_interp: bool = True,
) -> McStreams:
    """The four compacted MC streams plus per-plane counts.

    CPU tensors take the plain version. CUDA tensors run the kernel's
    count, scan and emit passes (``marching_cubes_fused.launches`` counts
    each such run), reading the four totals back once to size the
    outputs, or raise on inputs the kernel does not take or a non-zero
    cudaError_t."""
    if sdf.device.type == "cpu":
        return mc_streams_plain(sdf, un, cx, cy, cz, iso_level, linear_interp)
    nz, ny, nx = sdf.shape
    _kernels.check_tensor("sdf", sdf, torch.float32, (nz, ny, nx))
    _kernels.check_tensor("update_num", un, torch.int32, (nz, ny, nx))
    _kernels.check_tensor("cx", cx, torch.float32, (nx,))
    _kernels.check_tensor("cy", cy, torch.float32, (ny,))
    _kernels.check_tensor("cz", cz, torch.float32, (nz,))
    if nz * ny * nx >= 2**31:
        raise ValueError("linear ids are int32: the grid is too large")
    dev = sdf.device
    lib = _kernels.load()
    stream = _kernels.stream_ptr(dev)
    n_tiles = nz * lib.vt_mc_tiles(ny, nx)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    tile_counts, tile_offsets = i32(n_tiles, 4), i32(n_tiles, 4)
    totals, plane_counts = i32(4), i32(nz, 4)
    geom = (sdf.data_ptr(), un.data_ptr(), cx.data_ptr(), cy.data_ptr(),
            cz.data_ptr(), nz, ny, nx, float(np.float32(iso_level)),
            int(bool(linear_interp)))
    _kernels.check(
        lib.vt_mc_count_scan(
            *geom, tile_counts.data_ptr(), tile_offsets.data_ptr(),
            totals.data_ptr(), plane_counts.data_ptr(), stream,
        ),
        "mc_fused count/scan launch",
    )
    ne, ny_, nz_, nc = totals.tolist()
    outs = []
    for n in (ne, ny_, nz_):
        outs += [torch.empty(n, dtype=torch.float32, device=dev), i32(n)]
    outs += [i32(nc), i32(nc)]
    _kernels.check(
        lib.vt_mc_emit(
            *geom, tile_offsets.data_ptr(), *(o.data_ptr() for o in outs),
            stream,
        ),
        "mc_fused emit launch",
    )
    marching_cubes_fused.launches += 1
    return McStreams(*outs, plane_counts)


marching_cubes_fused.launches = 0


_EDGE_OFF_XYZ = CORNER_OFFSETS[EDGE_OWNER]  # [12, 3] (dx, dy, dz)


def _expand_faces(
    clin: np.ndarray,
    ccase: np.ndarray,
    ny: int,
    nx: int,
    vlin_by_axis,
    bases,
) -> np.ndarray:
    """Expand active cubes into faces on the host.

    Cube-major then slot order with the reference's reversed winding
    (vertex j reads table slot 3t + (2 - j), marching_cubes.cc:199-218);
    each corner's canonical-edge key (axis, owner lin) resolves to a
    global vertex id by binary search over the per-axis lin streams."""
    ntri = TRI_COUNT[ccase]
    total = int(ntri.sum())
    if total == 0:
        return np.zeros((0, 3), np.int32)
    starts_excl = np.concatenate([[0], np.cumsum(ntri, dtype=np.int64)])
    off_lin = (
        _EDGE_OFF_XYZ[:, 2].astype(np.int64) * (ny * nx)
        + _EDGE_OFF_XYZ[:, 1] * nx
        + _EDGE_OFF_XYZ[:, 0]
    )  # [12]
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


def assemble_fused_streams(vpos_parts, vlin_parts, clin, ccase,
                           ny: int, nx: int, grid: GridSpec) -> Mesh:
    """Host assembly of the compacted streams (numpy, flat (z, y, x) order
    per stream): the interpolated coordinate comes from the kernel, the
    two fixed coordinates are recomputed from the owner id, and faces
    expand from (cube id, case) pairs."""
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
    faces = _expand_faces(clin, ccase, ny, nx, vlin_parts, bases)
    return Mesh(vertices=verts, faces=faces)
