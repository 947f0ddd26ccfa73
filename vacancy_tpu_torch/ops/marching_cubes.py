"""Marching-cubes extraction (``vacancy_tpu/ops/marching_cubes.py``).

Every vertex lies on a unique canonical grid edge ``(axis, owner voxel)``
(the edge from a voxel centre to its +axis neighbour), so vertices are
welded by construction and their order is structural: axis-major, then
flat (z, y, x) order of the owner voxel. Faces come cube-major, then by
table slot.

``extract_mesh`` has two engines that give the same mesh:

  * ``"fused"`` (and ``"auto"``): the fused marching-cubes kernel
    (``ops/mc_fused.py``; its plain version on a CPU state) and the host
    assembly;
  * ``"xla"``: the JAX package's dense and z-slab routines as plain torch
    ops on the state's device. ``marching_cubes_dense`` handles the whole
    grid in one set of grid-shaped temporaries; ``extract_mesh_blocked``
    is a host loop over z-slabs for grids past ``_DENSE_MAX_VOXELS``,
    where each slab owns the edges whose owner voxel lies in its z-range
    and the cubes based there, and faces name their vertices by global
    edge key ``(axis, owner flat id)``, resolved on the host by a per-axis
    searchsorted. Torch sizes every output from its count, so the JAX
    routines' fixed capacities and retry loops have no counterpart.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import INVALID_SDF
from ..grid import GridSpec, VoxelGridState
from ..mesh import Mesh
from ..utils.timing import span
from .mc_fused import (
    _edge_vertex_interp,
    assemble_fused_streams,
    marching_cubes_fused,
)
from .mc_tables import (
    CORNER_OFFSETS,
    EDGE_AXIS,
    EDGE_OWNER,
    TRI_COUNT,
    TRI_TABLE,
)


def _corner_view(vol: torch.Tensor, c: int) -> torch.Tensor:
    """View of ``vol`` at cube corner c over the cube lattice
    [Z-1, Y-1, X-1]: cube (k, j, i) has its base corner at voxel
    (k, j, i), and corner c sits at voxel (k+dz, j+dy, i+dx)."""
    dx, dy, dz = (int(v) for v in CORNER_OFFSETS[c])
    nz, ny, nx = vol.shape
    return vol[dz : dz + nz - 1, dy : dy + ny - 1, dx : dx + nx - 1]


def _pad_last(t: torch.Tensor, dim: int, value) -> torch.Tensor:
    """``t`` with one more slice of ``value`` at the end of ``dim``."""
    shape = list(t.shape)
    shape[dim] = 1
    return torch.cat([t, t.new_full(shape, value)], dim=dim)


def _mc_geometry(
    sdf: torch.Tensor,  # f32[nz, ny, nx] (a slab may include halo planes)
    un: torch.Tensor,  # i32[nz, ny, nx]
    centers: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # cx, cy, cz
    iso_level: float,
    linear_interp: bool,
):
    """Shared geometry core: (cube_valid bool[cz, cy, cx], case
    i32[cz, cy, cx], vflags 3 x bool[nz, ny, nx], pvars 3 x f32[nz, ny, nx]:
    per axis, the vertex coordinate along that axis per owner voxel)."""
    nz, ny, nx = sdf.shape
    inv = float(INVALID_SDF)

    # --- cube validity (marching_cubes.cc:88-112) ---
    corner_sdf = [_corner_view(sdf, c) for c in range(8)]
    all_valid = corner_sdf[0] != inv
    for c in range(1, 8):
        all_valid = all_valid & (corner_sdf[c] != inv)
    # corner 6 is the reference's centre voxel
    cube_valid = all_valid & (_corner_view(un, 6) >= 1)

    # --- case index (marching_cubes.cc:121-128) ---
    case = torch.zeros(cube_valid.shape, dtype=torch.int32, device=sdf.device)
    for c in range(8):
        case |= (corner_sdf[c] < iso_level).to(torch.int32) << c

    cube_valid_pad = torch.nn.functional.pad(cube_valid, (1, 1, 1, 1, 1, 1))

    def adjacent_cube(axis: int, a_: int, b_: int) -> torch.Tensor:
        """Validity of one of the 4 cubes adjacent to each ``axis``-edge,
        bool[nz, ny, nx] aligned with the edge's owner voxel. For an
        x-edge the cubes vary over (z, y) = owner + (a_-1, b_-1); for a
        y-edge over (z, x); for a z-edge over (y, x)."""
        if axis == 0:
            return cube_valid_pad[a_ : a_ + nz, b_ : b_ + ny, 1 : 1 + nx]
        if axis == 1:
            return cube_valid_pad[a_ : a_ + nz, 1 : 1 + ny, b_ : b_ + nx]
        return cube_valid_pad[1 : 1 + nz, a_ : a_ + ny, b_ : b_ + nx]

    vflags, pvars = [], []
    for axis in range(3):
        dim = 2 - axis  # array dim of this axis
        n = sdf.shape[dim]
        s0, s1 = sdf.narrow(dim, 0, n - 1), sdf.narrow(dim, 1, n - 1)
        straddle = (s0 < iso_level) != (s1 < iso_level)
        shape = [1, 1, 1]
        shape[dim] = n - 1
        p0 = centers[axis][: n - 1].reshape(shape)
        p1 = centers[axis][1:].reshape(shape)
        cubes = [adjacent_cube(axis, a_, b_)
                 for a_, b_ in ((0, 0), (0, 1), (1, 0), (1, 1))]
        if linear_interp:
            pvar = _edge_vertex_interp(s0, s1, p0, p1, iso_level)
        elif axis == 2:
            # z-edges always take the lower end (edges 8-11 point +z)
            pvar = p0.expand(s0.shape)
        else:
            # No-interp parity (marching_cubes.cc:49-57 + the dedup map):
            # the reference stores the position from whichever cube FIRST
            # references the edge in (z, y, x) scan order, and the edge's
            # role in that cube fixes which end that is: x-edges see roles
            # (upper, lower, upper, lower) over their 4 adjacent cubes in
            # scan order, y-edges (lower, upper, lower, upper).
            c = [q.narrow(dim, 0, n - 1) for q in cubes]
            if axis == 0:
                use_upper = c[0] | (~c[0] & ~c[1] & c[2])
            else:
                use_upper = (~c[0] & c[1]) | (~c[0] & ~c[1] & ~c[2] & c[3])
            pvar = torch.where(use_upper, p1, p0)
        # the last slice along the axis owns no edge
        adjacent = cubes[0] | cubes[1] | cubes[2] | cubes[3]
        vflags.append(_pad_last(straddle, dim, False) & adjacent)
        pvars.append(_pad_last(pvar.expand(s0.shape), dim, 0.0))
    return cube_valid, case, vflags, pvars


def _vertex_positions(src: torch.Tensor, n_vox: int, shape, centers, pvars):
    """(x, y, z) of the vertices whose (axis, owner voxel) ids are
    ``src`` = axis * n_vox + local flat id: the owner's centre, with the
    coordinate along the edge's axis taken from ``pvars``."""
    _, ny, nx = shape
    axis_of = src // n_vox
    lin = src - axis_of * n_vox
    idx = (lin % nx, (lin // nx) % ny, lin // (nx * ny))
    pv = torch.cat([p.reshape(-1) for p in pvars])[src]
    return tuple(torch.where(axis_of == a, pv, centers[a][idx[a]])
                 for a in range(3))


def _edge_off_lin(ny: int, nx: int, device) -> torch.Tensor:
    """i64[12]: each cube edge's owner voxel as a flat-id offset from the
    cube's base voxel."""
    off = CORNER_OFFSETS[EDGE_OWNER].astype(np.int64)  # [12, 3] (dx, dy, dz)
    return torch.from_numpy(off[:, 2] * (ny * nx) + off[:, 1] * nx
                            + off[:, 0]).to(device)


def _face_edges(cube_valid, case, owned=None):
    """The faces of the valid (and ``owned``) cubes in cube-major then
    slot order: (flat cube-lattice index i64[F] of each face's cube, and
    per corner j its cube edge i64[F], with the reference's reversed
    winding: vertex j reads table slot 3t + (2 - j),
    marching_cubes.cc:199-218)."""
    dev = case.device
    ntri = torch.from_numpy(TRI_COUNT).to(dev)[case] * cube_valid
    if owned is not None:
        ntri = ntri * owned
    ntri = ntri.reshape(-1)
    cubes = torch.nonzero(ntri).squeeze(1)
    cnt = ntri[cubes].to(torch.int64)
    f_cube = torch.repeat_interleave(cubes, cnt)
    starts = torch.cumsum(cnt, 0) - cnt
    f_slot = (torch.arange(f_cube.numel(), device=dev)
              - torch.repeat_interleave(starts, cnt))
    rows = torch.from_numpy(TRI_TABLE).to(dev)[case.reshape(-1)[f_cube]]
    edges = [rows.gather(1, (3 * f_slot + (2 - j))[:, None]).squeeze(1)
             .to(torch.int64) for j in range(3)]
    return f_cube, edges


def marching_cubes_dense(
    state: VoxelGridState,
    grid: GridSpec,
    iso_level: float = 0.0,
    linear_interp: bool = True,
):
    """Marching cubes over the full grid on the state's device.

    Returns ``((vx, vy, vz), n_vertices, (fa, fb, fc), n_faces)``: the
    vertex position components f32[n_vertices] and the per-face vertex
    ids i32[n_faces], component-separated as the JAX routine returns them
    and sized by the counts."""
    sdf, un = state.sdf, state.update_num
    nz, ny, nx = sdf.shape
    n_vox = nz * ny * nx
    dev = sdf.device
    centers = tuple(grid.axis_centers_t(a, dev) for a in range(3))
    cube_valid, case, vflags, pvars = _mc_geometry(
        sdf, un, centers, float(iso_level), linear_interp)

    # global vertex ids: cumsum over (axis, z, y, x) order
    flags_flat = torch.cat([f.reshape(-1) for f in vflags])
    vid_flat = torch.cumsum(flags_flat, 0, dtype=torch.int32) - 1
    src = torch.nonzero(flags_flat).squeeze(1)
    vcomps = _vertex_positions(src, n_vox, sdf.shape, centers, pvars)

    f_cube, edges = _face_edges(cube_valid, case)
    cy, cx = ny - 1, nx - 1
    f_cz = f_cube // (cy * cx)
    f_rem = f_cube - f_cz * (cy * cx)
    f_cy = f_rem // cx
    base_lin = f_cz * (ny * nx) + f_cy * nx + (f_rem - f_cy * cx)
    edge_axis = torch.from_numpy(EDGE_AXIS).to(dev).to(torch.int64)
    edge_off = _edge_off_lin(ny, nx, dev)
    fcomps = tuple(
        vid_flat[edge_axis[e] * n_vox + base_lin + edge_off[e]]
        for e in edges
    )
    return vcomps, src.numel(), fcomps, f_cube.numel()


# ---------------------------------------------------------------------------
# z-slab blocked routine (grids past the dense budget)
# ---------------------------------------------------------------------------


def marching_cubes_slab(
    sdf: torch.Tensor,  # f32[nz, ny, nx] UNPADDED grid state
    un: torch.Tensor,  # i32[nz, ny, nx]
    grid: GridSpec,
    slice_lo: int,  # global z of the first owned-candidate plane
    own_lo: int,  # first owned voxel z
    own_hi: int,  # one past the last owned voxel z
    slab_nz: int,
    iso_level: float = 0.0,
    linear_interp: bool = True,
    edge: str = "middle",
):
    """One z-slab of marching cubes, emitting global edge keys.

    The slab sees voxel planes ``[slice_lo - 1, slice_lo + slab_nz]`` and
    *owns* the edges whose owner voxel z is in ``[own_lo, own_hi)`` plus
    the cubes based there. The state is taken UNPADDED (an 8.6 GB state
    at 1024^3 cannot afford a padded copy); the missing halo plane of a
    boundary slab is made in the slab: ``edge="bottom"`` slices from plane
    0 and puts an INVALID plane below it, ``edge="top"`` slices up to the
    last plane and puts an INVALID plane above it.

    Returns ``(v_counts, v_pos, v_lin, n_faces, f_ax, f_lin)``: per axis
    a, the vertex count, position components and owner flat ids,
    compacted in (z, y, x) order; the face count and, per corner, the
    (axis, owner flat id) global edge keys in cube-major order -- the
    order in which ``_assemble_slab_parts`` rebuilds the dense routine's
    mesh exactly."""
    nz, ny, nx = sdf.shape
    s_nz = slab_nz + 2  # local voxel planes including the halo
    dev = sdf.device
    cz_full = grid.axis_centers_t(2, dev)
    inv = float(INVALID_SDF)

    def halo(t, value):
        return t.new_full((1,) + tuple(t.shape[1:]), value)

    if edge == "bottom":
        sl = slice(0, s_nz - 1)
        sl_sdf = torch.cat([halo(sdf, inv), sdf[sl]])
        sl_un = torch.cat([halo(un, 0), un[sl]])
        cz_sl = torch.cat([halo(cz_full, 0.0), cz_full[sl]])
    elif edge == "top":
        sl = slice(nz - s_nz + 1, nz)
        sl_sdf = torch.cat([sdf[sl], halo(sdf, inv)])
        sl_un = torch.cat([un[sl], halo(un, 0)])
        cz_sl = torch.cat([cz_full[sl], halo(cz_full, 0.0)])
    elif edge == "middle":
        sl = slice(slice_lo - 1, slice_lo - 1 + s_nz)
        sl_sdf, sl_un, cz_sl = sdf[sl], un[sl], cz_full[sl]
    else:
        raise ValueError(f"unknown edge mode {edge!r}")

    return _slab_emit(
        sl_sdf, sl_un,
        (grid.axis_centers_t(0, dev), grid.axis_centers_t(1, dev), cz_sl),
        slice_lo, own_lo, own_hi, float(iso_level), linear_interp)


def _slab_emit(
    sl_sdf: torch.Tensor,  # f32[s_nz, ny, nx]: the slab with its halo planes
    sl_un: torch.Tensor,  # i32[s_nz, ny, nx]
    centers: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # cx, cy, cz_sl
    slice_lo: int,  # local plane i is global z = slice_lo - 1 + i
    own_lo: int,
    own_hi: int,
    iso_level: float,
    linear_interp: bool,
):
    """The slab-emission core shared by the z-slab routine above and the
    z-sharded routine (``parallel/sharded.py``, whose blocks arrive with
    their halo planes exchanged): see ``marching_cubes_slab`` for the
    ownership rule and the returned tuple."""
    s_nz, ny, nx = sl_sdf.shape
    dev = sl_sdf.device
    cube_valid, case, vflags, pvars = _mc_geometry(
        sl_sdf, sl_un, centers, float(iso_level), linear_interp)

    # global z of local voxel plane i: slice_lo - 1 + i
    gz = torch.arange(s_nz, device=dev) + (slice_lo - 1)
    owned_plane = (gz >= own_lo) & (gz < own_hi)
    lin_shift = (slice_lo - 1) * (ny * nx)  # local flat id -> global
    n_loc = s_nz * ny * nx

    v_counts, v_pos, v_lin = [], [], []
    for a in range(3):
        flag = (vflags[a] & owned_plane[:, None, None]).reshape(-1)
        src = torch.nonzero(flag).squeeze(1)
        v_counts.append(src.numel())
        v_pos.append(_vertex_positions(src + a * n_loc, n_loc, sl_sdf.shape,
                                       centers, pvars))
        v_lin.append((src + lin_shift).to(torch.int32))

    f_cube, edges = _face_edges(cube_valid, case,
                                owned_plane[:-1, None, None])
    cy, cx = ny - 1, nx - 1
    f_cz = f_cube // (cy * cx)
    f_rem = f_cube - f_cz * (cy * cx)
    f_cy = f_rem // cx
    cube_lin = (f_cz * (ny * nx) + f_cy * nx + (f_rem - f_cy * cx)
                + lin_shift)
    edge_axis = torch.from_numpy(EDGE_AXIS).to(dev)
    edge_off = _edge_off_lin(ny, nx, dev)
    f_ax = tuple(edge_axis[e] for e in edges)
    f_lin = tuple((cube_lin + edge_off[e]).to(torch.int32) for e in edges)
    return (tuple(v_counts), tuple(v_pos), tuple(v_lin), f_cube.numel(),
            f_ax, f_lin)


def _assemble_slab_parts(pos_parts, lin_parts, face_parts) -> Mesh:
    """Assemble slab emissions into the dense routine's exact mesh.

    pos_parts/lin_parts: per axis, lists (ascending z) of [n_k, 3] / [n_k]
    arrays; face_parts: list of (axis [m, 3], owner flat id [m, 3]) in
    cube-major order. Vertex order: axis-major then ascending owner id (=
    the dense cumsum order); faces resolve via per-axis searchsorted."""
    axis_lin = [
        np.concatenate(lin_parts[a]) if lin_parts[a]
        else np.zeros((0,), np.int32)
        for a in range(3)
    ]
    axis_pos = [
        np.concatenate(pos_parts[a]) if pos_parts[a]
        else np.zeros((0, 3), np.float32)
        for a in range(3)
    ]
    bases = np.cumsum([0, len(axis_lin[0]), len(axis_lin[1])])
    verts = np.concatenate(axis_pos)

    if face_parts:
        f_ax = np.concatenate([p[0] for p in face_parts])
        f_lin = np.concatenate([p[1] for p in face_parts])
    else:
        f_ax = np.zeros((0, 3), np.int32)
        f_lin = np.zeros((0, 3), np.int32)
    faces = np.zeros(f_ax.shape, np.int32)
    for a in range(3):
        sel = f_ax == a
        faces[sel] = bases[a] + np.searchsorted(axis_lin[a], f_lin[sel])
    return Mesh(vertices=verts, faces=faces)


def _stack_host(comps) -> np.ndarray:
    """Device vectors -> one host array [n, len(comps)]."""
    return torch.stack(list(comps), dim=-1).cpu().numpy()


def extract_mesh_blocked(
    state: VoxelGridState,
    grid: GridSpec,
    iso_level: float = 0.0,
    linear_interp: bool = True,
    slab_nz: int = 48,
) -> Mesh:
    """Marching cubes via a host loop over z-slabs.

    Produces the identical mesh (same vertex and face order) as the dense
    routine: slab vertex blocks concatenate per axis into the global
    (axis, z, y, x) order, and face edge keys resolve to vertex ids with
    a per-axis searchsorted over the owner-id arrays, sorted by
    construction."""
    nz, ny, nx = state.sdf.shape
    if nz <= slab_nz + 2:
        return _extract_mesh_dense(state, grid, iso_level, linear_interp)
    pos_parts = [[], [], []]  # per axis: list of [n_k, 3] arrays
    lin_parts = [[], [], []]
    face_parts = []  # list of (ax [m, 3], lin [m, 3])
    for own_lo in range(0, nz, slab_nz):
        own_hi = min(own_lo + slab_nz, nz)
        # keep the slice in range; the ownership masks handle the overlap
        slice_lo = min(own_lo, nz - slab_nz)
        edge = ("bottom" if own_lo == 0 else "top" if own_hi == nz
                else "middle")
        _, vp, vl, _, fa, fl = marching_cubes_slab(
            state.sdf, state.update_num, grid, slice_lo, own_lo, own_hi,
            slab_nz=slab_nz, iso_level=float(iso_level),
            linear_interp=bool(linear_interp), edge=edge,
        )
        for a in range(3):
            pos_parts[a].append(_stack_host(vp[a]))
            lin_parts[a].append(vl[a].cpu().numpy())
        face_parts.append((_stack_host(fa), _stack_host(fl)))
    return _assemble_slab_parts(pos_parts, lin_parts, face_parts)


# grids past this size get the blocked routine: the dense routine holds
# some twenty grid-shaped temporaries
_DENSE_MAX_VOXELS = 24_000_000


def _pick_slab_nz(nz: int, ny: int, nx: int, default: int = 48) -> int:
    """Slab height keeping per-slab temporaries within the dense budget.

    A flat wide grid (e.g. 32 x 2048 x 2048) needs a much smaller slab
    than the default 48 for slab-shaped temporaries to fit; a slab only
    helps at all when nz > slab_nz + 2 (the slab plus its two halo
    planes), so the returned value also caps at nz - 3."""
    by_mem = max(1, _DENSE_MAX_VOXELS // max(1, ny * nx))
    return max(1, min(default, by_mem, nz - 3))


def _extract_mesh_dense(state, grid, iso_level, linear_interp) -> Mesh:
    vcomps, _, fcomps, _ = marching_cubes_dense(
        state, grid, iso_level=float(iso_level),
        linear_interp=bool(linear_interp))
    return Mesh(vertices=_stack_host(vcomps), faces=_stack_host(fcomps))


def _extract_mesh_fused(state, grid, iso_level, linear_interp) -> Mesh:
    nz, ny, nx = state.sdf.shape
    dev = state.sdf.device
    with span("mc_b"):
        st = marching_cubes_fused(
            state.sdf, state.update_num, grid.axis_centers_t(0, dev),
            grid.axis_centers_t(1, dev), grid.axis_centers_t(2, dev),
            iso_level, linear_interp,
        )
    with span("stream_copy"):
        host = [t.cpu().numpy() for t in st.as_tuple()[:8]]
        vpos_parts = host[0:6:2]
        vlin_parts = [v.astype(np.int64) for v in host[1:6:2]]
    return assemble_fused_streams(
        vpos_parts, vlin_parts, host[6], host[7], ny, nx, grid
    )


def extract_mesh(
    state: VoxelGridState,
    grid: GridSpec,
    iso_level: float = 0.0,
    linear_interp: bool = True,
    engine: str = "auto",
) -> Mesh:
    """The iso-surface of ``state`` as a host ``Mesh``.

    engine="auto" and "fused" run the fused marching-cubes kernel on a
    CUDA state (its plain version on a CPU state), copy the four streams
    to the host once and assemble them there; "xla" runs the dense routine
    in plain torch, or the z-slab blocked routine for a grid past
    ``_DENSE_MAX_VOXELS`` (a grid too flat to z-block stays dense). The
    engines give the identical mesh."""
    if engine not in ("auto", "fused", "xla"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine != "xla":
        return _extract_mesh_fused(state, grid, iso_level, linear_interp)
    nz, ny, nx = state.sdf.shape
    if nz * ny * nx > _DENSE_MAX_VOXELS:
        slab = _pick_slab_nz(nz, ny, nx)
        if nz > slab + 2:
            return extract_mesh_blocked(state, grid, iso_level,
                                        linear_interp, slab_nz=slab)
    return _extract_mesh_dense(state, grid, iso_level, linear_interp)
