"""Marching cubes of a fused state (marching_cubes.cc:25-228).

A cube is the 2x2x2 block of voxels at base voxel (k, j, i); it is valid
when no corner holds the sentinel and its corner 6 (k+1, j+1, i+1) has
been updated. Each vertex lies on a canonical grid edge (axis, owner
voxel), shared by the four cubes around it, and exists when the edge
straddles the iso level and one of those cubes is valid. Vertices come
axis-major, then in flat (z, y, x) order of their owner; the coordinate
along the edge is interpolated with the reference's 1e-5 snapping.
Faces come cube-major, then in table order with the winding reversed
(vertex j of a triangle is table slot 3t + 2 - j).
"""

import numpy as np
import torch

from .geometry import INVALID_SDF
from .mc_tables import (CORNER_OFFSETS, EDGE_AXIS, EDGE_OWNER, TRI_COUNT,
                        TRI_TABLE)

SNAP_EPS = np.float32(1e-5)


def _interp(s0, s1, p0, p1, iso):
    dev = s0.device

    def f32(v):
        return torch.tensor(np.float32(v), device=dev)

    iso_t, eps = f32(iso), f32(SNAP_EPS)
    denom = s1 - s0
    mu = torch.where(torch.abs(denom) < eps, f32(0.0), (iso_t - s0) / denom)
    t = torch.where(torch.abs(iso_t - s0) < eps, f32(0.0), mu)
    t = torch.where(torch.abs(iso_t - s1) < eps, f32(1.0), t)
    return p0 + t * (p1 - p0)


def _flags(sdf, un, iso):
    """The x/y/z-edge vertex flags and the active-cube flag per voxel,
    and the case index of the cube based there."""
    nz, ny, nx = sdf.shape
    dev = sdf.device
    iso_t = torch.tensor(np.float32(iso), device=dev)
    pad = torch.full((nz + 1, ny + 1, nx + 1), INVALID_SDF,
                     dtype=torch.float32, device=dev)
    pad[:nz, :ny, :nx] = sdf
    corners = [pad[dz:dz + nz, dy:dy + ny, dx:dx + nx]
               for dx, dy, dz in CORNER_OFFSETS.tolist()]
    inside = [c < iso_t for c in corners]
    case = torch.zeros((nz, ny, nx), dtype=torch.int32, device=dev)
    for q in range(8):
        case |= inside[q].to(torch.int32) << q
    valid = corners[0] != INVALID_SDF
    for c in corners[1:]:
        valid &= c != INVALID_SDF
    del corners, pad
    updated = torch.zeros((nz + 1, ny + 1, nx + 1), dtype=torch.bool,
                          device=dev)
    updated[:nz, :ny, :nx] = un >= 1
    cube = valid & updated[1:, 1:, 1:]
    del valid, updated
    cpad = torch.zeros((nz + 1, ny + 1, nx + 1), dtype=torch.bool,
                       device=dev)
    cpad[1:, 1:, 1:] = cube

    def at(dk, dj, di):  # validity of cube (k+dk, j+dj, i+di)
        return cpad[1 + dk:1 + dk + nz, 1 + dj:1 + dj + ny,
                    1 + di:1 + di + nx]

    jj = torch.arange(ny, device=dev).reshape(1, ny, 1)
    ii = torch.arange(nx, device=dev).reshape(1, 1, nx)
    fx = ((inside[0] != inside[1]) & (ii < nx - 1)
          & (at(-1, -1, 0) | at(-1, 0, 0) | at(0, -1, 0) | cube))
    fy = ((inside[0] != inside[3]) & (jj < ny - 1)
          & (at(-1, 0, -1) | at(-1, 0, 0) | at(0, 0, -1) | cube))
    fz = ((inside[0] != inside[4])
          & (at(0, -1, -1) | at(0, -1, 0) | at(0, 0, -1) | cube))
    active = cube & (case != 0) & (case != 255)
    return (fx, fy, fz, active), case


def extract(sdf, un, cx, cy, cz, iso=0.0):
    """(vertices float32 [N, 3], faces int32 [M, 3]) as numpy arrays;
    ``cx``, ``cy``, ``cz`` are the voxel centres (numpy float32)."""
    nz, ny, nx = sdf.shape
    dev = sdf.device
    flags, case = _flags(sdf, un, iso)
    flat = sdf.reshape(-1)
    steps = (1, nx, ny * nx)
    sizes = (nx, ny, nz)
    centers = [torch.from_numpy(c).to(dev) for c in (cx, cy, cz)]
    lins, coords = [], []
    for a in range(3):
        lin = torch.nonzero(flags[a].reshape(-1)).squeeze(1)
        idx = (lin // steps[a]) % sizes[a]
        p0 = centers[a][idx]
        p1 = centers[a][torch.clamp_max(idx + 1, sizes[a] - 1)]
        coords.append(_interp(flat[lin], flat[lin + steps[a]], p0, p1,
                              iso).cpu().numpy())
        lins.append(lin.cpu().numpy())
    active = torch.nonzero(flags[3].reshape(-1)).squeeze(1)
    clin = active.cpu().numpy()
    ccase = case.reshape(-1)[active].cpu().numpy()
    del flags, case

    axes_c = (cx, cy, cz)
    verts = []
    for a in range(3):
        lin = lins[a]
        comp = [axes_c[0][lin % nx], axes_c[1][(lin // nx) % ny],
                axes_c[2][lin // (nx * ny)]]
        comp[a] = coords[a]
        verts.append(np.stack(comp, axis=-1).astype(np.float32))
    verts = np.concatenate(verts) if verts else np.zeros((0, 3), np.float32)
    return verts, _faces(clin, ccase, ny, nx, lins)


def _faces(clin, ccase, ny, nx, lins):
    ntri = TRI_COUNT[ccase].astype(np.int64)
    total = int(ntri.sum())
    if total == 0:
        return np.zeros((0, 3), np.int32)
    off = CORNER_OFFSETS[EDGE_OWNER].astype(np.int64)  # [12, (dx, dy, dz)]
    edge_lin = off[:, 2] * (ny * nx) + off[:, 1] * nx + off[:, 0]
    first = np.concatenate([[0], np.cumsum(ntri)[:-1]])
    cube = np.repeat(np.arange(len(ccase)), ntri)
    slot = np.arange(total) - np.repeat(first, ntri)
    rows = TRI_TABLE[ccase[cube]]
    base = clin[cube].astype(np.int64)
    bases = np.cumsum([0, len(lins[0]), len(lins[1])])
    faces = np.empty((total, 3), np.int64)
    for j in range(3):
        e = rows[np.arange(total), 3 * slot + 2 - j]
        key = base + edge_lin[e]
        ax = EDGE_AXIS[e]
        for a in range(3):
            sel = ax == a
            faces[sel, j] = bases[a] + np.searchsorted(lins[a], key[sel])
    return faces.astype(np.int32)
