"""The exact engine's fused fold: kernel E's wrapper and its plain version.

The kernel (``csrc/exact_fused.cu``) replaces no TPU kernel: the JAX
package folds the exact engine's views in plain ``jnp``, and so does
``ops/fusion.fold_views``, with some ninety eager launches a view. One
launch of E folds every view of a call: a CTA owns 32 x by ``TILE_Y``
rows of ``VPT`` consecutive z-planes; each thread loads its ``VPT``
voxels' state once, computes their centres from the grid's axis arrays,
folds every view in order with the state in registers, and stores the
state once into new tensors (see the source's header for what bounds it
and what the design does about it). ``exact_plan`` gives the launch's
grid; ``exact_refusal`` names what E cannot take (more than 65535 CTAs
along y or z, an image of 2**31 pixels or more, a ROI outside the image).

Its plain version, ``exact_fold_plain``, stacks the centres and runs
``fusion.fold_views``. Float expressions keep that fold's operation
order, and the kernel is built without FMA contraction, so the two agree
bit for bit. The wrapper ``exact_fold`` runs the plain version for CPU
tensors and only for them; on a CUDA tensor it launches E or raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .. import _kernels
from ..config import (SdfInterpolation, UpdateOutsideImage, VoxelUpdate,
                      VoxelUpdateOption)
from . import fusion  # which imports this module: use at call time

# the tiling of csrc/exact_fused.cu: a CTA of THREADS threads owns TILE_X
# consecutive x (one warp) by TILE_Y rows (one per warp); a thread owns
# VPT consecutive z-planes of its (y, x) column
TILE_X = 32
TILE_Y = 8
VPT = 8
THREADS = TILE_X * TILE_Y
# registers a thread may use (__launch_bounds__(256, 4): four CTAs per SM)
REGISTER_BUDGET = 64
# floats of one view's coefficients: three w2c rows, f, the principal
# point and the image's max, padded to five float4s
COEFS = 20
# the kernel offsets a tap within an image by a 32-bit signed int
MAX_IMAGE_PIXELS = 2**31 - 1
# a launch grid's y and z dimensions
MAX_GRID_YZ = 65535


def exact_refusal(nz: int, ny: int, nx: int, h: int, w: int,
                  roi: Tuple[int, int, int, int]) -> Optional[str]:
    """What kernel E cannot take in a launch over ``nz x ny x nx`` voxels
    with views of ``h x w`` pixels and the inclusive ``roi`` (x0, y0, x1,
    y1), or None when it takes it."""
    if min(nz, ny, nx, h, w) < 1:
        return f"an empty state or views: {(nz, ny, nx)}, {h} x {w} pixels"
    if h * w > MAX_IMAGE_PIXELS:
        return (f"images of {h} x {w} pixels: 2**31 or more, past the "
                f"kernel's 32-bit offsets within an image")
    y_tiles, z_tiles = -(-ny // TILE_Y), -(-nz // VPT)
    if max(y_tiles, z_tiles) > MAX_GRID_YZ:
        return (f"{y_tiles} y-tiles or {z_tiles} z-tiles: a grid holds at "
                f"most {MAX_GRID_YZ}")
    x0, y0, x1, y1 = roi
    if not (0 <= x0 <= x1 < w and 0 <= y0 <= y1 < h):
        return f"the roi {tuple(roi)}: not inside the {w} x {h} image"
    return None


def exact_plan(nz: int, ny: int, nx: int, h: int, w: int,
               roi: Tuple[int, int, int, int]) -> Tuple[int, int, int]:
    """The launch grid, CTAs over (x-tiles, y-tiles, z-tiles), that the C
    entry point makes for a state of ``nz x ny x nx`` voxels and views of
    ``h x w`` pixels. Raises ValueError for what the kernel does not take
    (``exact_refusal``)."""
    refusal = exact_refusal(nz, ny, nx, h, w, roi)
    if refusal is not None:
        raise ValueError(f"the fused exact kernel does not take {refusal}")
    return -(-nx // TILE_X), -(-ny // TILE_Y), -(-nz // VPT)


@functools.lru_cache(maxsize=None)
def _check_tiling() -> None:
    """Once per process: the built kernel's tiling is this module's."""
    lib = _kernels.load()
    got = tuple(lib.vt_exact_tiling(i) for i in range(5))
    if got[:4] != (TILE_X, TILE_Y, VPT, THREADS) or not (
            0 < got[4] <= REGISTER_BUDGET):
        raise RuntimeError(f"csrc/exact_fused.cu's tiling {got} differs "
                           f"from ops/exact_fused.py's")


def exact_fold_plain(
    sdf: torch.Tensor,  # f32[NZ, NY, NX]
    un: torch.Tensor,  # i32[NZ, NY, NX]
    cx: torch.Tensor,  # f32[NX]
    cy: torch.Tensor,  # f32[NY]
    cz: torch.Tensor,  # f32[NZ]
    w2c: torch.Tensor,  # f32[V, 4, 4]
    principal_point: torch.Tensor,  # f32[V, 2]
    focal_length: torch.Tensor,  # f32[V, 2]
    sdf_images: torch.Tensor,  # f32[V, H, W]
    max_sdfs: torch.Tensor,  # f32[V]
    roi: Tuple[int, int, int, int],
    opt: VoxelUpdateOption,
    projection: str = "pinhole",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel E's plain version: the centres stacked as
    ``GridSpec.centers_zyx`` stacks them, then ``fusion.fold_views``."""
    zz, yy, xx = torch.meshgrid(cz, cy, cx, indexing="ij")
    return fusion.fold_views(
        sdf, un, torch.stack([xx, yy, zz], dim=-1), w2c, principal_point,
        focal_length, sdf_images, max_sdfs, roi, opt, projection)


def _coefficients(w2c, principal_point, focal_length, max_sdfs,
                  device) -> torch.Tensor:
    """f32[V, 20] per view: the three w2c rows (r0 r1 r2 t each), fx, fy,
    cx, cy, the image's max and three zeros."""
    v = w2c.shape[0]
    parts = [w2c[:, :3, :].reshape(v, 12), focal_length.reshape(v, 2),
             principal_point.reshape(v, 2), max_sdfs.reshape(v, 1)]
    coef = torch.zeros((v, COEFS), dtype=torch.float32, device=device)
    coef[:, :17] = torch.cat([p.to(device, torch.float32) for p in parts],
                             dim=1)
    return coef


def exact_fold(
    sdf: torch.Tensor,  # f32[NZ, NY, NX]
    un: torch.Tensor,  # i32[NZ, NY, NX]
    cx: torch.Tensor,  # f32[NX]
    cy: torch.Tensor,  # f32[NY]
    cz: torch.Tensor,  # f32[NZ]
    w2c: torch.Tensor,  # f32[V, 4, 4]
    principal_point: torch.Tensor,  # f32[V, 2]
    focal_length: torch.Tensor,  # f32[V, 2]
    sdf_images: torch.Tensor,  # f32[V, H, W]
    max_sdfs: torch.Tensor,  # f32[V] per-image max (MAX outside policy)
    roi: Tuple[int, int, int, int],
    opt: VoxelUpdateOption,
    projection: str = "pinhole",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold every view, in order, into (sdf, un); returns new tensors and
    leaves the inputs unwritten (with no view or no voxel, the inputs).

    CPU tensors take the plain version. CUDA tensors launch kernel E once
    for all views (``exact_fold.launches`` counts those launches and
    ``exact_fold.views`` the views they fold) or raise: on a build
    failure, on what the kernel does not take (ValueError, from
    ``exact_plan``), or on a non-zero cudaError_t from the launch."""
    if sdf.device.type == "cpu":
        return exact_fold_plain(sdf, un, cx, cy, cz, w2c, principal_point,
                                focal_length, sdf_images, max_sdfs, roi, opt,
                                projection)
    nz, ny, nx = sdf.shape
    v, h, w = sdf_images.shape
    dev = sdf.device
    sdf, un, sdf_images = (t.contiguous() for t in (sdf, un, sdf_images))
    _kernels.check_tensor("sdf", sdf, torch.float32, (nz, ny, nx))
    _kernels.check_tensor("update_num", un, torch.int32, (nz, ny, nx))
    _kernels.check_tensor("cx", cx, torch.float32, (nx,))
    _kernels.check_tensor("cy", cy, torch.float32, (ny,))
    _kernels.check_tensor("cz", cz, torch.float32, (nz,))
    _kernels.check_tensor("sdf_images", sdf_images, torch.float32, (v, h, w))
    for name, t, shape in (("w2c", w2c, (v, 4, 4)),
                           ("principal_point", principal_point, (v, 2)),
                           ("focal_length", focal_length, (v, 2)),
                           ("max_sdfs", max_sdfs, (v,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if projection not in ("pinhole", "ortho"):
        raise ValueError(f"unknown projection {projection!r}")
    if v == 0 or sdf.numel() == 0:
        return sdf, un
    exact_plan(nz, ny, nx, h, w, roi)  # raises for what E cannot take
    coef = _coefficients(w2c, principal_point, focal_length, max_sdfs, dev)
    out_sdf, out_un = torch.empty_like(sdf), torch.empty_like(un)
    x0, y0, x1, y1 = roi
    _check_tiling()
    err = _kernels.load().vt_exact_fold(
        sdf.data_ptr(), un.data_ptr(), out_sdf.data_ptr(), out_un.data_ptr(),
        cx.data_ptr(), cy.data_ptr(), cz.data_ptr(), coef.data_ptr(),
        sdf_images.data_ptr(), nz, ny, nx, v, h, w, x0, y0, x1, y1,
        int(opt.sdf_interp == SdfInterpolation.BILINEAR),
        int(opt.voxel_update == VoxelUpdate.WEIGHTED_AVERAGE),
        int(opt.update_outside == UpdateOutsideImage.MAX),
        int(bool(opt.use_truncation)),
        int(projection == "ortho"),
        int(opt.voxel_max_update_num),
        float(fusion.truncation_threshold(opt)),
        float(opt.voxel_update_weight),
        _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "exact_fused kernel launch")
    exact_fold.launches += 1
    exact_fold.views += v
    return out_sdf, out_un


exact_fold.launches = 0
exact_fold.views = 0
