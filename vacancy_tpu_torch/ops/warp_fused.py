"""The fused warp kernel's wrapper and its plain version
(``vacancy_tpu/ops/warp_fused.py``).

The kernel (``csrc/warp_fused.cu``) replaces
``vacancy_tpu/ops/warp_fused.py::_warp_fused_kernel``: one launch folds
every view into the state. A CTA owns a (z-plane, 32-wide x-tile, 64-row
y-tile); each thread loads its 8 voxels once, folds every view with the
state in registers, and stores them once. Per view the pass-1 intermediate
is computed only over the band of image rows the CTA's voxels tap and
lives in shared memory, ``inter_rows`` rows at a time (see the source's
header for what bounds it and what the design does about it).
``fused_plan`` mirrors the launch: the grid, the rows and the bytes of
shared memory. It takes views of any height: a band taller than
``INTER_ROWS_CAP`` rows goes in chunks. ``fused_refusal`` names what the
kernel cannot take (an empty state, more than 65535 planes or y-tiles, a
card whose shared memory holds no two rows of the intermediate, an image
of 2**32 pixels or more), and ``ops/fusion_warp.carve_views_warp`` sends
only such launches to the two-pass engine.

With ``ortho_rows`` the views are orthographic: the caller passes the
synthetic homography (third row ``(0, 0, 0, 1)``, unit focal length, zero
principal point) and each view's real camera-z row, which the kernel
carries as four more coefficients for the behind-camera mask.

Its plain version, ``warp_fuse_planes_plain``, is that two-pass engine
(``ops/fusion_warp.warp_fold``) with the plain row sampler. Float
expressions keep the JAX package's operation order, and the kernel is
built without FMA contraction, so the two agree bit for bit. The wrapper
``warp_fuse_planes`` runs the plain version for CPU tensors and only for
them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from .. import _kernels
from .._kernels import smem_optin_bytes
from ..config import UpdateOutsideImage, VoxelUpdate, VoxelUpdateOption
from . import fusion_warp  # which imports this module: use at call time
from .fusion import truncation_threshold
from .warp_gather import interp_rows_plain

# the tiling of csrc/warp_fused.cu: a CTA of THREADS threads owns TILE_X
# consecutive x (one warp) by TILE_Y rows of one z-plane, 8 voxels a thread
TILE_X = 32
TILE_Y = 64
THREADS = 256
# registers a thread may use (__launch_bounds__(256, 4): four CTAs per SM)
REGISTER_BUDGET = 64
# rows of the pass-1 intermediate a CTA holds at once (INTER_ROWS_CAP x
# TILE_X f32 = 48 KiB: four CTAs fit an SM); a taller band goes in chunks
INTER_ROWS_CAP = 384
# the kernel's fixed shared memory: two buffers of 24 coefficients, the
# band reduction's 2 x 8 ints and the y-tile's TILE_Y centers
STATIC_SMEM_BYTES = 2 * 24 * 4 + 2 * 8 * 4 + TILE_Y * 4
# the kernel offsets a tap within an image by a 32-bit unsigned row start
MAX_IMAGE_PIXELS = 2**32 - 1
# a launch grid's y and z dimensions
MAX_GRID_YZ = 65535


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """One launch of kernel A, as the C entry point makes it."""

    grid: Tuple[int, int, int]  # CTAs over (x-tiles, z-planes, y-tiles)
    inter_rows: int  # rows of the intermediate in shared memory
    smem_bytes: int  # dynamic + static shared memory of a CTA


def _inter_rows(h: int, optin_bytes: int) -> int:
    """Rows of the intermediate a CTA holds at once."""
    return min(h, INTER_ROWS_CAP,
               (optin_bytes - STATIC_SMEM_BYTES) // (TILE_X * 4))


def fused_refusal(nz: int, ny: int, nx: int, h: int, w: int,
                  optin_bytes: int) -> Optional[str]:
    """What kernel A cannot take in a launch over ``nz x ny x nx`` voxels
    with views of ``h x w`` pixels on a card whose blocks may opt into
    ``optin_bytes`` of shared memory, or None when it takes it: the rule
    by which ``carve_views_warp`` gives views to kernel A."""
    if min(nz, ny, nx, h, w) < 1:
        return f"an empty state or views: {(nz, ny, nx)}, {h} x {w} pixels"
    if h * w > MAX_IMAGE_PIXELS:
        return (f"images of {h} x {w} pixels: 2**32 or more, past the "
                f"kernel's 32-bit offsets within an image")
    y_tiles = -(-ny // TILE_Y)
    if max(nz, y_tiles) > MAX_GRID_YZ:
        return (f"{nz} planes or {y_tiles} y-tiles: a grid holds at most "
                f"{MAX_GRID_YZ}")
    if _inter_rows(h, optin_bytes) < min(h, 2):  # a linear tap pair
        return (f"{optin_bytes} bytes of shared memory: they hold no two "
                f"rows of the intermediate")
    return None


def fused_plan(nz: int, ny: int, nx: int, h: int, w: int,
               optin_bytes: int) -> FusedPlan:
    """The launch for a state of ``nz x ny x nx`` voxels and views of
    ``h x w`` pixels on a card whose blocks may opt into ``optin_bytes``
    of shared memory. Raises ValueError for what the kernel does not take
    (``fused_refusal``)."""
    refusal = fused_refusal(nz, ny, nx, h, w, optin_bytes)
    if refusal is not None:
        raise ValueError(f"the fused warp kernel does not take {refusal}")
    rows = _inter_rows(h, optin_bytes)
    return FusedPlan((-(-nx // TILE_X), nz, -(-ny // TILE_Y)), rows,
                     rows * TILE_X * 4 + STATIC_SMEM_BYTES)


@functools.lru_cache(maxsize=None)
def _check_tiling() -> None:
    """Once per process: the built kernel's tiling is this module's."""
    lib = _kernels.load()
    got = tuple(lib.vt_warp_tiling(i) for i in range(5))
    if got[:3] != (TILE_X, TILE_Y, THREADS) or not (
            0 <= got[3] <= STATIC_SMEM_BYTES) or not (
            0 < got[4] <= REGISTER_BUDGET):
        raise RuntimeError(f"csrc/warp_fused.cu's tiling {got} differs from "
                           f"ops/warp_fused.py's")


def warp_fuse_planes_plain(
    sdf: torch.Tensor,  # f32[NZ, NY, NX]
    un: torch.Tensor,  # i32[NZ, NY, NX]
    cx: torch.Tensor,  # f32[NX]
    cy: torch.Tensor,  # f32[NY]
    cz: torch.Tensor,  # f32[NZ]
    w2c: torch.Tensor,  # f32[V, 4, 4]
    principal_point: torch.Tensor,  # f32[V, 2]
    focal_length: torch.Tensor,  # f32[V, 2]
    sdf_images: torch.Tensor,  # f32[V, H, W]
    opt: VoxelUpdateOption,
    linear: bool,
    roi: Optional[Tuple[int, int, int, int]] = None,
    ortho_rows: Optional[torch.Tensor] = None,  # f32[V, 4]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold every view into (sdf, un) in order, two passes per view (the
    fused warp kernel's plain version): the two-pass engine with the
    plain row sampler, so it launches no kernel on any device. Returns
    new tensors."""
    return fusion_warp.warp_fold(
        sdf, un, cx, cy, cz, w2c, principal_point, focal_length, sdf_images,
        opt, linear, roi, interp_rows_plain, z_rows=ortho_rows,
    )


def _coefficients(w2c, principal_point, focal_length,
                  ortho_rows=None) -> torch.Tensor:
    """f32[V, 16] per view: R row-major (9), t (3), fx, fy, cx, cy; with
    ``ortho_rows`` f32[V, 20]: + the real camera-z row (rz0 rz1 rz2 rt)."""
    v = w2c.shape[0]
    return torch.cat(
        [
            w2c[:, :3, :3].reshape(v, 9),
            w2c[:, :3, 3],
            focal_length[:, :1], focal_length[:, 1:2],
            principal_point[:, :1], principal_point[:, 1:2],
        ] + ([] if ortho_rows is None else [ortho_rows]),
        dim=1,
    ).to(torch.float32).contiguous()


def warp_fuse_planes(
    sdf: torch.Tensor,  # f32[NZ, NY, NX]
    un: torch.Tensor,  # i32[NZ, NY, NX]
    cx: torch.Tensor,  # f32[NX]
    cy: torch.Tensor,  # f32[NY]
    cz: torch.Tensor,  # f32[NZ]
    w2c: torch.Tensor,  # f32[V, 4, 4]
    principal_point: torch.Tensor,  # f32[V, 2]
    focal_length: torch.Tensor,  # f32[V, 2]
    sdf_images: torch.Tensor,  # f32[V, H, W]
    opt: VoxelUpdateOption,
    linear: bool,
    roi: Optional[Tuple[int, int, int, int]] = None,
    ortho_rows: Optional[torch.Tensor] = None,  # f32[V, 4] real z rows
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse every view, in order, into (sdf, un); returns new tensors, or
    ``out`` = (sdf, update_num) tensors to write, which may be the inputs
    themselves (an update in place: each voxel is read, before the first
    view, and written, after the last, by one thread).

    With ``ortho_rows`` the caller passes the SYNTHETIC orthographic
    homography in ``w2c`` (third row (0, 0, 0, 1)), unit ``focal_length``
    and zero ``principal_point``, plus each view's real camera-z row for
    the behind-camera mask.

    CPU tensors take the plain two-pass version. CUDA tensors launch the
    kernel once for all views (``warp_fuse_planes.launches`` counts
    those launches, ``warp_fuse_planes.in_place`` those whose outputs are
    their inputs), whatever their height, or raise: on a build
    failure, on inputs the kernel does not take (ValueError, from
    ``fused_plan``), or on a non-zero cudaError_t from the launch."""
    if sdf.device.type == "cpu":
        new_sdf, new_un = warp_fuse_planes_plain(
            sdf, un, cx, cy, cz, w2c, principal_point, focal_length,
            sdf_images, opt, linear, roi, ortho_rows,
        )
        if out is None:
            return new_sdf, new_un
        out[0].copy_(new_sdf)
        out[1].copy_(new_un)
        return out
    nz, ny, nx = sdf.shape
    v, h, w = sdf_images.shape
    _kernels.check_tensor("sdf", sdf, torch.float32, (nz, ny, nx))
    _kernels.check_tensor("update_num", un, torch.int32, (nz, ny, nx))
    _kernels.check_tensor("cx", cx, torch.float32, (nx,))
    _kernels.check_tensor("cy", cy, torch.float32, (ny,))
    _kernels.check_tensor("cz", cz, torch.float32, (nz,))
    _kernels.check_tensor("sdf_images", sdf_images, torch.float32, (v, h, w))
    per_view = [("w2c", w2c, (v, 4, 4)),
                ("principal_point", principal_point, (v, 2)),
                ("focal_length", focal_length, (v, 2))]
    if ortho_rows is not None:
        per_view.append(("ortho_rows", ortho_rows, (v, 4)))
    for name, t, shape in per_view:
        if t.device != sdf.device or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} on {sdf.device}")
    x0, y0, x1, y1 = roi or (0, 0, w - 1, h - 1)
    if not (0 <= x0 <= x1 < w and 0 <= y0 <= y1 < h):
        raise ValueError(f"roi {roi} outside the {w}x{h} image")
    plan = fused_plan(nz, ny, nx, h, w, smem_optin_bytes(sdf.device))
    if out is None:
        out_sdf, out_un = torch.empty_like(sdf), torch.empty_like(un)
    else:
        out_sdf, out_un = out
        _kernels.check_tensor("out sdf", out_sdf, torch.float32, (nz, ny, nx))
        _kernels.check_tensor("out update_num", out_un, torch.int32,
                              (nz, ny, nx))
    if v == 0:
        if out_sdf.data_ptr() != sdf.data_ptr():
            out_sdf.copy_(sdf)
        if out_un.data_ptr() != un.data_ptr():
            out_un.copy_(un)
        return out_sdf, out_un

    coef = _coefficients(w2c, principal_point, focal_length, ortho_rows)
    vmax = sdf_images.amax(dim=(1, 2)).contiguous()
    _check_tiling()
    err = _kernels.load().vt_warp_fuse_planes(
        sdf.data_ptr(), un.data_ptr(), out_sdf.data_ptr(), out_un.data_ptr(),
        cx.data_ptr(), cy.data_ptr(), cz.data_ptr(), coef.data_ptr(),
        vmax.data_ptr(), sdf_images.data_ptr(),
        nz, ny, nx, v, h, w, x0, y0, x1, y1,
        int(bool(linear)),
        0 if opt.voxel_update == VoxelUpdate.MAX else 1,
        0 if opt.update_outside == UpdateOutsideImage.NONE else 1,
        int(opt.voxel_max_update_num),
        int(bool(opt.use_truncation)),
        float(truncation_threshold(opt)),
        float(opt.voxel_update_weight),
        int(ortho_rows is not None),
        plan.inter_rows,
        _kernels.stream_ptr(sdf.device),
    )
    _kernels.check(err, "warp_fused kernel launch")
    warp_fuse_planes.launches += 1
    if (out_sdf.data_ptr(), out_un.data_ptr()) == (sdf.data_ptr(),
                                                   un.data_ptr()):
        warp_fuse_planes.in_place += 1
    return out_sdf, out_un


warp_fuse_planes.launches = 0
warp_fuse_planes.in_place = 0
