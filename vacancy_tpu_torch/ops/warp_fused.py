"""The fused warp kernel's wrapper and its plain version
(``vacancy_tpu/ops/warp_fused.py``, ``vacancy_tpu/ops/fusion_warp.py``).

The kernel (``csrc/warp_fused.cu``) replaces
``vacancy_tpu/ops/warp_fused.py::_warp_fused_kernel``: one launch folds
every view into the state, per (z-plane, 32-wide x-tile) CTA, with the
pass-1 intermediate in shared memory (see the source's header for what
bounds it and what the design does about it).

Its plain version, ``warp_fuse_planes_plain``, applies each view's
per-z-slice homography as two 1D resamples:

  pass 1 (horizontal): for every image row v and grid column x, sample
      the image row at u_eq(x, v) -- where the slice's projection crosses
      row v at column x (closed form from the homography);
  pass 2 (vertical):   for every voxel (y, x), sample the pass-1 field
      along v at the voxel's exact projected v*(x, y).

Then the behind-camera / non-finite / outside masks and
``apply_view_update``. Float expressions keep the JAX package's operation
order, and the kernel is built without FMA contraction, so the two agree
bit for bit. The wrapper ``warp_fuse_planes`` runs the plain version for
CPU tensors and only for them.

Truncation sentinels (-FLT_MAX) are clamped to -1e6 before sampling so
contaminated samples still trigger the reference's ``dist < -1`` skip;
the per-view max for the MAX outside policy comes from the raw images.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..config import UpdateOutsideImage, VoxelUpdate, VoxelUpdateOption
from .fusion import apply_view_update, truncation_threshold

SENTINEL_CLAMP = np.float32(-1e6)
_SAFE_EPS = np.float32(1e-12)


def _sample_rows(table: torch.Tensor, row_index: torch.Tensor,
                 pos: torch.Tensor, lo: int, hi: int,
                 linear: bool) -> torch.Tensor:
    """Sample ``table`` (any shape, flattened) at ``row_index + tap``
    where the taps come from ``pos``: floor + clamp to [lo, hi], second
    linear tap at min(p0 + 1, hi); NN rounds half up. ``row_index`` is
    the flat offset of each sample's row (broadcast against ``pos``)."""
    flat = table.reshape(-1)
    if linear:
        p0f = torch.floor(pos)
        frac = pos - p0f
        p0 = p0f.to(torch.int64).clamp(lo, hi)
        p1 = torch.clamp_max(p0 + 1, hi)
        t0 = flat[row_index + p0]
        t1 = flat[row_index + p1]
        return (1.0 - frac) * t0 + frac * t1
    p0 = torch.floor(pos + 0.5).to(torch.int64).clamp(lo, hi)
    return flat[row_index + p0]


def _clip_finite(x: torch.Tensor, hi: int) -> torch.Tensor:
    """``clip(nan_to_num(x, nan=0), -1, hi)``."""
    return torch.nan_to_num(x, nan=0.0).clamp(-1.0, float(hi))


def _safe(x: torch.Tensor) -> torch.Tensor:
    eps = torch.tensor(_SAFE_EPS, device=x.device)
    return torch.where(torch.abs(x) < eps, eps, x)


def _warp_dist_one_view(
    sdf_img: torch.Tensor,  # f32[H, W]
    w2c: torch.Tensor,  # f32[4, 4]
    pp: torch.Tensor,  # f32[2]
    fl: torch.Tensor,  # f32[2]
    cx: torch.Tensor,  # f32[NX] grid x centers
    cy: torch.Tensor,  # f32[NY]
    cz: torch.Tensor,  # f32[NZ]
    linear: bool,
    roi: Optional[Tuple[int, int, int, int]] = None,
):
    """(dist, skip, outside), each [NZ, NY, NX], for one view.

    roi = inclusive (x0, y0, x1, y1): pass-1 taps clamp to [x0, x1],
    pass-2 taps to [y0, y1], and the outside test runs against it (the
    reference's ROI Carve, voxel_carver.cc:16-76, 394-413)."""
    h, w = sdf_img.shape
    x0, y0, x1, y1 = roi or (0, 0, w - 1, h - 1)
    nx, ny, nz = cx.shape[0], cy.shape[0], cz.shape[0]
    dev = sdf_img.device
    r, t = w2c[:3, :3], w2c[:3, 3]
    fx, fy = fl[0], fl[1]
    cxp, cyp = pp[0], pp[1]

    # per-slice homography: P = a0(z) + a1 x + a2 y; Q = b0(z) + b1 x +
    # b2 y; S = c0(z) + c1 x + c2 y; u = fx P/S + cx; v = fy Q/S + cy
    a0 = (r[0, 2] * cz + t[0]).reshape(nz, 1, 1)
    b0 = (r[1, 2] * cz + t[1]).reshape(nz, 1, 1)
    c0 = (r[2, 2] * cz + t[2]).reshape(nz, 1, 1)
    a1, a2 = r[0, 0], r[0, 1]
    b1, b2 = r[1, 0], r[1, 1]
    c1, c2 = r[2, 0], r[2, 1]

    img = torch.clamp_min(sdf_img, float(SENTINEL_CLAMP))

    # ---- pass 1: horizontal resample at u_eq(z, vrow, x) -> [NZ, H, NX]
    vrow = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1)
    vbar = vrow - cyp
    x = cx.reshape(1, 1, nx)
    safe = _safe(vbar * c2 - fy * b2)
    y_star = (fy * (b0 + b1 * x) - vbar * (c0 + c1 * x)) / safe
    s_safe = _safe(c0 + c1 * x + c2 * y_star)
    u_eq = _clip_finite(fx * (a0 + a1 * x + a2 * y_star) / s_safe + cxp, w)
    row1 = torch.arange(h, device=dev).reshape(1, h, 1) * w
    inter = _sample_rows(img, row1, u_eq, x0, x1, linear)

    # ---- pass 2: vertical resample at the exact v*(z, y, x) ----
    y = cy.reshape(1, ny, 1)
    s_ = c0 + c1 * x + c2 * y  # [NZ, NY, NX]
    q_ = b0 + b1 * x + b2 * y
    p_ = a0 + a1 * x + a2 * y
    v_star = fy * q_ / s_ + cyp
    u_star = fx * p_ / s_ + cxp
    v_pos = _clip_finite(v_star, h)
    # sample each (z, x) column of the intermediate along v: as rows of
    # inter_t [NZ, NX, H], row (z, x) starts at flat (z*NX + x)*H
    z_i = torch.arange(nz, device=dev).reshape(nz, 1, 1)
    x_i = torch.arange(nx, device=dev).reshape(1, 1, nx)
    inter_t = inter.permute(0, 2, 1).contiguous()
    dist = _sample_rows(
        inter_t, (z_i * nx + x_i) * h, v_pos, y0, y1, linear
    )

    behind = s_ < 0
    bad = ~(torch.isfinite(u_star) & torch.isfinite(v_star))
    outside = (u_star < x0) | (v_star < y0) | (u_star > x1) | (v_star > y1)
    return dist, behind | bad, outside


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold every view into (sdf, un) in order, two passes per view (the
    fused warp kernel's plain version). Returns new tensors."""
    max_sdfs = sdf_images.amax(dim=(1, 2))
    for i in range(sdf_images.shape[0]):
        dist, skip, outside = _warp_dist_one_view(
            sdf_images[i], w2c[i], principal_point[i], focal_length[i],
            cx, cy, cz, linear, roi,
        )
        if opt.update_outside == UpdateOutsideImage.NONE:
            skip = skip | outside
        elif opt.update_outside == UpdateOutsideImage.MAX:
            dist = torch.where(outside, max_sdfs[i], dist)
        sdf, un = apply_view_update(sdf, un, dist, skip, opt)
    return sdf, un


def _coefficients(w2c, principal_point, focal_length) -> torch.Tensor:
    """f32[V, 16] per view: R row-major (9), t (3), fx, fy, cx, cy."""
    v = w2c.shape[0]
    return torch.cat(
        [
            w2c[:, :3, :3].reshape(v, 9),
            w2c[:, :3, 3],
            focal_length[:, :1], focal_length[:, 1:2],
            principal_point[:, :1], principal_point[:, 1:2],
        ],
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse every view, in order, into (sdf, un); returns new tensors.

    CPU tensors take the plain two-pass version. CUDA tensors launch the
    kernel once for all views (``warp_fuse_planes.launches`` counts
    those launches) or raise: on a build failure, on inputs the kernel
    does not take, or on a non-zero cudaError_t from the launch."""
    if sdf.device.type == "cpu":
        return warp_fuse_planes_plain(
            sdf, un, cx, cy, cz, w2c, principal_point, focal_length,
            sdf_images, opt, linear, roi,
        )
    nz, ny, nx = sdf.shape
    v, h, w = sdf_images.shape
    _kernels.check_tensor("sdf", sdf, torch.float32, (nz, ny, nx))
    _kernels.check_tensor("update_num", un, torch.int32, (nz, ny, nx))
    _kernels.check_tensor("cx", cx, torch.float32, (nx,))
    _kernels.check_tensor("cy", cy, torch.float32, (ny,))
    _kernels.check_tensor("cz", cz, torch.float32, (nz,))
    _kernels.check_tensor("sdf_images", sdf_images, torch.float32, (v, h, w))
    for name, t, shape in (("w2c", w2c, (v, 4, 4)),
                           ("principal_point", principal_point, (v, 2)),
                           ("focal_length", focal_length, (v, 2))):
        if t.device != sdf.device or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} on {sdf.device}")
    x0, y0, x1, y1 = roi or (0, 0, w - 1, h - 1)
    if not (0 <= x0 <= x1 < w and 0 <= y0 <= y1 < h):
        raise ValueError(f"roi {roi} outside the {w}x{h} image")
    out_sdf = torch.empty_like(sdf)
    out_un = torch.empty_like(un)
    if v == 0:
        return out_sdf.copy_(sdf), out_un.copy_(un)

    coef = _coefficients(w2c, principal_point, focal_length)
    vmax = sdf_images.amax(dim=(1, 2)).contiguous()
    lib = _kernels.load()
    err = lib.vt_warp_fuse_planes(
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
        _kernels.stream_ptr(sdf.device),
    )
    _kernels.check(err, "warp_fused kernel launch")
    warp_fuse_planes.launches += 1
    return out_sdf, out_un


warp_fuse_planes.launches = 0
