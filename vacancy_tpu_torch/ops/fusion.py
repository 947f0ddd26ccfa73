"""Voxel fusion: the per-voxel update rule and the exact engine
(``vacancy_tpu/ops/fusion.py``).

The exact engine projects every voxel center into each view and samples
the 2D SDF image there (NN or bilinear, the reference's
``SdfInterpolationNn`` / ``SdfInterpolationBiliner``,
voxel_carver.cc:16-76), then applies the update rule with the
reference's first-touch / cap / truncation semantics
(voxel_carver.cc:78-95, 442-491). It is plain PyTorch: the JAX package
has no Pallas kernel here either.

``apply_view_update`` is shared with the warp engine and, as the same
expressions in C++, with the fused warp kernel (``csrc/warp_fused.cu``).
Float expressions keep the JAX package's operation order. The world to
camera transform is written as the three-term sum
``((x r0 + y r1) + z r2) + t`` in that order, on every device; XLA on the
CPU evaluates its dot product in its own order, so the tests hold the
two packages to an ulp-level bar there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..camera import OrthoCamera
from ..config import (
    SdfInterpolation,
    UpdateOutsideImage,
    VoxelUpdate,
    VoxelUpdateOption,
)
from ..grid import GridSpec, VoxelGridState
from ..utils.debug import assert_finite, assert_no_nan
from ..utils.timing import span
from .sdf2d import make_signed_distance_field


def truncation_threshold(opt: VoxelUpdateOption) -> np.float32:
    """Below-range skip threshold for truncated samples: the reference's
    -1 (band-normalized values, voxel_carver.cc:477-480), or -band when
    truncation is metric."""
    return np.float32(
        -float(opt.truncation_band) if opt.metric_truncation else -1.0
    )


def _taps(c: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Integer taps of integral float coordinates clamped to [lo, hi].
    For every voxel that is not masked this is the reference's clamp;
    masked voxels (non-finite or outside coordinates) also land inside,
    so the gather never leaves the image."""
    return torch.nan_to_num(c, nan=float(lo)).clamp(lo, hi).to(torch.int64)


def sample_sdf_nn(sdf_img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  roi: Tuple[int, int, int, int]) -> torch.Tensor:
    """Nearest-neighbor SDF sampling with round half up + clamp to the
    ROI (``SdfInterpolationNn``, voxel_carver.cc:16-38)."""
    x0, y0, x1, y1 = roi
    xi = _taps(torch.floor(u + 0.5), x0, x1)
    yi = _taps(torch.floor(v + 0.5), y0, y1)
    return sdf_img.reshape(-1)[yi * sdf_img.shape[1] + xi]


def sample_sdf_bilinear(sdf_img: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor,
                        roi: Tuple[int, int, int, int]) -> torch.Tensor:
    """Bilinear SDF sampling, clamp-to-ROI taps (``SdfInterpolationBiliner``,
    voxel_carver.cc:40-76): the floor tap clamps to the ROI, the +1 tap to
    its max, and the blend weights use the clamped floor."""
    x0, y0, x1, y1 = roi
    w = sdf_img.shape[1]
    ix0 = _taps(torch.floor(u), x0, x1)
    iy0 = _taps(torch.floor(v), y0, y1)
    ix1 = torch.clamp_max(ix0 + 1, x1)
    iy1 = torch.clamp_max(iy0 + 1, y1)
    lu = u - ix0.to(torch.float32)
    lv = v - iy0.to(torch.float32)
    flat = sdf_img.reshape(-1)
    d00 = flat[iy0 * w + ix0]
    d10 = flat[iy0 * w + ix1]
    d01 = flat[iy1 * w + ix0]
    d11 = flat[iy1 * w + ix1]
    return (
        (1.0 - lu) * (1.0 - lv) * d00
        + lu * (1.0 - lv) * d10
        + (1.0 - lu) * lv * d01
        + lu * lv * d11
    )


def _view_distance(
    pos_w: torch.Tensor,  # f32[..., 3] voxel centers (world)
    w2c: torch.Tensor,  # f32[4, 4]
    principal_point: torch.Tensor,  # f32[2]
    focal_length: torch.Tensor,  # f32[2]
    sdf_img: torch.Tensor,  # f32[H, W]
    max_sdf: torch.Tensor,  # f32[] per-image max (MAX outside policy)
    roi: Tuple[int, int, int, int],
    opt: VoxelUpdateOption,
    projection: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist, skip) of one view for every voxel."""
    x0, y0, x1, y1 = roi
    r, t = w2c[:3, :3], w2c[:3, 3]
    px, py, pz = pos_w[..., 0], pos_w[..., 1], pos_w[..., 2]

    def cam(i):  # world -> camera (voxel_carver.cc:453)
        return px * r[i, 0] + py * r[i, 1] + pz * r[i, 2] + t[i]

    z = cam(2)
    if projection == "pinhole":  # camera.cc:131-137
        u = focal_length[0] / z * cam(0) + principal_point[0]
        v = focal_length[1] / z * cam(1) + principal_point[1]
    elif projection == "ortho":  # identity on x, y (camera.cc:196-212)
        u, v = cam(0), cam(1)
    else:
        raise ValueError(f"unknown projection {projection!r}")

    # behind the camera (voxel_carver.cc:456-458); z == 0 gives
    # non-finite uv, also skipped
    behind = z < 0
    bad_uv = ~(torch.isfinite(u) & torch.isfinite(v))
    outside = (u < x0) | (v < y0) | (u > x1) | (v > y1)

    if opt.sdf_interp == SdfInterpolation.NN:
        dist_in = sample_sdf_nn(sdf_img, u, v, roi)
    elif opt.sdf_interp == SdfInterpolation.BILINEAR:
        dist_in = sample_sdf_bilinear(
            sdf_img,
            torch.where(bad_uv, torch.tensor(float(x0), device=u.device), u),
            torch.where(bad_uv, torch.tensor(float(y0), device=v.device), v),
            roi,
        )
    else:
        raise ValueError(f"unknown interpolation {opt.sdf_interp}")

    if opt.update_outside == UpdateOutsideImage.NONE:
        return dist_in, behind | bad_uv | outside
    if opt.update_outside == UpdateOutsideImage.MAX:
        return torch.where(outside, max_sdf, dist_in), behind | bad_uv
    raise ValueError(f"unknown outside policy {opt.update_outside}")


def _carve_one_view(sdf, update_num, pos_w, w2c, principal_point,
                    focal_length, sdf_img, max_sdf, roi, opt,
                    projection: str = "pinhole"):
    """Apply one view's update to (sdf, update_num); returns new tensors."""
    dist, skip = _view_distance(pos_w, w2c, principal_point, focal_length,
                                sdf_img, max_sdf, roi, opt, projection)
    return apply_view_update(sdf, update_num, dist, skip, opt)


def apply_view_update(
    sdf: torch.Tensor,
    update_num: torch.Tensor,
    dist: torch.Tensor,
    skip: torch.Tensor,
    opt: VoxelUpdateOption,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One view's update given the sampled distance and skip mask:
    first-touch / cap / truncation-skip semantics (voxel_carver.cc:447-488)
    and both update rules (voxel_carver.cc:78-95). Returns new tensors."""
    dev = sdf.device
    # frozen voxels: update_num > cap (voxel_carver.cc:447-449)
    skip = skip | (update_num > opt.voxel_max_update_num)
    if opt.use_truncation:
        thresh = torch.tensor(truncation_threshold(opt), device=dev)
        skip = skip | (dist < thresh)

    first_touch = update_num < 1
    if opt.voxel_update == VoxelUpdate.MAX:
        # kMax: sdf = max(sdf, d); update_num++ only on improvement
        # (voxel_carver.cc:78-86); first touch always writes (.:482-486).
        improved = dist > sdf
        new_sdf = torch.where(first_touch, dist, torch.maximum(sdf, dist))
        new_un = update_num + (first_touch | improved).to(torch.int32)
    elif opt.voxel_update == VoxelUpdate.WEIGHTED_AVERAGE:
        # kWeightedAverage: running mean; the weight cancels algebraically
        # (voxel_carver.cc:88-95) but the float expression is kept as
        # written for bit parity: ((w * n) * sdf + w * dist) * inv_denom
        w = torch.tensor(np.float32(opt.voxel_update_weight), device=dev)
        one = torch.tensor(1.0, dtype=torch.float32, device=dev)
        n = update_num.to(torch.float32)
        inv_denom = one / (w * (n + one))
        avg = (w * n * sdf + w * dist) * inv_denom
        new_sdf = torch.where(first_touch, dist, avg)
        new_un = update_num + 1
    else:
        raise ValueError(f"unknown update rule {opt.voxel_update}")

    out_sdf = torch.where(skip, sdf, new_sdf)
    out_un = torch.where(skip, update_num, new_un)
    return out_sdf, out_un


def fold_views(
    sdf: torch.Tensor,
    update_num: torch.Tensor,
    pos_w: torch.Tensor,  # f32[..., 3] voxel centers matching sdf's shape
    w2c: torch.Tensor,  # f32[V, 4, 4]
    principal_point: torch.Tensor,  # f32[V, 2]
    focal_length: torch.Tensor,  # f32[V, 2]
    sdf_images: torch.Tensor,  # f32[V, H, W]
    max_sdfs: torch.Tensor,  # f32[V]
    roi: Tuple[int, int, int, int],
    opt: VoxelUpdateOption,
    projection: str = "pinhole",
    debug: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a stacked view batch into (sdf, update_num), views in order.

    ``debug=True`` checks each view's sampled distance for NaN and the
    updated state for NaN/Inf, raising FloatingPointError (the JAX
    package runs this fold under checkify's float checks instead, which
    PyTorch lacks)."""
    for i in range(sdf_images.shape[0]):
        dist, skip = _view_distance(
            pos_w, w2c[i], principal_point[i], focal_length[i],
            sdf_images[i], max_sdfs[i], roi, opt, projection,
        )
        if debug:
            assert_no_nan(f"view {i}: sampled distance", dist)
        sdf, update_num = apply_view_update(sdf, update_num, dist, skip, opt)
        if debug:
            assert_finite(f"view {i}: fusion state sdf", sdf)
    return sdf, update_num


def carve_views(
    state: VoxelGridState,
    grid: GridSpec,
    w2c: torch.Tensor,  # f32[V, 4, 4] or f32[4, 4]
    principal_point: torch.Tensor,  # f32[V, 2] or f32[2]
    focal_length: torch.Tensor,  # f32[V, 2] or f32[2]
    sdf_images: torch.Tensor,  # f32[V, H, W] or f32[H, W]
    roi: Optional[Tuple[int, int, int, int]] = None,
    opt: VoxelUpdateOption = VoxelUpdateOption(),
    projection: str = "pinhole",
    debug: bool = False,
) -> VoxelGridState:
    """Fuse a batch of views into the grid state (the reference's Carve),
    views in order. Accepts a single view (unbatched args) or a stacked
    batch; ``debug`` as in ``fold_views``.

    The exact engine's one entry on a dense state: the centres and the
    fold run in the span ``vt.exact``, and ``carve_views.views`` counts
    the views folded."""
    if w2c.ndim == 2:
        w2c = w2c[None]
        principal_point = principal_point[None]
        focal_length = focal_length[None]
        sdf_images = sdf_images[None]
    views, h, w = sdf_images.shape
    if roi is None:
        roi = (0, 0, w - 1, h - 1)
    with span("exact"):
        # per-image max over the *whole* image (voxel_carver.cc:436)
        max_sdfs = sdf_images.amax(dim=(1, 2))
        sdf, un = fold_views(
            state.sdf, state.update_num, grid.centers_zyx(state.sdf.device),
            w2c, principal_point, focal_length, sdf_images, max_sdfs, roi,
            opt, projection, debug,
        )
    carve_views.views += views
    return VoxelGridState(sdf=sdf, update_num=un)


carve_views.views = 0


def carve_masks(
    state: VoxelGridState,
    grid: GridSpec,
    camera,  # a (possibly stacked) PinholeCamera or OrthoCamera
    masks: torch.Tensor,  # [V, H, W] or [H, W] uint8/bool silhouettes
    roi: Optional[Tuple[int, int, int, int]] = None,
    opt: VoxelUpdateOption = VoxelUpdateOption(),
    sdf_minmax_normalize: bool = True,
    sdf_scale: Optional[float] = None,
    debug: bool = False,
):
    """mask -> 2D SDF -> fuse, the reference's full Carve overload
    (voxel_carver.cc:394-413), on the state's device. Returns
    (new_state, sdf_images). sdf_scale: metric-TSDF extension, see
    config.VoxelCarverOption."""
    dev = state.sdf.device
    masks = masks.to(dev)
    single = masks.ndim == 2
    sdf_images = make_signed_distance_field(
        masks[None] if single else masks, roi,
        minmax_normalize=sdf_minmax_normalize,
        use_truncation=opt.use_truncation,
        truncation_band=opt.truncation_band, sdf_scale=sdf_scale,
    )
    w2c = camera.w2c.to(dev)
    ortho = isinstance(camera, OrthoCamera)
    if ortho:  # u = x, v = y with no intrinsics (camera.cc:196-212)
        pp = fl = torch.zeros(w2c.shape[:-2] + (2,), dtype=torch.float32,
                              device=dev)
    else:
        pp = camera.principal_point.to(dev)
        fl = camera.focal_length.to(dev)
    sdf_b = sdf_images
    if single:
        sdf_b = sdf_images[0]
        if w2c.ndim == 3:
            w2c, pp, fl = w2c[0], pp[0], fl[0]
    new_state = carve_views(
        state, grid, w2c, pp, fl, sdf_b, roi, opt,
        projection="ortho" if ortho else "pinhole", debug=debug,
    )
    return new_state, sdf_images
