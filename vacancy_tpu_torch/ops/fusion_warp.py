"""Projective-warp fusion of many views (``vacancy_tpu/ops/fusion_warp.py``).

The warp engine reformulates per-view fusion as an image warp, the
two-pass decomposition of each z-slice's homography:

  pass 1 (horizontal): for every image row v and grid column x, sample
      the image row at u_eq(x, v) -- where the slice's projection crosses
      row v at column x (closed form from the homography);
  pass 2 (vertical):   for every voxel (y, x), sample the pass-1 field
      along v at the voxel's exact projected v*(x, y).

Then the behind-camera / non-finite / outside masks and
``apply_view_update``. Truncation sentinels (-FLT_MAX) are clamped to
-1e6 before sampling so contaminated samples still trigger the
reference's ``dist < -1`` skip; the per-view max for the MAX outside
policy comes from the raw images.

``carve_views_warp`` picks the engine by shape before any launch. On a
CUDA state it launches the fused warp kernel (``ops/warp_fused.py``,
kernel A) whenever its launch plan takes the shapes, views of any height
(4K UHD among them) included, and runs the two-pass engine ``warp_fold``
with ``interp_rows`` (kernel C) for each pass only for what the plan
refuses (``warp_fused.fused_refusal``) -- the JAX package's
``_fused_view_chunk`` -> None branch. Orthographic cameras make the same
choice (kernel A carries their real camera-z rows). On CPU tensors both
engines are the same plain fold.

``carve_views_warp`` and ``carve_views_warp_ortho`` return new tensors,
or, with ``in_place=True`` on CUDA tensors, write kernel A's result over
the state they are given (the facade's route for the state it owns); the
two-pass engine and CPU tensors return new tensors either way. ``carve_views_warp_blocked`` is the same
fusion as a host loop over z-chunks that updates the state in place, for
grids where the two-pass engine's per-view fields would not fit the card
(1024^3).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import UpdateOutsideImage, VoxelUpdateOption
from ..grid import GridSpec, VoxelGridState
from ..utils import LOGI, LOGW
from ..utils.timing import span
from . import warp_fused  # which imports this module: use at call time
from .fusion import apply_view_update, carve_views
from .warp_gather import interp_rows

SENTINEL_CLAMP = np.float32(-1e6)
_SAFE_EPS = np.float32(1e-12)

# |w2c[1,1]| below this sends ortho views to the exact engine: the
# warp's vertical-pass inversion divides by it, and a near-90-degree
# rolled camera (image v decoupled from world y) would interpolate
# garbage with no error otherwise.
_ORTHO_V_COUPLING_MIN = 1e-2

# interp_rows or interp_rows_plain: (tables, pos, width, linear,
# share_table, lo, hi) -> samples
RowSampler = Callable[..., torch.Tensor]


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
    roi: Optional[Tuple[int, int, int, int]],
    sampler: RowSampler,
):
    """(dist, skip, outside), each [NZ, NY, NX], for one view; ``sampler``
    samples the rows of both passes.

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
    del y_star, s_safe
    inter = sampler(img[None], u_eq, w, linear, True, x0, x1)
    del u_eq

    # ---- pass 2: vertical resample at the exact v*(z, y, x) ----
    y = cy.reshape(1, ny, 1)
    s_ = c0 + c1 * x + c2 * y  # [NZ, NY, NX]
    q_ = b0 + b1 * x + b2 * y
    p_ = a0 + a1 * x + a2 * y
    v_star = fy * q_ / s_ + cyp
    u_star = fx * p_ / s_ + cxp
    v_pos = _clip_finite(v_star, h)
    # the (z, x) columns of the intermediate are the rows of inter_t
    # [NZ, NX, H]; each is sampled at v_pos[z, :, x]
    inter_t = inter.transpose(1, 2).contiguous()
    del inter
    dist = sampler(inter_t, v_pos.transpose(1, 2).contiguous(), h, linear,
                   False, y0, y1).transpose(1, 2).contiguous()
    del inter_t

    behind = s_ < 0
    bad = ~(torch.isfinite(u_star) & torch.isfinite(v_star))
    outside = (u_star < x0) | (v_star < y0) | (u_star > x1) | (v_star > y1)
    return dist, behind | bad, outside


def warp_fold(
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
    roi: Optional[Tuple[int, int, int, int]],
    sampler: RowSampler,
    z_rows: Optional[torch.Tensor] = None,  # f32[V, 4]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-pass engine: fold every view into (sdf, un) in order and
    return new tensors. ``sampler`` is ``interp_rows`` (kernel C on a
    CUDA state) or ``interp_rows_plain`` (the fused warp kernel's plain
    version). ``z_rows`` are the real camera-z rows of orthographic views
    whose ``w2c`` carries the synthetic ``(0, 0, 0, 1)`` row: their
    behind-camera mask is evaluated from it (reference skip,
    voxel_carver.cc:456-458). One view's temporaries are freed before the
    next."""
    nx, ny, nz = cx.shape[0], cy.shape[0], cz.shape[0]
    max_sdfs = sdf_images.amax(dim=(1, 2))
    for i in range(sdf_images.shape[0]):
        dist, skip, outside = _warp_dist_one_view(
            sdf_images[i], w2c[i], principal_point[i], focal_length[i],
            cx, cy, cz, linear, roi, sampler,
        )
        if z_rows is not None:
            zr = z_rows[i]
            z_cam = ((zr[2] * cz).reshape(nz, 1, 1)
                     + (zr[1] * cy).reshape(1, ny, 1)
                     + (zr[0] * cx).reshape(1, 1, nx) + zr[3])
            skip = skip | (z_cam < 0)
        if opt.update_outside == UpdateOutsideImage.NONE:
            skip = skip | outside
        elif opt.update_outside == UpdateOutsideImage.MAX:
            dist = torch.where(outside, max_sdfs[i], dist)
        sdf, un = apply_view_update(sdf, un, dist, skip, opt)
        del dist, skip, outside
    return sdf, un


def _batched(w2c, *per_view):
    """Single-view arguments as a batch of one."""
    if w2c.ndim == 2:
        return (w2c[None], *(a[None] for a in per_view))
    return (w2c, *per_view)


def _fused_kernel_takes(device: torch.device, shape_zyx: Tuple[int, ...],
                        h: int, w: int) -> bool:
    """Whether the fused warp kernel takes one launch over ``shape_zyx``
    voxels with views of ``h x w`` pixels on ``device``: whenever its
    launch plan can be made for the card's shared-memory opt-in (CPU
    tensors: both engines are the same plain fold, and the fused
    wrapper's is taken)."""
    if device.type != "cuda":
        return True
    refusal = warp_fused.fused_refusal(*shape_zyx, h, w,
                                       warp_fused.smem_optin_bytes(device))
    _log_engine(device, h, w, refusal)
    return refusal is None


@functools.lru_cache(maxsize=None)
def _log_engine(device: torch.device, h: int, w: int,
                refusal: Optional[str]) -> None:
    """The engine chosen, logged once per (device, image size, reason)."""
    LOGI("carve_views_warp: views of %d x %d pixels on %s: %s", w, h, device,
         "the fused warp kernel (its launch plan takes them)"
         if refusal is None else
         f"the two-pass engine (interp_rows): the fused warp kernel does "
         f"not take {refusal}")


def warp_carve_centers(
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
    roi: Optional[Tuple[int, int, int, int]],
    chunk_nz: Optional[int] = None,
    z_rows: Optional[torch.Tensor] = None,  # f32[V, 4]
    in_place: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The warp engines on centre vectors: what ``carve_views_warp`` and
    ``carve_views_warp_blocked`` run on a grid's centres, and the sharded
    carve (``parallel/sharded.py``) on each block's slices of them. The
    one place where the engine is chosen: before any launch, by whether
    kernel A's launch plan takes the shapes of one launch (one z-chunk
    when chunked; module docstring). ``z_rows``: the real camera-z rows
    of orthographic views (``ortho_homography``), which kernel A carries
    as four more coefficients and the two-pass engine evaluates per view.

    Without ``chunk_nz``, or with at most that many planes, one call that
    returns new tensors; with ``in_place`` on CUDA tensors, kernel A
    writes its result over (sdf, un) and returns them, while the two-pass
    engine and the plain fold on CPU tensors still return new tensors. With more planes,
    a host loop over z-chunks that UPDATES (sdf, un) IN PLACE and returns
    them: kernel A writes each chunk over its input, and the two-pass
    engine's chunk result is copied over it."""
    nz, ny, nx = sdf.shape
    chunked = chunk_nz is not None and nz > chunk_nz
    if chunked:
        chunk_nz = _snap_chunk_nz(nz, chunk_nz)
    fused = _fused_kernel_takes(sdf.device, (chunk_nz if chunked else nz, ny,
                                             nx), *sdf_images.shape[1:])
    views = (w2c, principal_point, focal_length, sdf_images, opt, linear, roi)
    if not chunked:
        if fused:
            return warp_fused.warp_fuse_planes(
                sdf, un, cx, cy, cz, *views, ortho_rows=z_rows,
                out=(sdf, un) if in_place and sdf.is_cuda else None)
        return warp_fold(sdf, un, cx, cy, cz, *views, interp_rows,
                         z_rows=z_rows)
    for z_lo in range(0, nz, chunk_nz):
        s = sdf[z_lo:z_lo + chunk_nz]
        u = un[z_lo:z_lo + chunk_nz]
        args = (s, u, cx, cy, cz[z_lo:z_lo + chunk_nz].contiguous(), *views)
        if fused:
            warp_fused.warp_fuse_planes(*args, ortho_rows=z_rows, out=(s, u))
        else:
            new_s, new_u = warp_fold(*args, interp_rows, z_rows=z_rows)
            s.copy_(new_s)
            u.copy_(new_u)
            del new_s, new_u
    return sdf, un


def carve_views_warp(
    state: VoxelGridState,
    grid: GridSpec,
    w2c: torch.Tensor,  # f32[V, 4, 4] or [4, 4]
    principal_point: torch.Tensor,
    focal_length: torch.Tensor,
    sdf_images: torch.Tensor,  # f32[V, H, W] or [H, W]
    opt: VoxelUpdateOption = VoxelUpdateOption(),
    linear: bool = True,
    roi: Optional[Tuple[int, int, int, int]] = None,
    in_place: bool = False,
) -> VoxelGridState:
    """Warp-engine multi-view fusion, views in order. roi is an inclusive
    (x0, y0, x1, y1) applied as the reference's ROI Carve
    (voxel_carver.cc:394-413). The engine is chosen by shape before any
    launch (``warp_carve_centers``): kernel A for views of any height
    its launch plan takes; a kernel that fails raises, and nothing falls
    back after a failure. With ``in_place`` kernel A writes over a CUDA
    ``state``'s tensors, and the returned state holds them."""
    w2c, principal_point, focal_length, sdf_images = _batched(
        w2c, principal_point, focal_length, sdf_images)
    dev = state.sdf.device
    with span("warp"):
        sdf, un = warp_carve_centers(
            state.sdf, state.update_num,
            *(grid.axis_centers_t(a, dev) for a in range(3)), w2c,
            principal_point, focal_length, sdf_images, opt, linear, roi,
            in_place=in_place)
    return VoxelGridState(sdf=sdf, update_num=un)


def carve_views_warp_ortho(
    state: VoxelGridState,
    grid: GridSpec,
    w2c: torch.Tensor,  # f32[V, 4, 4] or [4, 4]
    sdf_images: torch.Tensor,  # f32[V, H, W] or [H, W]
    opt: VoxelUpdateOption = VoxelUpdateOption(),
    linear: bool = True,
    roi: Optional[Tuple[int, int, int, int]] = None,
    in_place: bool = False,
) -> VoxelGridState:
    """Orthographic warp fusion with a structural-orientation guard.

    The warp engine assumes the image v axis couples to world y
    (|w2c[1,1]| well away from zero -- the vertical-pass inversion
    divides by it). A rolled camera that violates this would silently
    produce garbage, so the coupling is read on the host and such batches
    go through the exact engine (reference semantics,
    voxel_carver.cc:442-491) instead, which returns new tensors.
    ``in_place`` as in ``carve_views_warp``."""
    w2c, sdf_images = _batched(w2c, sdf_images)
    if ortho_warp_views(w2c) is None:
        zero2 = torch.zeros((w2c.shape[0], 2), dtype=torch.float32,
                            device=w2c.device)
        return carve_views(state, grid, w2c, zero2, zero2, sdf_images,
                           roi=roi, opt=opt, projection="ortho")
    return _carve_views_warp_ortho(state, grid, w2c, sdf_images, opt, linear,
                                   roi, in_place)


def ortho_warp_views(w2c: torch.Tensor):
    """The engine decision for orthographic views ``w2c`` f32[V, 4, 4],
    made in this one place for a dense and a block-sharded state alike:
    ``ortho_homography(w2c)`` where the warp engine can take the batch,
    None (with a warning) where a view decouples image v from world y and
    the batch must go through the exact engine."""
    coupling = float(w2c[:, 1, 1].abs().min())
    if coupling < _ORTHO_V_COUPLING_MIN:
        LOGW("carve_views_warp_ortho: |w2c[1,1]| = %.2e decouples image v "
             "from world y; falling back to the exact engine", coupling)
        return None
    return ortho_homography(w2c)


def ortho_homography(w2c: torch.Tensor):
    """What the warp engine takes for orthographic views ``w2c``
    f32[V, 4, 4]: (the synthetic homography with third row (0, 0, 0, 1),
    zero principal points f32[V, 2], unit focal lengths f32[V, 2], and
    the real camera-z rows f32[V, 4] for the behind-camera mask)."""
    w2c_synth = w2c.clone()
    w2c_synth[:, 2, :] = torch.tensor([0.0, 0.0, 0.0, 1.0],
                                      dtype=torch.float32, device=w2c.device)
    zero2 = torch.zeros((w2c.shape[0], 2), dtype=torch.float32,
                        device=w2c.device)
    return w2c_synth, zero2, torch.ones_like(zero2), w2c[:, 2, :].contiguous()


def _carve_views_warp_ortho(
    state: VoxelGridState,
    grid: GridSpec,
    w2c: torch.Tensor,  # f32[V, 4, 4]
    sdf_images: torch.Tensor,  # f32[V, H, W]
    opt: VoxelUpdateOption = VoxelUpdateOption(),
    linear: bool = True,
    roi: Optional[Tuple[int, int, int, int]] = None,
    in_place: bool = False,
) -> VoxelGridState:
    """Warp-engine multi-view fusion for ORTHOGRAPHIC cameras.

    An affine projection is a special case of the per-z-slice
    homography: a synthetic third row (0, 0, 0, 1) in place of w2c's
    makes the projective divisor S identically 1, and with unit focal
    length and zero principal point the two-pass warp evaluates exactly
    u = x_cam, v = y_cam (camera.cc:196-212). The synthetic homography
    loses the behind-camera test (S < 0 never fires), so the real camera
    z, affine in the voxel index, is evaluated as one broadcast
    expression per view by the two-pass engine, and carried as four more
    coefficients per view by the fused warp kernel. The engine is chosen
    by shape before any launch, as in ``carve_views_warp``."""
    dev = state.sdf.device
    w2c_synth, zero2, one2, z_rows = ortho_homography(w2c)
    with span("warp"):
        sdf, un = warp_carve_centers(
            state.sdf, state.update_num,
            *(grid.axis_centers_t(a, dev) for a in range(3)), w2c_synth,
            zero2, one2, sdf_images, opt, linear, roi, z_rows=z_rows,
            in_place=in_place)
    return VoxelGridState(sdf=sdf, update_num=un)


def _snap_chunk_nz(nz: int, chunk_nz: int) -> int:
    """The largest divisor of ``nz`` at most ``chunk_nz`` (always exists:
    1). Exact tiling only: a clamped or overlapping last chunk would fuse
    its voxels twice and double-count update_num."""
    if nz % chunk_nz == 0:
        return chunk_nz
    snapped = max(d for d in range(1, chunk_nz + 1) if nz % d == 0)
    if snapped < max(8, chunk_nz // 8):
        # a (near-)prime nz degrades to per-plane launches; make the
        # cliff visible so the caller can pad the grid instead
        LOGW("carve_views_warp_blocked: nz=%d has no divisor near "
             "chunk_nz=%d; snapping to %d planes per chunk (%d "
             "dispatches). Pad the grid z extent to a composite size for "
             "full-speed chunking.", nz, chunk_nz, snapped, nz // snapped)
    return snapped


def carve_views_warp_blocked(
    state: VoxelGridState,
    grid: GridSpec,
    w2c: torch.Tensor,
    principal_point: torch.Tensor,
    focal_length: torch.Tensor,
    sdf_images: torch.Tensor,
    opt: VoxelUpdateOption = VoxelUpdateOption(),
    linear: bool = True,
    chunk_nz: int = 128,
    roi: Optional[Tuple[int, int, int, int]] = None,
) -> VoxelGridState:
    """Warp fusion for grids whose two-pass per-view fields exceed the
    card's memory (1024^3): a host loop over z-chunks of ``chunk_nz``
    planes, each fused by the engine ``carve_views_warp`` would pick (the
    warp is separable per z, so the result is identical to it, bit for
    bit).

    With more than ``chunk_nz`` planes the state is UPDATED IN PLACE and
    the returned state holds the caller's tensors (the JAX package donates
    its buffers): kernel A writes each chunk over its input, and the
    two-pass engine's chunk result is copied over it. With kernel A, for
    views of any height its plan takes, the peak is the state (8 bytes per
    voxel, 8.6 GB at 1024^3) plus the images. ``VoxelCarver`` holds the
    same one state without chunks: its warp carve passes ``in_place`` to
    ``carve_views_warp``, and kernel A takes all 1024 planes in one
    launch. The two-pass engine, which takes only what that plan refuses,
    adds one view's fields over one chunk (about 10 arrays of ``chunk_nz
    * max(h, ny) * nx`` f32: ~11 GB for 2160-row views at 1024^3, where
    its unchunked fold would need eight times that). A grid of at most
    ``chunk_nz`` planes is one ``carve_views_warp`` call, which returns
    new tensors."""
    w2c, principal_point, focal_length, sdf_images = _batched(
        w2c, principal_point, focal_length, sdf_images)
    dev = state.sdf.device
    with span("warp"):
        sdf, un = warp_carve_centers(
            state.sdf, state.update_num,
            *(grid.axis_centers_t(a, dev) for a in range(3)), w2c,
            principal_point, focal_length, sdf_images, opt, linear, roi,
            chunk_nz=chunk_nz)
    return VoxelGridState(sdf=sdf, update_num=un)
