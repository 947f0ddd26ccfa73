"""2D L1 distance transform and signed distance field, batched over views.

Same formulation as ``vacancy_tpu/ops/sdf2d.py``: the L1 metric is
separable, and each 1D transform ``f[i] = min_j |i - j| + d[j]`` is a
forward and a backward min-plus scan with unit slope,

    fwd[i] = i + cummin(d[j] - j),   bwd[i] = -i + revcummin(d[j] + j),

here as ``torch.cummin`` along one axis of a ``[V, H, W]`` stack. All
values are small integers or FLT_MAX, exact in f32, so the result is
bitwise the JAX package's. Masked pixels carry FLT_MAX (FLT_MAX + small
rounds back to FLT_MAX, as in the reference's guarded scans).

That plain code serves tensors off the card. On a CUDA tensor
``make_signed_distance_field`` launches kernel set S
(``ops/sdf2d_fused``, ``csrc/sdf2d_fused.cu``), three launches a call
and bit for bit this plain version; ``distance_transform_l1`` stays
plain on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import INVALID_SDF
from . import sdf2d_fused  # which imports this module: use at call time

_FLT_MAX = float(np.finfo(np.float32).max)
_FLT_TINY = float(np.finfo(np.float32).tiny)


def _dt1d(d: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact 1D L1 distance transform along `dim` via two min-plus scans."""
    n = d.shape[dim]
    shape = [1] * d.ndim
    shape[dim] = n
    iota = torch.arange(n, dtype=torch.float32, device=d.device).reshape(shape)
    fwd = iota + torch.cummin(d - iota, dim=dim).values
    bwd = -iota + torch.cummin(
        (d + iota).flip(dim), dim=dim
    ).values.flip(dim)
    return torch.minimum(fwd, bwd)


def _as_mask(mask: torch.Tensor) -> torch.Tensor:
    return mask if mask.dtype == torch.bool else mask == 255


def _full_roi(h: int, w: int, roi) -> Tuple[int, int, int, int]:
    return tuple(roi) if roi is not None else (0, 0, w - 1, h - 1)


def distance_transform_l1(
    mask: torch.Tensor,
    roi: Optional[Tuple[int, int, int, int]] = None,
) -> torch.Tensor:
    """Exact L1 distance transform of foreground masks ``[..., H, W]``.

    Foreground pixels (``True``, or ``255`` for uint8 -- reference
    voxel_carver.cc:109) get the city-block distance to the nearest
    background pixel; background pixels get 0; pixels outside the
    inclusive ROI ``(x_min, y_min, x_max, y_max)`` are 0. A foreground
    region with no background pixel in the ROI stays at FLT_MAX.
    """
    mask = _as_mask(mask)
    h, w = mask.shape[-2:]
    x0, y0, x1, y1 = _full_roi(h, w, roi)
    sub = mask[..., y0 : y1 + 1, x0 : x1 + 1]
    d = torch.where(
        sub,
        torch.tensor(_FLT_MAX, dtype=torch.float32, device=mask.device),
        torch.tensor(0.0, dtype=torch.float32, device=mask.device),
    )
    d = _dt1d(d, dim=d.ndim - 2)
    d = _dt1d(d, dim=d.ndim - 1)
    if (x0, y0, x1, y1) == (0, 0, w - 1, h - 1):
        return d
    out = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    out[..., y0 : y1 + 1, x0 : x1 + 1] = d
    return out


def make_signed_distance_field(
    mask: torch.Tensor,
    roi: Optional[Tuple[int, int, int, int]] = None,
    minmax_normalize: bool = True,
    use_truncation: bool = False,
    truncation_band: float = 0.1,
    sdf_scale: Optional[float] = None,
) -> torch.Tensor:
    """Signed distance fields of silhouette masks ``[..., H, W]``.

    Negative inside the silhouette, positive outside (reference
    voxel_carver.cc:169-237). Per image, in reference order:
    ``sdf_scale`` (metric mode) multiplies by a world-units-per-pixel
    factor; else ``minmax_normalize`` divides by the max |value| over the
    whole image (zeros outside the ROI participate); truncation maps
    ``d <= -band`` to INVALID_SDF and clamps to ``min(1, d / band)``
    (``min(band, d)`` in metric mode). Inputs are uint8 (255 =
    foreground) or bool; the result is f32 on the masks' device.

    CUDA tensors go through kernel set S (``sdf2d_fused.sdf2d_fused``),
    which raises for what it does not take; other tensors take
    ``signed_distance_field_plain``.
    """
    if mask.device.type == "cuda":
        return sdf2d_fused.sdf2d_fused(mask, roi, minmax_normalize,
                                       use_truncation, truncation_band,
                                       sdf_scale)
    return signed_distance_field_plain(mask, roi, minmax_normalize,
                                       use_truncation, truncation_band,
                                       sdf_scale)


def signed_distance_field_plain(
    mask: torch.Tensor,
    roi: Optional[Tuple[int, int, int, int]] = None,
    minmax_normalize: bool = True,
    use_truncation: bool = False,
    truncation_band: float = 0.1,
    sdf_scale: Optional[float] = None,
) -> torch.Tensor:
    """``make_signed_distance_field`` in plain PyTorch, on any device: the
    plain version of kernel set S (``ops/sdf2d_fused``), which CPU tensors
    take."""
    mask = _as_mask(mask)
    dev = mask.device
    h, w = mask.shape[-2:]
    x0, y0, x1, y1 = _full_roi(h, w, roi)

    inside_d = distance_transform_l1(mask, roi)
    outside_d = distance_transform_l1(~mask, roi)
    sdf = torch.where(mask, -inside_d, outside_d)

    in_roi = torch.zeros((h, w), dtype=torch.bool, device=dev)
    in_roi[y0 : y1 + 1, x0 : x1 + 1] = True
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    sdf = torch.where(in_roi, sdf, zero)

    def f32(v):
        return torch.tensor(np.float32(v), dtype=torch.float32, device=dev)

    if sdf_scale is not None:
        sdf = torch.where(in_roi, sdf * f32(sdf_scale), sdf)
    elif minmax_normalize:
        red = tuple(range(sdf.ndim - 2, sdf.ndim))
        abs_max = torch.maximum(sdf.amax(dim=red), -sdf.amin(dim=red))
        # 1/abs_max rounds to f32 once, then multiplies
        # (voxel_carver.cc:214-219)
        norm = torch.where(abs_max > _FLT_TINY, f32(1.0) / abs_max, f32(1.0))
        sdf = torch.where(in_roi, sdf * norm[..., None, None], sdf)

    if use_truncation:
        band = f32(truncation_band)
        if sdf_scale is not None:
            trunc = torch.where(
                -band >= sdf, f32(INVALID_SDF), torch.minimum(band, sdf)
            )
        else:
            trunc = torch.where(
                -band >= sdf, f32(INVALID_SDF),
                torch.minimum(f32(1.0), sdf / band),
            )
        sdf = torch.where(in_roi, trunc, sdf)

    return sdf


def signed_distance_to_color(
    sdf: np.ndarray, min_negative_d: float = -1.0, max_positive_d: float = 1.0
) -> np.ndarray:
    """SDF -> red(outside)/blue(inside) debug image on the host
    (voxel_carver.cc:239-267)."""
    assert min_negative_d < 0 and max_positive_d > 0
    sdf = np.asarray(sdf, np.float32)
    pos = (max_positive_d - sdf) / max_positive_d
    neg = (sdf - min_negative_d) / (-min_negative_d)
    pos = np.clip(pos, 0.0, 1.0)
    neg = np.clip(neg, 0.0, 1.0)
    out = np.empty(sdf.shape + (3,), np.uint8)
    is_pos = sdf > 0
    out[..., 0] = np.where(is_pos, 255, (255 * neg).astype(np.uint8))
    out[..., 1] = np.where(
        is_pos, (255 * pos).astype(np.uint8), (255 * neg).astype(np.uint8)
    )
    out[..., 2] = np.where(is_pos, (255 * pos).astype(np.uint8), 255)
    return out
