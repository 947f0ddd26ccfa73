"""The 2D SDF in hand-written kernels, S: the wrapper of ``csrc/sdf2d_fused.cu``.

The kernels replace no TPU kernel: the JAX package computes the layer with
XLA scans, and ``ops/sdf2d.signed_distance_field_plain`` with ``torch.cummin``
scans and a dozen more passes over full-size float32 temporaries. S turns a
``[..., H, W]`` stack of uint8 (255 = foreground) or bool masks into the
finished float32 images in three launches: the column distances of both
classes at once (pass 1), the row transform with the sign and each image's
largest |value| (pass 2), then the scale or normalisation and the truncation
(pass 3). Intermediates are int16 or stay on chip (see the source's header).

Every distance is an integer and the float steps keep the plain version's
order and operations, so the two agree bit for bit. ``sdf2d_fused`` runs the
plain version for CPU tensors and only for them; on a CUDA tensor it launches
S or raises: ``sdf2d_refusal`` names what S cannot take.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _kernels
from ..config import INVALID_SDF
from . import sdf2d  # which imports this module: use at call time

# h + w of the images S takes: its int16 distances hold (h - 1) + (w - 1)
# below the sentinel 32767
MAX_SIDES = 32768
# image rows of a stack: pass 3 launches a CTA per row
MAX_ROWS = 2**31 - 1
# kernels that one call launches
LAUNCHES = 3
# the C entry point's modes
_RAW, _SCALE, _MINMAX = 0, 1, 2


def sdf2d_refusal(n_views: int, h: int, w: int,
                  roi: Tuple[int, int, int, int]) -> Optional[str]:
    """What S cannot take in a stack of ``n_views`` images of ``h x w``
    pixels with the inclusive ``roi`` (x0, y0, x1, y1), or None."""
    if h + w > MAX_SIDES:
        return (f"images of {h} x {w} pixels: h + w = {h + w} is past "
                f"{MAX_SIDES}, the range of the kernels' 16-bit distances")
    x0, y0, x1, y1 = roi
    if not (0 <= x0 <= x1 < w and 0 <= y0 <= y1 < h):
        return f"the roi {tuple(roi)}: not inside the {w} x {h} image"
    if n_views * h > MAX_ROWS:
        return (f"{n_views} images of {h} rows: more than {MAX_ROWS} rows "
                f"in one launch")
    return None


def sdf2d_fused(
    mask: torch.Tensor,
    roi: Optional[Tuple[int, int, int, int]] = None,
    minmax_normalize: bool = True,
    use_truncation: bool = False,
    truncation_band: float = 0.1,
    sdf_scale: Optional[float] = None,
) -> torch.Tensor:
    """``sdf2d.make_signed_distance_field`` through kernel set S.

    CPU tensors take the plain version. CUDA tensors launch S's three
    kernels (``sdf2d_fused.launches`` counts the launches and
    ``sdf2d_fused.images`` the images transformed) or raise: TypeError
    for masks neither uint8 nor bool, ValueError for what S does not take
    (``sdf2d_refusal``), RuntimeError on a build failure or a non-zero
    cudaError_t."""
    if mask.device.type == "cpu":
        return sdf2d.signed_distance_field_plain(
            mask, roi, minmax_normalize, use_truncation, truncation_band,
            sdf_scale)
    if mask.dtype not in (torch.uint8, torch.bool):
        raise TypeError(f"mask must be uint8 or bool, got {mask.dtype}")
    if mask.ndim < 2:
        raise ValueError(f"mask must be [..., H, W], got {tuple(mask.shape)}")
    shape = tuple(mask.shape)
    h, w = shape[-2:]
    dev = mask.device
    mask = mask.contiguous()
    _kernels.check_tensor("mask", mask, mask.dtype, shape)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    n_views = out.numel() // (h * w)
    x0, y0, x1, y1 = (int(r) for r in sdf2d._full_roi(h, w, roi))
    refusal = sdf2d_refusal(n_views, h, w, (x0, y0, x1, y1))
    if refusal is not None:
        raise ValueError(f"the fused 2D SDF kernels do not take {refusal}")
    dist = torch.empty((n_views, y1 - y0 + 1, x1 - x0 + 1), dtype=torch.int16,
                       device=dev)
    abs_max = torch.empty((n_views,), dtype=torch.int32, device=dev)
    mode = (_SCALE if sdf_scale is not None
            else _MINMAX if minmax_normalize else _RAW)
    err = _kernels.load().vt_sdf2d(
        mask.data_ptr(), dist.data_ptr(), abs_max.data_ptr(), out.data_ptr(),
        n_views, h, w, x0, y0, x1, y1,
        1 if mask.dtype == torch.bool else 255, mode,
        int(bool(use_truncation)),
        float(sdf_scale) if sdf_scale is not None else 0.0,
        float(truncation_band), float(INVALID_SDF),
        _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "sdf2d_fused kernel launch")
    sdf2d_fused.launches += LAUNCHES
    sdf2d_fused.images += n_views
    return out


sdf2d_fused.launches = 0
sdf2d_fused.images = 0
