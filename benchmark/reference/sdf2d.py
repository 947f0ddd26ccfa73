"""2D signed distance images of silhouette masks (voxel_carver.cc:105-237).

The L1 distance to the nearest pixel of the other side is separable: per
axis, ``f[i] = min_j |i - j| + d[j]`` is a forward and a backward
min-plus scan with unit slope. Every distance is a small integer or
FLT_MAX, exact in float32. Then, per image: negative inside, positive
outside; divided by the largest magnitude (one rounded reciprocal, then a
product); truncated, ``d <= -band`` to the sentinel and ``min(1, d /
band)`` elsewhere.
"""

import numpy as np
import torch

from .geometry import INVALID_SDF, rounded

FLT_MAX = float(np.finfo(np.float32).max)
FLT_TINY = float(np.finfo(np.float32).tiny)


def _scan(d, dim):
    n = d.shape[dim]
    shape = [1] * d.ndim
    shape[dim] = n
    i = torch.arange(n, dtype=torch.float32, device=d.device).reshape(shape)
    fwd = i + torch.cummin(d - i, dim=dim).values
    bwd = -i + torch.cummin((d + i).flip(dim), dim=dim).values.flip(dim)
    return torch.minimum(fwd, bwd)


def distance_l1(fg):
    """City-block distance of every ``True`` pixel of ``fg`` [V, H, W] to
    the nearest ``False`` one (0 on ``False`` pixels)."""
    big = torch.tensor(FLT_MAX, dtype=torch.float32, device=fg.device)
    zero = torch.tensor(0.0, dtype=torch.float32, device=fg.device)
    return _scan(_scan(torch.where(fg, big, zero), 1), 2)


def sdf_images(masks, band, store=torch.float32, block=4):
    """float32 [V, H, W] signed distance images of uint8 masks [V, H, W]
    (255 = foreground), normalised and truncated by ``band``, in blocks of
    ``block`` views."""
    dev = masks.device

    def f32(v):
        return torch.tensor(np.float32(v), dtype=torch.float32, device=dev)

    out = torch.empty(masks.shape, dtype=torch.float32, device=dev)
    for lo in range(0, masks.shape[0], block):
        fg = masks[lo:lo + block] == 255
        sdf = torch.where(fg, -distance_l1(fg), distance_l1(~fg))
        abs_max = torch.maximum(sdf.amax(dim=(1, 2)), -sdf.amin(dim=(1, 2)))
        norm = torch.where(abs_max > FLT_TINY, f32(1.0) / abs_max, f32(1.0))
        sdf = sdf * norm[:, None, None]
        b = f32(band)
        sdf = torch.where(-b >= sdf, f32(INVALID_SDF),
                          torch.minimum(f32(1.0), sdf / b))
        out[lo:lo + block] = rounded(sdf, store)
    return out
