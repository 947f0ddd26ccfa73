"""Weighted-average fusion of SDF images into a voxel state, in the
two-pass projective-warp formulation.

Per view and z-plane the projection is a homography of the plane's
(x, y): ``u = fx P/S + cx``, ``v = fy Q/S + cy`` with P, Q, S affine in
x and y. Pass 1 samples every image row v at ``u_eq(x, v)``, where the
plane's projection crosses row v at grid column x; pass 2 samples that
field along v at each voxel's exact ``v*``. Both blend two taps
linearly, ``(1 - frac) * t0 + frac * t1``, taps clamped to the image.
A voxel behind the camera, with a non-finite or outside projection, or
whose distance is below -1 (the truncation sentinel, clamped to -1e6
before sampling) keeps its value; otherwise the first touch writes the
distance and later ones the running mean ``(w n sdf + w d) / (w (n +
1))`` (voxel_carver.cc:78-95, 442-491).
"""

import numpy as np
import torch

from .geometry import INVALID_SDF, rounded

SENTINEL_CLAMP = float(np.float32(-1e6))
SAFE_EPS = np.float32(1e-12)


def _safe(x):
    eps = torch.tensor(SAFE_EPS, device=x.device)
    return torch.where(torch.abs(x) < eps, eps, x)


def _clip(x, hi):
    return torch.nan_to_num(x, nan=0.0).clamp(-1.0, float(hi))


def _blend(t0, t1, frac):
    return (1.0 - frac) * t0 + frac * t1


def _taps(pos, hi):
    p0f = torch.floor(pos)
    p0 = p0f.to(torch.int64).clamp(0, hi)
    return p0, torch.clamp_max(p0 + 1, hi), pos - p0f


def view_distance(img, w2c, pp, fl, cx, cy, cz):
    """(dist, skip), each [nz, ny, nx], of one view over the planes
    ``cz``."""
    h, w = img.shape
    nx, ny, nz = cx.shape[0], cy.shape[0], cz.shape[0]
    r, t = w2c[:3, :3], w2c[:3, 3]
    fx, fy, cxp, cyp = fl[0], fl[1], pp[0], pp[1]
    a0 = (r[0, 2] * cz + t[0]).reshape(nz, 1, 1)
    b0 = (r[1, 2] * cz + t[1]).reshape(nz, 1, 1)
    c0 = (r[2, 2] * cz + t[2]).reshape(nz, 1, 1)
    a1, a2 = r[0, 0], r[0, 1]
    b1, b2 = r[1, 0], r[1, 1]
    c1, c2 = r[2, 0], r[2, 1]
    x = cx.reshape(1, 1, nx)

    # pass 1: row v of the image at u_eq(z, v, x) -> [nz, h, nx]
    vbar = torch.arange(h, dtype=torch.float32,
                        device=img.device).reshape(1, h, 1) - cyp
    safe = _safe(vbar * c2 - fy * b2)
    y_eq = (fy * (b0 + b1 * x) - vbar * (c0 + c1 * x)) / safe
    s_eq = _safe(c0 + c1 * x + c2 * y_eq)
    u_eq = _clip(fx * (a0 + a1 * x + a2 * y_eq) / s_eq + cxp, w)
    del y_eq, s_eq
    flat = img.clamp_min(SENTINEL_CLAMP).reshape(-1)
    p0, p1, frac = _taps(u_eq, w - 1)
    row = torch.arange(h, device=img.device).reshape(1, h, 1) * w
    inter = _blend(flat[row + p0], flat[row + p1], frac)
    del u_eq, p0, p1, frac

    # pass 2: that field along v at v*(z, y, x) -> [nz, ny, nx]
    y = cy.reshape(1, ny, 1)
    s = c0 + c1 * x + c2 * y
    q = b0 + b1 * x + b2 * y
    p = a0 + a1 * x + a2 * y
    v_star = fy * q / s + cyp
    u_star = fx * p / s + cxp
    p0, p1, frac = _taps(_clip(v_star, h), h - 1)
    dist = _blend(torch.gather(inter, 1, p0), torch.gather(inter, 1, p1),
                  frac)
    skip = ((s < 0) | ~(torch.isfinite(u_star) & torch.isfinite(v_star))
            | (u_star < 0) | (v_star < 0) | (u_star > w - 1)
            | (v_star > h - 1))
    return dist, skip


def update(sdf, un, dist, skip, cap, weight):
    """One view's weighted-average update with truncation (skip below
    -1) and the cap on updates."""
    dev = sdf.device
    skip = skip | (un > cap) | (dist < torch.tensor(np.float32(-1.0),
                                                    device=dev))
    w = torch.tensor(np.float32(weight), device=dev)
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    n = un.to(torch.float32)
    avg = (w * n * sdf + w * dist) * (one / (w * (n + one)))
    new_sdf = torch.where(un < 1, dist, avg)
    return torch.where(skip, sdf, new_sdf), torch.where(skip, un, un + 1)


def fuse(images, w2c, pp, fl, cx, cy, cz, cap, weight,
         store=torch.float32, planes=64):
    """The state (sdf f32, update_num i32) [nz, ny, nx] after folding the
    views in order into an untouched grid, ``planes`` z-planes at a time
    (the planes are independent)."""
    nz, ny, nx = cz.shape[0], cy.shape[0], cx.shape[0]
    dev = images.device
    sdf = torch.full((nz, ny, nx), INVALID_SDF, dtype=torch.float32,
                     device=dev)
    un = torch.zeros((nz, ny, nx), dtype=torch.int32, device=dev)
    for lo in range(0, nz, planes):
        s, u = sdf[lo:lo + planes], un[lo:lo + planes]
        for i in range(images.shape[0]):
            dist, skip = view_distance(images[i], w2c[i], pp[i], fl[i], cx,
                                       cy, cz[lo:lo + planes])
            new_s, new_u = update(s, u, dist, skip, cap, weight)
            s.copy_(rounded(new_s, store))
            u.copy_(new_u)
    return sdf, un
