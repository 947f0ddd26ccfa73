"""The reference of upstream vacancy's naive voxel carving, as a
configuration names it (``"reference": "naive_carving"``): masks and
cameras in; SDF images, state and mesh out.

This is the per-voxel ``Carve`` of voxel_carver.cc:442-491 under the
defaults of ``VoxelCarverOption`` and ``VoxelUpdateOption``
(voxel_carver.h:43-60): the 2D SDF min-max normalised and not truncated,
bilinear sampling, views outside the image skipped, the kMax rule, a cap
on updates. Every step is float32 and is done in this order, per view
and per voxel centre ``p = (x, y, z)``:

1. 2D SDF (voxel_carver.cc:105-237): the L1 distance to the other side,
   negative inside, an exact small integer; then multiplied by the one
   rounded reciprocal of the image's largest magnitude (:214-219). A
   division in its place changes bits.
2. ``c = R p + t`` with each row summed as ``((x r0 + y r1) + z r2) + t``,
   the order of Eigen's fixed-size product (:453). Another order of the
   sum changes bits.
3. Skip the voxel when ``c.z < 0`` (:456-458).
4. ``u = fx / c.z * c.x + cx`` and ``v = fy / c.z * c.y + cy``, left to
   right (camera.cc:131-137). ``fx * c.x / c.z`` changes bits.
5. Skip a non-finite ``(u, v)`` and one outside the image: ``u < 0``,
   ``v < 0``, ``u > w - 1``, ``v > h - 1`` (:464-475).
6. Bilinear (:40-76): ``x0 = floor(u)`` (upstream's integer cast, the
   same for ``u >= 0``), ``x1 = min(x0 + 1, w - 1)``, ``a = u - x0``;
   likewise ``y0``, ``y1``, ``b``; then
   ``d = (1-a)(1-b) s00 + a(1-b) s10 + (1-a) b s01 + a b s11``, each
   product and the sum left to right, as written there. Another
   grouping changes bits.
7. Skip a voxel updated more than ``cap`` times (:447-449). Its first
   touch writes ``d`` (:482-486); a later one writes ``d`` only where
   ``d > sdf``, and counts an update only then (``UpdateVoxelMax``,
   :78-86).

Views fold in order into a fresh grid; voxels are independent, so the
grid is folded in blocks of z-planes, all views each. The mesh is
``reference.mc``'s. ``store`` is the precision the images and the state
are kept in between steps, as in ``reference/__init__.py``.
"""

import contextlib

import numpy as np
import torch

from . import mc
from .geometry import (INVALID_SDF, axis_centers, rounded,
                       world_to_camera)
from .sdf2d import FLT_TINY, distance_l1

# the options this reference computes; a configuration that asks for
# others needs a reference of its own
RULE = dict(rule="MAX", sdf_interp="BILINEAR", update_outside="NONE",
            use_truncation=False, sdf_minmax_normalize=True)


@contextlib.contextmanager
def _no_tf32():
    """float32 products in float32, not TF32, inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def sdf_images(masks, store=torch.float32, block=4):
    """float32 [V, H, W] min-max normalised, untruncated signed distance
    images of uint8 masks [V, H, W] (255 = foreground), in blocks of
    ``block`` views."""
    dev = masks.device
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    out = torch.empty(masks.shape, dtype=torch.float32, device=dev)
    for lo in range(0, masks.shape[0], block):
        fg = masks[lo:lo + block] == 255
        sdf = torch.where(fg, -distance_l1(fg), distance_l1(~fg))
        abs_max = torch.maximum(sdf.amax(dim=(1, 2)), -sdf.amin(dim=(1, 2)))
        norm = torch.where(abs_max > FLT_TINY, one / abs_max, one)
        out[lo:lo + block] = rounded(sdf * norm[:, None, None], store)
    return out


def _distance(img, w2c, pp, fl, x, y, z):
    """(d, skip) of one view over the voxels at the broadcast centres
    ``x`` [1, 1, nx], ``y`` [1, ny, 1], ``z`` [nz, 1, 1]: steps 2-6."""
    h, w = img.shape
    r, t = w2c[:3, :3], w2c[:3, 3]
    cam = [((x * r[k, 0] + y * r[k, 1]) + z * r[k, 2]) + t[k]
           for k in range(3)]
    u = fl[0] / cam[2] * cam[0] + pp[0]
    v = fl[1] / cam[2] * cam[1] + pp[1]
    skip = ((cam[2] < 0) | ~(torch.isfinite(u) & torch.isfinite(v))
            | (u < 0) | (v < 0) | (u > w - 1) | (v > h - 1))
    # a skipped voxel samples pixel (0, 0), so every tap lies in the image
    u = torch.where(skip, 0.0, u)
    v = torch.where(skip, 0.0, v)
    xf, yf = torch.floor(u), torch.floor(v)
    x0, y0 = xf.to(torch.int64), yf.to(torch.int64)
    x1, y1 = torch.clamp_max(x0 + 1, w - 1), torch.clamp_max(y0 + 1, h - 1)
    a, b = u - xf, v - yf
    flat = img.reshape(-1)
    d = ((1.0 - a) * (1.0 - b) * flat[y0 * w + x0]
         + a * (1.0 - b) * flat[y0 * w + x1]
         + (1.0 - a) * b * flat[y1 * w + x0]
         + a * b * flat[y1 * w + x1])
    return d, skip


def fold(images, w2c, pp, fl, cx, cy, cz, cap, store=torch.float32,
         planes=64):
    """The state (sdf f32, update_num i32) [nz, ny, nx] after folding the
    views of ``images`` in order into an untouched grid with the kMax
    rule (step 7), ``planes`` z-planes at a time."""
    nz, ny, nx = cz.shape[0], cy.shape[0], cx.shape[0]
    dev = images.device
    sdf = torch.full((nz, ny, nx), INVALID_SDF, dtype=torch.float32,
                     device=dev)
    un = torch.zeros((nz, ny, nx), dtype=torch.int32, device=dev)
    x, y = cx.reshape(1, 1, nx), cy.reshape(1, ny, 1)
    for lo in range(0, nz, planes):
        s, n = sdf[lo:lo + planes], un[lo:lo + planes]
        z = cz[lo:lo + planes].reshape(-1, 1, 1)
        for i in range(images.shape[0]):
            d, skip = _distance(images[i], w2c[i], pp[i], fl[i], x, y, z)
            write = ~(skip | (n > cap)) & ((n < 1) | (d > s))
            s.copy_(rounded(torch.where(write, d, s), store))
            n.add_(write.to(torch.int32))
    return sdf, un


def reconstruct(masks, c2w, principal_point, focal_length, config, stages,
                store=torch.float32):
    """``masks`` uint8 [V, H, W] on the device the work runs on;
    ``c2w`` float64 [V, 4, 4], ``principal_point`` and ``focal_length``
    float32 [V, 2] (numpy); ``config`` a configuration's ``grid``,
    ``update``, ``extract`` and ``precision``. Returns, of ``stages``,
    ``sdf_images`` (float32 [V, H, W] on that device), ``state`` (sdf
    float32 and update_num int32 [nz, ny, nx] on that device) and
    ``mesh`` (vertices float32 [N, 3] and faces int32 [M, 3] in numpy),
    with the images and the state kept in ``store`` between steps."""
    grid, update = config["grid"], config["update"]
    if (any(update[k] != v for k, v in RULE.items())
            or not config["extract"]["linear_interp"]
            or config["precision"] != "float32"):
        raise ValueError(f"this reference computes {RULE} in float32 with "
                         f"interpolated vertices, not {config}")
    dev = masks.device
    out = {}
    with _no_tf32():
        images = sdf_images(masks, store)
        if "sdf_images" in stages:
            out["sdf_images"] = images
        if not {"state", "mesh"} & set(stages):
            return out
        box = (grid["bb_min"], grid["bb_max"], grid["resolution"])
        centers = [axis_centers(*box, a) for a in range(3)]
        w2c = torch.from_numpy(np.stack([world_to_camera(m) for m in c2w]))
        sdf, un = fold(
            images, w2c.to(dev),
            torch.from_numpy(np.asarray(principal_point, np.float32)).to(dev),
            torch.from_numpy(np.asarray(focal_length, np.float32)).to(dev),
            *(torch.from_numpy(c).to(dev) for c in centers),
            cap=int(update["voxel_max_update_num"]), store=store)
        del images
        out["state"] = (sdf, un)
        if "mesh" in stages:
            out["mesh"] = mc.extract(sdf, un, *centers,
                                     iso=config["extract"]["iso_level"])
    return out
