"""Synthetic turntable data: silhouettes of a sphere-union blob seen from
orbiting pinhole cameras (the JAX package's ``synthetic.py``, with the
rendering as torch on the given device). The scene comes from the same
numpy generator, so both packages render the same numbers."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .camera import PinholeCamera


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)):
    """c2w pose for an OpenCV-convention camera at `eye` looking at
    `target` (z forward, y down -- reference common.h:44-67 semantics)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    z = target - eye
    z = z / np.linalg.norm(z)
    up = np.asarray(up, np.float64)
    x = np.cross(-up, z)  # y-down convention
    if np.linalg.norm(x) < 1e-9:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0] = x
    c2w[:3, 1] = y
    c2w[:3, 2] = z
    c2w[:3, 3] = eye
    return c2w


def turntable_cameras(
    n_views: int,
    radius: float,
    width: int = 320,
    height: int = 240,
    fov_y_deg: float = 45.0,
    elevation: float = 0.25,
    device="cpu",
) -> List[PinholeCamera]:
    cams = []
    for i in range(n_views):
        ang = 2.0 * np.pi * i / n_views
        eye = np.array(
            [
                radius * np.cos(ang),
                radius * elevation * np.sin(3 * ang + 0.5),
                radius * np.sin(ang),
            ]
        )
        cams.append(
            PinholeCamera.create(
                width, height, c2w=look_at(eye, np.zeros(3)),
                fov_y_deg=fov_y_deg, device=device,
            )
        )
    return cams


def blob_spheres(seed: int = 0, n_spheres: int = 6, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.45, 0.45, size=(n_spheres, 3)) * scale
    radii = rng.uniform(0.18, 0.42, size=n_spheres) * scale
    return centers.astype(np.float32), radii.astype(np.float32)


def render_silhouettes(
    cameras: List[PinholeCamera],
    centers: np.ndarray,
    radii: np.ndarray,
) -> torch.Tensor:
    """Analytic silhouette masks of a sphere union: pixel is foreground iff
    its camera ray hits any sphere. Returns uint8 [V, H, W] (255 = fg) on
    the cameras' device. The ray rotation is a full-f32 product (no TF32:
    ``torch.backends.cuda.matmul.allow_tf32`` is left off)."""
    device = cameras[0].c2w.device
    h, w = cameras[0].height, cameras[0].width
    vv, uu = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    uv = torch.stack([uu, vv], dim=-1)  # [H, W, 2]
    cen = torch.from_numpy(np.asarray(centers, np.float32)).to(device)
    rad = torch.from_numpy(np.asarray(radii, np.float32)).to(device)
    ones = torch.ones((h, w, 1), dtype=torch.float32, device=device)

    masks = []
    for cam in cameras:
        rot = cam.c2w[:3, :3]
        org = cam.c2w[:3, 3]
        d = torch.cat([(uv - cam.principal_point) / cam.focal_length, ones],
                      dim=-1)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        d_w = d @ rot.T
        # |org + t d - c|^2 = r^2 has a solution with t > 0
        oc = org[None, None, None, :] - cen[None, None, :, :]
        b = torch.sum(d_w[:, :, None, :] * oc, dim=-1)
        c_ = torch.sum(oc * oc, dim=-1) - rad[None, None, :] ** 2
        disc = b * b - c_
        t = -b + torch.sqrt(torch.clamp_min(disc, 0.0))
        hit = (disc >= 0) & (t > 0)
        masks.append(torch.any(hit, dim=-1).to(torch.uint8) * 255)
    return torch.stack(masks)
