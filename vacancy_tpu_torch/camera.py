"""Pinhole cameras as small dataclasses of torch tensors.

Convention (reference ``camera.h:6-10``): OpenCV pinhole -- right-handed,
z forward, y down, x right. ``c2w`` maps camera to world; ``w2c`` is its
inverse, computed in float64 on the host and then rounded to float32, as
``vacancy_tpu/camera.py`` does, so both packages hold the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def _inverse_pose(m: np.ndarray) -> np.ndarray:
    """Invert a rigid 4x4 pose in float64 (reference uses double poses)."""
    m = np.asarray(m, np.float64)
    r, t = m[:3, :3], m[:3, 3]
    inv = np.eye(4, dtype=np.float64)
    inv[:3, :3] = r.T
    inv[:3, 3] = -r.T @ t
    return inv


@dataclasses.dataclass
class PinholeCamera:
    """Pinhole camera: pixel-scale intrinsics + pose pair.

    Projection (reference ``camera.cc:122-146``):
        u = fx * x / z + cx,  v = fy * y / z + cy
    Leading batch dims allow a stacked multi-view camera.
    """

    principal_point: torch.Tensor  # f32[..., 2]
    focal_length: torch.Tensor  # f32[..., 2]
    c2w: torch.Tensor  # f32[..., 4, 4]
    w2c: torch.Tensor  # f32[..., 4, 4]
    width: int
    height: int

    @staticmethod
    def create(
        width: int,
        height: int,
        c2w: Optional[np.ndarray] = None,
        principal_point: Optional[np.ndarray] = None,
        focal_length: Optional[np.ndarray] = None,
        fov_y_deg: Optional[float] = None,
        device="cpu",
    ) -> "PinholeCamera":
        if c2w is None:
            c2w = np.eye(4)
        c2w = np.asarray(c2w, np.float64)
        w2c = _inverse_pose(c2w)
        if principal_point is None:
            # reference camera.cc:54-55
            principal_point = np.array(
                [width * 0.5 - 0.5, height * 0.5 - 0.5], np.float32
            )
        if focal_length is None:
            if fov_y_deg is None:
                focal_length = np.array([-1.0, -1.0], np.float32)
            else:
                # reference camera.cc:114-120 -- same f for x and y
                f = height * 0.5 / np.tan(np.radians(fov_y_deg) * 0.5)
                focal_length = np.array([f, f], np.float32)
        return from_numpy(
            principal_point, focal_length, c2w, w2c, width, height, device
        )


def from_numpy(principal_point, focal_length, c2w, w2c, width: int,
               height: int, device) -> PinholeCamera:
    """A (possibly stacked) camera from numpy arrays, rounded to float32
    -- e.g. the fields of a JAX ``PinholeCamera`` through ``np.asarray``."""

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)

    return PinholeCamera(
        principal_point=t(principal_point),
        focal_length=t(focal_length),
        c2w=t(c2w),
        w2c=t(w2c),
        width=int(width),
        height=int(height),
    )


def stack_cameras(cameras: Sequence[PinholeCamera]) -> PinholeCamera:
    """Stack N same-size cameras into one batched camera."""
    w, h = cameras[0].width, cameras[0].height
    if any(c.width != w or c.height != h for c in cameras):
        raise ValueError("all cameras must share width/height to stack")
    return PinholeCamera(
        principal_point=torch.stack([c.principal_point for c in cameras]),
        focal_length=torch.stack([c.focal_length for c in cameras]),
        c2w=torch.stack([c.c2w for c in cameras]),
        w2c=torch.stack([c.w2c for c in cameras]),
        width=w,
        height=h,
    )
