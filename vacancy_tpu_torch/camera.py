"""Pinhole and orthographic cameras as small dataclasses of torch tensors.

Convention (reference ``camera.h:6-10``): OpenCV pinhole -- right-handed,
z forward, y down, x right. ``c2w`` maps camera to world; ``w2c`` is its
inverse, computed in float64 on the host and then rounded to float32, as
``vacancy_tpu/camera.py`` does, so both packages hold the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

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

    def with_c2w(self, c2w: np.ndarray) -> "PinholeCamera":
        """Functional set_c2w: recomputes the w2c inverse
        (camera.cc:39-42)."""
        c2w = np.asarray(c2w, np.float64)
        dev = self.c2w.device
        return dataclasses.replace(self, c2w=_f32(c2w, dev),
                                   w2c=_f32(_inverse_pose(c2w), dev))

    def with_principal_point(self, pp: np.ndarray) -> "PinholeCamera":
        """Functional set_principal_point (camera.cc:97-100)."""
        return dataclasses.replace(
            self, principal_point=_f32(pp, self.principal_point.device))

    def with_focal_length(self, fl: np.ndarray) -> "PinholeCamera":
        """Functional set_focal_length (camera.cc:102-104)."""
        return dataclasses.replace(
            self, focal_length=_f32(fl, self.focal_length.device))

    def with_fov_x(self, fov_x_deg: float) -> "PinholeCamera":
        """Functional set_fov_x: same focal length per pixel for x and y
        (camera.cc:106-112)."""
        f = np.float32(
            self.width * 0.5 / np.tan(np.radians(fov_x_deg) * 0.5)
        )
        return self.with_focal_length(np.array([f, f], np.float32))

    def with_fov_y(self, fov_y_deg: float) -> "PinholeCamera":
        """Functional set_fov_y: same focal length per pixel for x and y
        (camera.cc:114-120)."""
        f = np.float32(
            self.height * 0.5 / np.tan(np.radians(fov_y_deg) * 0.5)
        )
        return self.with_focal_length(np.array([f, f], np.float32))

    @property
    def fov_x(self) -> torch.Tensor:
        return torch.rad2deg(
            2.0 * torch.atan(self.width * 0.5 / self.focal_length[..., 0])
        )

    @property
    def fov_y(self) -> torch.Tensor:
        return torch.rad2deg(
            2.0 * torch.atan(self.height * 0.5 / self.focal_length[..., 1])
        )

    def world_to_camera(self, points_w: torch.Tensor) -> torch.Tensor:
        """Transform world points [..., 3] into camera space."""
        r = self.w2c[..., :3, :3]
        t = self.w2c[..., :3, 3]
        return points_w @ r.transpose(-1, -2) + t

    def project(self, points_c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Camera-space points [..., 3] -> (image uv [..., 2], depth)."""
        z = points_c[..., 2]
        uv = (
            self.focal_length / z[..., None] * points_c[..., :2]
            + self.principal_point
        )
        return uv, z

    def unproject(self, uv: torch.Tensor, depth: torch.Tensor
                  ) -> torch.Tensor:
        """Image points + depth -> camera-space points
        (camera.cc:157-162)."""
        xy = (uv - self.principal_point) * depth[..., None] / self.focal_length
        return torch.cat([xy, depth[..., None]], dim=-1)

    def ray_c(self, uv: torch.Tensor) -> torch.Tensor:
        """Normalized camera-space ray directions (camera.cc:178-183)."""
        d = torch.cat(
            [
                (uv - self.principal_point) / self.focal_length,
                torch.ones(uv.shape[:-1] + (1,), dtype=uv.dtype,
                           device=uv.device),
            ],
            dim=-1,
        )
        return d / torch.linalg.norm(d, dim=-1, keepdim=True)

    def ray_w(self, uv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """World-space ray (origin, direction) per pixel
        (camera.cc:172-188)."""
        d = self.ray_c(uv)
        rot = self.c2w[..., :3, :3]
        org = torch.broadcast_to(self.c2w[..., :3, 3], d.shape)
        return org, d @ rot.transpose(-1, -2)


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)


def from_numpy(principal_point, focal_length, c2w, w2c, width: int,
               height: int, device) -> PinholeCamera:
    """A (possibly stacked) camera from numpy arrays, rounded to float32
    -- e.g. the fields of a JAX ``PinholeCamera`` through ``np.asarray``."""
    return PinholeCamera(
        principal_point=_f32(principal_point, device),
        focal_length=_f32(focal_length, device),
        c2w=_f32(c2w, device),
        w2c=_f32(w2c, device),
        width=int(width),
        height=int(height),
    )


@dataclasses.dataclass
class OrthoCamera:
    """Orthographic camera (reference ``camera.h:114-135``).

    Projection is the identity on camera-space x, y (camera.cc:196-212).
    Leading batch dims allow a stacked multi-view camera.
    """

    c2w: torch.Tensor  # f32[..., 4, 4]
    w2c: torch.Tensor  # f32[..., 4, 4]
    width: int
    height: int

    @staticmethod
    def create(width: int, height: int, c2w: Optional[np.ndarray] = None,
               device="cpu") -> "OrthoCamera":
        c2w = np.eye(4) if c2w is None else np.asarray(c2w, np.float64)
        return ortho_from_numpy(c2w, _inverse_pose(c2w), width, height,
                                device)

    def with_c2w(self, c2w: np.ndarray) -> "OrthoCamera":
        """Functional set_c2w: recomputes the w2c inverse
        (camera.cc:39-42)."""
        c2w = np.asarray(c2w, np.float64)
        dev = self.c2w.device
        return dataclasses.replace(self, c2w=_f32(c2w, dev),
                                   w2c=_f32(_inverse_pose(c2w), dev))

    def world_to_camera(self, points_w: torch.Tensor) -> torch.Tensor:
        """Transform world points [..., 3] into camera space."""
        r = self.w2c[..., :3, :3]
        t = self.w2c[..., :3, 3]
        return points_w @ r.transpose(-1, -2) + t

    def project(self, points_c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Camera-space points [..., 3] -> (image uv [..., 2], depth)."""
        return points_c[..., :2], points_c[..., 2]

    def unproject(self, uv: torch.Tensor, depth: torch.Tensor
                  ) -> torch.Tensor:
        """Image points + depth -> camera-space points."""
        return torch.cat([uv, depth[..., None]], dim=-1)

    def ray_c(self, uv: torch.Tensor) -> torch.Tensor:
        """Camera-space ray directions: +z for every pixel."""
        d = torch.zeros(uv.shape[:-1] + (3,), dtype=torch.float32,
                        device=uv.device)
        d[..., 2] = 1.0
        return d

    def ray_w(self, uv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """World-space ray (origin, direction) per pixel: origins offset
        along the pose x/y axes (camera.cc:232-245)."""
        rot = self.c2w[..., :3, :3]
        off = torch.stack([uv[..., 0] - self.width * 0.5,
                           uv[..., 1] - self.height * 0.5], dim=-1)
        org = self.c2w[..., :3, 3] + off @ rot[..., :2].transpose(-1, -2)
        return org, torch.broadcast_to(rot[..., :, 2], org.shape)


def ortho_from_numpy(c2w, w2c, width: int, height: int,
                     device) -> OrthoCamera:
    """A (possibly stacked) orthographic camera from numpy arrays, rounded
    to float32 -- e.g. the fields of a JAX ``OrthoCamera``."""
    return OrthoCamera(c2w=_f32(c2w, device), w2c=_f32(w2c, device),
                       width=int(width), height=int(height))


Camera = Union[PinholeCamera, OrthoCamera]


def stack_cameras(cameras: Sequence[Camera]) -> Camera:
    """Stack N same-size cameras of one type into one batched camera."""
    w, h = cameras[0].width, cameras[0].height
    if any(c.width != w or c.height != h for c in cameras):
        raise ValueError("all cameras must share width/height to stack")
    kind = type(cameras[0])
    if any(type(c) is not kind for c in cameras):
        raise ValueError("all cameras must be of one type to stack")
    return kind(**{
        f.name: torch.stack([getattr(c, f.name) for c in cameras])
        for f in dataclasses.fields(kind) if f.name not in ("width", "height")
    }, width=w, height=h)
