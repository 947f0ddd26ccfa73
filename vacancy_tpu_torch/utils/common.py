"""Math/common utilities (reference include/vacancy/common.h:30-82)."""

from __future__ import annotations

import numpy as np

_DEG2RAD = 0.01745329251994329576923690768489
_RAD2DEG = 57.295779513082320876798154814105


def radians(degrees_val):
    """Degrees -> radians (common.h:32-39, glm-style constant)."""
    return degrees_val * _DEG2RAD


def degrees(radians_val):
    """Radians -> degrees (common.h:41-48)."""
    return radians_val * _RAD2DEG


def c2w(
    position,
    target,
    up,
) -> np.ndarray:
    """Camera-to-world look-at pose (common.h:50-76).

    OpenCV convention (camera.h:6-10): column 2 (z) looks from `position`
    toward `target`, column 0 (x) = z x up normalized, column 1 (y) =
    z x x. Returns a 4x4 float64 matrix with `position` as translation.
    """
    position = np.asarray(position, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)

    z = target - position
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)

    T = np.eye(4, dtype=np.float64)
    T[:3, 0] = x
    T[:3, 1] = y
    T[:3, 2] = z
    T[:3, 3] = position
    return T
