"""TUM-format trajectory loader (reference: examples.cc:22-72).

Each line: ``id tx ty tz qx qy qz qw`` -> 4x4 camera-to-world pose
(translation composed with the unit quaternion's rotation).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def quat_to_rotmat(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    """Unit quaternion -> 3x3 rotation matrix (float64)."""
    q = np.array([qw, qx, qy, qz], np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def load_tum_format(path: str) -> List[Tuple[int, np.ndarray]]:
    """Parse TUM pose lines into (id, c2w 4x4 float64) pairs."""
    poses = []
    with open(path) as fp:
        for line in fp:
            tok = line.split()
            if not tok:
                continue
            if len(tok) != 8:
                raise ValueError(f"wrong tum format: {line!r}")
            pose_id = int(tok[0])
            tx, ty, tz, qx, qy, qz, qw = (float(t) for t in tok[1:])
            c2w = np.eye(4, dtype=np.float64)
            c2w[:3, :3] = quat_to_rotmat(qx, qy, qz, qw)
            c2w[:3, 3] = [tx, ty, tz]
            poses.append((pose_id, c2w))
    return poses


def load_tum_poses(path: str) -> List[np.ndarray]:
    """Poses only (reference's second overload, examples.cc:58-72)."""
    return [pose for _, pose in load_tum_format(path)]
