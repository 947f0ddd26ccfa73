"""Grid centres, camera poses and the storage rounding of the reference."""

import numpy as np
import torch

# the invalid-distance sentinel: the lowest float32 (voxel_carver.cc:100)
INVALID_SDF = float(np.finfo(np.float32).min)


def voxel_num(bb_min, bb_max, resolution):
    """(nx, ny, nz): the float32 extent over the float32 resolution,
    truncated (voxel_carver.cc:276-302)."""
    diff = np.asarray(bb_max, np.float32) - np.asarray(bb_min, np.float32)
    n = (diff / np.float32(resolution)).astype(np.int32)
    return int(n[0]), int(n[1]), int(n[2])


def axis_centers(bb_min, bb_max, resolution, axis):
    """float32 voxel centres along one axis (0=x, 1=y, 2=z):
    ``diff * (i / n) + bb_min + resolution / 2`` (voxel_carver.cc:333)."""
    n = voxel_num(bb_min, bb_max, resolution)[axis]
    diff = (np.asarray(bb_max, np.float32)
            - np.asarray(bb_min, np.float32))[axis]
    i = np.arange(n, dtype=np.float32)
    offset = np.float32(resolution) * np.float32(0.5)
    return (diff * (i / np.float32(n)) + np.float32(bb_min[axis])
            + offset).astype(np.float32)


def world_to_camera(c2w):
    """The inverse of a rigid camera-to-world pose, in float64, rounded to
    float32 once."""
    m = np.asarray(c2w, np.float64)
    r, t = m[:3, :3], m[:3, 3]
    inv = np.eye(4, dtype=np.float64)
    inv[:3, :3] = r.T
    inv[:3, 3] = -r.T @ t
    return inv.astype(np.float32)


def rounded(x, store):
    """``x`` (float32) as kept in ``store``: each value rounded to that
    type and back, the sentinel kept as it is."""
    if store == torch.float32:
        return x
    return torch.where(x == INVALID_SDF, x, x.to(store).to(torch.float32))
