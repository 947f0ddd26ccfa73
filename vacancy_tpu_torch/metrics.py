"""Mesh quality metrics: Chamfer / Hausdorff distance between point sets.

Used by the parity harness to compare reconstructions against
``data/GT.ply`` (the BASELINE bound: Chamfer <= 1e-3 of the bbox
diagonal). Distances are computed point-to-point over (sampled) vertex
sets with a KD-tree on host; for very large meshes pass ``max_points``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _as_points(mesh_or_points) -> np.ndarray:
    if hasattr(mesh_or_points, "vertices"):
        return np.asarray(mesh_or_points.vertices, np.float64)
    return np.asarray(mesh_or_points, np.float64).reshape(-1, 3)


def _sample(points: np.ndarray, max_points: Optional[int], seed: int = 0):
    if max_points is None or len(points) <= max_points:
        return points
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(points), size=max_points, replace=False)
    return points[idx]


def _nn_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """For each point in a, distance to the nearest point in b."""
    from scipy.spatial import cKDTree

    tree = cKDTree(b)
    d, _ = tree.query(a, k=1, workers=-1)
    return d


def chamfer_distance(
    a, b, max_points: Optional[int] = 200_000
) -> Tuple[float, float, float]:
    """Symmetric Chamfer distance (mean nearest-neighbor, both ways).

    Returns (chamfer, mean_a_to_b, mean_b_to_a)."""
    pa = _sample(_as_points(a), max_points)
    pb = _sample(_as_points(b), max_points)
    d_ab = float(_nn_dists(pa, pb).mean())
    d_ba = float(_nn_dists(pb, pa).mean())
    return 0.5 * (d_ab + d_ba), d_ab, d_ba


def hausdorff_distance(a, b, max_points: Optional[int] = 200_000) -> float:
    """Symmetric Hausdorff distance (max of the two directed maxima)."""
    pa = _sample(_as_points(a), max_points)
    pb = _sample(_as_points(b), max_points)
    return float(
        max(_nn_dists(pa, pb).max(), _nn_dists(pb, pa).max())
    )


def bbox_diagonal(mesh_or_points) -> float:
    p = _as_points(mesh_or_points)
    return float(np.linalg.norm(p.max(axis=0) - p.min(axis=0)))
