"""Projective-warp fusion of many views (``vacancy_tpu/ops/fusion_warp.py``).

``carve_views_warp`` folds every view into a grid state through
``ops/warp_fused.warp_fuse_planes``: one launch of the fused warp kernel
for CUDA tensors, the two-pass plain fold for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import VoxelUpdateOption
from ..grid import GridSpec, VoxelGridState
from .warp_fused import warp_fuse_planes


def carve_views_warp(
    state: VoxelGridState,
    grid: GridSpec,
    w2c: torch.Tensor,  # f32[V, 4, 4] or [4, 4]
    principal_point: torch.Tensor,
    focal_length: torch.Tensor,
    sdf_images: torch.Tensor,  # f32[V, H, W] or [H, W]
    opt: VoxelUpdateOption = VoxelUpdateOption(),
    linear: bool = True,
    roi: Optional[Tuple[int, int, int, int]] = None,
) -> VoxelGridState:
    """Warp-engine multi-view fusion, views in order. roi is an inclusive
    (x0, y0, x1, y1) applied as the reference's ROI Carve
    (voxel_carver.cc:394-413)."""
    if w2c.ndim == 2:
        w2c = w2c[None]
        principal_point = principal_point[None]
        focal_length = focal_length[None]
        sdf_images = sdf_images[None]
    dev = state.sdf.device
    sdf, un = warp_fuse_planes(
        state.sdf, state.update_num,
        grid.axis_centers_t(0, dev), grid.axis_centers_t(1, dev),
        grid.axis_centers_t(2, dev),
        w2c, principal_point, focal_length, sdf_images, opt, linear, roi,
    )
    return VoxelGridState(sdf=sdf, update_num=un)
