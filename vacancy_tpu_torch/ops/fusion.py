"""The per-voxel fusion update rule (``vacancy_tpu/ops/fusion.py:152-199``).

Shared by the warp engine's plain version and, as the same expressions in
C++, by the fused warp kernel (``csrc/warp_fused.cu``). Float expressions
keep the JAX package's operation order so results round identically.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import VoxelUpdate, VoxelUpdateOption


def truncation_threshold(opt: VoxelUpdateOption) -> np.float32:
    """Below-range skip threshold for truncated samples: the reference's
    -1 (band-normalized values, voxel_carver.cc:477-480), or -band when
    truncation is metric."""
    return np.float32(
        -float(opt.truncation_band) if opt.metric_truncation else -1.0
    )


def apply_view_update(
    sdf: torch.Tensor,
    update_num: torch.Tensor,
    dist: torch.Tensor,
    skip: torch.Tensor,
    opt: VoxelUpdateOption,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One view's update given the sampled distance and skip mask:
    first-touch / cap / truncation-skip semantics (voxel_carver.cc:447-488)
    and both update rules (voxel_carver.cc:78-95). Returns new tensors."""
    dev = sdf.device
    # frozen voxels: update_num > cap (voxel_carver.cc:447-449)
    skip = skip | (update_num > opt.voxel_max_update_num)
    if opt.use_truncation:
        thresh = torch.tensor(truncation_threshold(opt), device=dev)
        skip = skip | (dist < thresh)

    first_touch = update_num < 1
    if opt.voxel_update == VoxelUpdate.MAX:
        # kMax: sdf = max(sdf, d); update_num++ only on improvement
        # (voxel_carver.cc:78-86); first touch always writes (.:482-486).
        improved = dist > sdf
        new_sdf = torch.where(first_touch, dist, torch.maximum(sdf, dist))
        new_un = update_num + (first_touch | improved).to(torch.int32)
    elif opt.voxel_update == VoxelUpdate.WEIGHTED_AVERAGE:
        # kWeightedAverage: running mean; the weight cancels algebraically
        # (voxel_carver.cc:88-95) but the float expression is kept as
        # written for bit parity: ((w * n) * sdf + w * dist) * inv_denom
        w = torch.tensor(np.float32(opt.voxel_update_weight), device=dev)
        one = torch.tensor(1.0, dtype=torch.float32, device=dev)
        n = update_num.to(torch.float32)
        inv_denom = one / (w * (n + one))
        avg = (w * n * sdf + w * dist) * inv_denom
        new_sdf = torch.where(first_touch, dist, avg)
        new_un = update_num + 1
    else:
        raise ValueError(f"unknown update rule {opt.voxel_update}")

    out_sdf = torch.where(skip, sdf, new_sdf)
    out_un = torch.where(skip, update_num, new_un)
    return out_sdf, out_un
