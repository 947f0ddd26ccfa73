"""Fusion options for the PyTorch/CUDA port.

The same option surface as ``vacancy_tpu/config.py`` (reference
``include/vacancy/voxel_carver.h:20-60``): frozen dataclasses and enums,
so a configuration means the same thing in both packages.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class VoxelUpdate(enum.Enum):
    """Voxel update rule (reference: voxel_carver.h:20-24)."""

    MAX = 0  # take max -> naive voxel carving (intersection of cones)
    WEIGHTED_AVERAGE = 1  # KinectFusion-style running mean; use truncation


class SdfInterpolation(enum.Enum):
    """2D SDF sampling mode (reference: voxel_carver.h:27-30)."""

    NN = 0
    BILINEAR = 1


class UpdateOutsideImage(enum.Enum):
    """Policy for voxels projecting outside the image (voxel_carver.h:33-37)."""

    NONE = 0  # skip the voxel
    MAX = 1  # fuse the per-image max SDF value


# The reference's invalid-SDF sentinel: std::numeric_limits<float>::lowest()
# (src/vacancy/voxel_carver.cc:100).
INVALID_SDF = np.float32(np.finfo(np.float32).min)


@dataclasses.dataclass(frozen=True)
class VoxelUpdateOption:
    """Per-view fusion options (reference: voxel_carver.h:43-52)."""

    voxel_update: VoxelUpdate = VoxelUpdate.MAX
    sdf_interp: SdfInterpolation = SdfInterpolation.BILINEAR
    update_outside: UpdateOutsideImage = UpdateOutsideImage.NONE
    # After update_num exceeds this cap, the voxel is frozen
    # (reference semantics: skip when update_num > cap, voxel_carver.cc:447-449).
    voxel_max_update_num: int = 255
    voxel_update_weight: float = 1.0  # only used by WEIGHTED_AVERAGE
    use_truncation: bool = False
    truncation_band: float = 0.1  # must be positive
    # Metric-TSDF extension: truncated 2D SDF values stay in world units,
    # so the fusion loop's truncated-sample skip threshold is
    # -truncation_band instead of the reference's hardcoded -1 (which
    # assumes band-normalized values).
    metric_truncation: bool = False

    def validate(self) -> None:
        if self.voxel_max_update_num < 1:
            raise ValueError("voxel_max_update_num must be positive")
        if self.voxel_update_weight <= 0.0:
            raise ValueError("voxel_update_weight must be positive")
        if self.truncation_band <= 0.0:
            raise ValueError("truncation_band must be positive")
