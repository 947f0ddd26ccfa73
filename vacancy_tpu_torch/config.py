"""Fusion options for the PyTorch/CUDA port.

The same option surface as ``vacancy_tpu/config.py`` (reference
``include/vacancy/voxel_carver.h:20-60``): frozen dataclasses and enums,
so a configuration means the same thing in both packages.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple, Union

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


@dataclasses.dataclass(frozen=True)
class VoxelCarverOption:
    """Carver configuration (reference: voxel_carver.h:54-60).

    ``sdf_scale`` extends the reference: when set, the 2D SDF images stay
    metric -- pixel distances times this factor (world units per pixel at
    the object's depth) instead of per-image minmax normalization -- and
    ``truncation_band`` is in the same world units."""

    bb_min: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    bb_max: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    resolution: float = 0.1
    sdf_minmax_normalize: bool = True
    update_option: VoxelUpdateOption = dataclasses.field(
        default_factory=VoxelUpdateOption
    )
    sdf_scale: Optional[float] = None

    def validate(self) -> None:
        self.update_option.validate()
        if self.resolution <= 0.0:
            raise ValueError(f"resolution must be positive: {self.resolution}")
        if self.sdf_scale is not None and self.sdf_scale <= 0.0:
            raise ValueError(f"sdf_scale must be positive: {self.sdf_scale}")
        bb_min = np.asarray(self.bb_min, dtype=np.float64)
        bb_max = np.asarray(self.bb_max, dtype=np.float64)
        if np.any(bb_max <= bb_min):
            raise ValueError("input bounding box is invalid")


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """How the voxel grid is partitioned over a block mesh.

    The grid is block-partitioned along z (an int block count) or over
    2-D/3-D (z, y[, x]) blocks (a tuple mesh shape); fusion is
    embarrassingly parallel per block and marching cubes performs a
    one-voxel halo exchange per sharded axis (parallel/sharded.py).
    Build the mesh with ``parallel.make_device_mesh(config=...)``.
    """

    axis_name: str = "z"
    # Blocks along z (int), a (z, y[, x]) mesh shape (tuple), or None
    # for one block per device on a 1-D z mesh.
    n_devices: Union[Tuple[int, ...], int, None] = None


def _from_fields(cls, other):
    """An instance of the dataclass ``cls`` with the same-named fields of
    ``other``: enums matched by ``.name``, nested options converted."""
    kw, defaults = {}, cls()
    for f in dataclasses.fields(cls):
        v = getattr(other, f.name)
        default = getattr(defaults, f.name)
        if isinstance(default, enum.Enum):
            v = type(default)[v.name]
        elif dataclasses.is_dataclass(default):
            v = _from_fields(type(default), v)
        elif isinstance(default, tuple):
            v = tuple(float(x) for x in v)
        kw[f.name] = v
    return cls(**kw)


def sharding_config_from(other) -> ShardingConfig:
    """The port's ``ShardingConfig`` with the fields of ``other`` (e.g. a
    ``vacancy_tpu.config.ShardingConfig``); imports nothing of it."""
    n = other.n_devices
    if isinstance(n, (tuple, list)):
        n = tuple(int(v) for v in n)
    elif n is not None:
        n = int(n)
    return ShardingConfig(axis_name=str(other.axis_name), n_devices=n)


def update_option_from(other) -> VoxelUpdateOption:
    """The port's ``VoxelUpdateOption`` with the fields of ``other`` (e.g.
    a ``vacancy_tpu.config.VoxelUpdateOption``); imports nothing of it."""
    return _from_fields(VoxelUpdateOption, other)


def carver_option_from(other) -> VoxelCarverOption:
    """The port's ``VoxelCarverOption`` with the fields of ``other`` (e.g.
    a ``vacancy_tpu.config.VoxelCarverOption``); imports nothing of it."""
    return _from_fields(VoxelCarverOption, other)
