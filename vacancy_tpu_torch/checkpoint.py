"""Checkpoint / resume for carving runs (``vacancy_tpu/checkpoint.py``).

The complete fusion state is (sdf, update_num) per voxel plus the grid
spec and the index of the next view to fuse; per-view fusion is a pure
fold over the state, so a run resumes from a snapshot between views.

A snapshot is one ``.npz`` file with the JAX package's keys (``sdf``,
``update_num``, ``meta``: a JSON string of ``bb_min``, ``bb_max``,
``resolution``, ``next_view``, ``extra``), so a file saved by either
package loads in the other. The per-process layout of a sharded state
(``path.proc{K}``) waits for the port of ``parallel/``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional, Tuple

import numpy as np

from .grid import GridSpec, VoxelGridState, state_from_numpy, state_to_numpy

_SHARDED = ("sharded checkpoints wait for the port of parallel/ "
            "(ROADMAP Queue 1: parallel/ -> torch.distributed)")


def _meta(grid: GridSpec, next_view: int, extra: Optional[dict]) -> str:
    return json.dumps(
        {
            "bb_min": list(grid.bb_min),
            "bb_max": list(grid.bb_max),
            "resolution": grid.resolution,
            "next_view": int(next_view),
            "extra": extra or {},
        }
    )


def _atomic_savez(path: str, **payload) -> None:
    """Write-temp + atomic rename: a concurrent reader either sees the
    complete file or no file, never a half-written zip (np.savez names
    the target itself, so write to a sibling temp and os.replace)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    # a dot-prefixed basename that keeps the .npz suffix (or np.savez
    # appends its own) and that no ``path + '.proc*'`` glob can match
    d, name = os.path.split(path)
    tmp = os.path.join(d, f".{name}.tmp{os.getpid()}.npz")
    try:
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # savez failed mid-write
            os.remove(tmp)


def save_state(
    path: str,
    state: VoxelGridState,
    grid: GridSpec,
    next_view: int = 0,
    extra: Optional[dict] = None,
    force_sharded: bool = False,
) -> None:
    """Snapshot ``state`` (copied to the host) with its grid and the next
    view's index into ``path`` (``.npz`` appended if missing)."""
    if force_sharded:
        raise NotImplementedError(f"save_state(force_sharded=True): "
                                  f"{_SHARDED}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    sdf, update_num = state_to_numpy(state)
    _atomic_savez(path, sdf=sdf, update_num=update_num,
                  meta=_meta(grid, next_view, extra))


def load_state(
    path: str, sharding=None, device="cuda"
) -> Tuple[VoxelGridState, GridSpec, int, dict]:
    """(state on ``device``, grid, next view, extra) from a snapshot
    written by either package's ``save_state``."""
    if sharding is not None:
        raise NotImplementedError(f"load_state(sharding=...): {_SHARDED}")
    single = path if os.path.exists(path) else path + ".npz"
    if not os.path.exists(single):
        if glob.glob(path + ".proc*"):
            raise NotImplementedError(
                f"{path} is a per-process sharded checkpoint: {_SHARDED}")
        raise FileNotFoundError(path)
    with np.load(single, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        sdf = z["sdf"]
        un = z["update_num"]
    grid = GridSpec(
        bb_min=tuple(meta["bb_min"]),
        bb_max=tuple(meta["bb_max"]),
        resolution=float(meta["resolution"]),
    )
    if tuple(sdf.shape) != grid.shape_zyx:
        raise ValueError(f"checkpoint state {sdf.shape} does not fit its "
                         f"grid {grid.shape_zyx}")
    state = state_from_numpy(sdf, un, device)
    return state, grid, int(meta["next_view"]), meta.get("extra", {})
