"""Checkpoint / resume for carving runs (``vacancy_tpu/checkpoint.py``).

The complete fusion state is (sdf, update_num) per voxel plus the grid
spec and the index of the next view to fuse; per-view fusion is a pure
fold over the state, so a run resumes from a snapshot between views.

A snapshot is one ``.npz`` file with the JAX package's keys (``sdf``,
``update_num``, ``meta``: a JSON string of ``bb_min``, ``bb_max``,
``resolution``, ``next_view``, ``extra``), so a file saved by either
package loads in the other. A block-sharded state (or any state with
``force_sharded=True``) saves one file per process, ``path.proc{K}.npz``,
holding that process's blocks under ``{field}_z{z0}_y{y0}_x{x0}`` keys
(their global offsets) plus the same ``meta``; ``load_state`` with a
sharding reads whichever files cover this process's blocks, so a state
that spans processes round-trips without being gathered anywhere. The
two packages read each other's per-process files too.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional, Tuple

import numpy as np

from .grid import (
    GridSpec,
    ShardedGridState,
    state_from_numpy,
    state_to_numpy,
)
from .parallel.mesh_utils import rank_and_world


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


def _grid_of(meta: dict) -> GridSpec:
    return GridSpec(
        bb_min=tuple(meta["bb_min"]),
        bb_max=tuple(meta["bb_max"]),
        resolution=float(meta["resolution"]),
    )


def save_state(
    path: str,
    state,
    grid: GridSpec,
    next_view: int = 0,
    extra: Optional[dict] = None,
    force_sharded: bool = False,
) -> None:
    """Snapshot ``state`` (copied to the host) with its grid and the next
    view's index into ``path`` (``.npz`` appended if missing).

    A ``ShardedGridState``, or any state with ``force_sharded``, goes to
    ``{path}.proc{rank}.npz`` instead: this process's blocks only, keyed
    by their global (z, y, x) offsets. That save is collective: it ends
    in a barrier, so that no process reads before a peer's file is
    there."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    meta = _meta(grid, next_view, extra)
    if not force_sharded and not isinstance(state, ShardedGridState):
        sdf, update_num = state_to_numpy(state)
        _atomic_savez(path, sdf=sdf, update_num=update_num, meta=meta)
        return
    if isinstance(state, ShardedGridState):
        blocks = {tuple(s.start for s in state.sharding.slices(b, state.shape)):
                  st for b, st in state.blocks.items()}
    else:
        blocks = {(0, 0, 0): state}
    payload = {"meta": meta}
    for (z0, y0, x0), st in blocks.items():
        sdf, update_num = state_to_numpy(st)
        payload[f"sdf_z{z0}_y{y0}_x{x0}"] = sdf
        payload[f"update_num_z{z0}_y{y0}_x{x0}"] = update_num
    rank, world = rank_and_world()
    _atomic_savez(f"{path}.proc{rank}", **payload)
    if world > 1:
        import torch.distributed as dist

        dist.barrier()


def _read_blocks(files, needed: set, shape) -> dict:
    """{(z0, y0, x0): (sdf, update_num)} for the ``needed`` offsets, from
    as few of ``files`` as cover them (a zip member is read only when
    asked for, so skimming a file's keys is cheap)."""
    pieces = {"sdf": {}, "update_num": {}}
    for f in files:
        with np.load(f, allow_pickle=False) as z:
            for key in z.files:
                for field, got in pieces.items():
                    prefix = f"{field}_z"
                    if not key.startswith(prefix):
                        continue
                    # "z{z0}_y{y0}_x{x0}"; files from before the
                    # multi-axis meshes wrote "z{z0}" only (their blocks
                    # all start at y = x = 0)
                    parts = key[len(prefix):].split("_")
                    off = (int(parts[0]),
                           int(parts[1][1:]) if len(parts) > 1 else 0,
                           int(parts[2][1:]) if len(parts) > 2 else 0)
                    if off in needed and off not in got:
                        got[off] = z[key]
        if all(needed <= got.keys() for got in pieces.values()):
            break
    out = {}
    for off in needed:
        if any(off not in got or tuple(got[off].shape) != tuple(shape)
               for got in pieces.values()):
            raise ValueError(
                f"checkpoint shard for (z,y,x)={off} of shape {shape} not "
                f"found in local files {files}; was the checkpoint written "
                "with a different process layout?"
            )
        out[off] = (pieces["sdf"][off], pieces["update_num"][off])
    return out


def load_state(
    path: str, sharding=None, device="cuda"
) -> Tuple[object, GridSpec, int, dict]:
    """(state, grid, next view, extra) from a snapshot written by either
    package's ``save_state``: a dense state on ``device``, or, with a
    ``parallel.grid_sharding(mesh)``, a ``ShardedGridState`` on the
    mesh's devices. Per-process files need a sharding, and each process
    reads only the files that cover its own blocks."""
    single = path if os.path.exists(path) else path + ".npz"
    if os.path.exists(single):
        with np.load(single, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            sdf = z["sdf"]
            un = z["update_num"]
        grid = _grid_of(meta)
        if tuple(sdf.shape) != grid.shape_zyx:
            raise ValueError(f"checkpoint state {sdf.shape} does not fit "
                             f"its grid {grid.shape_zyx}")
        if sharding is None:
            state = state_from_numpy(sdf, un, device)
        else:
            state = ShardedGridState.from_dense(
                state_from_numpy(sdf, un, "cpu"), sharding)
        return state, grid, int(meta["next_view"]), meta.get("extra", {})

    files = sorted(glob.glob(path + ".proc*.npz")) + sorted(
        glob.glob(path + ".proc*"))
    # never an orphaned temp of a save that crashed (it may be half a zip)
    files = [
        f for f in dict.fromkeys(files)
        if os.path.isfile(f)
        and ".tmp" not in os.path.basename(f)
        and not os.path.basename(f).startswith(".")
    ]
    if not files:
        raise FileNotFoundError(path)
    if sharding is None:
        raise ValueError(
            "loading a per-process sharded checkpoint requires a sharding"
        )
    # this process's own file almost always covers its blocks: try it
    # first, so that usually exactly one file is opened
    own = f"{path}.proc{sharding.mesh.rank}.npz"
    if own in files:
        files = [own] + [f for f in files if f != own]
    with np.load(files[0], allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
    grid = _grid_of(meta)
    shape = grid.shape_zyx
    local = sharding.local_blocks()
    offsets = {b: tuple(s.start for s in sharding.slices(b, shape))
               for b in local}
    got = _read_blocks(files, set(offsets.values()),
                       sharding.block_shape(shape))
    state = ShardedGridState(
        blocks={b: state_from_numpy(*got[offsets[b]], sharding.device_of(b))
                for b in local},
        sharding=sharding, shape=shape)
    return state, grid, int(meta["next_view"]), meta.get("extra", {})
