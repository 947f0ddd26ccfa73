"""End-to-end pipeline + CLI: the synthetic turntable (BASELINE config 4).

    python -m vacancy_tpu_torch.pipeline turntable --n 512 --views 36 --out DIR

renders silhouettes of a sphere-union blob from ``--views`` orbiting
cameras, turns them into truncated 2D SDFs, fuses them into an n^3 grid
with weighted-average TSDF updates through the fused warp kernel, extracts
the iso-surface through the fused marching-cubes kernel, and writes a
binary PLY. It prints one JSON line. The device defaults to ``cuda``;
``--device cpu`` runs the kernels' plain versions instead.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch

from .camera import stack_cameras
from .config import (
    SdfInterpolation,
    VoxelCarverOption,
    VoxelUpdate,
    VoxelUpdateOption,
)
from .grid import GridSpec, VoxelGridState
from .ops.fusion_warp import carve_views_warp
from .ops.marching_cubes import extract_mesh
from .ops.sdf2d import make_signed_distance_field
from .synthetic import blob_spheres, render_silhouettes, turntable_cameras
from .utils import LOGI


def turntable_grid(n: int) -> GridSpec:
    """The n^3 grid over [-1.1, 1.1]^3 that ``vacancy_tpu.pipeline``'s
    turntable uses."""
    res = 2.2 / n
    grid = GridSpec(
        bb_min=(-1.1, -1.1, -1.1),
        bb_max=(-1.1 + (n + 0.4) * res,) * 3,
        resolution=res,
    )
    assert grid.shape_zyx == (n, n, n), grid.shape_zyx
    return grid


def turntable_option(tsdf: bool = True) -> VoxelUpdateOption:
    return VoxelUpdateOption(
        voxel_update=(
            VoxelUpdate.WEIGHTED_AVERAGE if tsdf else VoxelUpdate.MAX
        ),
        use_truncation=tsdf,
        truncation_band=0.05,
    )


def turntable_masks(n_views: int, device):
    """(stacked cameras, uint8 silhouettes [V, 240, 320]) on ``device``."""
    centers, radii = blob_spheres(seed=3)
    cams = turntable_cameras(n_views, radius=3.2, device=device)
    return stack_cameras(cams), render_silhouettes(cams, centers, radii)


def turntable_inputs(n: int, n_views: int, tsdf: bool, device):
    """(grid, option, stacked cameras, 2D SDF images [V, 240, 320]): what
    ``run_turntable`` fuses, on ``device``."""
    opt = turntable_option(tsdf)
    cams, masks = turntable_masks(n_views, device)
    sdf_images = make_signed_distance_field(
        masks, use_truncation=opt.use_truncation,
        truncation_band=opt.truncation_band,
    )
    return turntable_grid(n), opt, cams, sdf_images


def facade_inputs(n: int, n_views: int, width: int, height: int, device):
    """(VoxelCarverOption, cameras, uint8 silhouettes [V, height, width])
    for ``VoxelCarver``: the turntable's n^3 grid, WAVG + truncation band
    0.05, and ``n_views`` orbiting cameras of ``width`` x ``height`` that
    see the same blob."""
    grid = turntable_grid(n)
    opt = VoxelCarverOption(bb_min=grid.bb_min, bb_max=grid.bb_max,
                            resolution=grid.resolution,
                            update_option=turntable_option(tsdf=True))
    cams = turntable_cameras(n_views, 3.2, width=width, height=height,
                             device=device)
    return opt, cams, render_silhouettes(cams, *blob_spheres(seed=3))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_turntable(
    n: int = 256,
    n_views: int = 36,
    tsdf: bool = True,
    out_dir: Optional[str] = None,
    device="cuda",
) -> dict:
    """Synthetic turntable blob at n^3 on one device. carve_s is the
    second (warm) fusion of every view; the first call builds the
    kernels. Both timings end in a device synchronize."""
    device = torch.device(device)
    grid, opt, cams, sdf_images = turntable_inputs(n, n_views, tsdf, device)
    linear = opt.sdf_interp == SdfInterpolation.BILINEAR

    def carve():
        st = carve_views_warp(
            VoxelGridState.create(grid, device), grid, cams.w2c,
            cams.principal_point, cams.focal_length, sdf_images,
            opt=opt, linear=linear,
        )
        _sync(device)
        return st

    carve()  # warm-up (first use builds the kernels)
    t0 = time.perf_counter()
    state = carve()
    carve_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    mesh = extract_mesh(state, grid)
    _sync(device)
    extract_s = time.perf_counter() - t0
    LOGI("turntable %d^3 x %d views: carve %.4f s, extract %.4f s",
         n, n_views, carve_s, extract_s)

    out = {
        "grid": list(grid.voxel_num),
        "views": n_views,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "carve_s": carve_s,
        "fusions_per_s": grid.num_voxels * n_views / carve_s,
        "extract_s": extract_s,
        "mc_vertices": mesh.num_vertices,
        "mc_faces": mesh.num_faces,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        out["ply"] = os.path.join(out_dir, f"turntable_{n}.ply")
        mesh.write_ply(out["ply"], binary=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="vacancy_tpu_torch.pipeline")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("turntable", help="synthetic turntable at N^3")
    t.add_argument("--n", type=int, default=256)
    t.add_argument("--views", type=int, default=36)
    t.add_argument("--out", default=None)
    t.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args = p.parse_args(argv)
    out = run_turntable(n=args.n, n_views=args.views, out_dir=args.out,
                        device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
