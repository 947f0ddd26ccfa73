"""Headline benchmark of the port: voxel-view fusions per second on one
card, and marching-cubes extraction (``bench.py`` of the JAX package, on
the same geometry).

    python -m vacancy_tpu_torch.bench

Fuses 24 views into a 512^3 grid with the warp engine (the fused warp
kernel, ``csrc/warp_fused.cu``), ``iters`` times chained and ending in a
device synchronize, and reports steady-state voxel-view fusions per
second. The marching-cubes figures run ``extract_mesh`` (the fused MC
kernel, the mesh's assembly and its copy to the host) on sphere TSDFs:
256^3, and 512^3 with a realistic and a near-empty sphere, since
extraction cost tracks surface occupancy. Before anything is timed, a
probe kernel (``csrc/probe.cu``) shows that the kernel library builds,
launches and returns.

Prints exactly one JSON line. Without a CUDA device (and without
``--device cpu``), or when the probe fails, the line carries
``"value": null`` and an ``"error"`` field, the exit code is 0, and
nothing is run in the card's place.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels
from .camera import PinholeCamera, stack_cameras
from .config import VoxelUpdateOption
from .grid import GridSpec, VoxelGridState
from .io import native
from .ops.fusion_warp import carve_views_warp
from .ops.marching_cubes import extract_mesh
from .ops.mc_fused import marching_cubes_fused
from .synthetic import look_at

PROBE_SHAPE = (8, 128)


def probe_scale_plain(x: torch.Tensor) -> torch.Tensor:
    """The probe kernel's plain version."""
    return x * 2.0


@functools.lru_cache(maxsize=None)
def _probe_entry():
    """The library's bound ``vt_probe_scale``, looked up once."""
    return _kernels.load().vt_probe_scale


def probe_scale(x: torch.Tensor) -> torch.Tensor:
    """``x * 2`` for a contiguous f32 tensor. A CPU tensor takes the plain
    version; a CUDA tensor launches the probe kernel once
    (``probe_scale.launches``) or raises on a failed build or launch."""
    if x.device.type == "cpu":
        return probe_scale_plain(x)
    if (x.device.type != "cuda" or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    out = torch.empty_like(x)
    err = _probe_entry()(x.data_ptr(), out.data_ptr(), x.numel(),
                         torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(err, "probe kernel launch")
    probe_scale.launches += 1
    return out


probe_scale.launches = 0


def warm_probe(device) -> Tuple[bool, float]:
    """Build (at first use), launch and read back one trivial kernel
    before any timed work: ``(ok, seconds)``, where ok says that the sum
    of ``ones[8, 128] * 2`` came back right. Raises what the build or the
    launch raises."""
    t0 = time.perf_counter()
    x = torch.ones(PROBE_SHAPE, dtype=torch.float32, device=device)
    total = float(probe_scale(x).sum())  # a host read: a real sync
    return total == 2.0 * x.numel(), time.perf_counter() - t0


def build_case(n=256, n_views=24, h=240, w=320, device="cuda"):
    """An n^3 grid over [-1, 1]^3, ``n_views`` cameras on a ring of
    radius 3.5, random-normal SDF images (numpy seed 0)."""
    res = 2.0 / n
    grid = GridSpec(
        bb_min=(-1.0, -1.0, -1.0),
        bb_max=(-1.0 + (n + 0.3) * res,) * 3,
        resolution=res,
    )
    assert grid.shape_zyx == (n, n, n), grid.shape_zyx
    rng = np.random.default_rng(0)
    cams = stack_cameras([
        PinholeCamera.create(
            w, h,
            c2w=look_at(
                [
                    3.5 * np.sin(2 * np.pi * i / n_views),
                    0.5,
                    -3.5 * np.cos(2 * np.pi * i / n_views),
                ],
                np.zeros(3),
            ),
            principal_point=np.array([159.5, 119.5], np.float32),
            focal_length=np.array([260.0, 260.0], np.float32),
            device=device,
        )
        for i in range(n_views)
    ])
    imgs = torch.from_numpy(
        rng.normal(size=(n_views, h, w)).astype(np.float32)).to(device)
    state = VoxelGridState.create(grid, device)
    return (grid, state, cams.w2c, cams.principal_point, cams.focal_length,
            imgs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_bench(n=512, n_views=24, iters=4, device="cuda"):
    """(fusions/s, seconds per carve): ``iters`` carves of every view,
    each fed the last one's state so none can be elided, ending in a
    synchronize."""
    device = torch.device(device)
    grid, state, w2c, pp, fl, imgs = build_case(n, n_views, device=device)
    opt = VoxelUpdateOption()

    def step(st):
        return carve_views_warp(st, grid, w2c, pp, fl, imgs, opt)

    step(state)  # warm-up
    _sync(device)

    t0 = time.perf_counter()
    cur = state
    for _ in range(iters):
        cur = step(cur)
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    return grid.num_voxels * n_views / dt, dt


def _sphere_state(n, radius=0.8, device="cuda"):
    """A clipped sphere TSDF on the turntable's n^3 grid, every voxel
    updated."""
    res = 2.2 / n
    grid = GridSpec(
        bb_min=(-1.1, -1.1, -1.1),
        bb_max=(-1.1 + (n + 0.4) * res,) * 3,
        resolution=res,
    )
    assert grid.shape_zyx == (n, n, n)
    cx, cy, cz = (grid.axis_centers_t(a, device) for a in range(3))
    r2 = (cz**2)[:, None, None] + (cy**2)[None, :, None] + (cx**2)[None]
    sdf = torch.clamp((torch.sqrt(r2) - radius) / 0.05, -1, 1)
    un = torch.ones((n, n, n), dtype=torch.int32, device=device)
    return grid, VoxelGridState(sdf=sdf.contiguous(), update_num=un)


def run_mc_bench(n=256, iters=3, radius=0.8, device="cuda"):
    """Marching-cubes extraction (kernel, assembly and the mesh's transfer)
    of a closed-surface sphere TSDF at n^3. Returns (cubes/s over the full
    lattice, best warm seconds, vertices)."""
    device = torch.device(device)
    grid, state = _sphere_state(n, radius, device)
    mesh = extract_mesh(state, grid)  # warm-up
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        mesh = extract_mesh(state, grid)
        best = min(best, time.perf_counter() - t0)
    return (n - 1) ** 3 / best, best, mesh.num_vertices


def run_mc_device_bench(n=256, iters=3, radius=0.8, device="cuda"):
    """Best warm seconds of the fused MC kernel's passes alone at n^3 (the
    totals are read back, then a synchronize; no stream transfer and no
    host assembly)."""
    device = torch.device(device)
    grid, state = _sphere_state(n, radius, device)
    centers = [grid.axis_centers_t(a, device) for a in range(3)]

    def call():
        marching_cubes_fused(state.sdf, state.update_num, *centers)
        _sync(device)

    call()  # warm-up
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return best


def power_limit_w(device: torch.device) -> Optional[float]:
    """The card's power limit in watts as nvidia-smi reports it, or None
    where there is no card or no nvidia-smi."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="vacancy_tpu_torch.bench")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    p.add_argument("--n", type=int, default=512, help="fusion grid")
    p.add_argument("--views", type=int, default=24)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--mc-n", type=int, default=256,
                   help="grid of the first marching-cubes figures")
    p.add_argument("--mc-n-large", type=int, default=512,
                   help="grid of the realistic and near-empty spheres")
    args = p.parse_args(argv)
    metric = f"voxel_view_fusions_per_sec_per_chip_{args.n}^3"

    def refuse(error: str, **extra) -> dict:
        # the one-line contract holds with the card gone: a null value
        # and the reason, never a figure from another device
        out = {"metric": metric, "value": None, "unit": "fusions/s",
               **extra, "error": error}
        print(json.dumps(out))
        return out

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return refuse("no CUDA device (torch.cuda.is_available() is False); "
                      "pass --device cpu to time the plain versions")
    try:
        ok, probe_s = warm_probe(device)
    except (RuntimeError, OSError) as e:
        return refuse(f"warm-up probe failed: {str(e)[-300:]}")
    if not ok:
        return refuse("warm-up probe returned a wrong sum",
                      probe_s=round(probe_s, 4))

    rate, _ = run_bench(args.n, args.views, args.iters, device)
    small, large = args.mc_n, args.mc_n_large
    mc_rate, mc_s, mc_verts = run_mc_bench(small, device=device)
    _, mcl_s, mcl_verts = run_mc_bench(large, iters=2, device=device)
    _, mce_s, mce_verts = run_mc_bench(large, iters=2, radius=0.04,
                                       device=device)
    mc_dev_s = run_mc_device_bench(small, device=device)
    out = {
        "metric": metric,
        "value": round(rate, 1),
        "unit": "fusions/s",
        "probe_s": round(probe_s, 4),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "power_limit_w": power_limit_w(device),
        f"mc_cubes_per_sec_{small}^3": round(mc_rate, 1),
        f"mc_extract_warm_s_{small}^3": round(mc_s, 4),
        f"mc_device_s_{small}^3": round(mc_dev_s, 6),
        "native_fast_path": native.available(),
        f"mc_vertices_{small}^3": int(mc_verts),
        f"mc_extract_warm_s_{large}^3": round(mcl_s, 4),
        f"mc_vertices_{large}^3": int(mcl_verts),
        f"mc_extract_warm_s_{large}^3_near_empty": round(mce_s, 4),
        f"mc_vertices_{large}^3_near_empty": int(mce_verts),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
