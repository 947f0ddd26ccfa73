#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vacancy_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device: a CUDA card is required; prints nvidia-smi's name and power
     limit; TF32 off.
  2. build: both kernels from csrc/ with nvcc (cached under build/).
  3. fused warp kernel vs its plain PyTorch version (update_num exact, sdf
     bitwise): 128^3 x 8 views for MAX/WAVG x NN/bilinear and ROI +
     outside=MAX; an unaligned 72x80x96 grid; the bench shape 512^3 x 24
     views with random-normal images, timed against the plain version.
  4. fused MC kernel vs its plain version (counts, the four streams and
     the assembled meshes byte-identical): the 256^3 sphere (r = 0.8) and
     a random state with invalid voxels, timed at 256^3.
  5. the main path: `pipeline turntable --n 512 --views 36` in process,
     with every launch counter reset just before and read just after (both
     must be > 0); the PLY must read back. Then both kernels against their
     plain versions on the main path's own inputs (the 36 truncated SDFs
     into the empty 512^3 grid, WAVG; MC on the fused state): update_num
     exact, sdf bitwise, counts and streams byte-identical, and as many
     vertices as the main path's mesh.
Then one JSON line of per-kernel results, and as the last line
{"ok": true, "device": {...}}. No JAX is imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def _cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bits(t):
    import torch

    return t.contiguous().view(torch.int32)


def phase_device():
    import torch

    _require(torch.cuda.is_available(), "no CUDA device: this needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _phase("device", f"{torch.cuda.get_device_name(0)}; torch "
           f"{torch.__version__} cuda {torch.version.cuda}; "
           f"count {torch.cuda.device_count()}")
    print(smi, flush=True)
    return torch.device("cuda", 0), smi


def phase_build():
    from vacancy_tpu_torch import _kernels

    t0 = time.perf_counter()
    _kernels.load()
    secs = time.perf_counter() - t0
    usage = [ln.strip() for ln in _kernels.build_log().splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    _phase("build", f"nvcc + load {secs:.3f} s -> {_kernels.build()}")
    for ln in usage:
        print("  " + ln)
    return secs


def _bench_case(n: int, n_views: int, device, h=240, w=320):
    """bench.py's build_case geometry: an n^3 grid over [-1, 1]^3, cameras
    on a 3.5-radius ring, random-normal SDF images (numpy seed 0)."""
    import numpy as np
    import torch

    from vacancy_tpu_torch.camera import PinholeCamera, stack_cameras
    from vacancy_tpu_torch.grid import GridSpec
    from vacancy_tpu_torch.synthetic import look_at

    res = 2.0 / n
    grid = GridSpec((-1.0,) * 3, (-1.0 + (n + 0.3) * res,) * 3, res)
    _require(grid.shape_zyx == (n, n, n), "bench grid shape")
    cams = stack_cameras([
        PinholeCamera.create(
            w, h,
            c2w=look_at([3.5 * np.sin(2 * np.pi * i / n_views), 0.5,
                         -3.5 * np.cos(2 * np.pi * i / n_views)], np.zeros(3)),
            principal_point=np.array([159.5, 119.5], np.float32),
            focal_length=np.array([260.0, 260.0], np.float32),
            device=device,
        )
        for i in range(n_views)
    ])
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(
        rng.normal(size=(n_views, h, w)).astype(np.float32)).to(device)
    return grid, cams, imgs


def _turntable_case(shape, n_views, device):
    from vacancy_tpu_torch.grid import GridSpec
    from vacancy_tpu_torch.ops.sdf2d import make_signed_distance_field
    from vacancy_tpu_torch.pipeline import turntable_masks

    nz, ny, nx = shape
    res = 2.2 / max(shape)
    grid = GridSpec((-1.1,) * 3, tuple(-1.1 + (m + 0.4) * res
                                       for m in (nx, ny, nz)), res)
    _require(grid.shape_zyx == shape, f"grid shape {grid.shape_zyx}")
    cams, masks = turntable_masks(n_views, device)
    imgs = make_signed_distance_field(masks, use_truncation=True,
                                      truncation_band=0.05)
    return grid, cams, imgs


def phase_warp(device):
    import torch

    from vacancy_tpu_torch import config as cfg
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.ops.warp_fused import (
        warp_fuse_planes,
        warp_fuse_planes_plain,
    )

    def args_of(grid, cams, imgs, state):
        return (state.sdf, state.update_num,
                *(grid.axis_centers_t(a, device) for a in range(3)),
                cams.w2c, cams.principal_point, cams.focal_length, imgs)

    wavg = dict(voxel_update=cfg.VoxelUpdate.WEIGHTED_AVERAGE,
                use_truncation=True, truncation_band=0.05)
    cases = [
        ("128^3x8 max bilinear", (128,) * 3, 8, {}, True, None),
        ("128^3x8 max nn", (128,) * 3, 8, {}, False, None),
        ("128^3x8 wavg bilinear", (128,) * 3, 8, wavg, True, None),
        ("128^3x8 wavg nn", (128,) * 3, 8, wavg, False, None),
        ("128^3x8 roi outside=max cap=3", (128,) * 3, 8,
         dict(update_outside=cfg.UpdateOutsideImage.MAX,
              voxel_max_update_num=3), True, (40, 30, 280, 210)),
        ("72x80x96 x8 wavg bilinear", (72, 80, 96), 8, wavg, True, None),
    ]
    max_err = 0.0
    for name, shape, nv, kw, linear, roi in cases:
        grid, cams, imgs = _turntable_case(shape, nv, device)
        opt = cfg.VoxelUpdateOption(**kw)
        st = VoxelGridState.create(grid, device)
        # fold twice so the second pass updates an already fused state
        ks, ku = warp_fuse_planes(*args_of(grid, cams, imgs, st), opt,
                                  linear, roi)
        st1 = VoxelGridState(ks, ku)
        ks, ku = warp_fuse_planes(*args_of(grid, cams, imgs, st1), opt,
                                  linear, roi)
        ps, pu = warp_fuse_planes_plain(*args_of(grid, cams, imgs, st),
                                        opt, linear, roi)
        ps, pu = warp_fuse_planes_plain(
            *args_of(grid, cams, imgs, VoxelGridState(ps, pu)), opt,
            linear, roi)
        torch.cuda.synchronize()
        _require(torch.equal(ku, pu), f"warp {name}: update_num differs")
        _require(torch.equal(_bits(ks), _bits(ps)), f"warp {name}: sdf bits")
        fused = float((ku > 0).float().mean())
        _require(fused > 0.05, f"warp {name}: nothing fused")
        max_err = max(max_err, float((ks - ps).abs().nan_to_num(0).max()))
        _phase("warp", f"{name}: bitwise equal (fused {fused:.3f} of voxels)")

    # (c) bench shape 512^3 x 24 views, MAX, random-normal images
    grid, cams, imgs = _bench_case(512, 24, device)
    opt = cfg.VoxelUpdateOption()
    st = VoxelGridState.create(grid, device)
    a = args_of(grid, cams, imgs, st)
    ks, ku = warp_fuse_planes(*a, opt, True)
    ps, pu = warp_fuse_planes_plain(*a, opt, True)
    torch.cuda.synchronize()
    _require(torch.equal(ku, pu), "warp 512^3x24: update_num differs")
    _require(torch.equal(_bits(ks), _bits(ps)), "warp 512^3x24: sdf bits")
    del ks, ku, ps, pu
    ms = _cuda_ms(lambda: warp_fuse_planes(*a, opt, True), 5)
    plain_ms = _cuda_ms(lambda: warp_fuse_planes_plain(*a, opt, True), 2)
    nf = grid.num_voxels * 24
    _phase("warp", f"512^3x24 max bilinear: bitwise equal; kernel {ms:.3f} "
           f"ms ({nf / ms / 1e6:.3f} Gfusions/s), plain {plain_ms:.3f} ms")
    return max_err, ms, plain_ms


def _sphere_state(n, device, radius=0.8):
    """bench.py's _sphere_state: a clipped sphere TSDF, all updated."""
    import torch

    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.pipeline import turntable_grid

    grid = turntable_grid(n)
    cx, cy, cz = (grid.axis_centers_t(a, device) for a in range(3))
    r2 = (cz ** 2)[:, None, None] + (cy ** 2)[None, :, None] + (cx ** 2)[None]
    sdf = torch.clamp((torch.sqrt(r2) - radius) / 0.05, -1, 1)
    un = torch.ones((n, n, n), dtype=torch.int32, device=device)
    return grid, VoxelGridState(sdf.contiguous(), un)


def _random_state(shape, device, seed=5):
    import numpy as np

    from vacancy_tpu_torch.config import INVALID_SDF
    from vacancy_tpu_torch.grid import GridSpec, state_from_numpy

    nz, ny, nx = shape
    rng = np.random.default_rng(seed)
    sdf = rng.normal(size=shape).astype(np.float32)
    sdf[rng.random(shape) < 0.05] = INVALID_SDF
    un = (rng.random(shape) < 0.9).astype(np.int32)
    grid = GridSpec((0.0,) * 3, (nx + 0.4, ny + 0.4, nz + 0.4), 1.0)
    return grid, state_from_numpy(sdf, un, device)


def _require_same_streams(k, p, what: str) -> float:
    """Counts and all four streams of the MC kernel byte-identical to its
    plain version's; returns the largest |difference| of the positions."""
    import torch

    torch.cuda.synchronize()
    max_err = 0.0
    for x, y, f in zip(k.as_tuple(), p.as_tuple(),
                       ("vx_pos", "vx_lin", "vy_pos", "vy_lin", "vz_pos",
                        "vz_lin", "c_lin", "c_case", "plane_counts")):
        _require(x.dtype == y.dtype and x.shape == y.shape
                 and torch.equal(_bits(x), _bits(y)),
                 f"{what}: stream {f} differs")
        if x.dtype == torch.float32 and x.numel():
            max_err = max(max_err, float((x - y).abs().max()))
    return max_err


def phase_mc(device):
    import numpy as np

    from vacancy_tpu_torch.ops.mc_fused import (
        assemble_fused_streams,
        marching_cubes_fused,
        mc_streams_plain,
    )

    def mesh_of(st, grid):
        h = [t.cpu().numpy() for t in st.as_tuple()[:8]]
        nz, ny, nx = grid.shape_zyx
        return assemble_fused_streams(
            h[0:6:2], [v.astype(np.int64) for v in h[1:6:2]], h[6], h[7],
            ny, nx, grid)

    timing, max_err = None, 0.0
    for name, (grid, st) in (
        ("256^3 sphere", _sphere_state(256, device)),
        ("64x72x80 random", _random_state((64, 72, 80), device)),
    ):
        a = (st.sdf, st.update_num,
             *(grid.axis_centers_t(i, device) for i in range(3)))
        for linear in (True, False):
            k = marching_cubes_fused(*a, linear_interp=linear)
            p = mc_streams_plain(*a, linear_interp=linear)
            max_err = max(max_err, _require_same_streams(
                k, p, f"mc {name} linear={linear}"))
            mk, mp = mesh_of(k, grid), mesh_of(p, grid)
            _require(mk.num_faces > 0 and np.array_equal(
                mk.vertices.view(np.int32), mp.vertices.view(np.int32))
                and np.array_equal(mk.faces, mp.faces),
                f"mc {name} linear={linear}: meshes differ")
            _phase("mc", f"{name} linear={linear}: streams and mesh "
                   f"byte-identical ({mk.num_vertices} vertices, "
                   f"{mk.num_faces} faces)")
        if timing is None:
            ms = _cuda_ms(lambda: marching_cubes_fused(*a), 10)
            plain_ms = _cuda_ms(lambda: mc_streams_plain(*a), 3)
            timing = (ms, plain_ms)
            _phase("mc", f"{name}: kernel {ms:.3f} ms (count+scan+emit, one "
                   f"host read), plain {plain_ms:.3f} ms")
    return max_err, timing[0], timing[1]


def phase_main_path(device):
    import numpy as np
    import torch

    from vacancy_tpu_torch import pipeline
    from vacancy_tpu_torch.config import SdfInterpolation
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.mesh import Mesh
    from vacancy_tpu_torch.ops import mc_fused, warp_fused

    with tempfile.TemporaryDirectory() as out_dir:
        warp_fused.warp_fuse_planes.launches = 0
        mc_fused.marching_cubes_fused.launches = 0
        t0 = time.perf_counter()
        res = pipeline.main(["turntable", "--n", "512", "--views", "36",
                             "--out", out_dir])
        wall = time.perf_counter() - t0
        launches = {
            "warp_fused": warp_fused.warp_fuse_planes.launches,
            "mc_fused": mc_fused.marching_cubes_fused.launches,
        }
        _require(all(v > 0 for v in launches.values()),
                 f"a kernel was not launched on the main path: {launches}")
        mesh = Mesh.load_ply(res["ply"])
    _require((mesh.num_vertices, mesh.num_faces)
             == (res["mc_vertices"], res["mc_faces"]), "PLY read-back counts")
    _require(mesh.num_faces > 100_000, f"too few faces: {mesh.num_faces}")
    _require(bool(np.isfinite(mesh.vertices).all()), "non-finite vertices")
    _require(bool((np.abs(mesh.vertices) <= 1.11).all()),
             "vertices outside the grid")
    _require(int(mesh.faces.min()) >= 0
             and int(mesh.faces.max()) < mesh.num_vertices, "face indices")
    _phase("main", f"turntable 512^3x36: carve {res['carve_s']:.4f} s "
           f"({res['fusions_per_s'] / 1e9:.3f} Gfusions/s), extract "
           f"{res['extract_s']:.4f} s, {res['mc_vertices']} vertices, "
           f"{res['mc_faces']} faces, wall {wall:.3f} s, launches {launches},"
           f" peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # both kernels against their plain versions on the main path's own
    # inputs: the 36 truncated turntable SDFs into the empty 512^3 grid
    # (WAVG, bilinear), then MC on that fused state
    grid, opt, cams, imgs = pipeline.turntable_inputs(512, 36, True, device)
    linear = opt.sdf_interp == SdfInterpolation.BILINEAR
    st = VoxelGridState.create(grid, device)
    centers = [grid.axis_centers_t(a, device) for a in range(3)]
    a = (st.sdf, st.update_num, *centers, cams.w2c, cams.principal_point,
         cams.focal_length, imgs)
    ks, ku = warp_fused.warp_fuse_planes(*a, opt, linear)
    ps, pu = warp_fused.warp_fuse_planes_plain(*a, opt, linear)
    torch.cuda.synchronize()
    _require(torch.equal(ku, pu), "main-path warp: update_num differs")
    _require(torch.equal(_bits(ks), _bits(ps)), "main-path warp: sdf bits")
    warp_err = float((ks - ps).abs().nan_to_num(0).max())
    del st, a, ps, pu
    k = mc_fused.marching_cubes_fused(ks, ku, *centers)
    p = mc_fused.mc_streams_plain(ks, ku, *centers)
    mc_err = _require_same_streams(k, p, "main-path mc")
    n_vert = sum(int(t.numel()) for t in (k.vx_lin, k.vy_lin, k.vz_lin))
    _require(n_vert == res["mc_vertices"],
             f"main-path mc: {n_vert} vertices, the main path had "
             f"{res['mc_vertices']}")
    _phase("main", f"512^3x36 main-path inputs: warp kernel == plain "
           f"(update_num exact, sdf bitwise; fused "
           f"{float((ku > 0).float().mean()):.3f} of voxels); MC kernel == "
           f"plain (counts and 4 streams byte-identical, {n_vert} vertices "
           f"as in the main path)")
    return launches, warp_err, mc_err


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "vacancy_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout that holds "
                         "vacancy_tpu_torch/")
    sys.path.insert(0, HERE)
    import torch

    device, smi = phase_device()
    phase_build()
    a_err, a_ms, a_plain = phase_warp(device)
    b_err, b_ms, b_plain = phase_mc(device)
    launches, a_main_err, b_main_err = phase_main_path(device)
    kernels = [
        {"name": "warp_fused", "route": "cuda",
         "source": "vacancy_tpu_torch/csrc/warp_fused.cu",
         "replaces": "vacancy_tpu/ops/warp_fused.py:252",
         "launches": launches["warp_fused"],
         "max_abs_err": max(a_err, a_main_err),
         "ms": a_ms, "plain_ms": a_plain},
        {"name": "mc_fused", "route": "cuda",
         "source": "vacancy_tpu_torch/csrc/mc_fused.cu",
         "replaces": "vacancy_tpu/ops/mc_fused.py:285",
         "launches": launches["mc_fused"],
         "max_abs_err": max(b_err, b_main_err),
         "ms": b_ms, "plain_ms": b_plain},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
