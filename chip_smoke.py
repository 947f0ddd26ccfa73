#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vacancy_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device: a CUDA card is required; prints nvidia-smi's name and power
     limit; TF32 off.
  2. build: every kernel from csrc/ with nvcc (cached under build/).
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
  6. interp_rows kernel vs its plain version, bitwise and timed, at the
     two shapes the UHD facade path gives it (pass 1: a shared 2160 x 3840
     image, positions [64, 2160, 512]; pass 2: tables [64, 512, 2160],
     positions [64, 512, 512]), linear and NN, full row and a ROI.
  7. the two-pass engine through interp_rows vs the fused warp kernel on
     the 128^3 x 8 turntable (240 rows): update_num exact, sdf bitwise;
     both timed.
  8. the facade at full size: VoxelCarver.carve_batch(engine="warp") of 36
     views of 3840 x 2160 into 512^3 (WAVG, band 0.05, bilinear), then
     extract_iso_surface, extract_voxel and a binary PLY read-back. The
     counters are reset after a warm-up carve, just before the timed one,
     and read after the extracts: interp_rows 72 (two per view), MC 1,
     the fused warp kernel 0 (2160 rows exceed its shared memory). Then
     the carve against the plain two-pass fold (bitwise) and plain MC (as
     many vertices).
  9. 128^3 x 8 orthographic views through interp_rows vs the plain fold
     (bitwise); a rolled orthographic camera on the exact engine (the
     interp_rows counter does not move); the exact engine vs the warp
     engine at 256^3 x 8 turntable views (the JAX package's
     test_warp_close_to_exact bar).
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


# kernel C's shapes on the UHD facade path, for 64 of the 512 z-planes:
# (name, tables, positions, shared table, ROI taps)
INTERP_SHAPES = (
    ("pass1", (1, 2160, 3840), (64, 2160, 512), True, (200, 3600)),
    ("pass2", (64, 512, 2160), (64, 512, 512), False, (100, 2000)),
)


def phase_interp(device, shapes=INTERP_SHAPES):
    """Kernel C against its plain version at the two shapes the UHD
    facade path gives it: pass 1 (a shared 2160 x 3840 image, positions
    for 64 z-planes x 2160 rows x 512 columns) and pass 2 (64 transposed
    pass-1 planes of 512 x 2160, positions 64 x 512 x 512)."""
    import numpy as np
    import torch

    from vacancy_tpu_torch.ops.warp_gather import interp_rows, interp_rows_plain

    rng = np.random.default_rng(7)
    timings, max_err = {}, 0.0
    for name, tshape, pshape, share, roi in shapes:
        width = tshape[2]
        tables = torch.from_numpy(
            rng.normal(size=tshape).astype(np.float32)).to(device)
        pos = torch.from_numpy(rng.uniform(
            -1.0, width, size=pshape).astype(np.float32)).to(device)
        pos[..., 0], pos[..., -1] = -1.0, float(width)
        for linear in (True, False):
            for lo, hi in ((0, width - 1), roi):
                k = interp_rows(tables, pos, width, linear, share, lo, hi)
                p = interp_rows_plain(tables, pos, width, linear, share, lo,
                                      hi)
                torch.cuda.synchronize()
                _require(torch.equal(_bits(k), _bits(p)),
                         f"interp_rows {name} linear={linear} [{lo}, {hi}]: "
                         f"kernel != plain")
                max_err = max(max_err, float((k - p).abs().max()))
                del k, p
        ms = _cuda_ms(lambda: interp_rows(tables, pos, width, True, share),
                      20)
        plain_ms = _cuda_ms(
            lambda: interp_rows_plain(tables, pos, width, True, share), 5)
        timings[name] = (ms, plain_ms)
        gb = pos.numel() * 8 / 1e9
        _phase("interp", f"{name} tables {list(tshape)} pos {list(pshape)}: "
               f"bitwise equal (linear, nn; full row and [{roi[0]}, "
               f"{roi[1]}]); kernel {ms:.3f} ms ({gb / ms:.3f} TB/s of "
               f"positions + outputs), plain {plain_ms:.3f} ms")
        del tables, pos
    return max_err, timings


def phase_two_pass(device):
    """The two-pass engine through kernel C against the fused warp kernel
    on the 128^3 x 8 turntable (240 rows): the same expressions, so
    update_num exact and sdf bitwise."""
    import torch

    from vacancy_tpu_torch import config as cfg
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.ops.fusion_warp import warp_fold
    from vacancy_tpu_torch.ops.warp_fused import warp_fuse_planes
    from vacancy_tpu_torch.ops.warp_gather import interp_rows

    grid, cams, imgs = _turntable_case((128,) * 3, 8, device)
    st = VoxelGridState.create(grid, device)
    a = (st.sdf, st.update_num,
         *(grid.axis_centers_t(i, device) for i in range(3)), cams.w2c,
         cams.principal_point, cams.focal_length, imgs)
    wavg = dict(voxel_update=cfg.VoxelUpdate.WEIGHTED_AVERAGE,
                use_truncation=True, truncation_band=0.05)
    for rule, kw in (("max", {}), ("wavg", wavg)):
        for linear in (True, False):
            opt = cfg.VoxelUpdateOption(**kw)
            before = interp_rows.launches
            cs, cu = warp_fold(*a, opt, linear, None, interp_rows)
            _require(interp_rows.launches == before + 16,
                     "two-pass engine: kernel C not launched twice per view")
            ks, ku = warp_fuse_planes(*a, opt, linear)
            torch.cuda.synchronize()
            what = f"two-pass 128^3x8 {rule} linear={linear}"
            _require(torch.equal(cu, ku), f"{what}: update_num differs")
            _require(torch.equal(_bits(cs), _bits(ks)), f"{what}: sdf bits")
            _phase("two-pass", f"{what}: kernel C engine == fused kernel "
                   f"(fused {float((ku > 0).float().mean()):.3f} of voxels)")
    two_ms = _cuda_ms(lambda: warp_fold(*a, opt, linear, None, interp_rows), 5)
    fused_ms = _cuda_ms(lambda: warp_fuse_planes(*a, opt, linear), 20)
    _phase("two-pass", f"128^3x8 wavg nn: two-pass engine with kernel C "
           f"{two_ms:.3f} ms, fused warp kernel {fused_ms:.3f} ms")
    return two_ms, fused_ms


def phase_facade(device, n_views=36):
    """The slice at full size through the facade: 36 UHD views of the
    turntable blob into 512^3 (WAVG, band 0.05, bilinear). 2160 rows are
    more than the fused warp kernel takes, so the carve runs the two-pass
    engine with kernel C. After a warm-up carve the launch counters are
    reset just before the timed carve and read after its extracts: kernel
    C twice per view, MC once, the fused warp kernel never. Then the carve
    against the plain two-pass fold and MC against its plain version on
    the same 36 SDFs into the empty grid."""
    import numpy as np
    import torch

    from vacancy_tpu_torch import VoxelCarver
    from vacancy_tpu_torch.camera import stack_cameras
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.mesh import Mesh
    from vacancy_tpu_torch.ops import mc_fused, warp_fused, warp_gather
    from vacancy_tpu_torch.pipeline import facade_inputs

    opt, cams, masks = facade_inputs(512, n_views, 3840, 2160, device)
    torch.cuda.reset_peak_memory_stats(device)
    counters = (warp_fused.warp_fuse_planes, mc_fused.marching_cubes_fused,
                warp_gather.interp_rows)
    carver = VoxelCarver(opt, device)
    _require(carver.init(), "VoxelCarver.init")
    carver.carve_batch(cams, masks, engine="warp")  # warm-up
    torch.cuda.synchronize()
    _require(carver.init(), "VoxelCarver.init")  # the empty grid again
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    imgs = carver.carve_batch(cams, masks, engine="warp")
    torch.cuda.synchronize()
    carve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = carver.extract_iso_surface()
    extract_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    voxels = carver.extract_voxel()
    voxel_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as out_dir:
        path = os.path.join(out_dir, "uhd_512.ply")
        mesh.write_ply(path, binary=True)
        back = Mesh.load_ply(path)
    launches = {"warp_fused": counters[0].launches,
                "mc_fused": counters[1].launches,
                "interp_rows": counters[2].launches}
    _require(launches == {"warp_fused": 0, "mc_fused": 1,
                          "interp_rows": 2 * n_views},
             f"UHD facade launches {launches}: need kernel C twice per view, "
             f"MC once, and no fused warp kernel at 2160 rows")
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    _require(np.array_equal(back.vertices, mesh.vertices)
             and np.array_equal(back.faces, mesh.faces), "PLY read-back")
    _require(mesh.num_faces > 100_000, f"too few faces: {mesh.num_faces}")
    _require(bool(np.isfinite(mesh.vertices).all())
             and bool((np.abs(mesh.vertices) <= 1.11).all()),
             "vertices outside the grid")
    _require(voxels.num_faces == 12 * voxels.num_vertices // 24 > 0,
             "voxel mesh")
    fusions = carver.grid.num_voxels * n_views
    _phase("facade", f"VoxelCarver 512^3 x {n_views} views of 3840x2160: "
           f"carve {carve_s:.4f} s ({fusions / carve_s / 1e9:.3f} "
           f"Gfusions/s), extract_iso_surface {extract_s:.4f} s ({mesh.num_vertices} "
           f"vertices, {mesh.num_faces} faces), extract_voxel {voxel_s:.4f} "
           f"s ({voxels.num_vertices // 24} voxel cubes), launches "
           f"{launches}, peak mem {peak:.2f} GiB")

    # the plain two-pass fold and MC on the same 36 SDFs into the empty grid
    grid = carver.grid
    centers = [grid.axis_centers_t(a, device) for a in range(3)]
    st = VoxelGridState.create(grid, device)
    cam = stack_cameras(cams)
    ps, pu = warp_fused.warp_fuse_planes_plain(
        st.sdf, st.update_num, *centers, cam.w2c, cam.principal_point,
        cam.focal_length, torch.from_numpy(imgs).to(device),
        opt.update_option, True)
    torch.cuda.synchronize()
    ks, ku = carver.state.sdf, carver.state.update_num
    _require(torch.equal(ku, pu), "UHD facade: update_num != plain fold")
    _require(torch.equal(_bits(ks), _bits(ps)), "UHD facade: sdf bits")
    c_err = float((ks - ps).abs().nan_to_num(0).max())
    del st, ps, pu
    p = mc_fused.mc_streams_plain(ks, ku, *centers)
    n_vert = sum(int(t.numel()) for t in (p.vx_lin, p.vy_lin, p.vz_lin))
    _require(n_vert == mesh.num_vertices,
             f"UHD facade: plain MC has {n_vert} vertices, the facade's mesh "
             f"{mesh.num_vertices}")
    _phase("facade", f"512^3 x 36 UHD: kernel C carve == plain two-pass fold "
           f"(update_num exact, sdf bitwise; fused "
           f"{float((ku > 0).float().mean()):.3f} of voxels); plain MC "
           f"{n_vert} vertices as the facade's mesh")
    return launches, c_err


def _ortho_case(device, n_views=8, n=128, size=192, rolled=False):
    """n^3 unit voxels seen by orthographic cameras turned about world y
    (image v stays world y), or one camera rolled 90 degrees about its
    axis; silhouettes of two spheres."""
    import numpy as np

    from vacancy_tpu_torch.camera import OrthoCamera

    grid_bb = ((0.0,) * 3, (n + 0.4,) * 3, 1.0)  # bb_min, bb_max, res
    center = np.full(3, n / 2)
    spheres = ((center, 0.3 * n), (center + [0.15 * n, -0.1 * n, 0.0],
                                   0.2 * n))
    cams, masks = [], []
    vv, uu = np.mgrid[0:size, 0:size]
    for i in range(n_views):
        ang = -0.35 + 0.7 * i / max(n_views - 1, 1)
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        if rolled:
            rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                            [0.0, 0.0, 1.0]]) @ rot
        w2c = np.eye(4)
        w2c[:3, :3] = rot
        w2c[:3, 3] = [size / 2, size / 2, 2.0 * n] - rot @ center
        cams.append(OrthoCamera.create(size, size, np.linalg.inv(w2c),
                                       device=device))
        m = np.zeros((size, size), bool)
        for cen, r in spheres:
            cu, cv, _ = w2c[:3, :3] @ cen + w2c[:3, 3]
            m |= (uu - cu) ** 2 + (vv - cv) ** 2 < r ** 2
        masks.append(m.astype(np.uint8) * 255)
    return grid_bb, cams, np.stack(masks)


def phase_ortho_exact(device):
    """Orthographic views through kernel C (bitwise against the plain
    fold), a rolled ortho camera on the exact engine, and the exact engine
    against the warp engine at 256^3 x 8 turntable views (the bar of the
    JAX package's test_warp_close_to_exact)."""
    import numpy as np
    import torch

    from vacancy_tpu_torch import VoxelCarver, VoxelCarverOption
    from vacancy_tpu_torch.camera import stack_cameras
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.ops.fusion_warp import _carve_views_warp_ortho
    from vacancy_tpu_torch.ops.warp_gather import interp_rows, interp_rows_plain
    from vacancy_tpu_torch.pipeline import turntable_grid, turntable_masks

    def carver_of(bb):
        c = VoxelCarver(VoxelCarverOption(bb_min=bb[0], bb_max=bb[1],
                                          resolution=bb[2]), device)
        _require(c.init(), "VoxelCarver.init")
        return c

    bb, cams, masks = _ortho_case(device)
    c = carver_of(bb)
    before = interp_rows.launches
    imgs = c.carve_batch(cams, masks, engine="warp")
    _require(interp_rows.launches == before + 16,
             "ortho warp: kernel C not launched twice per view")
    cam = stack_cameras(cams)
    st = VoxelGridState.create(c.grid, device)
    plain = _carve_views_warp_ortho(
        st, c.grid, cam.w2c, torch.from_numpy(imgs).to(device),
        c.option.update_option, True, None, interp_rows_plain)
    torch.cuda.synchronize()
    _require(torch.equal(c.state.update_num, plain.update_num)
             and torch.equal(_bits(c.state.sdf), _bits(plain.sdf)),
             "ortho 128^3x8: kernel C engine != plain fold")
    fused = float((plain.update_num > 0).float().mean())
    _require(fused > 0.05, "ortho: nothing fused")
    _phase("ortho", f"128^3 x 8 ortho views via kernel C == plain fold "
           f"(update_num exact, sdf bitwise; fused {fused:.3f} of voxels)")

    bb, cams, masks = _ortho_case(device, n_views=1, rolled=True)
    _require(abs(float(cams[0].w2c[1, 1])) < 1e-2, "rolled camera")
    warp, exact = carver_of(bb), carver_of(bb)
    before = interp_rows.launches
    warp.carve_batch(cams, masks, engine="warp")
    _require(interp_rows.launches == before,
             "rolled ortho camera launched kernel C")
    exact.carve_batch(cams, masks, engine="exact")
    torch.cuda.synchronize()
    _require(torch.equal(warp.state.update_num, exact.state.update_num)
             and torch.equal(_bits(warp.state.sdf), _bits(exact.state.sdf))
             and bool((exact.state.update_num > 0).any()),
             "rolled ortho camera: warp != exact engine")
    _phase("ortho", "rolled camera (|w2c[1,1]| < 1e-2): exact engine, "
           "kernel C not launched, state == carve_batch(engine='exact')")

    grid = turntable_grid(256)
    bb = (grid.bb_min, grid.bb_max, grid.resolution)
    cams, masks = turntable_masks(8, device)
    states = {}
    for engine in ("exact", "warp"):
        c = carver_of(bb)
        t0 = time.perf_counter()
        c.carve_batch(cams, masks, engine=engine)
        torch.cuda.synchronize()
        states[engine] = (c.state, time.perf_counter() - t0)
    (e, e_s), (w, w_s) = states["exact"], states["warp"]
    touched = e.update_num >= 1
    _require(torch.equal(touched, w.update_num >= 1),
             "256^3x8: exact and warp touch different voxels")
    err = (e.sdf[touched] - w.sdf[touched]).abs()
    q99 = float(torch.quantile(err[:2**24].float(), 0.99))
    _require(q99 < 0.05 and float(err.max()) < 0.25,
             f"256^3x8 warp vs exact: q99 {q99}, max {float(err.max())}")
    _phase("exact", f"256^3 x 8 turntable views, MAX bilinear: warp vs exact "
           f"engine: same touched voxels, |dsdf| q99 {q99:.3e} max "
           f"{float(err.max()):.3e}; carve_batch exact {e_s:.3f} s, warp "
           f"{w_s:.3f} s (first calls)")


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
    c_err, c_times = phase_interp(device)
    phase_two_pass(device)
    facade_launches, c_main_err = phase_facade(device)
    phase_ortho_exact(device)
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
        {"name": "interp_rows", "route": "cuda",
         "source": "vacancy_tpu_torch/csrc/interp_rows.cu",
         "replaces": "vacancy_tpu/ops/warp_gather.py:29",
         "launches": facade_launches["interp_rows"],
         "max_abs_err": max(c_err, c_main_err),
         "ms": c_times["pass1"][0], "plain_ms": c_times["pass1"][1]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
