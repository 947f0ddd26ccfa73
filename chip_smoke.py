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
     Then the shapes that straddle the kernel's tiling (a CTA owns 32 x by
     64 y of one plane and holds 384 rows of the pass-1 intermediate): ny
     under one y-tile, ny two y-tiles and two rows with nx 33, a ROI that
     leaves a y-tile wholly outside the image with outside = NONE and =
     MAX, and views of 1800 rows whose tapped band is nearly the whole
     image (row chunks); in place == out of place; one line with the
     registers and shared memory of the kernel's variants from the build
     log and the CTAs per SM they allow.
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
     two UHD shapes with random positions (pass 1: a shared 2160 x 3840
     image, positions [64, 2160, 512]; pass 2: tables [64, 512, 2160],
     positions [64, 512, 512]), linear and NN, full row and a ROI; at the
     two launches the two-pass engine makes for view 0 of the UHD facade
     (pass 1 [512, 2160, 512] at u_eq, pass 2 [512, 512, 512] at v*), each
     beside its bound, the plain version and one F.grid_sample; the
     variants off the fast way (t % 4 != 0, unaligned positions, a row
     wider than the staging budget); the staged variant at 8 to 64 planes
     per CTA.
  7. the two-pass engine through interp_rows vs the fused warp kernel on
     the 128^3 x 8 turntable (240 rows): update_num exact, sdf bitwise;
     both timed.
  8. the facade at full size: VoxelCarver.carve_batch(engine="warp") of 36
     views of 3840 x 2160 into 512^3 (WAVG, band 0.05, bilinear), then
     extract_iso_surface, extract_voxel and a binary PLY read-back. The
     counters are reset after a warm-up carve, just before the timed one,
     and read after the iso-surface extract: the fused warp kernel 1, MC 1,
     interp_rows 0. Then, on the same 36 SDFs into the empty grid, the
     carve against the two-pass engine with interp_rows (72 launches,
     counted from 0) and against the plain fold, both bitwise, and plain MC
     (as many vertices); the fused kernel alone timed at that shape beside
     its bound, the two-pass engine and the plain fold; the carve again
     with the SDF images returned in the pool's reused page-locked
     buffers, staged through two page-locked buffers (the pool given no
     room) and through pageable memory, in turns; then five results kept,
     with the pool's locked bytes, VmPin and VmLck within its budget.
  9. 128^3 x 8 orthographic views of 192 rows: the fused warp kernel with
     orthographic rows vs its plain version (update_num exact, sdf bitwise)
     for MAX/WAVG x NN/bilinear; the two-pass engine (interp_rows and the
     behind-camera mask from the real z rows) vs the same plain fold,
     bitwise, and both timed; the facade launches the fused kernel and not
     interp_rows for them and for a 2160-row orthographic view, whose
     state is held against the two-pass engine and the plain fold too; a
     rolled ortho camera on the exact engine (neither counter moves); the
     exact engine vs the warp engine at 256^3 x 8 turntable views (the JAX
     package's test_warp_close_to_exact bar).
 10. the probe kernel vs its plain version, bitwise; its first launch
     timed; the device durations of its kernel and of torch.mul's kernel
     (torch.profiler) beside the host-bracketed means.
 11. the MC kernel's passes alone: the scan vs torch.cumsum at 1, 2100,
     131,072 and 1,048,576 tiles, 20 times at the largest with identical
     bytes every time; the count and emit passes vs boolean-mask compaction
     at flag densities of about 0, 0.02, 0.5 and 1 and on a state with one
     inside voxel, whose flags lie in two tiles.
 12. the sweep at full size: `pipeline sweep --n 1024 --views 100` in
     process (counters reset just before, read just after: the fused warp
     kernel once per z-chunk and carve, MC once per extract); the PLY reads
     back. Then, on the same inputs: the z-chunked carve == one
     carve_views_warp (bitwise); the fused warp kernel == plain on one
     128-plane chunk x 100 views; the MC kernel == plain on a 64-plane slab
     of the fused state (the plain version's dense temporaries do not fit
     1024^3), and on the whole grid the kernel's mesh == the plain
     version's over a (16,) mesh of CPU blocks (emission windows and
     global-id bases) byte for byte, timed, with the process's peak host
     RSS; the native face expansion == numpy byte for byte on the whole
     mesh, both timed; the scan pass timed at 1024^3; the fused warp
     kernel's time per chunk and the MC passes' times, each beside the
     parent's, its bound and its launches on the sweep; the share of
     non-empty tiles.
 13. the z-chunked carve of UHD views: 1024^3 x 2 views of 3840 x 2160
     through carve_views_warp_blocked, on the fused warp kernel (once per
     chunk, interp_rows 0), then on the two-pass engine (interp_rows 32
     times, counted from 0, the fused kernel never), which the dispatch
     picks by shape when the card's shared-memory opt-in is swapped for
     one too small for the fused kernel's plan; each peak under the
     unchunked two-pass estimate; the two states equal bitwise; one chunk
     == the plain fold.
 14. the bench entry point in process: one JSON line, every key present and
     no value null; the probe kernel launched once.
 15. a checkpoint of the 256^3 sphere's state saved and loaded back
     equal.
 16. the MC kernel with emission windows and global-id bases vs its plain
     version, byte-identical tile counts, streams and plane counts: the
     eight halo-extended blocks of a (2, 2, 2) split of a random 256^3 state
     with invalid voxels (linear and no-interp), and one block each of a
     (4,) and a (2, 2) split of the 512^3 turntable state; halo planes, rows
     and lanes emit nothing, and the blocks' global ids, sorted, are the
     dense run's.
 17. the sharded sweep at full size, one process, four blocks on the card:
     `pipeline sweep --n 1024 --views 100 --mesh-shape 4` in process
     (counters reset just before: the fused warp kernel once per block,
     z-chunk and carve, MC once per block and extract, interp_rows 0), then
     `--mesh-shape 2,2` (z and y blocks: the sorted assembly). Every block of
     each sharded state == the slice of the unsharded state (update_num
     exact, sdf bitwise); each mesh and PLY == phase 12's byte for byte;
     the fused warp kernel == plain on one chunk of a [512, 512, 1024]
     block; the windowed MC
     kernel == plain on the first 64 planes (halo plane included) of the
     (4,) block [258, 1024, 1024] and of the (2, 2) block [514, 514, 1024]
     with its row window and bases; the MC passes timed on the (4,) block;
     peak memory and the halo exchange's bytes and milliseconds are printed.
 18. a (2, 2, 2) mesh at 512^3 x 36 through `pipeline turntable
     --mesh-shape 2,2,2`: mesh == phase 5's; the fused warp kernel == plain
     on one [256, 256, 256] block; the windowed MC kernel == plain on one
     whole halo-extended [258, 258, 258] block; a sharded checkpoint
     (force_sharded=True) of the 256^3 sphere saved and loaded back equal.
 19. two processes on the card: this script starts two ranks of itself
     (`--worker`), both on cuda:0, with a (2, 2) mesh spanning them at
     512^3 x 36: initialize_distributed, carve_views_warp_sharded (blocks ==
     the dense carve), a per-process checkpoint round trip,
     extract_mesh_sharded(engine="fused", piece_dir=...); rank 0's mesh ==
     phase 5's byte for byte, rank 1 gets None; the line names the
     transport. A worker that fails, or is not done after 300 s, fails the
     run.
 20. the exact engine's kernel E vs its plain version (update_num exact,
     sdf bitwise) at the exact cell's shape: 36 turntable views of 320 x
     240, min-max normalised and untruncated, into the empty 512^3 grid
     (kMax, bilinear, outside NONE); 8 more views on the fused state with
     the weighted average, truncation, nearest taps and outside = MAX;
     the facade's default carve (no engine named) launches E once and
     the warp kernel never, and leaves E's state. E and kernel A at the
     same shape and options timed in turns (CUDA events), E beside its
     bound, the plain fold once; E's registers, shared memory and spills.
 21. the 2D SDF's kernel set S vs its plain version (float bits equal) on
     the cells' masks, min-max normalised with the band 0.05: 36 turntable
     views of 320 x 240 and 36 views of 3840 x 2160; the facade's UHD carve
     transforms its 36 views through S (3 launches). S and the plain
     version timed in turns (CUDA events), S beside its bound (masks read
     once, images written once); S's registers and shared memory.
Then one JSON line of per-kernel results (A's, B's and the scan's
launches summed over phases 12 and 17; C's from phase 13's two-pass run
of carve_views_warp_blocked, its path in this script since the fused warp
kernel takes the UHD views; E's on phase 20's facade carve; S's on phase
21's), and as the
last line {"ok": true, "device": {...}}. No JAX is imported.

    python3 chip_smoke.py --interp-only [--compare-source FILE]

runs phases 1, 2 and 6 alone and prints their times as one JSON line; FILE
is another kernel C source (an earlier commit's), built and timed in turns
with this one on the same inputs.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

from benchmark.harness.roofline import bound_s, warp_a_bound_s
from benchmark.harness.roofline_exact import exact_bound_s

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


def _bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): ``roofline.bound_s`` in milliseconds, the
    least time the card could take to move ``n_bytes`` (each input read
    once, each output written once) and to do ``n_ops`` float32
    operations, whichever is larger."""
    secs, by = bound_s(n_bytes, n_ops)
    return secs * 1e3, by


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _warp_bound(sdf, imgs, n_views, linear=True):
    """Kernel A's bound (``roofline.warp_a_bound_s``) in milliseconds,
    folding the ``n_views`` images ``imgs`` into a state shaped like
    ``sdf``."""
    secs, by = warp_a_bound_s(*sdf.shape, n_views, *imgs.shape[1:], linear)
    return secs * 1e3, by


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

    from vacancy_tpu_torch.io import native

    t0 = time.perf_counter()
    _kernels.load()
    secs = time.perf_counter() - t0
    usage = [ln.strip() for ln in _kernels.build_log().splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    _phase("build", f"nvcc + load {secs:.3f} s -> {_kernels.build()}")
    for ln in usage:
        print("  " + ln)
    t0 = time.perf_counter()
    native.load()
    _phase("build", f"host compiler + load {time.perf_counter() - t0:.3f} s "
           f"-> {native.build()}")
    return secs


def _kernel_usage() -> dict:
    """{mangled kernel name: (registers, static shared-memory bytes)} from
    the build log's ``-Xptxas -v`` lines."""
    import re

    from vacancy_tpu_torch import _kernels

    usage, name = {}, None
    for ln in _kernels.build_log().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            usage[name] = (int(m.group(1)), int(smem.group(1)) if smem else 0)
    return usage


def _usage_of(substring: str):
    """(most registers, most static shared memory) over the kernels whose
    mangled name holds ``substring``."""
    got = [v for k, v in _kernel_usage().items() if substring in k]
    _require(bool(got), f"no kernel named *{substring}* in the build log")
    return max(r for r, _ in got), max(m for _, m in got)


def _ctas_per_sm(registers: int, threads: int) -> int:
    """CTAs of ``threads`` threads an SM's 65,536 registers hold (a warp's
    registers are allocated in units of 256: 8 per thread)."""
    per_thread = -(-registers // 8) * 8
    return min(32, 2048 // threads, 65536 // (per_thread * threads))


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

    max_err = max(max_err, _warp_tiling_edges(device))

    # (c) the bench's shape: 512^3 x 24 views, MAX, random-normal images
    from vacancy_tpu_torch.bench import build_case

    grid, st, w2c, pp, fl, imgs = build_case(512, 24, device=device)
    opt = cfg.VoxelUpdateOption()
    a = (st.sdf, st.update_num,
         *(grid.axis_centers_t(i, device) for i in range(3)), w2c, pp, fl,
         imgs)
    bound = _warp_bound(st.sdf, imgs, 24)
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
           f"ms ({nf / ms / 1e6:.3f} Gfusions/s), plain {plain_ms:.3f} ms, "
           f"bound {bound[0]:.3f} ms by {bound[1]}")
    return max_err, ms, plain_ms, bound


def _warp_tiling_edges(device) -> float:
    """Kernel A against plain on shapes that straddle its tiling, in place
    against out of place, and its registers and shared memory."""
    import numpy as np
    import torch

    from vacancy_tpu_torch import _kernels
    from vacancy_tpu_torch import config as cfg
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.ops import warp_fused

    wavg = dict(voxel_update=cfg.VoxelUpdate.WEIGHTED_AVERAGE,
                use_truncation=True, truncation_band=0.05)
    top = (0, 30, 319, 110)  # image rows 30..110: part of the grid's height
    cases = [
        ("6x37x40 (ny under one y-tile) max nn", (6, 37, 40), {}, False,
         None, 240),
        ("5x130x33 (two y-tiles and two rows, nx 33) wavg bilinear",
         (5, 130, 33), wavg, True, None, 240),
        ("8x256x48 roi rows 30..110 outside=none", (8, 256, 48), wavg, True,
         top, 240),
        ("8x256x48 roi rows 30..110 outside=max", (8, 256, 48),
         dict(wavg, update_outside=cfg.UpdateOutsideImage.MAX), True, top,
         240),
        ("11x17x45 x 1800 rows (band in row chunks) wavg bilinear",
         (11, 17, 45), dict(wavg, truncation_band=0.4,
                            update_outside=cfg.UpdateOutsideImage.MAX),
         True, None, 1800),
        ("11x17x45 x 1800 rows (band in row chunks) max nn", (11, 17, 45),
         {}, False, None, 1800),
    ]
    max_err = 0.0
    for name, shape, kw, linear, roi, rows in cases:
        grid, cams, imgs = _turntable_case(shape, 5, device)
        pp, fl = cams.principal_point, cams.focal_length
        if rows != imgs.shape[1]:
            # the same cameras seen through taller random images: v scales
            scale = rows / imgs.shape[1]
            rng = np.random.default_rng(4)
            imgs = torch.from_numpy(rng.normal(
                size=(5, rows, 360)).astype(np.float32)).to(device)
            pp, fl = pp.clone(), fl.clone()
            pp[:, 1] *= scale
            fl[:, 1] *= scale
        opt = cfg.VoxelUpdateOption(**kw)
        st = VoxelGridState.create(grid, device)
        centers = [grid.axis_centers_t(a, device) for a in range(3)]
        a = (st.sdf, st.update_num, *centers, cams.w2c, pp, fl, imgs, opt,
             linear, roi)
        ks, ku = warp_fused.warp_fuse_planes(*a)
        ps, pu = warp_fused.warp_fuse_planes_plain(*a)
        # once more, on the fused state, in place
        a2 = (ks.clone(), ku.clone(), *a[2:])
        warp_fused.warp_fuse_planes(*a2, out=(a2[0], a2[1]))
        ks, ku = warp_fused.warp_fuse_planes(ks, ku, *a[2:])
        ps, pu = warp_fused.warp_fuse_planes_plain(ps, pu, *a[2:])
        torch.cuda.synchronize()
        _require(torch.equal(ku, pu) and torch.equal(_bits(ks), _bits(ps)),
                 f"warp {name}: kernel != plain")
        _require(torch.equal(a2[1], ku)
                 and torch.equal(_bits(a2[0]), _bits(ks)),
                 f"warp {name}: in place != out of place")
        ty = warp_fused.TILE_Y
        touched = [round(float((pu[:, y:y + ty] != 0).float().mean()), 3)
                   for y in range(0, shape[1], ty)]
        if roi is not None and "update_outside" not in kw:
            _require(min(touched) == 0.0 and max(touched) > 0.05,
                     f"warp {name}: a y-tile should lie wholly outside the "
                     f"ROI, touched {touched}")
        else:
            _require(max(touched) > 0.05, f"warp {name}: nothing fused")
        max_err = max(max_err, float((ks - ps).abs().nan_to_num(0).max()))
        _phase("warp", f"{name}: bitwise equal, in place == out of place "
               f"(touched {touched} of the voxels of each y-tile)")
    lib = _kernels.load()
    regs, smem = _usage_of("warp_fused_kernel")
    _require(regs == lib.vt_warp_tiling(4) and smem == lib.vt_warp_tiling(3),
             "the build log and the loaded library disagree on kernel A")
    rows = warp_fused.INTER_ROWS_CAP
    variants = sum("warp_fused_kernel" in k for k in _kernel_usage())
    _phase("warp", f"build log, the kernel's {variants} variants: at most "
           f"{regs} registers and {smem} bytes of static shared memory; dynamic "
           f"{240 * warp_fused.TILE_X * 4} bytes at 240 rows, "
           f"{rows * warp_fused.TILE_X * 4} at the cap of {rows}: "
           f"{lib.vt_warp_ctas_per_sm(240)} and "
           f"{lib.vt_warp_ctas_per_sm(rows)} CTAs of {warp_fused.THREADS} "
           f"threads per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    return max_err


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

    from vacancy_tpu_torch.bench import _sphere_state

    timing, max_err = None, 0.0
    for name, (grid, st) in (
        ("256^3 sphere", _sphere_state(256, device=device)),
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
            # the state read once, the streams and counts written once;
            # about 30 operations per voxel (8 compares, the case, flags)
            bound = _bound(_nbytes(st.sdf, st.update_num, *k.as_tuple()),
                           30 * st.sdf.numel())
            timing = (ms, plain_ms, bound)
            _phase("mc", f"{name}: kernel {ms:.3f} ms (count+scan+emit, one "
                   f"host read), plain {plain_ms:.3f} ms, bound "
                   f"{bound[0]:.3f} ms by {bound[1]}")
    return (max_err, *timing)


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
    return launches, warp_err, mc_err, mesh


# kernel C's shapes on the UHD facade path, for 64 of the 512 z-planes:
# (name, tables, positions, shared table, ROI taps)
INTERP_SHAPES = (
    ("pass1", (1, 2160, 3840), (64, 2160, 512), True, (200, 3600)),
    ("pass2", (64, 512, 2160), (64, 512, 512), False, (100, 2000)),
)
# planes per CTA tried for the staged variant at each pass-1 shape
INTERP_GROUPS = (8, 16, 32, 64, 128, 256, 512)


def _grid_sample_ms(tables, pos, share) -> float:
    """Milliseconds of the one PyTorch call that computes kernel C's linear
    full-row case: ``F.grid_sample`` (bilinear, border padding, corners
    aligned) at a grid made beforehand from the positions [B, R, N] and
    their row numbers, of the shared [1, R, T] table (as one image) or of
    the [B, R, T] tables (as B images of one channel). The positions are
    clamped at 0 first, as the port's callers clip them (left of 0 the
    kernel blends taps 0 and 1 where border padding holds tap 0). The
    normalised coordinates round, so the result is held to kernel C's
    within 1e-2 of the tables' scale, not bitwise."""
    import torch
    import torch.nn.functional as F

    from vacancy_tpu_torch.ops.warp_gather import interp_rows

    b, r, n = pos.shape
    t = tables.shape[2]
    pos = pos.clamp_min(0.0)
    rows = torch.arange(r, dtype=torch.float32, device=pos.device)
    grid = torch.stack(
        [pos * (2.0 / (t - 1)) - 1.0,
         (rows * (2.0 / max(r - 1, 1)) - 1.0)[None, :, None].expand(b, r, n)],
        dim=-1)
    image = tables[None] if share else tables[:, None]
    if share:
        grid = grid.reshape(1, b * r, n, 2)

    def call():
        return F.grid_sample(image, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    scale = max(float(tables.abs().max()), 1.0)
    err = float((call().reshape(b, r, n)
                 - interp_rows(tables, pos, t, True, share)).abs().max())
    _require(err <= 1e-2 * scale,
             f"F.grid_sample differs from interp_rows by {err}")
    ms = _cuda_ms(call, 5)
    del grid, pos
    return ms


def _interp_bound(tables, pos, share, lo, hi):
    """(bound, bound with every table element read): the taps the linear
    full-row case needs read once (a gather needs only the table elements
    its positions tap: counted on the card), the positions read once, the
    outputs written once; 6 operations per output (floor, frac, 1 - frac,
    two products, the sum)."""
    import torch

    n, r, t = pos.shape
    width = tables.shape[2]
    tapped = torch.zeros(tables.numel(), dtype=torch.bool, device=pos.device)
    step = max(1, (1 << 26) // (r * t))
    for n0 in range(0, n, step):
        p = pos[n0:n0 + step]
        row = torch.arange(r, device=pos.device).view(1, r, 1)
        if not share:
            row = row + torch.arange(n0, n0 + p.shape[0],
                                     device=pos.device).view(-1, 1, 1) * r
        p0 = torch.floor(p).to(torch.int64).clamp_(lo, hi)
        tapped[row * width + p0] = True
        tapped[row * width + torch.clamp_max(p0 + 1, hi)] = True
        del p0
    n_tapped = int(tapped.sum())
    del tapped
    ops = 6 * pos.numel()
    return (_bound(4 * n_tapped + _nbytes(pos, pos), ops),
            _bound(_nbytes(tables, pos, pos), ops))


def _facade_launches(device):
    """Kernel C's two launches for view 0 of the UHD facade (512^3, 3840 x
    2160, WAVG, band 0.05, bilinear), as the two-pass engine makes them:
    the facade sends such views to kernel A, so its own SDF image and
    camera go through ``warp_fold`` with a sampler that records its
    arguments and calls interp_rows. Returns [(tables, pos, width,
    linear, share, lo, hi)] for pass 1 and pass 2."""
    import torch

    from vacancy_tpu_torch import VoxelCarver
    from vacancy_tpu_torch.camera import stack_cameras
    from vacancy_tpu_torch.config import SdfInterpolation
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.ops.fusion_warp import warp_fold
    from vacancy_tpu_torch.ops.warp_gather import interp_rows
    from vacancy_tpu_torch.pipeline import facade_inputs

    opt, cams, masks = facade_inputs(512, 1, 3840, 2160, device)
    calls = []

    def record(tables, pos, width, linear, share, lo, hi):
        calls.append((tables, pos, width, linear, share, lo, hi))
        return interp_rows(tables, pos, width, linear, share, lo, hi)

    carver = VoxelCarver(opt, device)
    _require(carver.init(), "VoxelCarver.init")
    imgs = torch.from_numpy(carver.carve_batch(cams, masks, engine="warp"))
    cam = stack_cameras(cams)
    st = VoxelGridState.create(carver.grid, device)
    uopt = opt.update_option
    warp_fold(st.sdf, st.update_num,
              *(carver.grid.axis_centers_t(a, device) for a in range(3)),
              cam.w2c, cam.principal_point, cam.focal_length,
              imgs.to(device), uopt,
              uopt.sdf_interp == SdfInterpolation.BILINEAR, None, record)
    torch.cuda.synchronize()
    del carver, st
    _require(len(calls) == 2, f"the facade's view made {len(calls)} calls")
    return calls


def _load_other_interp(source: str):
    """Another build of kernel C, e.g. an earlier commit's
    csrc/interp_rows.cu, compiled with the port's nvcc flags into a
    temporary directory, for timing beside this one. Returns a function of
    (tables, pos, out, n, r, t, width, share, linear, lo, hi, stream), the
    entry point of the first kernel C, which took no plan; a source with
    this one's entry point (it has ``vt_interp_tiling``) is launched with
    this checkout's plan."""
    import ctypes

    import torch

    from vacancy_tpu_torch import _kernels
    from vacancy_tpu_torch.ops import warp_gather

    tmp = tempfile.mkdtemp(prefix="interp_other_")
    path = os.path.join(tmp, "libinterp_other.so")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o",
                    path, source], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(path)
    fn = lib.vt_interp_rows
    fn.restype = ctypes.c_int
    if not hasattr(lib, "vt_interp_tiling"):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        return fn
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]

    def launch(tables, pos, out, n, r, t, width, share, linear, lo, hi,
               stream):
        plan = warp_gather.interp_plan(n, r, t, width, bool(share), lo, hi,
                                       _kernels.smem_optin_bytes(
                                           torch.cuda.current_device()),
                                       pos % 16 == 0)
        return fn(tables, pos, out, n, r, t, width, share, linear, lo, hi,
                  warp_gather.MODES[plan.mode], plan.group, plan.rows,
                  stream)

    return launch


def _time_pair(kernel, other, iters):
    """(kernel ms, other ms) in turns: other, kernel, kernel, other; each the
    mean of its two readings (other None: (kernel ms, None))."""
    if other is None:
        return _cuda_ms(kernel, iters), None
    o1, k1, k2, o2 = (_cuda_ms(f, iters) for f in (other, kernel, kernel,
                                                   other))
    return (k1 + k2) / 2, (o1 + o2) / 2


def _interp_case(name, tables, pos, width, share, tapss, compare, iters):
    """Kernel C == plain bitwise for linear and nn at each (lo, hi) of
    ``tapss``; then the linear full row timed (and ``compare``'s build on
    the same inputs), the plain version, the bound and the library call.
    Returns (max |kernel - plain|, (ms, plain_ms, bound, lib_ms,
    other_ms, bound with every table element read), the plan's
    variant)."""
    import torch

    from vacancy_tpu_torch import _kernels
    from vacancy_tpu_torch.ops.warp_gather import (interp_plan, interp_rows,
                                                   interp_rows_plain)

    n, r, t = pos.shape
    err = 0.0
    for linear in (True, False):
        for lo, hi in tapss:
            k = interp_rows(tables, pos, width, linear, share, lo, hi)
            p = interp_rows_plain(tables, pos, width, linear, share, lo, hi)
            torch.cuda.synchronize()
            _require(torch.equal(_bits(k), _bits(p)),
                     f"interp_rows {name} linear={linear} [{lo}, {hi}]: "
                     f"kernel != plain")
            err = max(err, float((k - p).abs().max()))
            del k, p
    plan = interp_plan(n, r, t, width, share, 0, width - 1,
                       _kernels.smem_optin_bytes(pos.device),
                       pos.data_ptr() % 16 == 0)
    other = None
    if compare is not None:
        out = torch.empty_like(pos)
        stream = _kernels.stream_ptr(pos.device)

        def other():
            _kernels.check(compare(tables.data_ptr(), pos.data_ptr(),
                                   out.data_ptr(), n, r, t, width,
                                   int(share), 1, 0, width - 1, stream),
                           "the other interp_rows build")
            return out

        other()
        _require(torch.equal(_bits(out), _bits(interp_rows(
            tables, pos, width, True, share))),
            f"{name}: the other build != kernel C")
    ms, other_ms = _time_pair(
        lambda: interp_rows(tables, pos, width, True, share), other, iters)
    plain_ms = _cuda_ms(
        lambda: interp_rows_plain(tables, pos, width, True, share), 3)
    bound, whole = _interp_bound(tables, pos, share, 0, width - 1)
    lib_ms = _grid_sample_ms(tables, pos, share)
    gb = pos.numel() * 8 / 1e9
    _phase("interp", f"{name} tables {list(tables.shape)} pos "
           f"{list(pos.shape)}: bitwise equal (linear, nn; taps {list(tapss)}); variant "
           f"{plan.mode} (grid {plan.grid}, group {plan.group}, rows "
           f"{plan.rows}, {plan.smem_bytes} B shared); kernel {ms:.4f} ms "
           f"({gb / ms:.3f} TB/s of positions + outputs, {bound[0] / ms:.2f} "
           f"of the bound)"
           + ("" if other_ms is None else f", the other build {other_ms:.4f}"
              f" ms") + f", plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms "
           f"by {bound[1]} ({whole[0]:.4f} ms with every table element read), "
           f"F.grid_sample on a prebuilt grid {lib_ms:.4f} ms")
    return err, (ms, plain_ms, bound, lib_ms, other_ms, whole), plan.mode


def _staged_groups(name, tables, pos, groups=INTERP_GROUPS):
    """The staged variant's time at ``groups`` planes per CTA, by the C
    entry point, linear, full row; each result == interp_rows's."""
    import torch

    from vacancy_tpu_torch import _kernels
    from vacancy_tpu_torch.ops import warp_gather

    n, r, t = pos.shape
    width = tables.shape[2]
    ref = warp_gather.interp_rows(tables, pos, width, True, True)
    out = torch.empty_like(pos)
    lib, stream = _kernels.load(), _kernels.stream_ptr(pos.device)
    times = {}
    for g in (g for g in groups if g <= n):
        def call(g=g):
            _kernels.check(lib.vt_interp_rows(
                tables.data_ptr(), pos.data_ptr(), out.data_ptr(), n, r, t,
                width, 1, 1, 0, width - 1, warp_gather.MODES["staged"], g, 1,
                stream), f"staged group {g}")

        call()
        torch.cuda.synchronize()
        _require(torch.equal(_bits(out), _bits(ref)), f"{name} group {g}")
        times[g] = _cuda_ms(call, 10)
    _phase("interp", f"{name} staged, planes per CTA: " + ", ".join(
        f"{g}: {ms:.4f} ms" for g, ms in times.items()))
    return times


def phase_interp(device, shapes=INTERP_SHAPES, compare=None):
    """Kernel C against its plain version: (a) at the two UHD shapes with
    random positions over the whole row (pass 1: a shared 2160 x 3840
    image, positions for 64 z-planes x 2160 rows x 512 columns; pass 2: 64
    transposed pass-1 planes of 512 x 2160, positions 64 x 512 x 512);
    (b) at the facade's own two launches for one view (u_eq over all 512
    planes, then v* on the transposed field); (c) the variants the plan
    sends off the fast way: t % 4 != 0, an unaligned position pointer, a
    shared row wider than the staging budget; (d) the staged variant at
    other groups of planes per CTA. With ``compare`` (another build of
    kernel C) both are timed in turns at (a) and (b)."""
    import numpy as np
    import torch

    from vacancy_tpu_torch import _kernels
    from vacancy_tpu_torch.ops.warp_gather import (STAGE_BYTES_MAX,
                                                   interp_plan, interp_rows,
                                                   interp_rows_plain)

    rng = np.random.default_rng(7)
    timings, max_err = {}, 0.0
    for name, tshape, pshape, share, roi in shapes:
        width = tshape[2]
        tables = torch.from_numpy(
            rng.normal(size=tshape).astype(np.float32)).to(device)
        pos = torch.from_numpy(rng.uniform(
            -1.0, width, size=pshape).astype(np.float32)).to(device)
        pos[..., 0], pos[..., -1] = -1.0, float(width)
        err, timings[name], _ = _interp_case(
            name, tables, pos, width, share, ((0, width - 1), roi), compare,
            20)
        max_err = max(max_err, err)
        if share:
            timings[name + " groups"] = _staged_groups(name, tables, pos)
        del tables, pos

    calls = _facade_launches(device)
    for name, (tables, pos, width, linear, share, lo, hi) in zip(
            ("facade pass1", "facade pass2"), calls):
        _require(linear and (lo, hi) == (0, width - 1),
                 f"{name}: linear {linear}, taps [{lo}, {hi}]")
        err, timings[name], mode = _interp_case(
            name, tables, pos, width, share, ((lo, hi),), compare, 10)
        _require(mode == ("staged" if share else "direct4"),
                 f"{name}: variant {mode}")
        max_err = max(max_err, err)
        if share:
            timings[name + " groups"] = _staged_groups(name, tables, pos)
    del calls, tables, pos

    # the variants off the fast way, each == plain bitwise
    wide = STAGE_BYTES_MAX // 4 + 8
    flat = torch.from_numpy(rng.uniform(
        -1.0, 3840.0, size=64 * 2160 * 512 + 1).astype(np.float32)).to(device)
    cases = (
        ("t % 4 != 0", (1, 2160, 3840), flat[:64 * 2160 * 511].view(
            64, 2160, 511), True, "direct1"),
        ("unaligned positions", (1, 2160, 3840), flat[1:].view(
            64, 2160, 512), True, "direct1"),
        ("row wider than the staging budget", (1, 64, wide),
         torch.from_numpy(rng.uniform(-1.0, wide, size=(9, 64, 512)).astype(
             np.float32)).to(device), True, "direct4"),
        ("per-row t % 4 != 0", (64, 512, 2160), flat[:64 * 512 * 509].view(
            64, 512, 509).clamp_max(2160.0), False, "direct1"),
    )
    lines = []
    for what, tshape, pos, share, want in cases:
        tables = torch.from_numpy(
            rng.normal(size=tshape).astype(np.float32)).to(device)
        width = tshape[2]
        n, r, t = pos.shape
        plan = interp_plan(n, r, t, width, share, 0, width - 1,
                           _kernels.smem_optin_bytes(device),
                           pos.data_ptr() % 16 == 0)
        _require(plan.mode == want, f"{what}: variant {plan.mode}, not {want}")
        for linear in (True, False):
            for lo, hi in ((0, width - 1), (3, width // 2 + 1)):
                k = interp_rows(tables, pos, width, linear, share, lo, hi)
                p = interp_rows_plain(tables, pos, width, linear, share, lo,
                                      hi)
                torch.cuda.synchronize()
                _require(torch.equal(_bits(k), _bits(p)),
                         f"interp_rows {what} linear={linear}: kernel != "
                         f"plain")
                max_err = max(max_err, float((k - p).abs().max()))
        ms = _cuda_ms(lambda: interp_rows(tables, pos, width, True, share), 5)
        lines.append(f"{what} {list(pos.shape)}: {plan.mode} {ms:.4f} ms")
        del tables, pos
    del flat
    _phase("interp", "variants == plain bitwise (linear, nn; full row and "
           "a ROI): " + "; ".join(lines))
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


def _host_memory() -> dict:
    """The process's resident and locked host memory (/proc/self/status),
    and the page-locked bytes PyTorch's host cache holds where this torch
    reports them."""
    import torch

    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key in ("VmRSS", "VmLck", "VmPin"):
                out[key] = value.strip()
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is not None:
        keep = ("allocated_bytes.current", "reserved_bytes.current",
                "reserved_bytes.peak")
        out.update({k: v for k, v in stats().items() if k in keep})
    return out


def _timed_carve(carver, cams, masks):
    """(SDF images, seconds) of one carve_batch(engine="warp") into the
    empty grid, on the host clock, ending in a synchronize."""
    import torch

    _require(carver.init(), "VoxelCarver.init")  # the empty grid again
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = carver.carve_batch(cams, masks, engine="warp")
    torch.cuda.synchronize()
    return imgs, time.perf_counter() - t0


def phase_facade(device, n_views=36):
    """The UHD facade at full size: 36 views of 3840 x 2160 of the
    turntable blob into 512^3 (WAVG, band 0.05, bilinear). Kernel A takes
    2160-row views. After a warm-up carve the launch counters are reset
    just before the timed carve and read after its extracts: A once, MC
    once, kernel C never. Then, on the same 36 SDFs
    into the empty grid: the carve against the two-pass engine with
    kernel C (its 72 launches, counted from 0, are C's path in this
    script) and against the plain fold, update_num exact and sdf bitwise,
    and MC against its plain version; A alone timed with CUDA events
    beside its bound and the two-pass engine's and the plain fold's times
    on the same inputs; and the carve again with the SDF images returned
    in the pool's reused page-locked buffers, staged and through pageable
    memory, in turns; then five results kept, the pool's locked bytes,
    VmPin and VmLck within its budget."""
    import numpy as np
    import torch

    from vacancy_tpu_torch import VoxelCarver
    from vacancy_tpu_torch import carver as carver_mod
    from vacancy_tpu_torch.camera import stack_cameras
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.mesh import Mesh
    from vacancy_tpu_torch.ops import mc_fused, warp_fused, warp_gather
    from vacancy_tpu_torch.ops.fusion_warp import warp_fold
    from vacancy_tpu_torch.pipeline import facade_inputs

    opt, cams, masks = facade_inputs(512, n_views, 3840, 2160, device)
    torch.cuda.reset_peak_memory_stats(device)
    counters = (warp_fused.warp_fuse_planes, mc_fused.marching_cubes_fused,
                warp_gather.interp_rows)
    carver = VoxelCarver(opt, device)
    _require(carver.init(), "VoxelCarver.init")
    warm = carver.carve_batch(cams, masks, engine="warp")
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    imgs, carve_s = _timed_carve(carver, cams, masks)
    t0 = time.perf_counter()
    mesh = carver.extract_iso_surface()
    extract_s = time.perf_counter() - t0
    launches = {"warp_fused": counters[0].launches,
                "mc_fused": counters[1].launches,
                "interp_rows": counters[2].launches}
    t0 = time.perf_counter()
    voxels = carver.extract_voxel()
    voxel_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as out_dir:
        path = os.path.join(out_dir, "uhd_512.ply")
        mesh.write_ply(path, binary=True)
        back = Mesh.load_ply(path)
    _require(launches == {"warp_fused": 1, "mc_fused": 1, "interp_rows": 0},
             f"UHD facade launches {launches}: need the fused warp kernel "
             f"once for the 36 views of 2160 rows, MC once, and no kernel C")
    _require(np.array_equal(imgs, warm), "UHD facade: the SDF images of two "
             "carves differ")
    del warm
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
           f"Gfusions/s; the SDF images into a newly page-locked buffer "
           f"of the pool), extract_iso_surface {extract_s:.4f} s "
           f"({mesh.num_vertices} vertices, {mesh.num_faces} faces), "
           f"extract_voxel {voxel_s:.4f} s ({voxels.num_vertices // 24} "
           f"voxel cubes), launches {launches}, peak mem {peak:.2f} GiB")

    # the two-pass engine with kernel C, the plain fold and MC on the same
    # 36 SDFs into the empty grid
    grid = carver.grid
    st = VoxelGridState.create(grid, device)
    cam = stack_cameras(cams)
    imgs_dev = torch.from_numpy(imgs).to(device)
    a = (st.sdf, st.update_num, *(grid.axis_centers_t(i, device)
                                  for i in range(3)),
         cam.w2c, cam.principal_point, cam.focal_length, imgs_dev,
         opt.update_option, True)
    ks, ku = carver.state.sdf, carver.state.update_num
    counters[2].launches = 0
    cs, cu = warp_fold(*a, None, warp_gather.interp_rows)
    torch.cuda.synchronize()
    c_launches = counters[2].launches
    _require(c_launches == 2 * n_views,
             f"two-pass engine: {c_launches} launches of kernel C, not two "
             f"per view")
    _require(torch.equal(ku, cu), "UHD facade: update_num != two-pass engine")
    _require(torch.equal(_bits(ks), _bits(cs)),
             "UHD facade: sdf bits != two-pass engine with kernel C")
    del cs, cu
    ps, pu = warp_fused.warp_fuse_planes_plain(*a)
    torch.cuda.synchronize()
    _require(torch.equal(ku, pu), "UHD facade: update_num != plain fold")
    _require(torch.equal(_bits(ks), _bits(ps)), "UHD facade: sdf bits")
    c_err = float((ks - ps).abs().nan_to_num(0).max())
    del ps, pu
    p = mc_fused.mc_streams_plain(ks, ku, *a[2:5])
    n_vert = sum(int(t.numel()) for t in (p.vx_lin, p.vy_lin, p.vz_lin))
    _require(n_vert == mesh.num_vertices,
             f"UHD facade: plain MC has {n_vert} vertices, the facade's mesh "
             f"{mesh.num_vertices}")
    del p
    _phase("facade", f"512^3 x {n_views} UHD: fused kernel carve == "
           f"two-pass engine with kernel C ({c_launches} launches) == plain "
           f"fold (update_num exact, sdf bitwise; fused "
           f"{float((ku > 0).float().mean()):.3f} "
           f"of voxels); plain MC {n_vert} vertices as the facade's mesh")

    # kernel A alone at the facade's shape, beside its bound and the
    # two-pass engine on the same inputs
    a_ms = _cuda_ms(lambda: warp_fused.warp_fuse_planes(*a), 5)
    bound = _warp_bound(st.sdf, imgs_dev, n_views)
    two_ms = _cuda_ms(lambda: warp_fold(*a, None, warp_gather.interp_rows), 1)
    plain_ms = _cuda_ms(lambda: warp_fused.warp_fuse_planes_plain(*a), 1)
    plan = warp_fused.fused_plan(*st.sdf.shape, *imgs_dev.shape[1:],
                                 warp_fused.smem_optin_bytes(device))
    _phase("facade", f"512^3 x {n_views} x 3840x2160: fused warp kernel "
           f"{a_ms:.3f} ms ({fusions / a_ms / 1e6:.1f} Gfusions/s, "
           f"{bound[0] / a_ms:.3f} of the bound {bound[0]:.3f} ms by "
           f"{bound[1]}; {plan.inter_rows} rows of the intermediate, grid "
           f"{plan.grid}), two-pass engine with kernel C {two_ms:.1f} ms, "
           f"plain fold {plain_ms:.1f} ms")
    del a, st, imgs_dev

    # the copy of the returned SDF images: the carve with the pool's
    # reused page-locked buffers (each result dropped before the next),
    # with the staged copy (the pool given no room) and with a pageable
    # copy, in turns after the timed carve above; then the host's
    # footprint while the caller keeps five results
    host_array, share = carver_mod._host_array, carver_mod.PINNED_SHARE
    count = (host_array.pinned, host_array.staged)
    pooled_s, staged_s, pageable_s = [], [], []
    for _ in range(3):
        got, t = _timed_carve(carver, cams, masks)
        pooled_s.append(t)
        _require(np.array_equal(got, imgs), "UHD facade: the SDF images "
                 "of two carves differ (pool)")
        carver_mod.PINNED_SHARE = 0
        try:
            got, t = _timed_carve(carver, cams, masks)
        finally:
            carver_mod.PINNED_SHARE = share
        staged_s.append(t)
        _require(np.array_equal(got, imgs), "UHD facade: the SDF images "
                 "of two carves differ (staged)")
        carver_mod._host_array = lambda t: t.cpu().numpy()
        try:
            got, t = _timed_carve(carver, cams, masks)
        finally:
            carver_mod._host_array = host_array
        pageable_s.append(t)
        _require(np.array_equal(got, imgs), "UHD facade: the SDF images "
                 "of two carves differ (pageable)")
    del got
    turns = (host_array.pinned - count[0], host_array.staged - count[1])
    _require(turns == (3, 3), f"UHD facade: {turns} carves pooled and "
             f"staged, not 3 and 3")
    host_before = _host_memory()
    kept = [imgs]
    while len(kept) < 5:
        kept.append(_timed_carve(carver, cams, masks)[0])
    host_after = _host_memory()
    budget = int(share * carver_mod._physical_bytes())
    locked = {k: int(host_after[k].split()[0]) * 1024
              for k in ("VmPin", "VmLck") if k in host_after}
    _require(host_array.pinned_bytes <= budget
             and all(v <= budget for v in locked.values()),
             f"UHD facade: {host_array.pinned_bytes} bytes in the pool, "
             f"{locked} locked, over the budget of {budget}")
    _require(all(np.array_equal(k, imgs) for k in kept)
             and len({k.ctypes.data for k in kept}) == len(kept),
             "UHD facade: five kept results differ or share a buffer")
    _phase("facade", f"carve with the SDF images in the pool's reused "
           f"page-locked buffers {', '.join(f'{t:.4f}' for t in pooled_s)} "
           f"s, staged through two page-locked buffers "
           f"{', '.join(f'{t:.4f}' for t in staged_s)} s, through pageable "
           f"memory {', '.join(f'{t:.4f}' for t in pageable_s)} s; with "
           f"{len(kept)} results kept ({imgs.nbytes} bytes each): "
           f"_host_array.pinned_bytes {host_array.pinned_bytes} of a budget "
           f"of {budget} ({share:.4g} of {carver_mod._physical_bytes()} "
           f"bytes), pinned {host_array.pinned}, staged {host_array.staged}; "
           f"VmPin and VmLck {locked or 'not in /proc/self/status'}; "
           f"host {host_before} before the last four carves, {host_after} "
           f"after")
    del kept, imgs
    return c_err


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
        # the first camera stands at the grid's centre, so half of the
        # voxels lie behind it (the behind-camera mask has work to do)
        depth = 0.0 if i == 0 and not rolled else 2.0 * n
        w2c[:3, 3] = [size / 2, size / 2, depth] - rot @ center
        cams.append(OrthoCamera.create(size, size, np.linalg.inv(w2c),
                                       device=device))
        m = np.zeros((size, size), bool)
        for cen, r in spheres:
            cu, cv, _ = w2c[:3, :3] @ cen + w2c[:3, 3]
            m |= (uu - cu) ** 2 + (vv - cv) ** 2 < r ** 2
        masks.append(m.astype(np.uint8) * 255)
    return grid_bb, cams, np.stack(masks)


def phase_ortho_exact(device):
    """Orthographic views through the fused warp kernel (bitwise against
    its plain version, timed against the two-pass engine), a 2160-row
    orthographic view through the facade to the fused kernel (bitwise
    against the two-pass engine with kernel C and the plain fold), a
    rolled ortho camera on the exact engine, and the exact engine against
    the warp engine at 256^3 x 8 turntable views (the bar of the JAX
    package's test_warp_close_to_exact)."""
    import numpy as np
    import torch

    from vacancy_tpu_torch import VoxelCarver, VoxelCarverOption
    from vacancy_tpu_torch import config as cfg
    from vacancy_tpu_torch.camera import stack_cameras
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.ops.fusion_warp import ortho_homography, warp_fold
    from vacancy_tpu_torch.ops.sdf2d import make_signed_distance_field
    from vacancy_tpu_torch.ops.warp_fused import (
        warp_fuse_planes,
        warp_fuse_planes_plain,
    )
    from vacancy_tpu_torch.ops.warp_gather import interp_rows
    from vacancy_tpu_torch.pipeline import turntable_grid, turntable_masks

    def carver_of(bb, **kw):
        c = VoxelCarver(VoxelCarverOption(
            bb_min=bb[0], bb_max=bb[1], resolution=bb[2],
            update_option=cfg.VoxelUpdateOption(**kw)), device)
        _require(c.init(), "VoxelCarver.init")
        return c

    # kernel A with orthographic rows against its plain version
    bb, cams, masks = _ortho_case(device)
    cam = stack_cameras(cams)
    synth, zero2, one2, z_rows = ortho_homography(cam.w2c)
    wavg = dict(voxel_update=cfg.VoxelUpdate.WEIGHTED_AVERAGE,
                use_truncation=True, truncation_band=0.05)
    a_err = 0.0
    for rule, kw in (("max", {}), ("wavg", wavg)):
        c = carver_of(bb, **kw)
        opt = c.option.update_option
        imgs = make_signed_distance_field(
            torch.from_numpy(masks).to(device),
            use_truncation=opt.use_truncation,
            truncation_band=opt.truncation_band)
        st = VoxelGridState.create(c.grid, device)
        a = (st.sdf, st.update_num,
             *(c.grid.axis_centers_t(i, device) for i in range(3)), synth,
             zero2, one2, imgs, opt)
        for linear in (False, True):
            ks, ku = warp_fuse_planes(*a, linear, ortho_rows=z_rows)
            ps, pu = warp_fuse_planes_plain(*a, linear, None, z_rows)
            torch.cuda.synchronize()
            what = f"ortho 128^3x8 {rule} linear={linear}"
            _require(torch.equal(ku, pu), f"{what}: update_num differs")
            _require(torch.equal(_bits(ks), _bits(ps)), f"{what}: sdf bits")
            fused = float((ku > 0).float().mean())
            _require(fused > 0.05, f"{what}: nothing fused")
            a_err = max(a_err, float((ks - ps).abs().nan_to_num(0).max()))
            _phase("ortho", f"{what}: fused kernel with ortho rows == plain "
                   f"(update_num exact, sdf bitwise; fused {fused:.3f} of "
                   f"voxels)")
    # the two-pass engine (kernel C and the z_rows behind-camera mask) on
    # the same views: its plain version is the same fold, so the fused
    # kernel and the two-pass engine agree bit for bit as well
    ts, tu = warp_fold(*a, True, None, interp_rows, z_rows=z_rows)
    torch.cuda.synchronize()
    _require(torch.equal(tu, pu) and torch.equal(_bits(ts), _bits(ps)),
             "ortho 128^3x8 wavg bilinear: two-pass engine with kernel C != "
             "plain fold")
    del ts, tu
    a_ms = _cuda_ms(lambda: warp_fuse_planes(*a, True, ortho_rows=z_rows), 20)
    two_ms = _cuda_ms(lambda: warp_fold(*a, True, None, interp_rows,
                                        z_rows=z_rows), 5)
    plain_ms = _cuda_ms(
        lambda: warp_fuse_planes_plain(*a, True, None, z_rows), 3)
    a_bound = _warp_bound(st.sdf, imgs, len(cams))
    _phase("ortho", f"128^3x8 wavg bilinear, 192 rows: two-pass engine with "
           f"kernel C == plain fold (update_num exact, sdf bitwise); fused "
           f"kernel {a_ms:.3f} ms, two-pass engine {two_ms:.3f} ms, plain "
           f"{plain_ms:.3f} ms, bound {a_bound[0]:.4f} ms by {a_bound[1]}")

    # the facade sends ortho views of any height to A
    counters = (warp_fuse_planes, interp_rows)
    before = [k.launches for k in counters]
    c.carve_batch(cams, masks, engine="warp")
    _require([k.launches for k in counters] == [before[0] + 1, before[1]],
             "ortho views of 192 rows: need one fused-kernel launch and no "
             "kernel C")
    torch.cuda.synchronize()
    _require(torch.equal(c.state.update_num, pu)
             and torch.equal(_bits(c.state.sdf), _bits(ps)),
             "ortho facade carve != plain fold")
    tall_bb, tall_cams, tall_masks = _ortho_case(device, n_views=1, size=2160)
    c = carver_of(tall_bb)
    before = [k.launches for k in counters]
    tall_imgs = c.carve_batch(tall_cams, tall_masks, engine="warp")
    torch.cuda.synchronize()
    _require([k.launches for k in counters] == [before[0] + 1, before[1]],
             "a 2160-row ortho view: need one fused-kernel launch and no "
             "kernel C")
    opt = c.option.update_option
    st = VoxelGridState.create(c.grid, device)
    t_synth, t_zero2, t_one2, t_rows = ortho_homography(
        stack_cameras(tall_cams).w2c)
    t_args = (st.sdf, st.update_num,
              *(c.grid.axis_centers_t(i, device) for i in range(3)), t_synth,
              t_zero2, t_one2, torch.from_numpy(tall_imgs).to(device), opt,
              opt.sdf_interp == cfg.SdfInterpolation.BILINEAR, None)
    ps, pu = warp_fuse_planes_plain(*t_args, t_rows)
    before = interp_rows.launches
    ts, tu = warp_fold(*t_args, interp_rows, z_rows=t_rows)
    torch.cuda.synchronize()
    _require(interp_rows.launches == before + 2,
             "the two-pass engine: kernel C not launched twice")
    for what, (s, u) in (("plain fold", (ps, pu)),
                         ("two-pass engine with kernel C", (ts, tu))):
        _require(torch.equal(c.state.update_num, u)
                 and torch.equal(_bits(c.state.sdf), _bits(s)),
                 f"a 2160-row ortho view through the fused kernel != {what}")
    tall_fused = float((pu > 0).float().mean())
    _require(0.05 < tall_fused < 0.95,
             f"tall ortho: fused {tall_fused} of voxels (half lie behind)")
    del st, ps, pu, ts, tu
    _phase("ortho", f"carve_batch(engine='warp'): 8 ortho views of 192 rows "
           f"launch the fused kernel once and kernel C never (== plain "
           f"fold); one 2160-row ortho view likewise, == the two-pass engine "
           f"with kernel C == plain fold, update_num exact and sdf bitwise "
           f"(fused {tall_fused:.3f} of voxels, the rest behind the camera)")

    bb, cams, masks = _ortho_case(device, n_views=1, rolled=True)
    _require(abs(float(cams[0].w2c[1, 1])) < 1e-2, "rolled camera")
    warp, exact = carver_of(bb), carver_of(bb)
    before = [k.launches for k in counters]
    warp.carve_batch(cams, masks, engine="warp")
    _require([k.launches for k in counters] == before,
             "rolled ortho camera launched a warp kernel")
    exact.carve_batch(cams, masks, engine="exact")
    torch.cuda.synchronize()
    _require(torch.equal(warp.state.update_num, exact.state.update_num)
             and torch.equal(_bits(warp.state.sdf), _bits(exact.state.sdf))
             and bool((exact.state.update_num > 0).any()),
             "rolled ortho camera: warp != exact engine")
    _phase("ortho", "rolled camera (|w2c[1,1]| < 1e-2): exact engine, no "
           "warp kernel launched, state == carve_batch(engine='exact')")

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
    del c
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
    return a_err, a_ms, two_ms


def phase_exact(device):
    """Kernel E against its plain version at the exact cell's shape: 36
    turntable views of 320 x 240 (min-max normalised, untruncated SDFs)
    into the empty 512^3 grid, kMax, bilinear, outside NONE; then on the
    fused state a second fold of 8 views; the facade at its defaults
    (carve_batch with no engine named) launches E once and no warp kernel
    and leaves the same state. E, the plain fold and kernel A at the same
    shape and options are timed (CUDA events), E beside its bound; E's
    registers from the build log and its peak over the two states."""
    import torch

    from vacancy_tpu_torch import VoxelCarver, VoxelCarverOption
    from vacancy_tpu_torch import _kernels
    from vacancy_tpu_torch import config as cfg
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.ops.exact_fused import (
        THREADS,
        exact_fold,
        exact_fold_plain,
    )
    from vacancy_tpu_torch.ops.warp_fused import warp_fuse_planes
    from vacancy_tpu_torch.pipeline import turntable_inputs, turntable_masks

    n, n_views = 512, 36
    grid, _, cams, imgs = turntable_inputs(n, n_views, False, device)
    opt = cfg.VoxelUpdateOption()
    st = VoxelGridState.create(grid, device)
    h, w = imgs.shape[1:]
    roi = (0, 0, w - 1, h - 1)
    centers = [grid.axis_centers_t(a, device) for a in range(3)]
    views = (cams.w2c, cams.principal_point, cams.focal_length)

    def args_of(state, k=n_views, opt=opt):
        return (state.sdf, state.update_num, *centers,
                *(t[:k] for t in views), imgs[:k],
                imgs[:k].amax(dim=(1, 2)), roi, opt)

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = exact_fold.launches
    ks, ku = exact_fold(*args_of(st))
    torch.cuda.synchronize()
    e_peak = torch.cuda.max_memory_allocated() - held
    _require(exact_fold.launches == before + 1, "E: not one launch")
    ps, pu = exact_fold_plain(*args_of(st))
    torch.cuda.synchronize()
    _require(torch.equal(ku, pu), "E 512^3x36: update_num differs")
    _require(torch.equal(_bits(ks), _bits(ps)), "E 512^3x36: sdf bits")
    both = torch.isfinite(ks) & torch.isfinite(ps)
    e_err = float((ks[both] - ps[both]).abs().max())
    fused = float((ku > 0).float().mean())
    _require(fused > 0.05, "E 512^3x36: nothing fused")
    del ps, pu
    # kMax folds the same views again to no change: the second fold takes
    # the weighted average, truncation, nearest taps and outside = MAX
    wavg = cfg.VoxelUpdateOption(
        voxel_update=cfg.VoxelUpdate.WEIGHTED_AVERAGE,
        sdf_interp=cfg.SdfInterpolation.NN,
        update_outside=cfg.UpdateOutsideImage.MAX, use_truncation=True)
    again = VoxelGridState(ks, ku)
    ks2, ku2 = exact_fold(*args_of(again, 8, wavg))
    ps2, pu2 = exact_fold_plain(*args_of(again, 8, wavg))
    torch.cuda.synchronize()
    _require(torch.equal(ku2, pu2) and torch.equal(_bits(ks2), _bits(ps2)),
             "E on the fused state, 8 views: != plain")
    _require(not torch.equal(ku2, ku), "E: the second fold changed nothing")
    del ks2, ku2, ps2, pu2
    _phase("exact", f"{n}^3 x {n_views} x {w}x{h} kMax bilinear: E == plain "
           f"fold (update_num exact, sdf bitwise; fused {fused:.3f} of "
           f"voxels); 8 more views on the fused state (weighted average, "
           f"truncation, nearest, outside = MAX) likewise")

    # the facade at its defaults: the exact engine, E once, no warp kernel
    _, masks = turntable_masks(n_views, device)
    carver = VoxelCarver(VoxelCarverOption(
        bb_min=grid.bb_min, bb_max=grid.bb_max, resolution=grid.resolution),
        device)
    _require(carver.init(), "VoxelCarver.init")
    exact_fold.launches = 0
    warp_fuse_planes.launches = 0
    carver.carve_batch(cams, masks)
    torch.cuda.synchronize()
    facade_launches = exact_fold.launches
    _require((facade_launches, warp_fuse_planes.launches) == (1, 0),
             "the facade's default carve: need E once, A never")
    _require(torch.equal(carver.state.update_num, ku)
             and torch.equal(_bits(carver.state.sdf), _bits(ks)),
             "the facade's default carve != E on the same images")
    del carver

    secs, by = exact_bound_s(*st.sdf.shape, n_views, *imgs.shape[1:])
    bound = (secs * 1e3, by)
    a_args = (st.sdf, st.update_num, *centers, *views, imgs, opt, True)
    rows = []
    for _ in range(2):  # E, A, A, E
        e_ms = _cuda_ms(lambda: exact_fold(*args_of(st)), 10)
        a_ms = _cuda_ms(lambda: warp_fuse_planes(*a_args), 10)
        rows.append((e_ms, a_ms))
    plain_ms = _cuda_ms(lambda: exact_fold_plain(*args_of(st)), 1)
    regs, smem = _usage_of("exact_fused_kernel")
    lib = _kernels.load()
    _require(regs == lib.vt_exact_tiling(4), "the build log and the loaded "
             "library disagree on kernel E")
    e_ms = min(r[0] for r in rows)
    nf = grid.num_voxels * n_views
    _phase("exact", f"E {', '.join(f'{r[0]:.3f}' for r in rows)} ms "
           f"({nf / e_ms / 1e6:.3f} Gfusions/s, {bound[0] / e_ms:.2%} of the "
           f"{bound[0]:.3f} ms bound by {bound[1]}); kernel A at the same "
           f"shape and options {', '.join(f'{r[1]:.3f}' for r in rows)} ms; "
           f"plain fold {plain_ms:.1f} ms; E's peak over the input state "
           f"{e_peak} bytes (the output state {2 * _nbytes(st.sdf)}); E's "
           f"{sum('exact_fused_kernel' in k for k in _kernel_usage())} "
           f"variants at most {regs} registers, {smem} bytes of static shared "
           f"memory, {lib.vt_exact_tiling(5)} bytes spilled, "
           f"{_ctas_per_sm(regs, THREADS)} CTAs of {THREADS} threads per SM")
    return facade_launches, e_err, e_ms, plain_ms, bound


def phase_sdf2d(device):
    """Kernel set S against its plain version at the cells' mask shapes,
    bitwise and timed; the facade's UHD carve transforms its views
    through S."""
    import torch

    from vacancy_tpu_torch import VoxelCarver
    from vacancy_tpu_torch.ops.sdf2d import (make_signed_distance_field,
                                             signed_distance_field_plain)
    from vacancy_tpu_torch.ops.sdf2d_fused import sdf2d_fused
    from vacancy_tpu_torch.pipeline import facade_inputs, turntable_masks

    n_views = 36
    kw = dict(use_truncation=True, truncation_band=0.05)
    _, qvga = turntable_masks(n_views, device)
    opt, cams, uhd = facade_inputs(512, n_views, 3840, 2160, device)
    results = {}
    for name, masks in (("qvga", qvga), ("uhd", uhd)):
        before = sdf2d_fused.launches
        got = make_signed_distance_field(masks, **kw)
        want = signed_distance_field_plain(masks, **kw)
        torch.cuda.synchronize()
        _require(sdf2d_fused.launches == before + 3, f"S {name}: not 3 "
                 f"launches")
        _require(torch.equal(_bits(got), _bits(want)),
                 f"S {name}: != plain")
        inside = float((got < 0).float().mean())
        del got, want
        bound = _bound(masks.numel() * (1 + 4), 0)
        rows = []
        for _ in range(2):  # S, plain, plain, S
            s_ms = _cuda_ms(lambda: make_signed_distance_field(masks, **kw),
                            20)
            p_ms = _cuda_ms(lambda: signed_distance_field_plain(masks, **kw),
                            3)
            rows.append((s_ms, p_ms))
        s_ms = min(r[0] for r in rows)
        results[name] = (s_ms, min(r[1] for r in rows), bound)
        h, w = masks.shape[1:]
        _phase("sdf2d", f"{n_views} x {w}x{h}: S == plain (bits; "
               f"{inside:.3f} of pixels inside); S "
               f"{', '.join(f'{r[0]:.4f}' for r in rows)} ms "
               f"({bound[0] / s_ms:.2%} of the {bound[0]:.4f} ms bound by "
               f"{bound[1]}); plain {', '.join(f'{r[1]:.3f}' for r in rows)}"
               f" ms")

    carver = VoxelCarver(opt, device)
    _require(carver.init(), "VoxelCarver.init")
    sdf2d_fused.launches = sdf2d_fused.images = 0
    carver.carve_batch(cams, uhd, engine="warp")
    torch.cuda.synchronize()
    launches = sdf2d_fused.launches
    _require((launches, sdf2d_fused.images) == (3, n_views),
             "the UHD facade carve: need S's 3 launches for 36 views")
    del carver
    usage = {k: _usage_of(k) for k in ("sdf2d_columns_kernel",
                                       "sdf2d_rows_kernel",
                                       "sdf2d_finish_kernel")}
    _phase("sdf2d", "the UHD facade carve: S 3 launches, 36 views; "
           + "; ".join(f"{k} {r} registers, {m} bytes of static shared "
                       f"memory" for k, (r, m) in usage.items()))
    return launches, results


def phase_probe(device):
    """Kernel D against its plain version, and its first launch's time."""
    import numpy as np
    import torch

    from vacancy_tpu_torch import bench

    ok, first_s = bench.warm_probe(device)
    _require(ok, "probe kernel: wrong sum")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(
        rng.normal(size=bench.PROBE_SHAPE).astype(np.float32)).to(device)
    k, p = bench.probe_scale(x), bench.probe_scale_plain(x)
    torch.cuda.synchronize()
    _require(torch.equal(_bits(k), _bits(p)), "probe kernel != plain")
    ms = _cuda_ms(lambda: bench.probe_scale(x), 100)
    plain_ms = _cuda_ms(lambda: bench.probe_scale_plain(x), 100)
    lib_ms = _cuda_ms(lambda: torch.mul(x, 2.0), 100)
    bound = _bound(_nbytes(x, x), x.numel())
    _phase("probe", f"f32 {list(x.shape)} * 2: kernel == plain bitwise; "
           f"first launch (library already built) {first_s * 1e3:.3f} ms; "
           f"100 host calls between two events, per call: kernel {ms:.4f} "
           f"ms, plain {plain_ms:.4f} ms, torch.mul {lib_ms:.4f} ms (these "
           f"read the host's launch rate), bound {bound[0]:.2e} ms by "
           f"{bound[1]}")
    # what the card itself spends on each: the kernels' own durations
    dev = {}
    for name, fn, key in (
        ("probe", lambda: bench.probe_scale(x), "probe_scale_kernel"),
        ("torch.mul", lambda: torch.mul(x, 2.0), "elementwise"),
    ):
        hit = _kernel_spans(fn, 100, (key,))
        dev[name] = ("not measured" if hit is None else
                     f"{hit[0][2] / hit[0][1]:.3f} us")
    _phase("probe", f"device durations (torch.profiler, mean of up to 100 "
           f"launches each): probe_scale_kernel {dev['probe']}, torch.mul's "
           f"kernel {dev['torch.mul']}")
    return float((k - p).abs().max()), ms, plain_ms, lib_ms, bound


def _kernel_spans(fn, iters: int, keys, tries: int = 3):
    """[(kernel name, launches, total device microseconds)] of the kernels
    whose names hold one of ``keys``, over ``iters`` calls of ``fn`` under
    torch.profiler after one warm-up call: one span per key, or None.

    The profiler's device trace now and then comes back without the
    kernels that ran (CUPTI drops the session's activity), so a session
    that misses one is made again, up to ``tries`` times. These durations
    are readings, not checks: None means "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = []
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and any(k in e.key for k in keys)):
                us = getattr(e, "self_device_time_total", None)
                spans.append((e.key, e.count, float(
                    e.self_cuda_time_total if us is None else us)))
        if (len(spans) == len(keys) and all(sp[1] > 0 for sp in spans)
                and all(any(k in sp[0] for sp in spans) for k in keys)):
            return spans
    _phase("profiler", f"torch.profiler recorded {len(spans)} of the "
           f"{len(keys)} expected kernels ({', '.join(keys)}) in {tries} "
           f"sessions: their device durations are not measured")
    return None


def _density_state(shape, density, device, seed=9):
    """A state whose MC flags have about ``density`` per edge stream: 0 (a
    constant field), 1 (a checkerboard of signs), or signs drawn so that
    an edge straddles the iso level with that probability."""
    import numpy as np

    from vacancy_tpu_torch.grid import GridSpec, state_from_numpy

    nz, ny, nx = shape
    rng = np.random.default_rng(seed)
    if density == 0.0:
        sign = np.ones(shape)
    elif density == 1.0:
        k, j, i = np.indices(shape)
        sign = np.where((k + j + i) % 2 == 0, 1.0, -1.0)
    else:
        p = (1 - np.sqrt(1 - 2 * density)) / 2  # 2 p (1 - p) = density
        sign = np.where(rng.random(shape) < p, -1.0, 1.0)
    sdf = (sign * rng.uniform(0.1, 1.0, size=shape)).astype(np.float32)
    grid = GridSpec((0.0,) * 3, (nx + 0.4, ny + 0.4, nz + 0.4), 1.0)
    return grid, state_from_numpy(sdf, np.ones(shape, np.int32), device)


def phase_mc_passes(device):
    """Kernel B's passes on their own: the scan against torch.cumsum, the
    count pass against the dense flags summed per tile and the emit pass
    against boolean-mask compaction, at four flag densities."""
    import numpy as np
    import torch

    from vacancy_tpu_torch.ops import mc_fused

    rng = np.random.default_rng(11)
    scan_err = 0
    for nz, tpp in ((1, 1), (300, 7), (512, 256), (1024, 1024)):
        counts = torch.from_numpy(rng.integers(
            0, mc_fused.TILE + 1, size=(nz * tpp, 4)).astype(np.int32)
        ).to(device)
        k = mc_fused.mc_scan(counts, tpp)
        p = mc_fused.mc_scan_plain(counts, tpp)
        torch.cuda.synchronize()
        _require(all(x.dtype == y.dtype and torch.equal(x, y)
                     for x, y in zip(k, p)),
                 f"mc scan {nz} planes x {tpp} tiles != torch.cumsum")
        scan_err = max(scan_err, _scan_err(k, p))
    # the largest again and again: blocks that waited on one another in the
    # wrong order would show as a rare difference
    for _ in range(20):
        again = mc_fused.mc_scan(counts, tpp)
        torch.cuda.synchronize()
        _require(all(torch.equal(x, y) for x, y in zip(again, k)),
                 "mc scan: two runs on the same counts differ")
    _phase("mc-passes", f"scan pass alone == torch.cumsum (offsets, totals, "
           f"plane counts) for 1, 2100, 131072 and 1048576 tiles of random "
           f"counts ({mc_fused.scan_blocks(nz * tpp)} blocks at the "
           f"largest); 20 more runs there, identical bytes every time")
    shape = (64, 96, 128)
    for density in (0.0, 0.02, 0.5, 1.0):
        grid, st = _density_state(shape, density, device)
        a = (st.sdf, st.update_num,
             *(grid.axis_centers_t(i, device) for i in range(3)))
        counts = mc_fused.mc_tile_counts(*a)
        _require(torch.equal(counts, mc_fused.mc_tile_counts_plain(*a[:2])),
                 f"mc count pass at density {density} != plain")
        k = mc_fused.marching_cubes_fused(*a)
        p = mc_fused.mc_streams_plain(*a)
        _require_same_streams(k, p, f"mc emit at density {density}")
        got = [t.numel() / st.sdf.numel()
               for t in (k.vx_lin, k.vy_lin, k.vz_lin, k.c_lin)]
        _require(abs(got[0] - density) < 0.05,
                 f"density {density}: x-edge flags {got[0]}")
        _phase("mc-passes", f"{shape} density {density}: count == plain tile "
               f"sums, emit == mask compaction (flag densities x "
               f"{got[0]:.3f} y {got[1]:.3f} z {got[2]:.3f} cubes "
               f"{got[3]:.3f})")
    # one voxel below the iso level in a field above it: every flag lies in
    # two tiles (its own and the one below it) of the 768
    sdf, un = _empty_planes(shape, device)
    sdf.fill_(1.0)
    un.fill_(1)
    sdf[10, 12, 45] = -0.5
    a = (sdf, un, *(grid.axis_centers_t(i, device) for i in range(3)))
    counts = mc_fused.mc_tile_counts(*a)
    _require(torch.equal(counts, mc_fused.mc_tile_counts_plain(*a[:2])),
             "mc count pass on the one-voxel state != plain")
    busy = int((counts.sum(dim=1) > 0).sum())
    _require(busy == 2, f"one inside voxel: {busy} non-empty tiles, not 2")
    for linear in (True, False):
        _require_same_streams(
            mc_fused.marching_cubes_fused(*a, linear_interp=linear),
            mc_fused.mc_streams_plain(*a, linear_interp=linear),
            f"mc emit on the one-voxel state linear={linear}")
    _phase("mc-passes", f"{shape} one inside voxel: {busy} of "
           f"{counts.shape[0]} tiles non-empty, count and emit == plain "
           f"({int(counts.sum())} flags)")
    usage = {name: _usage_of(key)[0] for name, key in (
        ("count", "mc_count_kernelILb0"),
        ("count with windows", "mc_count_kernelILb1"),
        ("emit", "mc_emit_kernelILb0"),
        ("emit with windows", "mc_emit_kernelILb1"))}
    _phase("mc-passes", "build log: " + ", ".join(
        f"{name} {regs} registers ({_ctas_per_sm(regs, 256)} CTAs of 256 "
        f"threads per SM)" for name, regs in usage.items()))
    return scan_err


def _scan_err(kernel, plain) -> int:
    """max |kernel - plain| over the scan's offsets, totals and per-plane
    counts."""
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(kernel, plain))


def _empty_planes(shape, device):
    """(sdf, update_num) of an untouched grid of ``shape``."""
    import torch

    from vacancy_tpu_torch.config import INVALID_SDF

    return (torch.full(shape, float(INVALID_SDF), dtype=torch.float32,
                       device=device),
            torch.zeros(shape, dtype=torch.int32, device=device))


def _reset_counters():
    from vacancy_tpu_torch import bench
    from vacancy_tpu_torch.ops import mc_fused, warp_fused, warp_gather

    counters = {
        "warp_fused": warp_fused.warp_fuse_planes,
        "mc_fused": mc_fused.marching_cubes_fused,
        "mc_scan": mc_fused.mc_scan,
        "interp_rows": warp_gather.interp_rows,
        "probe": bench.probe_scale,
    }
    for c in counters.values():
        c.launches = 0
    return counters


def _read_counters(counters) -> dict:
    return {name: c.launches for name, c in counters.items()}


# what the parent commit's kernels took on the same inputs (NVIDIA H100 80GB
# HBM3, 700.00 W; this script's phases 12 and 17 on that commit, from
# PERF.md), printed beside this run's readings
PARENT_MS = {
    "warp chunk 128x1024^2 x 100": "111.9-112.6",
    "mc 1024^3": {"count": "14.50-14.53", "scan": "8.99-9.05",
                  "emit": "19.81-19.92",
                  "all three with the host read": "43.6-43.9"},
    "mc [258, 1024, 1024] windowed": {
        "count": "4.43-4.53", "scan": "1.83-1.85", "emit": "5.54-5.65",
        "all three with the host read": "11.93-12.25"},
}


def phase_sweep(device, n=1024, n_views=100):
    """This slice's main path at full size: the 1024^3 x 100 sweep through
    its entry point, then its kernels against their plain versions and the
    z-chunked carve against the unchunked one on the same inputs."""
    import numpy as np
    import torch

    from vacancy_tpu_torch import pipeline
    from vacancy_tpu_torch.config import SdfInterpolation
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.mesh import Mesh
    from vacancy_tpu_torch.ops import fusion_warp, mc_fused, warp_fused

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory() as out_dir:
        counters = _reset_counters()
        t0 = time.perf_counter()
        res = pipeline.main(["sweep", "--n", str(n), "--views", str(n_views),
                             "--out", out_dir])
        wall = time.perf_counter() - t0
        launches = _read_counters(counters)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        t0 = time.perf_counter()
        back = Mesh.load_ply(os.path.join(out_dir, f"sweep_{n}.ply"))
        load_s = time.perf_counter() - t0
        ply_sha = _sha256(os.path.join(out_dir, f"sweep_{n}.ply"))
    chunks = n // fusion_warp._snap_chunk_nz(n, 128) if n > 128 else 1
    _require(launches["warp_fused"] == 2 * chunks
             and launches["mc_fused"] == 2 and launches["mc_scan"] == 2
             and launches["interp_rows"] == 0,
             f"sweep launches {launches}: need the fused warp kernel once "
             f"per chunk and carve ({2 * chunks}), MC once per extract (2)")
    _require((back.num_vertices, back.num_faces)
             == (res["mc_vertices"], res["mc_faces"]), "PLY read-back counts")
    _require(back.num_faces > 400_000, f"too few faces: {back.num_faces}")
    _require(bool(np.isfinite(back.vertices).all())
             and bool((np.abs(back.vertices) <= 1.11).all()),
             "vertices outside the grid")
    _require(int(back.faces.min()) >= 0
             and int(back.faces.max()) < back.num_vertices, "face indices")
    _phase("sweep", f"run_sweep {n}^3 x {n_views}: carve cold "
           f"{res['carve_cold_s']:.4f} s, warm {res['carve_s']:.4f} s "
           f"({res['fusions_per_s'] / 1e9:.3f} Gfusions/s), extract cold "
           f"{res['extract_cold_s']:.4f} s, warm {res['extract_s']:.4f} s, "
           f"{res['mc_vertices']} vertices, {res['mc_faces']} faces, wall "
           f"{wall:.3f} s, launches {launches}, peak mem {peak:.2f} GiB; "
           f"PLY read back in {load_s:.3f} s")

    # the same inputs again: blocked (in place) vs one carve_views_warp
    grid, opt, cams, imgs = pipeline.turntable_inputs(n, n_views, True, device)
    linear = opt.sdf_interp == SdfInterpolation.BILINEAR
    cam_args = (cams.w2c, cams.principal_point, cams.focal_length, imgs)
    blocked = fusion_warp.carve_views_warp_blocked(
        VoxelGridState.create(grid, device), grid, *cam_args, opt=opt,
        linear=linear)
    whole = fusion_warp.carve_views_warp(
        VoxelGridState.create(grid, device), grid, *cam_args, opt=opt,
        linear=linear)
    torch.cuda.synchronize()
    _require(torch.equal(blocked.update_num, whole.update_num),
             "sweep: blocked carve update_num != unblocked")
    _require(torch.equal(_bits(blocked.sdf), _bits(whole.sdf)),
             "sweep: blocked carve sdf bits != unblocked")
    fused = float((whole.update_num > 0).float().mean())
    del whole
    torch.cuda.empty_cache()
    _phase("sweep", f"{n}^3 x {n_views}: carve_views_warp_blocked (in place, "
           f"{chunks} chunks) == one carve_views_warp, update_num exact and "
           f"sdf bitwise (fused {fused:.3f} of voxels)")

    # kernel A == plain on one 128-plane chunk x all views (the middle)
    centers = [grid.axis_centers_t(a, device) for a in range(3)]
    z0 = (n // 2 // 128) * 128 if n > 128 else 0
    zs = slice(z0, z0 + min(128, n))
    a = (*_empty_planes((zs.stop - zs.start, n, n), device), centers[0],
         centers[1], centers[2][zs].contiguous(), *cam_args, opt, linear)
    ps, pu = warp_fused.warp_fuse_planes_plain(*a)
    torch.cuda.synchronize()
    _require(torch.equal(blocked.update_num[zs], pu),
             "sweep chunk: fused warp kernel update_num != plain")
    _require(torch.equal(_bits(blocked.sdf[zs]), _bits(ps)),
             "sweep chunk: fused warp kernel sdf bits != plain")
    a_err = float((blocked.sdf[zs] - ps).abs().nan_to_num(0).max())
    ms = _cuda_ms(lambda: warp_fused.warp_fuse_planes(*a), 3)
    bound = _warp_bound(a[0], imgs, n_views, linear)
    del a, ps, pu
    torch.cuda.empty_cache()
    at_full = (n, n_views) == (1024, 100)
    _phase("sweep", f"planes [{zs.start}, {zs.stop}) x {n_views} views: "
           f"fused warp kernel == plain (update_num exact, sdf bitwise); "
           f"kernel {ms:.3f} ms per chunk"
           + (f" (parent {PARENT_MS['warp chunk 128x1024^2 x 100']} ms)"
              if at_full else "")
           + f", bound {bound[0]:.3f} ms by {bound[1]}, "
           f"{launches['warp_fused']} launches on the sweep")

    # kernel B == plain on a 64-plane slab of the fused state: the plain
    # version's dense temporaries (some 60 bytes per voxel) do not fit n^3
    ks = slice(n // 2 - 32, n // 2 + 32)
    slab = (blocked.sdf[ks].contiguous(), blocked.update_num[ks].contiguous(),
            centers[0], centers[1], centers[2][ks].contiguous())
    k = mc_fused.marching_cubes_fused(*slab)
    p = mc_fused.mc_streams_plain(*slab)
    b_err = _require_same_streams(k, p, "sweep slab mc")
    _require(int(k.c_lin.numel()) > 10_000, "sweep slab: too few cubes")
    slab_cubes = int(k.c_lin.numel())
    del k, p, slab
    torch.cuda.empty_cache()

    # the whole mesh: native face expansion against numpy, byte for byte
    st = mc_fused.marching_cubes_fused(blocked.sdf, blocked.update_num,
                                       *centers)
    host = [t.cpu().numpy() for t in st.as_tuple()[:8]]
    vlins = [v.astype(np.int64) for v in host[1:6:2]]
    bases = np.cumsum([0] + [len(v) for v in vlins[:2]])
    ny, nx = grid.shape_zyx[1:]
    t0 = time.perf_counter()
    f_native = mc_fused.expand_faces(host[6], host[7], ny, nx, vlins, bases)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_numpy = mc_fused._expand_faces(host[6], host[7], ny, nx, vlins, bases)
    numpy_s = time.perf_counter() - t0
    _require(f_native.dtype == f_numpy.dtype
             and f_native.tobytes() == f_numpy.tobytes(),
             "native face expansion != numpy")
    mesh = mc_fused.assemble_fused_streams(host[0:6:2], vlins, host[6],
                                           host[7], ny, nx, grid)
    _require(np.array_equal(mesh.vertices.view(np.int32),
                            back.vertices.view(np.int32))
             and np.array_equal(mesh.faces, back.faces),
             "the sweep's PLY differs from the mesh of the same inputs")
    # and the whole grid through B's plain version: a z mesh of CPU blocks
    # walks all n^3 voxels block by block with emission windows and
    # global-id bases, so the kernel's linear ids are held up to n^3 - 1
    # and not only inside one slab; 64 planes a block keep each block's
    # dense temporaries (some 60 bytes per voxel) to a few GiB of host
    import resource

    from vacancy_tpu_torch.parallel import (
        extract_mesh_sharded,
        make_device_mesh,
    )

    cpu_blocks = max(1, n // 64)
    t0 = time.perf_counter()
    plain = extract_mesh_sharded(
        blocked, grid, make_device_mesh(shape=(cpu_blocks,),
                                        devices=["cpu"] * cpu_blocks))
    plain_s = time.perf_counter() - t0
    _require(np.array_equal(plain.faces, mesh.faces)
             and np.array_equal(plain.vertices.view(np.int32),
                                mesh.vertices.view(np.int32)),
             f"sweep: the plain mesh over {cpu_blocks} CPU blocks != the "
             f"kernel's at {n}^3")
    del plain
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    _phase("sweep", f"{n}^3: the kernel's whole mesh == the plain version's "
           f"over a ({cpu_blocks},) mesh of CPU blocks byte for byte "
           f"({plain_s:.3f} s; the process's peak host RSS so far "
           f"{rss:.2f} GiB)")
    _phase("sweep", f"MC kernel == plain on planes [{ks.start}, {ks.stop}) "
           f"({slab_cubes} active cubes; counts and 4 streams "
           f"byte-identical); native face expansion == numpy on the whole "
           f"mesh ({len(f_native)} faces): native {native_s:.4f} s "
           f"(threads on {len(os.sched_getaffinity(0))} cores), numpy "
           f"{numpy_s:.4f} s; the written PLY equals the "
           f"mesh")

    # the scan pass at this size, over nz * tiles_per_plane tiles
    tpp = mc_fused.tiles_per_plane(ny, nx)
    counts = mc_fused.mc_tile_counts(blocked.sdf, blocked.update_num,
                                     *centers)
    k = mc_fused.mc_scan(counts, tpp)
    p = mc_fused.mc_scan_plain(counts, tpp)
    torch.cuda.synchronize()
    _require(all(torch.equal(x, y) for x, y in zip(k, p)),
             "sweep: scan pass != torch.cumsum")
    scan_err = _scan_err(k, p)
    scan_ms = _cuda_ms(lambda: mc_fused.mc_scan(counts, tpp), 5)
    scan_plain = _cuda_ms(lambda: mc_fused.mc_scan_plain(counts, tpp), 5)
    scan_lib = _cuda_ms(
        lambda: torch.cumsum(counts, dim=0, dtype=torch.int32), 5)
    scan_bound = _bound(_nbytes(counts, *k), 4 * counts.numel())
    # the host launches four small kernels per scan: what the card spends
    spans = _kernel_spans(
        lambda: mc_fused.mc_scan(counts, tpp), 10,
        ("mc_scan_sums", "mc_scan_blocks", "mc_scan_offsets",
         "mc_plane_counts"))
    # a kernel's mean over the launches the profiler kept (it may drop one)
    scan_dev = ("not measured" if spans is None else
                f"{sum(sp[2] / sp[1] for sp in spans) * 1e-3:.4f} ms")
    _phase("sweep", f"{n}^3 scan pass over {counts.shape[0]} tiles: "
           f"{scan_ms:.3f} ms per call from the host, {scan_dev} "
           f"on the card over its four kernels (plain {scan_plain:.3f} ms, "
           f"one torch.cumsum {scan_lib:.3f} ms, bound {scan_bound[0]:.4f} "
           f"ms by {scan_bound[1]})")
    busy = float((counts.sum(dim=1) > 0).float().mean())
    _phase("sweep", f"{n}^3 MC passes ({launches['mc_fused']} launches of "
           f"each on the sweep; {busy:.4f} of the {counts.shape[0]} tiles "
           f"non-empty): " + _mc_pass_times(
               blocked.sdf, blocked.update_num, centers, {},
               PARENT_MS["mc 1024^3"] if at_full else None))
    scan = {"ms": scan_ms, "plain_ms": scan_plain, "library_ms": scan_lib,
            "bound": scan_bound, "err": scan_err}
    del blocked, st, counts
    torch.cuda.empty_cache()
    return launches, a_err, b_err, scan, (back, ply_sha, peak)


def phase_blocked_uhd(device, n=1024, n_views=2):
    """The z-chunked carve of UHD views: 3840 x 2160 into n^3 through
    carve_views_warp_blocked, first on the fused warp kernel (once per
    chunk, no kernel C), then on the two-pass engine (kernel C twice per
    view and chunk, no fused kernel; its launches, counted from 0, are C's
    path in this script), which the dispatch picks by shape when the
    card's shared-memory opt-in is swapped for one that holds no two rows
    of the fused kernel's intermediate. Each run's peak stays under what
    the unchunked two-pass fold would hold; the two states are equal bit
    for bit, and one chunk equals the plain fold."""
    import torch

    from vacancy_tpu_torch.camera import stack_cameras
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.ops import fusion_warp, warp_fused
    from vacancy_tpu_torch.ops.sdf2d import make_signed_distance_field
    from vacancy_tpu_torch.pipeline import facade_inputs, turntable_grid

    h, w = 2160, 3840
    opt, cams, masks = facade_inputs(n, n_views, w, h, device)
    opt = opt.update_option
    grid = turntable_grid(n)
    cam = stack_cameras(cams)
    imgs = make_signed_distance_field(
        masks.to(device), use_truncation=True,
        truncation_band=opt.truncation_band)
    cam_args = (cam.w2c, cam.principal_point, cam.focal_length, imgs)
    chunks = n // fusion_warp._snap_chunk_nz(n, 128) if n > 128 else 1
    # the unchunked two-pass fold holds the state in and out plus about ten
    # fields of nz * max(h, ny) * nx f32 for one view
    unchunked = (16 * n**3 + 10 * 4 * n * max(h, n) * n) / 2**30

    def blocked(held_bytes=0):
        """(state, seconds, launches, peak GiB beside ``held_bytes``)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        counters = _reset_counters()
        t0 = time.perf_counter()
        st = fusion_warp.carve_views_warp_blocked(
            VoxelGridState.create(grid, device), grid, *cam_args, opt=opt)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_counters(counters)
        peak = (torch.cuda.max_memory_allocated(device) - held_bytes) / 2**30
        _require(peak < unchunked,
                 f"peak {peak} GiB, unchunked {unchunked} GiB")
        return st, seconds, launches, peak

    state, carve_s, launches, peak = blocked()
    _require(launches["warp_fused"] == chunks
             and launches["interp_rows"] == 0,
             f"blocked UHD launches {launches}: need the fused warp kernel "
             f"once per chunk ({chunks}) and no kernel C")
    optin = warp_fused.smem_optin_bytes
    warp_fused.smem_optin_bytes = lambda dev: (
        warp_fused.STATIC_SMEM_BYTES + 2 * warp_fused.TILE_X * 4 - 1)
    try:
        two, two_s, two_launches, two_peak = blocked(
            _nbytes(state.sdf, state.update_num))
    finally:
        warp_fused.smem_optin_bytes = optin
    _require(two_launches["interp_rows"] == 2 * n_views * chunks
             and two_launches["warp_fused"] == 0,
             f"blocked two-pass launches {two_launches}: need kernel C twice "
             f"per view and chunk ({2 * n_views * chunks}) and no fused "
             f"kernel")
    _require(torch.equal(state.update_num, two.update_num)
             and torch.equal(_bits(state.sdf), _bits(two.sdf)),
             "blocked UHD: fused warp kernel != two-pass engine")

    zs = slice(n // 2, n // 2 + min(128, n // 2))
    centers = [grid.axis_centers_t(a, device) for a in range(3)]
    ps, pu = warp_fused.warp_fuse_planes_plain(
        *_empty_planes((zs.stop - zs.start, n, n), device), centers[0],
        centers[1], centers[2][zs].contiguous(), *cam_args, opt, True)
    torch.cuda.synchronize()
    _require(torch.equal(state.update_num[zs], pu)
             and torch.equal(_bits(state.sdf[zs]), _bits(ps)),
             "blocked UHD chunk != plain fold")
    fused = float((pu > 0).float().mean())
    _require(fused > 0.05, "blocked UHD: nothing fused")
    c_err = float((two.sdf[zs] - ps).abs().nan_to_num(0).max())
    fusions = grid.num_voxels * n_views
    _phase("blocked", f"{n}^3 x {n_views} views of {w}x{h} through "
           f"carve_views_warp_blocked (first calls; unchunked two-pass "
           f"estimate {unchunked:.1f} GiB): fused warp kernel "
           f"{carve_s:.4f} s ({fusions / carve_s / 1e9:.3f} Gfusions/s), "
           f"launches {launches}, peak mem {peak:.2f} GiB; two-pass engine "
           f"{two_s:.4f} s ({fusions / two_s / 1e9:.3f} Gfusions/s), "
           f"launches {two_launches}, peak mem {two_peak:.2f} GiB beside the "
           f"first state; the two states equal (update_num exact, sdf "
           f"bitwise); planes [{zs.start}, {zs.stop}) == plain fold (fused "
           f"{fused:.3f} of them)")
    del state, two, ps, pu, imgs
    torch.cuda.empty_cache()
    return two_launches["interp_rows"], c_err


BENCH_KEYS = (
    "metric", "value", "unit", "probe_s", "device", "power_limit_w",
    "mc_cubes_per_sec_256^3", "mc_extract_warm_s_256^3", "mc_device_s_256^3",
    "native_fast_path", "mc_vertices_256^3", "mc_extract_warm_s_512^3",
    "mc_vertices_512^3", "mc_extract_warm_s_512^3_near_empty",
    "mc_vertices_512^3_near_empty",
)


def phase_bench(device):
    """The bench entry point in process: its one JSON line has every key
    and no null; the probe kernel ran once before the timed work."""
    from vacancy_tpu_torch import bench

    counters = _reset_counters()
    t0 = time.perf_counter()
    out = bench.main([])
    wall = time.perf_counter() - t0
    launches = _read_counters(counters)
    _require(tuple(out) == BENCH_KEYS, f"bench keys {tuple(out)}")
    _require(all(v is not None for v in out.values()),
             f"bench line holds a null: {out}")
    _require(out["native_fast_path"] is True, "bench: no native fast path")
    _require(launches["probe"] == 1 and launches["warp_fused"] == 5
             and launches["mc_fused"] > 0,
             f"bench launches {launches}: need the probe once and the fused "
             f"warp kernel five times (warm-up + 4)")
    _phase("bench", f"bench.main(): {out['value'] / 1e9:.3f} Gfusions/s at "
           f"512^3 x 24, wall {wall:.3f} s, launches {launches}")
    return launches


def phase_checkpoint(device):
    """A checkpoint round trip of the 256^3 sphere's state."""
    import torch

    from vacancy_tpu_torch.bench import _sphere_state
    from vacancy_tpu_torch.checkpoint import load_state, save_state

    grid, st = _sphere_state(256, device=device)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sphere_256")
        t0 = time.perf_counter()
        save_state(path, st, grid, next_view=7, extra={"case": "sphere"})
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path + ".npz")
        t0 = time.perf_counter()
        back, grid2, next_view, extra = load_state(path, device=device)
        load_s = time.perf_counter() - t0
    _require(grid2 == grid and next_view == 7 and extra == {"case": "sphere"}
             and torch.equal(_bits(back.sdf), _bits(st.sdf))
             and torch.equal(back.update_num, st.update_num)
             and back.sdf.device == st.sdf.device,
             "checkpoint round trip differs")
    _phase("checkpoint", f"256^3 state: save_state {save_s:.3f} s "
           f"({size / 2**20:.1f} MiB), load_state {load_s:.3f} s, equal")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _mc_pass_times(sdf, un, centers, window: dict, parent=None,
                   iters: int = 3) -> str:
    """The MC kernel's count, scan and emit passes timed apart and
    together on one state, each beside its bound: the bytes the pass must
    move (its inputs read once, its outputs written once) over the card's
    memory rate, or about 30 float32 operations per voxel (8 compares, the
    case, the flags) for the passes that walk the voxels. ``parent``:
    {pass: the parent commit's milliseconds on the same state}, printed
    beside each."""
    from vacancy_tpu_torch.ops import mc_fused

    a = (sdf, un, *centers)
    tpp = mc_fused.tiles_per_plane(*sdf.shape[1:])
    counts = mc_fused.mc_tile_counts(*a, **window)
    offsets, totals, plane_counts = mc_fused.mc_scan(counts, tpp)
    tot = totals.tolist()
    outs = mc_fused.mc_emit(*a, offsets, tot, **window)
    ops = 30 * sdf.numel()
    passes = (
        ("count", lambda: mc_fused.mc_tile_counts(*a, **window),
         _bound(_nbytes(sdf, un, counts), ops)),
        ("scan", lambda: mc_fused.mc_scan(counts, tpp),
         _bound(_nbytes(counts, offsets, totals, plane_counts),
                4 * counts.numel())),
        ("emit", lambda: mc_fused.mc_emit(*a, offsets, tot, **window),
         _bound(_nbytes(sdf, un, offsets, *outs), ops)),
        ("all three with the host read",
         lambda: mc_fused.marching_cubes_fused(*a, **window),
         _bound(_nbytes(sdf, un, *outs, plane_counts), ops)),
    )
    return ", ".join(
        f"{name} {_cuda_ms(fn, iters):.3f} ms ("
        + (f"parent {parent[name]} ms, " if parent else "")
        + f"bound {b[0]:.4f} ms by {b[1]})"
        for name, fn, b in passes) + f"; {sum(tot)} stream elements"


def _same_mesh(a, b) -> bool:
    import numpy as np

    return (a is not None and b is not None
            and a.vertices.shape == b.vertices.shape
            and np.array_equal(a.vertices.view(np.int32),
                               b.vertices.view(np.int32))
            and np.array_equal(a.faces, b.faces))


def _require_blocks_equal(sh, dense, what: str) -> None:
    """Every local block of a sharded state == the dense state's slice:
    update_num exact, sdf bitwise."""
    import torch

    for b, st in sh.blocks.items():
        sl = sh.sharding.slices(b, sh.shape)
        _require(torch.equal(st.update_num, dense.update_num[sl]),
                 f"{what}: block {b} update_num != the unsharded slice")
        _require(torch.equal(_bits(st.sdf), _bits(dense.sdf[sl])),
                 f"{what}: block {b} sdf bits != the unsharded slice")


def _extended_blocks(state, grid, mesh):
    """(sharded state, halos) of a dense state cut over ``mesh``."""
    from vacancy_tpu_torch.grid import ShardedGridState
    from vacancy_tpu_torch.parallel import grid_sharding, halo_exchange

    sh = ShardedGridState.from_dense(state, grid_sharding(mesh))
    return sh, halo_exchange(sh)


def _windowed_block(sh, halos, grid, block):
    """One halo-extended block as the sharded extraction hands it to the MC
    kernel: (sdf, update_num, cx, cy, cz) and the window keywords."""
    from vacancy_tpu_torch.parallel import sharded

    sdf, un = sharded._extended_block(sh, halos, block)
    centers = sharded._extended_centers(grid, sh, block, sdf.device)
    return (sdf, un, *centers), sharded.block_window(sh.sharding, sh.shape,
                                                     block)


def _require_window_equals_plain(args, window, linear, what: str):
    """Tile counts, streams and plane counts of the windowed kernel ==
    its plain version's, byte for byte; returns (kernel streams, largest
    |difference| of the positions)."""
    import torch

    from vacancy_tpu_torch.ops import mc_fused

    own = {k: window[k] for k in ("own_k", "own_j", "own_i")}
    counts = mc_fused.mc_tile_counts(*args, linear_interp=linear, **window)
    _require(torch.equal(counts, mc_fused.mc_tile_counts_plain(
        *args[:2], **own)), f"{what}: windowed tile counts != plain")
    k = mc_fused.marching_cubes_fused(*args, linear_interp=linear, **window)
    p = mc_fused.mc_streams_plain(*args, linear_interp=linear, **window)
    err = _require_same_streams(k, p, what)
    return k, err


SLAB_PLANES = 64


def _require_slab_equals_plain(args, window, what: str):
    """The windowed kernel == plain on the first ``SLAB_PLANES`` planes of a
    halo-extended block of the sweep, halo plane 0 included, with the
    block's row and lane windows and bases kept (the plain version's
    temporaries do not fit more planes at 1024^2); returns (largest
    |difference| of the positions, cubes emitted)."""
    n = min(SLAB_PLANES, args[0].shape[0])
    _require(window["own_k"] is not None and window["own_k"][0] == 1,
             f"{what}: plane 0 of the block is no halo")
    slab = tuple(t[:n].contiguous() for t in args[:2]) + (
        args[2], args[3], args[4][:n].contiguous())
    k, err = _require_window_equals_plain(
        slab, dict(window, own_k=(1, n)), True, what)
    cubes = int(k.c_lin.numel())
    _require(cubes > 0, f"{what}: the slab holds no surface")
    return err, cubes


def _require_owned_only(k, window, sh, block, what: str) -> None:
    """Halo planes count nothing, and every emitted id lies inside the
    block's own range of the global grid."""
    import torch

    nz = k.plane_counts.shape[0]
    lo, hi = window["own_k"] or (0, nz)
    _require(int(k.plane_counts[:lo].sum()) == 0
             and int(k.plane_counts[hi:].sum()) == 0,
             f"{what}: a halo plane emitted")
    _, ny, nx = sh.shape
    sz, sy, sx = sh.sharding.slices(block, sh.shape)
    for lin in (k.vx_lin, k.vy_lin, k.vz_lin, k.c_lin):
        lin = lin.long()
        kk, jj, ii = lin // (ny * nx), (lin // nx) % ny, lin % nx
        inside = ((kk >= sz.start) & (kk < sz.stop) & (jj >= sy.start)
                  & (jj < sy.stop) & (ii >= sx.start) & (ii < sx.stop))
        _require(bool(inside.all()), f"{what}: a halo voxel emitted")


def phase_mc_windows(device, n_random=256, n_turntable=512, n_views=36):
    """Kernel B with emission windows and global-id bases against its plain
    version on halo-extended blocks, and the blocks' ids against the dense
    run's."""
    import torch

    from vacancy_tpu_torch import pipeline
    from vacancy_tpu_torch.config import SdfInterpolation
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.ops import mc_fused, warp_fused
    from vacancy_tpu_torch.parallel import make_device_mesh

    max_err = 0.0
    grid, st = _random_state((n_random,) * 3, device, seed=23)
    mesh = make_device_mesh(shape=(2, 2, 2), devices=[device] * 8)
    sh, halos = _extended_blocks(st, grid, mesh)
    centers = [grid.axis_centers_t(a, device) for a in range(3)]
    for linear in (True, False):
        dense = mc_fused.marching_cubes_fused(st.sdf, st.update_num, *centers,
                                              linear_interp=linear)
        parts = []
        for b in sh.sharding.blocks():
            args, window = _windowed_block(sh, halos, grid, b)
            what = f"mc windows {n_random}^3 (2,2,2) block {b} linear={linear}"
            k, err = _require_window_equals_plain(args, window, linear, what)
            _require_owned_only(k, window, sh, b, what)
            max_err = max(max_err, err)
            parts.append(k)
        # the blocks' streams, stably sorted by global id, are the dense
        # run's: ids, cases and positions
        for s in range(4):
            lin = torch.cat([p.as_tuple()[2 * s + 1] for p in parts])
            val = torch.cat([p.as_tuple()[2 * s] for p in parts])
            if s == 3:  # the cube stream is (lin, case)
                lin, val = val, lin
            order = torch.argsort(lin, stable=True)
            d_val, d_lin = dense.as_tuple()[2 * s], dense.as_tuple()[2 * s + 1]
            if s == 3:
                d_val, d_lin = d_lin, d_val
            _require(torch.equal(lin[order], d_lin)
                     and torch.equal(_bits(val[order]), _bits(d_val)),
                     f"mc windows {n_random}^3 linear={linear}: stream {s} of "
                     f"the blocks != the dense run's")
        _phase("mc-windows", f"{n_random}^3 random state with invalid "
               f"voxels, linear={linear}: the 8 halo-extended blocks "
               f"{list(args[0].shape)} "
               f"of a (2, 2, 2) split: windowed kernel == plain (tile counts, "
               f"4 streams, plane counts byte-identical), halos emit "
               f"nothing, and the blocks' ids sorted == the dense run's "
               f"({int(dense.c_lin.numel())} cubes)")
    del st, sh, halos, dense, parts
    torch.cuda.empty_cache()

    # one block each of a (4,) and a (2, 2) split of the turntable state
    grid, opt, cams, imgs = pipeline.turntable_inputs(
        n_turntable, n_views, True, device)
    centers = [grid.axis_centers_t(a, device) for a in range(3)]
    st0 = VoxelGridState.create(grid, device)
    st = VoxelGridState(*warp_fused.warp_fuse_planes(
        st0.sdf, st0.update_num, *centers, cams.w2c, cams.principal_point,
        cams.focal_length, imgs, opt,
        opt.sdf_interp == SdfInterpolation.BILINEAR))
    del st0
    dense = mc_fused.marching_cubes_fused(st.sdf, st.update_num, *centers)
    for shape, block in (((4,), (1, 0, 0)), ((2, 2), (1, 1, 0))):
        n_blocks = 4
        mesh = make_device_mesh(shape=shape, devices=[device] * n_blocks)
        sh, halos = _extended_blocks(st, grid, mesh)
        args, window = _windowed_block(sh, halos, grid, block)
        what = f"mc windows {n_turntable}^3 turntable {shape} block {block}"
        k, err = _require_window_equals_plain(args, window, True, what)
        _require_owned_only(k, window, sh, block, what)
        max_err = max(max_err, err)
        # the dense run's cubes inside the block's range are the block's
        _, ny, nx = sh.shape
        sz, sy, sx = sh.sharding.slices(block, sh.shape)
        lin = dense.c_lin.long()
        kk, jj = lin // (ny * nx), (lin // nx) % ny
        inside = ((kk >= sz.start) & (kk < sz.stop) & (jj >= sy.start)
                  & (jj < sy.stop))
        _require(torch.equal(dense.c_lin[inside], k.c_lin)
                 and torch.equal(dense.c_case[inside], k.c_case)
                 and int(k.c_lin.numel()) > n_turntable ** 2 // 32,
                 f"{what}: cubes != the dense run's inside the block")
        _phase("mc-windows", f"{n_turntable}^3 turntable state, {shape} split, block "
               f"{block} extended to {list(args[0].shape)}: windowed kernel "
               f"== plain byte for byte; its {int(k.c_lin.numel())} cubes "
               f"are the dense run's inside the block")
        del sh, halos, args, k
    del st, dense
    torch.cuda.empty_cache()
    return max_err


def _sharded_sweep_run(device, n, n_views, mesh_shape, ref_mesh, ref_sha):
    """`pipeline sweep --mesh-shape ...` in process with the counters reset
    just before; its PLY against the unsharded sweep's."""
    import torch

    from vacancy_tpu_torch import pipeline
    from vacancy_tpu_torch.mesh import Mesh

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    arg = ",".join(str(m) for m in mesh_shape)
    with tempfile.TemporaryDirectory() as out_dir:
        counters = _reset_counters()
        t0 = time.perf_counter()
        res = pipeline.main(["sweep", "--n", str(n), "--views", str(n_views),
                             "--mesh-shape", arg, "--out", out_dir])
        wall = time.perf_counter() - t0
        launches = _read_counters(counters)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        path = os.path.join(out_dir, f"sweep_{n}.ply")
        _require(_sha256(path) == ref_sha,
                 f"sharded sweep {mesh_shape}: PLY bytes != the unsharded "
                 f"sweep's")
        _require(_same_mesh(Mesh.load_ply(path), ref_mesh),
                 f"sharded sweep {mesh_shape}: mesh != the unsharded sweep's")
    _require(res["sharded"] is True and res["mesh_shape"] == list(mesh_shape)
             and res["transport"] == "device copy",
             f"sharded sweep {mesh_shape}: report {res}")
    return res, launches, wall, peak


def phase_sharded_sweep(device, ref_mesh, ref_sha, ref_peak, n=1024,
                        n_views=100):
    """The sharded sweep at full size on one card: four z blocks, then
    2 x 2 (z, y) blocks, each held block by block against the unsharded
    state and byte for byte against the unsharded mesh."""
    import torch

    from vacancy_tpu_torch import pipeline
    from vacancy_tpu_torch.config import SdfInterpolation
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.ops import fusion_warp, warp_fused
    from vacancy_tpu_torch.parallel import (
        carve_views_warp_sharded,
        extract_mesh_sharded,
        grid_sharding,
        halo_exchange,
        make_device_mesh,
    )

    grid, opt, cams, imgs = pipeline.turntable_inputs(n, n_views, True, device)
    linear = opt.sdf_interp == SdfInterpolation.BILINEAR
    cam_args = (cams.w2c, cams.principal_point, cams.focal_length, imgs)
    chunk = fusion_warp._snap_chunk_nz(n, 128) if n > 128 else n
    launches, a_err, b_err = {}, 0.0, 0.0
    for mesh_shape in ((4,), (2, 2)):
        parts = mesh_shape + (1,) * (3 - len(mesh_shape))
        lz = n // parts[0]
        blocks = parts[0] * parts[1] * parts[2]
        chunks = lz // min(chunk, lz) if lz > 128 else 1
        res, got, wall, peak = _sharded_sweep_run(
            device, n, n_views, mesh_shape, ref_mesh, ref_sha)
        _require(got["warp_fused"] == 2 * blocks * chunks
                 and got["mc_fused"] == 2 * blocks
                 and got["mc_scan"] == 2 * blocks
                 and got["interp_rows"] == 0,
                 f"sharded sweep {mesh_shape} launches {got}: need the fused "
                 f"warp kernel once per block, chunk and carve "
                 f"({2 * blocks * chunks}), MC once per block and extract "
                 f"({2 * blocks})")
        launches[mesh_shape] = got
        halo = dict(halo_exchange.last)
        _phase("sharded", f"run_sweep {n}^3 x {n_views} --mesh-shape "
               f"{mesh_shape} (blocks {[n // p for p in parts]}, all on one "
               f"card): carve cold {res['carve_cold_s']:.4f} s, warm "
               f"{res['carve_s']:.4f} s ({res['fusions_per_s'] / 1e9:.3f} "
               f"Gfusions/s), extract cold {res['extract_cold_s']:.4f} s, "
               f"warm {res['extract_s']:.4f} s, wall {wall:.3f} s, launches "
               f"{got}, peak mem {peak:.2f} GiB (the unsharded sweep "
               f"{ref_peak:.2f} GiB); halo exchange "
               f"{halo['bytes']} bytes in {halo['ms']:.3f} ms by "
               f"{halo['transport']}; PLY bytes and mesh == the unsharded "
               f"sweep's")

        # block by block against the unsharded state, then the meshes
        mesh = make_device_mesh(shape=mesh_shape, devices=[device] * blocks)
        sh = carve_views_warp_sharded(
            VoxelGridState.create(grid, sharding=grid_sharding(mesh)), grid,
            *cam_args, opt=opt, linear=linear, mesh=mesh)
        dense = fusion_warp.carve_views_warp_blocked(
            VoxelGridState.create(grid, device), grid, *cam_args, opt=opt,
            linear=linear)
        torch.cuda.synchronize()
        _require_blocks_equal(sh, dense, f"sharded sweep {mesh_shape}")
        del dense
        torch.cuda.empty_cache()
        _require(_same_mesh(extract_mesh_sharded(sh, grid, mesh,
                                                 engine="fused"), ref_mesh),
                 f"sharded sweep {mesh_shape}: fused mesh != unsharded")
        line = (f"{mesh_shape}: every block == the unsharded state's slice "
                f"(update_num exact, sdf bitwise); extract_mesh_sharded "
                f"(fused) == the unsharded mesh")
        if mesh_shape == (4,):
            # the MC passes on the (4,) block with both halos
            halos = halo_exchange(sh)
            args, window = _windowed_block(sh, halos, grid, (1, 0, 0))
            _phase("sharded", f"MC passes on the (4,) block "
                   f"{list(args[0].shape)} with windows: "
                   + _mc_pass_times(
                       args[0], args[1], args[2:], window,
                       PARENT_MS["mc [258, 1024, 1024] windowed"]
                       if (n, n_views) == (1024, 100) else None))
            err, cubes = _require_slab_equals_plain(
                args, window, "sharded sweep (4,) block (1, 0, 0) slab")
            b_err = max(b_err, err)
            line += (f"; windowed MC kernel == plain on the first "
                     f"{SLAB_PLANES} planes of block (1, 0, 0) ({cubes} "
                     f"cubes)")
            del halos, args
        else:
            # the k- and j-windowed MC kernel on block (1, 1, 0), whose
            # plane 0 and row 0 are halos (yb = 511 in a 1024-row grid)
            b = (1, 1, 0)
            halos = halo_exchange(sh)
            args, window = _windowed_block(sh, halos, grid, b)
            err, cubes = _require_slab_equals_plain(
                args, window, f"sharded sweep (2, 2) block {b} slab")
            b_err = max(b_err, err)
            line += (f"; windowed MC kernel == plain on the first "
                     f"{SLAB_PLANES} planes of block {b} extended to "
                     f"{list(args[0].shape)} ({cubes} cubes)")
            del halos, args
            # kernel A == plain on one chunk of a [512, 512, 1024] block
            st = sh.blocks[b]
            sz, sy, sx = sh.sharding.slices(b, sh.shape)
            zs = slice(min(chunk, lz) * (chunks - 1), lz)  # the last chunk
            cz, cy, cx = (grid.axis_centers_t(a, device)[s].contiguous()
                          for a, s in ((2, sz), (1, sy), (0, sx)))
            a = (*_empty_planes((zs.stop - zs.start, sy.stop - sy.start,
                                 sx.stop - sx.start), device), cx, cy,
                 cz[zs].contiguous(),
                 *cam_args, opt, linear)
            ps, pu = warp_fused.warp_fuse_planes_plain(*a)
            torch.cuda.synchronize()
            _require(torch.equal(st.update_num[zs], pu)
                     and torch.equal(_bits(st.sdf[zs]), _bits(ps)),
                     "sharded sweep (2, 2): fused warp kernel != plain on a "
                     "chunk of block (1, 1, 0)")
            a_err = max(a_err,
                        float((st.sdf[zs] - ps).abs().nan_to_num(0).max()))
            ms = _cuda_ms(lambda: warp_fused.warp_fuse_planes(*a), 3)
            bound = _warp_bound(a[0], imgs, n_views, linear)
            line += (f"; fused warp kernel == plain on planes [{zs.start}, "
                     f"{zs.stop}) of block {b} ({list(a[0].shape)} x "
                     f"{n_views} views: "
                     f"kernel {ms:.3f} ms, bound {bound[0]:.3f} ms by "
                     f"{bound[1]})")
            del a, ps, pu
        _phase("sharded", line)
        del sh
        torch.cuda.empty_cache()
    return launches, a_err, b_err


def phase_mesh_222(device, ref_mesh, n=512, n_views=36, n_sphere=256):
    """A (2, 2, 2) mesh at 512^3 x 36 through the turntable entry point,
    kernel A on a [256, 256, 256] block against plain, and a sharded
    checkpoint round trip."""
    import torch

    from vacancy_tpu_torch import pipeline
    from vacancy_tpu_torch.bench import _sphere_state
    from vacancy_tpu_torch.checkpoint import load_state, save_state
    from vacancy_tpu_torch.config import SdfInterpolation
    from vacancy_tpu_torch.grid import ShardedGridState, VoxelGridState
    from vacancy_tpu_torch.mesh import Mesh
    from vacancy_tpu_torch.ops import warp_fused
    from vacancy_tpu_torch.parallel import (
        carve_views_warp_sharded,
        grid_sharding,
        halo_exchange,
        make_device_mesh,
    )

    with tempfile.TemporaryDirectory() as out_dir:
        counters = _reset_counters()
        res = pipeline.main(
            ["turntable", "--n", str(n), "--views", str(n_views),
             "--mesh-shape", "2,2,2", "--out", out_dir])
        launches = _read_counters(counters)
        got = Mesh.load_ply(res["ply"])
    # 8 blocks of n / 2 planes, in 128-plane chunks, two carves
    want_a = 2 * 8 * max(1, n // 2 // 128)
    want_b = 8
    _require(launches["warp_fused"] == want_a
             and launches["mc_fused"] == want_b
             and launches["interp_rows"] == 0,
             f"(2, 2, 2) turntable launches {launches}: need {want_a} of the "
             f"fused warp kernel and {want_b} of MC")
    _require(_same_mesh(got, ref_mesh),
             "(2, 2, 2) turntable: mesh != the unsharded turntable's")
    _phase("mesh-222", f"turntable {n}^3 x {n_views} --mesh-shape 2,2,2 (8 "
           f"blocks of {n // 2}^3 on one card): carve {res['carve_s']:.4f} s "
           f"({res['fusions_per_s'] / 1e9:.3f} Gfusions/s), extract "
           f"{res['extract_s']:.4f} s, launches {launches}; mesh == the "
           f"unsharded turntable's byte for byte ({got.num_vertices} "
           f"vertices)")

    # kernel A == plain on block (1, 0, 1), all 256 planes
    grid, opt, cams, imgs = pipeline.turntable_inputs(n, n_views, True,
                                                      device)
    linear = opt.sdf_interp == SdfInterpolation.BILINEAR
    h = n // 2
    cz, cy, cx = (grid.axis_centers_t(a, device)[s].contiguous()
                  for a, s in ((2, slice(h, n)), (1, slice(0, h)),
                               (0, slice(h, n))))
    a = (*_empty_planes((h,) * 3, device), cx, cy, cz, cams.w2c,
         cams.principal_point, cams.focal_length, imgs, opt, linear)
    ks, ku = warp_fused.warp_fuse_planes(*a)
    ps, pu = warp_fused.warp_fuse_planes_plain(*a)
    torch.cuda.synchronize()
    _require(torch.equal(ku, pu) and torch.equal(_bits(ks), _bits(ps))
             and float((ku > 0).float().mean()) > 0.05,
             "(2, 2, 2): fused warp kernel != plain on one block")
    a_err = float((ks - ps).abs().nan_to_num(0).max())
    ms = _cuda_ms(lambda: warp_fused.warp_fuse_planes(*a), 5)
    bound = _warp_bound(a[0], imgs, n_views, linear)
    _phase("mesh-222", f"fused warp kernel == plain on block (1, 0, 1) "
           f"{list(a[0].shape)} x {n_views} views (update_num exact, sdf "
           f"bitwise): "
           f"kernel {ms:.3f} ms, bound {bound[0]:.3f} ms by {bound[1]}")
    del a, ks, ku, ps, pu

    # the windowed MC kernel == plain on one whole halo-extended block of
    # the turntable state (k-, j- and i-windows, all three bases)
    mesh = make_device_mesh(shape=(2, 2, 2), devices=[device] * 8)
    sh = carve_views_warp_sharded(
        VoxelGridState.create(grid, sharding=grid_sharding(mesh)), grid,
        cams.w2c, cams.principal_point, cams.focal_length, imgs, opt=opt,
        linear=linear, mesh=mesh)
    halos = halo_exchange(sh)
    b = (1, 0, 1)
    args, window = _windowed_block(sh, halos, grid, b)
    what = f"(2, 2, 2) turntable block {b}"
    _require(all(window[w] == (1, h + 1)
                 for w in ("own_k", "own_j", "own_i")),
             f"{what}: windows {window}")
    k, b_err = _require_window_equals_plain(args, window, True, what)
    _require_owned_only(k, window, sh, b, what)
    cubes = int(k.c_lin.numel())
    _require(cubes > h * h // 32, f"{what}: only {cubes} cubes")
    _phase("mesh-222", f"windowed MC kernel == plain byte for byte on block "
           f"{b} of the turntable state extended to {list(args[0].shape)} "
           f"(windows {window['own_k']} on all three axes, {cubes} cubes, "
           f"halos emit nothing)")
    del sh, halos, args, k

    grid, st = _sphere_state(n_sphere, device=device)
    sharding = grid_sharding(mesh)
    sh = ShardedGridState.from_dense(st, sharding)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sphere_256")
        t0 = time.perf_counter()
        save_state(path, sh, grid, next_view=5, force_sharded=True)
        save_s = time.perf_counter() - t0
        _require(os.listdir(d) == ["sphere_256.proc0.npz"],
                 f"sharded checkpoint files {os.listdir(d)}")
        t0 = time.perf_counter()
        back, grid2, next_view, _ = load_state(path, sharding=sharding)
        load_s = time.perf_counter() - t0
    _require(grid2 == grid and next_view == 5
             and sorted(back.blocks) == sorted(sh.blocks), "sharded "
             "checkpoint: grid, next view or blocks differ")
    _require_blocks_equal(back, VoxelGridState(st.sdf, st.update_num),
                          "sharded checkpoint")
    _phase("mesh-222", f"sharded checkpoint of the {n_sphere}^3 sphere over "
           f"(2, 2, 2): save {save_s:.3f} s, load {load_s:.3f} s, every "
           f"block equal")
    return launches, a_err, b_err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(rank: int, port: int, tmp: str) -> int:
    """One of the two ranks of phase 19, both on cuda:0, at 512^3 x 36;
    writes ``tmp/rank{rank}.json`` and, on rank 0, the two meshes."""
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import torch.distributed as dist

    from vacancy_tpu_torch import pipeline
    from vacancy_tpu_torch.checkpoint import load_state, save_state
    from vacancy_tpu_torch.config import SdfInterpolation
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.ops import fusion_warp
    from vacancy_tpu_torch.parallel import (
        carve_views_warp_sharded,
        extract_mesh_sharded,
        grid_sharding,
        halo_exchange,
        initialize_distributed,
        make_device_mesh,
    )

    n, n_views = 512, 36
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    initialize_distributed(f"localhost:{port}", 2, rank)
    grid, opt, cams, imgs = pipeline.turntable_inputs(n, n_views, True,
                                                      device)
    linear = opt.sdf_interp == SdfInterpolation.BILINEAR
    cam_args = (cams.w2c, cams.principal_point, cams.focal_length, imgs)
    out = {"rank": rank}

    mesh = make_device_mesh(shape=(2, 2), devices=[device] * 2)
    _require(mesh.world_size == 2 and mesh.rank == rank and mesh.size == 4,
             f"mesh {mesh}")
    sharding = grid_sharding(mesh)
    dense = fusion_warp.carve_views_warp(
        VoxelGridState.create(grid, device), grid, *cam_args, opt=opt,
        linear=linear)
    counters = _reset_counters()
    sh = carve_views_warp_sharded(
        VoxelGridState.create(grid, sharding=sharding), grid, *cam_args,
        opt=opt, linear=linear, mesh=mesh)
    torch.cuda.synchronize()
    _require(sorted(sh.blocks) == [(rank, 0, 0), (rank, 1, 0)],
             f"rank {rank} holds blocks {sorted(sh.blocks)}")
    _require_blocks_equal(sh, dense, f"rank {rank} (2, 2)")
    del dense

    path = os.path.join(tmp, "ckpt")
    t0 = time.perf_counter()
    save_state(path, sh, grid, next_view=n_views)
    back, grid2, next_view, _ = load_state(path, sharding=sharding)
    out["checkpoint_s"] = time.perf_counter() - t0
    _require(grid2 == grid and next_view == n_views
             and os.path.exists(f"{path}.proc{rank}.npz"),
             "per-process checkpoint: grid, next view or file")
    for b, st in sh.blocks.items():
        _require(torch.equal(back.blocks[b].update_num, st.update_num)
                 and torch.equal(_bits(back.blocks[b].sdf), _bits(st.sdf)),
                 f"rank {rank}: checkpoint block {b} differs")
    del back

    t0 = time.perf_counter()
    fused = extract_mesh_sharded(sh, grid, mesh, engine="fused",
                                 piece_dir=os.path.join(tmp, "pieces"))
    out["extract_fused_s"] = time.perf_counter() - t0
    out["halo"] = dict(halo_exchange.last)
    out["launches"] = _read_counters(counters)
    del sh

    if rank == 0:
        _require(fused is not None, "rank 0 got no mesh")
        np.savez(os.path.join(tmp, "fused.npz"), vertices=fused.vertices,
                 faces=fused.faces)
    else:
        _require(fused is None, f"rank {rank} got a mesh")
    out["seconds"] = time.perf_counter() - t_start
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_two_ranks(ref_mesh, timeout_s: float = 300.0):
    """Two ranks of this script on the one card, a (2, 2) mesh spanning
    them; rank 0's meshes against the unsharded turntable's."""
    import numpy as np
    import torch

    from vacancy_tpu_torch.mesh import Mesh

    torch.cuda.empty_cache()
    port = _free_port()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # each worker's output goes to a file: a full pipe would stall a
        # rank inside a collective while its peer is waited for
        logs = [os.path.join(tmp, f"worker{r}.log") for r in (0, 1)]
        files = [open(path, "w") for path in logs]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r),
             str(port), tmp], stdout=f, stderr=subprocess.STDOUT)
            for r, f in zip((0, 1), files)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"a worker was not done after {timeout_s} s")
        finally:
            for p, f in zip(procs, files):
                if p.poll() is None:
                    p.kill()
                    p.wait()
                f.close()
        for r, (p, path) in enumerate(zip(procs, logs)):
            with open(path) as f:
                out = f.read()
            _require(p.returncode == 0,
                     f"worker {r} failed ({p.returncode}):\n{out[-4000:]}")
        ranks = []
        for r in (0, 1):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        with np.load(os.path.join(tmp, "fused.npz")) as z:
            got = Mesh(vertices=z["vertices"], faces=z["faces"])
        _require(_same_mesh(got, ref_mesh),
                 "two ranks: rank 0's mesh != the unsharded turntable's")
    wall = time.perf_counter() - t0
    r0, r1 = ranks
    launches = {k: r0["launches"][k] + r1["launches"][k]
                for k in r0["launches"]}
    _require(r0["halo"]["transport"] == r1["halo"]["transport"]
             and r0["halo"]["transport"].startswith("gloo, host-staged"),
             f"two ranks on one card: transport {r0['halo']}")
    # per rank: 2 blocks of 256 planes, two chunks each; MC once per block
    _require(launches["warp_fused"] == 8 and launches["mc_fused"] == 4,
             f"two ranks: launches {launches}")
    _phase("two-ranks", f"2 processes on cuda:0, (2, 2) mesh at 512^3 x 36 "
           f"(each rank 2 blocks [256, 256, 512]): blocks == the dense "
           f"carve, per-process checkpoints round-trip "
           f"({r0['checkpoint_s']:.2f} / {r1['checkpoint_s']:.2f} s), rank "
           f"0's mesh == the unsharded turntable's byte for byte, rank 1 "
           f"got None; transport: {r0['halo']['transport']}; halo exchange "
           f"{r0['halo']['bytes']} bytes sent by rank 0 in "
           f"{r0['halo']['ms']:.3f} ms; extract "
           f"{r0['extract_fused_s']:.3f} s; launches {launches}; workers "
           f"{r0['seconds']:.1f} / {r1['seconds']:.1f} s, phase wall "
           f"{wall:.1f} s")
    return launches


def interp_only(argv) -> int:
    """``--interp-only [--compare-source FILE]``: phases 1, 2 and 6 alone,
    then one JSON line of phase 6's times; with ``--compare-source``,
    FILE (another kernel C source, e.g. an earlier commit's
    csrc/interp_rows.cu) is built too and timed in turns with this kernel
    C on the same inputs."""
    import argparse

    p = argparse.ArgumentParser(prog="chip_smoke.py")
    p.add_argument("--interp-only", action="store_true", required=True)
    p.add_argument("--compare-source", default=None, metavar="FILE")
    args = p.parse_args(argv)
    device, smi = phase_device()
    phase_build()
    compare = (None if args.compare_source is None
               else _load_other_interp(args.compare_source))
    _, timings = phase_interp(device, compare=compare)

    def row(v):
        if isinstance(v, dict):
            return v
        ms, plain_ms, bound, lib_ms, other_ms, whole = v
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "whole_table_bound_ms": whole[0],
                "library_ms": lib_ms, "other_ms": other_ms}

    print(smi)
    print(json.dumps({"interp": {k: row(v) for k, v in timings.items()}}))
    return 0


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        # --worker RANK PORT DIR: one rank of phase 19
        return worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if not os.path.isdir(os.path.join(HERE, "vacancy_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout that holds "
                         "vacancy_tpu_torch/")
    sys.path.insert(0, HERE)
    import torch

    if len(sys.argv) > 1:
        return interp_only(sys.argv[1:])
    device, smi = phase_device()
    phase_build()
    a_err, a_ms, a_plain, a_bound = phase_warp(device)
    b_err, b_ms, b_plain, b_bound = phase_mc(device)
    _, a_main_err, b_main_err, turntable_mesh = phase_main_path(device)
    c_err, c_times = phase_interp(device)
    phase_two_pass(device)
    c_main_err = phase_facade(device)
    a_ortho_err, _, _ = phase_ortho_exact(device)
    d_err, d_ms, d_plain, d_lib, d_bound = phase_probe(device)
    scan_small_err = phase_mc_passes(device)
    sweep_launches, a_sweep_err, b_sweep_err, scan, sweep_ref = phase_sweep(
        device)
    c_blocked_launches, c_blocked_err = phase_blocked_uhd(device)
    bench_launches = phase_bench(device)
    phase_checkpoint(device)
    b_window_err = phase_mc_windows(device)
    sharded_launches, a_sharded_err, b_sharded_err = phase_sharded_sweep(
        device, *sweep_ref)
    del sweep_ref
    _, a_222_err, b_222_err = phase_mesh_222(device, turntable_mesh)
    phase_two_ranks(turntable_mesh)
    e_launches, e_err, e_ms, e_plain, e_bound = phase_exact(device)
    s_launches, s_times = phase_sdf2d(device)

    def on_sweeps(name):
        """Launches on the unsharded sweep and both sharded sweeps."""
        return sweep_launches[name] + sum(
            got[name] for got in sharded_launches.values())

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound,
              library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"vacancy_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms}

    c_ms, c_plain, c_bound, c_lib, _, _ = c_times["pass1"]
    kernels = [
        entry("warp_fused", "warp_fused.cu",
              "vacancy_tpu/ops/warp_fused.py:252",
              on_sweeps("warp_fused"),
              max(a_err, a_main_err, a_ortho_err, a_sweep_err,
                  a_sharded_err, a_222_err), a_ms, a_plain, a_bound),
        entry("mc_fused", "mc_fused.cu", "vacancy_tpu/ops/mc_fused.py:285",
              on_sweeps("mc_fused"),
              max(b_err, b_main_err, b_sweep_err, b_window_err,
                  b_sharded_err, b_222_err), b_ms, b_plain, b_bound),
        entry("interp_rows", "interp_rows.cu",
              "vacancy_tpu/ops/warp_gather.py:29",
              c_blocked_launches,
              max(c_err, c_main_err, c_blocked_err), c_ms, c_plain, c_bound,
              c_lib),
        entry("probe", "probe.cu", "bench.py:53", bench_launches["probe"],
              d_err, d_ms, d_plain, d_bound, d_lib),
        entry("mc_scan", "mc_fused.cu", "tests/test_mc_fused.py:199",
              on_sweeps("mc_scan"),
              float(max(scan_small_err, scan["err"])), scan["ms"],
              scan["plain_ms"],
              scan["bound"], scan["library_ms"]),
        entry("exact_fused", "exact_fused.cu",
              "none: vacancy_tpu/ops/fusion.py folds in plain jnp",
              e_launches, e_err, e_ms, e_plain, e_bound),
        entry("sdf2d_fused", "sdf2d_fused.cu",
              "none: vacancy_tpu/ops/sdf2d.py computes the 2D SDF with XLA "
              "scans", s_launches, 0.0, *s_times["uhd"]),
    ]
    _require(all(k["launches"] > 0 for k in kernels),
             f"a kernel was not launched on its path: {kernels}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
