"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

There every kernel must agree with its plain version bit for bit (the
kernels are built with -fmad=false and IEEE division), and the two-pass
warp engine through kernel C with the fused warp kernel. On a machine
without a card the ``cuda`` tests skip; the rest check that the wrappers
never run anything but the plain version on a CPU tensor and refuse any
other device, and that a missing nvcc is an error, not a fallback.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vacancy_tpu_torch import _kernels, bench
from vacancy_tpu_torch import config as cfg
from vacancy_tpu_torch.camera import stack_cameras
from vacancy_tpu_torch.grid import GridSpec, VoxelGridState
from vacancy_tpu_torch.ops import (exact_fused, fusion, fusion_warp,
                                   mc_fused, warp_fused, warp_gather)
from vacancy_tpu_torch.ops.exact_fused import exact_fold, exact_fold_plain
from vacancy_tpu_torch.synthetic import turntable_cameras
from vacancy_tpu_torch.ops.warp_fused import warp_fuse_planes_plain
from vacancy_tpu_torch.ops.warp_gather import interp_rows, interp_rows_plain
from vacancy_tpu_torch.ops.sdf2d import make_signed_distance_field
from vacancy_tpu_torch.pipeline import turntable_masks


def _warp_case(shape, n_views, device):
    """Grid centers, the turntable's cameras and truncated SDF images, and
    a partly fused initial state, all on ``device``."""
    nz, ny, nx = shape
    res = 2.2 / max(shape)
    grid = GridSpec((-1.1,) * 3, tuple(-1.1 + (n + 0.4) * res
                                       for n in (nx, ny, nz)), res)
    assert grid.shape_zyx == shape
    cams, masks = turntable_masks(n_views, device)
    imgs = make_signed_distance_field(masks, use_truncation=True,
                                      truncation_band=0.05)
    rng = np.random.default_rng(2)
    un = rng.integers(0, 4, size=shape).astype(np.int32)
    sdf = rng.normal(size=shape).astype(np.float32)
    sdf[un == 0] = cfg.INVALID_SDF
    return [torch.from_numpy(a).to(device) for a in (
        sdf, un, grid.axis_centers(0), grid.axis_centers(1),
        grid.axis_centers(2))] + [cams.w2c, cams.principal_point,
                                  cams.focal_length, imgs]


def _rows_case(share, device, n=3, r=8, w=40, t=16, seed=0):
    """Random tables and positions over [-1, w], ends included."""
    rng = np.random.default_rng(seed)
    tables = rng.normal(size=(1 if share else n, r, w)).astype(np.float32)
    pos = rng.uniform(-1.0, w, size=(n, r, t)).astype(np.float32)
    pos[..., 0], pos[..., -1] = -1.0, float(w)
    return (torch.from_numpy(tables).to(device),
            torch.from_numpy(pos).to(device))


def _mc_case(shape, device, seed=5):
    nz, ny, nx = shape
    rng = np.random.default_rng(seed)
    sdf = rng.normal(size=shape).astype(np.float32)
    sdf[rng.random(shape) < 0.05] = cfg.INVALID_SDF
    un = (rng.random(shape) < 0.9).astype(np.int32)
    grid = GridSpec((0.0,) * 3, (nx + 0.4, ny + 0.4, nz + 0.4), 1.0)
    return [torch.from_numpy(a).to(device) for a in (
        sdf, un, grid.axis_centers(0), grid.axis_centers(1),
        grid.axis_centers(2))]


def _ortho_case(device, n_views=4, shape=(20, 26, 37), size=48):
    """Unit voxels seen by orthographic cameras turned about world y, some
    of the grid behind the first camera; random-normal images. Returns
    kernel A's arguments (state, centers, the synthetic homography) and
    the real camera-z rows."""
    nz, ny, nx = shape
    rng = np.random.default_rng(6)
    grid = GridSpec((0.0,) * 3, (nx + 0.4, ny + 0.4, nz + 0.4), 1.0)
    assert grid.shape_zyx == shape
    center = np.array([nx, ny, nz]) / 2
    w2c = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    for i in range(n_views):
        ang = -0.4 + 0.8 * i / max(n_views - 1, 1)
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        w2c[i, :3, :3] = rot
        # view 0 stands inside the grid, so part of it lies behind
        depth = 0.0 if i == 0 else 2.0 * nz
        w2c[i, :3, 3] = [size / 2, size / 2, depth] - rot @ center
    un = rng.integers(0, 4, size=shape).astype(np.int32)
    sdf = rng.normal(size=shape).astype(np.float32)
    sdf[un == 0] = cfg.INVALID_SDF
    imgs = rng.normal(size=(n_views, size, size)).astype(np.float32)
    w2c_t = torch.from_numpy(w2c).to(device)
    synth, zero2, one2, z_rows = fusion_warp.ortho_homography(w2c_t)
    args = [torch.from_numpy(a).to(device) for a in (
        sdf, un, grid.axis_centers(0), grid.axis_centers(1),
        grid.axis_centers(2))] + [synth, zero2, one2,
                                  torch.from_numpy(imgs).to(device)]
    return args, z_rows


def _density_state(shape, density, device, seed=9):
    """A state whose MC flags have about ``density`` per edge stream: 0 (a
    constant field), 1 (a checkerboard of signs) or signs drawn so that an
    edge straddles with that probability."""
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
    un = np.ones(shape, np.int32)
    grid = GridSpec((0.0,) * 3, (nx + 0.4, ny + 0.4, nz + 0.4), 1.0)
    return [torch.from_numpy(a).to(device) for a in (
        sdf, un, grid.axis_centers(0), grid.axis_centers(1),
        grid.axis_centers(2))]


# kernel E's cases: a grid whose x, y and z are no multiples of its tiling
# (a CTA owns 32 x by 8 y, a thread 8 z), images of 37 x 53 pixels
EXACT_SHAPE = (13, 21, 45)
EXACT_CAP = 3


def _exact_grid(projection, shape=EXACT_SHAPE):
    """Pinhole: [-1.1, 1.1]-ish world units; ortho: unit voxels."""
    nz, ny, nx = shape
    if projection == "pinhole":
        res = 2.2 / max(shape)
        return GridSpec((-1.1,) * 3, tuple(-1.1 + (n + 0.4) * res
                                           for n in (nx, ny, nz)), res)
    return GridSpec((0.0,) * 3, (nx + 0.4, ny + 0.4, nz + 0.4), 1.0)


def _exact_case(projection, device, n_views=5, shape=EXACT_SHAPE, h=37,
                w=53, seed=3):
    """Kernel E's arguments but the ROI and options: a partly fused state
    with frozen voxels (update_num past ``EXACT_CAP``), the grid's axis
    centres, random-normal images and their maxima, and cameras that leave
    voxels behind them, at z_cam == 0 and outside the image. Pinhole: a
    turntable of ``n_views - 1`` views whose frame the grid overfills,
    then a camera with the identity rotation whose image plane holds the
    grid's middle z-plane. Ortho: unit voxels seen by cameras turned about
    world y, the first standing inside the grid, the grid off the
    images' centres."""
    nz, ny, nx = shape
    rng = np.random.default_rng(seed)
    grid = _exact_grid(projection, shape)
    if projection == "pinhole":
        cams = stack_cameras(turntable_cameras(
            n_views - 1, 2.4, width=w, height=h, fov_y_deg=40.0))
        w2c = np.concatenate([cams.w2c.numpy(), np.eye(4, dtype=np.float32)[
            None]])
        w2c[-1, :3, 3] = [0.05, -0.02, -grid.axis_centers(2)[nz // 2]]
        pp = np.concatenate([cams.principal_point.numpy(),
                             [[w / 2 - 0.3, h / 2 + 0.2]]]).astype(np.float32)
        fl = np.concatenate([cams.focal_length.numpy(),
                             [[9.0, 8.5]]]).astype(np.float32)
    else:
        center = np.array([nx, ny, nz]) / 2
        w2c = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
        for i in range(n_views):
            ang = -0.5 + 1.0 * i / max(n_views - 1, 1)
            c, s_ = np.cos(ang), np.sin(ang)
            rot = np.array([[c, 0.0, s_], [0.0, 1.0, 0.0], [-s_, 0.0, c]])
            w2c[i, :3, :3] = rot
            depth = 0.0 if i == 0 else 2.0 * nz
            # off centre, so that the grid leaves the image at two edges
            w2c[i, :3, 3] = [w / 2 + 6, h / 2 + 10, depth] - rot @ center
        pp = fl = np.zeros((n_views, 2), np.float32)
    assert grid.shape_zyx == shape
    un = rng.integers(0, EXACT_CAP + 3, size=shape).astype(np.int32)
    sdf = rng.normal(size=shape).astype(np.float32)
    sdf[un == 0] = cfg.INVALID_SDF
    imgs = rng.normal(size=(n_views, h, w)).astype(np.float32)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        sdf, un, grid.axis_centers(0), grid.axis_centers(1),
        grid.axis_centers(2), w2c, pp, fl, imgs)]
    return t + [t[-1].amax(dim=(1, 2))]


def _exact_opt(interp, rule, outside, trunc):
    return cfg.VoxelUpdateOption(
        voxel_update=cfg.VoxelUpdate[rule],
        sdf_interp=cfg.SdfInterpolation[interp],
        update_outside=cfg.UpdateOutsideImage[outside],
        use_truncation=trunc, truncation_band=0.4,
        voxel_max_update_num=EXACT_CAP, voxel_update_weight=0.7)


def _exact_roi(kind, h=37, w=53):
    return (0, 0, w - 1, h - 1) if kind == "full" else (4, 3, w - 8, h - 6)


@pytest.mark.parametrize("projection", ["pinhole", "ortho"])
def test_exact_case_holds_every_skip(projection):
    """The cases kernel E is held to on the card reach every branch of the
    fold: voxels behind a camera, at z_cam == 0 (pinhole: a whole plane),
    outside the image and inside it, and frozen."""
    _, un, _, _, _, w2c, pp, fl, _, _ = _exact_case(projection, "cpu")
    pos = _exact_grid(projection).centers_zyx("cpu")
    behind = at_zero = outside = inside = 0
    for i in range(w2c.shape[0]):
        r, t = w2c[i, :3, :3], w2c[i, :3, 3]
        cam = [pos[..., 0] * r[k, 0] + pos[..., 1] * r[k, 1]
               + pos[..., 2] * r[k, 2] + t[k] for k in range(3)]
        if projection == "pinhole":
            u = fl[i, 0] / cam[2] * cam[0] + pp[i, 0]
            v = fl[i, 1] / cam[2] * cam[1] + pp[i, 1]
        else:
            u, v = cam[0], cam[1]
        ok = (cam[2] >= 0) & torch.isfinite(u) & torch.isfinite(v)
        hit = ok & (u >= 0) & (u <= 52) & (v >= 0) & (v <= 36)
        behind += int((cam[2] < 0).sum())
        at_zero += int((cam[2] == 0).sum())
        outside += int((ok & ~hit).sum())
        inside += int(hit.sum())
    assert behind > 0 and outside > 0 and inside > 0
    assert at_zero >= (EXACT_SHAPE[1] * EXACT_SHAPE[2]
                       if projection == "pinhole" else 0)
    assert int((un > EXACT_CAP).sum()) > 0 and int((un == 0).sum()) > 0


@pytest.mark.parametrize("projection", ["pinhole", "ortho"])
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
def test_exact_fold_on_cpu_equals_fold_views(rule, projection):
    """On CPU tensors the wrapper is its plain version, the centres'
    meshgrid and ``fusion.fold_views``, and counts no launch."""
    before = (exact_fold.launches, exact_fold.views)
    *args, max_sdfs = _exact_case(projection, "cpu")
    opt = _exact_opt("BILINEAR", rule, "MAX", True)
    roi = _exact_roi("roi")
    sdf0, un0 = args[0].clone(), args[1].clone()
    ks, ku = exact_fold(*args, max_sdfs, roi, opt, projection)
    ps, pu = fusion.fold_views(
        args[0], args[1], _exact_grid(projection).centers_zyx("cpu"),
        *args[5:], max_sdfs, roi, opt, projection)
    assert torch.equal(ku, pu)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    assert torch.equal(args[0], sdf0) and torch.equal(args[1], un0)
    assert bool((ku != un0).any())
    assert (exact_fold.launches, exact_fold.views) == before


def test_carve_views_on_cpu_takes_the_plain_fold():
    """``carve_views`` on a CPU state folds through ``exact_fold``'s plain
    version, with ``debug=True`` as without, and counts every view but no
    launch of kernel E."""
    sdf, un, _, _, _, w2c, pp, fl, imgs, _ = _exact_case("pinhole", "cpu")
    grid = _exact_grid("pinhole")
    before = (exact_fold.launches, fusion.carve_views.views)
    state = VoxelGridState(sdf, un)
    a = fusion.carve_views(state, grid, w2c, pp, fl, imgs)
    b = fusion.carve_views(state, grid, w2c, pp, fl, imgs, debug=True)
    assert torch.equal(a.update_num, b.update_num)
    assert torch.equal(a.sdf.view(torch.int32), b.sdf.view(torch.int32))
    assert (exact_fold.launches, fusion.carve_views.views) == (
        before[0], before[1] + 2 * w2c.shape[0])


def test_exact_fold_refuses_devices_other_than_cpu_and_cuda():
    *args, max_sdfs = [t.to("meta") for t in _exact_case("pinhole", "cpu")]
    before = exact_fold.launches
    with pytest.raises(ValueError, match="CUDA"):
        exact_fold(*args, max_sdfs, _exact_roi("full"),
                   cfg.VoxelUpdateOption())
    assert exact_fold.launches == before


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    args = [t.to("meta") for t in _warp_case((4, 5, 6), 2, "cpu")]
    with pytest.raises(ValueError, match="CUDA"):
        warp_fused.warp_fuse_planes(*args, cfg.VoxelUpdateOption(), True)
    with pytest.raises(ValueError, match="CUDA"):
        mc_fused.marching_cubes_fused(*args[:5])
    tables, pos = _rows_case(True, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        interp_rows(tables, pos, tables.shape[2], share_table=True)
    with pytest.raises(ValueError, match="CUDA"):
        bench.probe_scale(torch.ones(bench.PROBE_SHAPE, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        mc_fused.mc_scan(torch.zeros((4, 4), dtype=torch.int32,
                                     device="meta"), 2)


def test_wrappers_on_cpu_equal_the_plain_versions():
    before = (warp_fused.warp_fuse_planes.launches,
              mc_fused.marching_cubes_fused.launches)
    args = _warp_case((6, 7, 8), 2, "cpu")
    opt = cfg.VoxelUpdateOption()
    s, u = warp_fused.warp_fuse_planes(*args, opt, True)
    ps, pu = warp_fuse_planes_plain(*args, opt, True)
    assert torch.equal(s, ps) and torch.equal(u, pu)
    k = mc_fused.marching_cubes_fused(*_mc_case((6, 7, 8), "cpu"))
    p = mc_fused.mc_streams_plain(*_mc_case((6, 7, 8), "cpu"))
    for a, b in zip(k.as_tuple(), p.as_tuple()):
        assert torch.equal(a, b)
    assert (warp_fused.warp_fuse_planes.launches,
            mc_fused.marching_cubes_fused.launches) == before


def test_new_wrappers_on_cpu_equal_the_plain_versions():
    """The probe, the count and scan passes and the fused kernel with
    ortho rows and an ``out`` take their plain versions on CPU tensors and
    count no launch."""
    before = (bench.probe_scale.launches, mc_fused.mc_scan.launches,
              mc_fused.mc_tile_counts.launches,
              warp_fused.warp_fuse_planes.launches)
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    assert torch.equal(bench.probe_scale(x), x * 2.0)
    assert bench.warm_probe("cpu")[0]
    args = _density_state((5, 40, 60), 0.5, "cpu")
    counts = mc_fused.mc_tile_counts(*args)
    assert torch.equal(counts, mc_fused.mc_tile_counts_plain(*args[:2]))
    tpp = mc_fused.tiles_per_plane(40, 60)
    assert counts.shape == (5 * tpp, 4) and tpp == 3
    off, tot, per_plane = mc_fused.mc_scan(counts, tpp)
    st = mc_fused.mc_streams_plain(*args)
    assert torch.equal(per_plane, st.plane_counts)
    assert tot.tolist() == [st.vx_lin.numel(), st.vy_lin.numel(),
                            st.vz_lin.numel(), st.c_lin.numel()]
    assert torch.equal(off[0], torch.zeros(4, dtype=torch.int32))
    assert torch.equal(off[-1] + counts[-1], tot)
    (a, z_rows), opt = _ortho_case("cpu"), cfg.VoxelUpdateOption()
    ps, pu = warp_fuse_planes_plain(*a, opt, True, None, z_rows)
    s, u = a[0].clone(), a[1].clone()
    inplace = a[:]
    inplace[0], inplace[1] = s, u
    rs, ru = warp_fused.warp_fuse_planes(*inplace, opt, True,
                                         ortho_rows=z_rows, out=(s, u))
    assert rs is s and ru is u
    assert torch.equal(s, ps) and torch.equal(u, pu)
    # the real z row matters: part of the grid lies behind view 0
    qs, qu = warp_fuse_planes_plain(*a, opt, True)
    assert not torch.equal(qu, pu)
    assert before == (bench.probe_scale.launches, mc_fused.mc_scan.launches,
                      mc_fused.mc_tile_counts.launches,
                      warp_fused.warp_fuse_planes.launches)


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_kernels, "CUDA_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_kernels, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.build()


_FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
time.sleep(0.2)
with open(out, "w") as f:
    f.write(" ".join(sys.argv[1:]))
"""


def test_concurrent_builds_keep_to_their_own_files(monkeypatch, tmp_path):
    """Two builds at once (a stand-in nvcc that only writes its -o file)
    both finish, and leave the library and its log and nothing else."""
    import sys
    import threading

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_kernels, "BUILD_ROOT", tmp_path / "build")
    libs, errors = [], []

    def run():
        try:
            libs.append(_kernels.build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(libs) == 2 and libs[0] == libs[1]
    out_dir = libs[0].parent
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "build.log", "libvacancy_kernels.so"]
    assert "-shared" in libs[0].read_text()
    assert all(src.name in _kernels.build_log()
               for src in _kernels._sources())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("roi", [None, (11, 7, 300, 229)], ids=["full", "roi"])
@pytest.mark.parametrize("linear", [True, False], ids=["bilinear", "nn"])
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
def test_warp_kernel_equals_plain_on_gpu(cuda_device, rule, linear, roi):
    args = _warp_case((20, 26, 37), 5, cuda_device)
    opt = cfg.VoxelUpdateOption(
        voxel_update=cfg.VoxelUpdate[rule], use_truncation=True,
        truncation_band=0.05, voxel_max_update_num=3,
        update_outside=(cfg.UpdateOutsideImage.MAX if roi
                        else cfg.UpdateOutsideImage.NONE),
    )
    before = warp_fused.warp_fuse_planes.launches
    ks, ku = warp_fused.warp_fuse_planes(*args, opt, linear, roi)
    ps, pu = warp_fuse_planes_plain(*args, opt, linear, roi)
    torch.cuda.synchronize()
    assert warp_fused.warp_fuse_planes.launches == before + 1
    assert torch.equal(ku, pu)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    assert bool((ku != args[1]).any())


# shapes that straddle kernel A's tiling (a CTA owns 32 x by 64 y of one
# plane): (name, shape, image rows, ROI)
TILING_CASES = {
    "ny-under-one-y-tile": ((6, 37, 40), 240, None),
    "two-y-tiles-and-two-rows": ((5, 130, 33), 240, None),
    "a-y-tile-outside-the-roi": ((8, 256, 48), 240, (0, 30, 319, 110)),
    "band-in-row-chunks": ((11, 17, 45), 1800, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("outside", ["NONE", "MAX"])
@pytest.mark.parametrize("linear", [True, False], ids=["bilinear", "nn"])
@pytest.mark.parametrize("case", list(TILING_CASES))
def test_warp_kernel_tiling_edges_equal_plain_on_gpu(cuda_device, case,
                                                     linear, outside):
    """Kernel A across its tiling's edges: rows past the grid in the last
    y-tile, a y-tile that no view's ROI reaches (skipped, or given the
    image's max), views of 1800 rows whose tapped band exceeds the rows of
    the intermediate held in shared memory; and the same in place."""
    shape, rows, roi = TILING_CASES[case]
    args = _warp_case(shape, 3, cuda_device)
    if rows != args[-1].shape[1]:
        scale = rows / args[-1].shape[1]
        rng = np.random.default_rng(4)
        args[-1] = torch.from_numpy(rng.normal(
            size=(3, rows, 360)).astype(np.float32)).to(cuda_device)
        args[6], args[7] = args[6].clone(), args[7].clone()
        args[6][:, 1] *= scale  # the principal point's and the focal
        args[7][:, 1] *= scale  # length's v: the same view, taller
        plan = warp_fused.fused_plan(
            *shape, rows, 360, warp_fused.smem_optin_bytes(cuda_device))
        assert plan.inter_rows < rows  # the band goes in chunks
    opt = cfg.VoxelUpdateOption(
        voxel_update=cfg.VoxelUpdate.WEIGHTED_AVERAGE, use_truncation=True,
        truncation_band=0.4, update_outside=cfg.UpdateOutsideImage[outside])
    ks, ku = warp_fused.warp_fuse_planes(*args, opt, linear, roi)
    ps, pu = warp_fuse_planes_plain(*args, opt, linear, roi)
    s, u = args[0].clone(), args[1].clone()
    warp_fused.warp_fuse_planes(s, u, *args[2:], opt, linear, roi,
                                out=(s, u))
    torch.cuda.synchronize()
    assert torch.equal(ku, pu)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    assert torch.equal(u, ku)
    assert torch.equal(s.view(torch.int32), ks.view(torch.int32))
    assert bool((ku != args[1]).any())


@pytest.mark.cuda
def test_warp_kernel_tall_images_and_metric_weights_on_gpu(cuda_device):
    """Images of 420 rows need 52.5 KB of shared memory per CTA (above the
    48 KB default); a non-unit weight with metric truncation takes the
    other threshold and weight arguments."""
    args = _warp_case((11, 17, 45), 3, cuda_device)
    rng = np.random.default_rng(4)
    args[-1] = torch.from_numpy(
        rng.normal(size=(3, 420, 360)).astype(np.float32)).to(cuda_device)
    opt = cfg.VoxelUpdateOption(
        voxel_update=cfg.VoxelUpdate.WEIGHTED_AVERAGE,
        voxel_update_weight=0.7, use_truncation=True, truncation_band=0.4,
        metric_truncation=True,
    )
    ks, ku = warp_fused.warp_fuse_planes(*args, opt, True)
    ps, pu = warp_fuse_planes_plain(*args, opt, True)
    torch.cuda.synchronize()
    assert torch.equal(ku, pu)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    assert bool((ku != args[1]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
@pytest.mark.parametrize("shape", [(9, 21, 13), (5, 3, 1100), (40, 64, 512)])
def test_mc_kernel_equals_plain_on_gpu(cuda_device, shape, linear):
    args = _mc_case(shape, cuda_device)
    before = mc_fused.marching_cubes_fused.launches
    k = mc_fused.marching_cubes_fused(*args, linear_interp=linear)
    p = mc_fused.mc_streams_plain(*args, linear_interp=linear)
    torch.cuda.synchronize()
    assert mc_fused.marching_cubes_fused.launches == before + 1
    assert int(p.plane_counts.sum()) > 0
    for a, b in zip(k.as_tuple(), p.as_tuple()):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_mc_kernel_on_an_empty_gpu_grid(cuda_device):
    grid = GridSpec((0.0,) * 3, (9.4, 8.4, 7.4), 1.0)
    st = VoxelGridState.create(grid, cuda_device)
    k = mc_fused.marching_cubes_fused(
        st.sdf, st.update_num,
        *(grid.axis_centers_t(a, cuda_device) for a in range(3)),
    )
    assert all(t.numel() == 0 for t in k.as_tuple()[:8])
    assert int(k.plane_counts.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 8, 40, 16), (40, 2000, 50, 37)],
                         ids=["small", "over-65535-rows"])
@pytest.mark.parametrize("taps", [None, (5, 30)], ids=["full", "lo-hi"])
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nn"])
@pytest.mark.parametrize("share", [True, False], ids=["shared", "per-n"])
def test_interp_rows_kernel_equals_plain_on_gpu(cuda_device, share, linear,
                                                taps, shape):
    n, r, w, t = shape
    tables, pos = _rows_case(share, cuda_device, n, r, w, t)
    lo, hi = taps or (0, None)
    before = interp_rows.launches
    k = interp_rows(tables, pos, w, linear, share, lo, hi)
    p = interp_rows_plain(tables, pos, w, linear, share, lo, hi)
    torch.cuda.synchronize()
    assert interp_rows.launches == before + 1
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


# (n, r, t, width, shared, lo, hi, unaligned positions): kernel C at the
# edges of its plan: t of 1, 5 and 512, width 1, one plane more than a
# staged group, a shared row wider than the staging budget, positions one
# float off 16-byte alignment, per-row tables
C_EDGES = {
    "t1": (3, 8, 1, 40, True, 0, 39, False),
    "t5": (3, 8, 5, 40, True, 2, 33, False),
    "t512": (9, 70, 512, 3840, True, 0, 3839, False),
    "t512-roi": (9, 70, 512, 3840, True, 201, 3601, False),
    "width1": (4, 7, 16, 1, True, 0, 0, False),
    "width1-per-row": (4, 7, 16, 1, False, 0, 0, False),
    "group+1": (warp_gather.GROUP_MAX + 1, 4200, 8, 42, True, 3, 41, False),
    "wide-row": (5, 6, 64, warp_gather.STAGE_BYTES_MAX // 4 + 8, True, 0,
                 warp_gather.STAGE_BYTES_MAX // 4 + 7, False),
    "unaligned": (6, 9, 64, 100, True, 0, 99, True),
    "per-row": (6, 9, 64, 2160, False, 100, 2000, False),
    "per-row-t13": (6, 9, 13, 50, False, 0, 49, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nn"])
@pytest.mark.parametrize("case", list(C_EDGES))
def test_interp_rows_kernel_edges_equal_plain_on_gpu(cuda_device, case,
                                                     linear):
    """Every variant of kernel C's plan (staged, direct4, direct1) equals
    the plain version bit for bit at its edges, with positions at -1 and
    at ``width`` and half-pixel positions for the NN rounding."""
    n, r, t, w, share, lo, hi, unaligned = C_EDGES[case]
    tables, pos = _rows_case(share, cuda_device, n, r, w, t)
    if unaligned:
        buf = torch.empty(pos.numel() + 1, device=cuda_device)
        buf[1:].copy_(pos.reshape(-1))
        pos = buf[1:].view(n, r, t)
    pos[0, 0, :] = torch.arange(t, device=cuda_device) * 0.5 - 0.5
    plan = warp_gather.interp_plan(
        n, r, t, w, share, lo, hi, _kernels.smem_optin_bytes(cuda_device),
        pos.data_ptr() % 16 == 0)
    want = ("direct1" if unaligned or t % 4 else
            "staged" if share and case != "wide-row" else "direct4")
    assert plan.mode == want
    before = interp_rows.launches
    k = interp_rows(tables, pos, w, linear, share, lo, hi)
    p = interp_rows_plain(tables, pos, w, linear, share, lo, hi)
    torch.cuda.synchronize()
    assert interp_rows.launches == before + 1
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


@pytest.mark.cuda
def test_interp_rows_constants_match_the_build_on_gpu(cuda_device):
    """The built kernel's launch constants are ops/warp_gather.py's, and
    the C entry point refuses a plan it cannot take."""
    warp_gather._check_tiling()
    lib = _kernels.load()
    assert 0 < lib.vt_interp_tiling(3) <= warp_gather.REGISTER_BUDGET
    tables, pos = _rows_case(False, cuda_device, t=16)
    out = torch.empty_like(pos)
    stream = _kernels.stream_ptr(cuda_device)
    args = (tables.data_ptr(), pos.data_ptr(), out.data_ptr(), 3, 8, 16, 40)
    # staged with per-row tables, a group of 0, rows of 0
    assert lib.vt_interp_rows(*args, 0, 1, 0, 39, 0, 1, 1, stream) != 0
    assert lib.vt_interp_rows(*args, 1, 1, 0, 39, 0, 0, 1, stream) != 0
    assert lib.vt_interp_rows(*args, 0, 1, 0, 39, 1, 1, 0, stream) != 0
    assert lib.vt_interp_rows(*args, 0, 1, 0, 39, 1, 1, 2, stream) == 0


@pytest.mark.cuda
def test_interp_rows_refuses_bad_inputs_on_gpu(cuda_device):
    tables, pos = _rows_case(False, cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        interp_rows(tables.cpu(), pos, 40)
    with pytest.raises(ValueError, match="CUDA"):
        interp_rows(tables, pos.cpu(), 40)
    with pytest.raises(TypeError, match="float32"):
        interp_rows(tables, pos.double(), 40)
    with pytest.raises(ValueError, match="shape"):
        interp_rows(tables, pos, 40, share_table=True)
    with pytest.raises(ValueError, match="taps"):
        interp_rows(tables, pos, 40, lo=12, hi=11)
    with pytest.raises(ValueError, match="taps"):
        interp_rows(tables, pos, 40, hi=40)


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [True, False], ids=["bilinear", "nn"])
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
def test_two_pass_engine_equals_fused_kernel_on_gpu(cuda_device, rule,
                                                    linear):
    """The two-pass engine through kernel C and the fused warp kernel
    compute the same expressions: bitwise equal at 240 rows. The fused
    kernel's plain version launches neither kernel."""
    args = _warp_case((20, 26, 37), 5, cuda_device)
    opt = cfg.VoxelUpdateOption(
        voxel_update=cfg.VoxelUpdate[rule], use_truncation=True,
        truncation_band=0.05, update_outside=cfg.UpdateOutsideImage.MAX)
    before = (warp_fused.warp_fuse_planes.launches, interp_rows.launches)
    cs, cu = fusion_warp.warp_fold(*args, opt, linear, None, interp_rows)
    assert interp_rows.launches == before[1] + 2 * 5
    ks, ku = warp_fused.warp_fuse_planes(*args, opt, linear)
    assert warp_fused.warp_fuse_planes.launches == before[0] + 1
    after = (warp_fused.warp_fuse_planes.launches, interp_rows.launches)
    ps, pu = warp_fuse_planes_plain(*args, opt, linear)
    torch.cuda.synchronize()
    assert (warp_fused.warp_fuse_planes.launches,
            interp_rows.launches) == after
    for s, u in ((cs, cu), (ps, pu)):
        assert torch.equal(u, ku)
        assert torch.equal(s.view(torch.int32), ks.view(torch.int32))
    assert bool((ku != args[1]).any())


def _tall_case(device, h=2160, w=480, n_views=2):
    """An 8 x 9 x 10 grid seen by cameras with images of ``h`` rows."""
    rng = np.random.default_rng(3)
    grid = GridSpec((-1.0,) * 3, (1.0, 0.9, 0.8), 0.1)
    w2c = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    w2c[:, 2, 3] = [3.0, 3.5][:n_views]
    pp = np.tile(np.float32([(w - 1) / 2, (h - 1) / 2]), (n_views, 1))
    fl = np.full((n_views, 2), 900.0, np.float32)
    imgs = rng.normal(size=(n_views, h, w)).astype(np.float32)
    return grid, [torch.from_numpy(a).to(device) for a in (w2c, pp, fl,
                                                           imgs)]


# an opt-in whose blocks hold no two rows of kernel A's intermediate: the
# engine choice then sends any view to the two-pass engine (kernel C)
NO_TWO_ROWS = warp_fused.STATIC_SMEM_BYTES + 2 * warp_fused.TILE_X * 4 - 1


@pytest.mark.cuda
def test_tall_views_take_the_fused_kernel_on_gpu(cuda_device):
    """2160 rows: carve_views_warp launches the fused kernel once, and no
    kernel C; its state equals the plain fold and the two-pass engine with
    kernel C bit for bit. Images of 2**32 pixels or more are refused before
    any launch."""
    grid, (w2c, pp, fl, imgs) = _tall_case(cuda_device)
    optin = warp_fused.smem_optin_bytes(cuda_device)
    shape = grid.shape_zyx
    assert warp_fused.fused_refusal(*shape, 2160, 480, optin) is None
    assert warp_fused.fused_plan(*shape, 2160, 480, optin).inter_rows == min(
        warp_fused.INTER_ROWS_CAP,
        (optin - warp_fused.STATIC_SMEM_BYTES) // (warp_fused.TILE_X * 4))
    st = VoxelGridState.create(grid, cuda_device)
    before = (warp_fused.warp_fuse_planes.launches, interp_rows.launches)
    out = fusion_warp.carve_views_warp(st, grid, w2c, pp, fl, imgs)
    assert (warp_fused.warp_fuse_planes.launches,
            interp_rows.launches) == (before[0] + 1, before[1])
    centers = [grid.axis_centers_t(a, cuda_device) for a in range(3)]
    args = (st.sdf, st.update_num, *centers, w2c, pp, fl, imgs,
            cfg.VoxelUpdateOption(), True)
    ps, pu = warp_fuse_planes_plain(*args)
    cs, cu = fusion_warp.warp_fold(*args, None, interp_rows)
    torch.cuda.synchronize()
    assert interp_rows.launches == before[1] + 2 * 2
    for s, u in ((ps, pu), (cs, cu)):
        assert torch.equal(out.update_num, u)
        assert torch.equal(out.sdf.view(torch.int32), s.view(torch.int32))
    assert bool((pu > 0).any())
    with pytest.raises(ValueError, match="2\\*\\*32"):
        warp_fused.fused_plan(*shape, 65536, 65536, optin)
    assert not fusion_warp._fused_kernel_takes(cuda_device, shape, 65536,
                                               65536)


@pytest.mark.cuda
@pytest.mark.parametrize("stage_bytes", [4096, 4 * 7007, 1 << 25],
                         ids=["many-slices", "one-slice-left", "one-slice"])
def test_host_array_stages_through_reused_buffers_on_gpu(
        cuda_device, monkeypatch, stage_bytes):
    """``carver._host_array`` of a CUDA tensor on its staged path (the
    pool of page-locked buffers given no room): the same values as
    ``.cpu()``, in a pageable array of its own for each call, whatever
    the staging buffers' size against the tensor's."""
    from vacancy_tpu_torch import carver as carver_mod

    monkeypatch.setattr(carver_mod, "PINNED_SHARE", 0)
    monkeypatch.setattr(carver_mod, "STAGE_BYTES", stage_bytes)
    t = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 1001, 7)).astype(np.float32)).to(cuda_device)
    a = carver_mod._host_array(t)
    b = carver_mod._host_array(t * 2)
    assert a.shape == (3, 1001, 7) and a.dtype == np.float32
    assert np.array_equal(a, t.cpu().numpy())
    assert np.array_equal(b, (t * 2).cpu().numpy())
    assert not torch.from_numpy(a).is_pinned()
    assert not np.shares_memory(a, b)


@pytest.mark.cuda
def test_host_array_returns_reused_page_locked_buffers_on_gpu(cuda_device):
    """``carver._host_array`` of a CUDA tensor on its pooled path: the
    same values as ``.cpu()`` in page-locked memory, the buffer handed out
    again once the array is dropped, and two kept results intact after a
    third call with other values."""
    from vacancy_tpu_torch import carver as carver_mod

    count = carver_mod._host_array
    before = (count.pinned, count.staged)
    t = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 1001, 7)).astype(np.float32)).to(cuda_device)
    a = carver_mod._host_array(t)
    assert a.shape == (2, 1001, 7) and a.dtype == np.float32
    assert np.array_equal(a, t.cpu().numpy())
    assert torch.from_numpy(a).is_pinned()
    first = a.ctypes.data
    del a
    a = carver_mod._host_array(t * 2)
    assert a.ctypes.data == first
    b = carver_mod._host_array(t * 3)
    c = carver_mod._host_array(t * 4)
    assert len({a.ctypes.data, b.ctypes.data, c.ctypes.data}) == 3
    assert np.array_equal(a, (t * 2).cpu().numpy())
    assert np.array_equal(b, (t * 3).cpu().numpy())
    assert np.array_equal(c, (t * 4).cpu().numpy())
    assert (count.pinned, count.staged) == (before[0] + 4, before[1])
    assert count.pinned_bytes == carver_mod._POOL.locked >= 3 * a.nbytes


def test_host_array_of_a_cpu_tensor_is_its_numpy_view():
    from vacancy_tpu_torch import carver as carver_mod

    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    a = carver_mod._host_array(t)
    assert np.array_equal(a, t.numpy()) and np.shares_memory(a, t.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(2,), (3,)], ids=["2-blocks",
                                                          "3-blocks"])
def test_sharded_carve_takes_tall_views_to_the_fused_kernel_on_gpu(
        cuda_device, mesh_shape):
    """``carve_views_warp_sharded`` over z blocks on the one card: views
    of 2160 rows go to the fused kernel once per block and never to
    kernel C, and the blocks gather to the dense carve bit for bit."""
    from vacancy_tpu_torch import parallel as tpar

    grid, (w2c, pp, fl, imgs) = _tall_case(cuda_device)
    dense = fusion_warp.carve_views_warp(
        VoxelGridState.create(grid, cuda_device), grid, w2c, pp, fl, imgs)
    mesh = tpar.make_device_mesh(shape=mesh_shape,
                                 devices=[cuda_device] * mesh_shape[0])
    st = VoxelGridState.create(grid, sharding=tpar.grid_sharding(mesh))
    before = (warp_fused.warp_fuse_planes.launches, interp_rows.launches)
    out = tpar.carve_views_warp_sharded(st, grid, w2c, pp, fl, imgs,
                                        mesh=mesh)
    assert (warp_fused.warp_fuse_planes.launches,
            interp_rows.launches) == (before[0] + mesh_shape[0], before[1])
    got = out.gather()
    torch.cuda.synchronize()
    assert torch.equal(got.update_num, dense.update_num)
    assert torch.equal(got.sdf.view(torch.int32), dense.sdf.view(torch.int32))
    assert bool((dense.update_num > 0).any())


@pytest.mark.cuda
def test_probe_kernel_equals_plain_on_gpu(cuda_device):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(
        rng.normal(size=bench.PROBE_SHAPE).astype(np.float32)).to(cuda_device)
    before = bench.probe_scale.launches
    k = bench.probe_scale(x)
    torch.cuda.synchronize()
    assert bench.probe_scale.launches == before + 1
    assert torch.equal(k.view(torch.int32),
                       bench.probe_scale_plain(x).view(torch.int32))
    ok, seconds = bench.warm_probe(cuda_device)
    assert ok and seconds > 0
    assert bench.probe_scale.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [True, False], ids=["bilinear", "nn"])
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
def test_warp_kernel_ortho_rows_equal_plain_on_gpu(cuda_device, rule, linear):
    """Kernel A with the four orthographic coefficients against the
    two-pass fold with ``z_rows``: update_num exact, sdf bitwise, also
    when it writes over its input."""
    args, z_rows = _ortho_case(cuda_device)
    opt = cfg.VoxelUpdateOption(
        voxel_update=cfg.VoxelUpdate[rule], use_truncation=True,
        truncation_band=0.4, update_outside=cfg.UpdateOutsideImage.MAX)
    before = (warp_fused.warp_fuse_planes.launches, interp_rows.launches)
    ks, ku = warp_fused.warp_fuse_planes(*args, opt, linear,
                                         ortho_rows=z_rows)
    ps, pu = warp_fuse_planes_plain(*args, opt, linear, None, z_rows)
    qs, qu = warp_fuse_planes_plain(*args, opt, linear)  # no behind mask
    torch.cuda.synchronize()
    assert (warp_fused.warp_fuse_planes.launches,
            interp_rows.launches) == (before[0] + 1, before[1])
    assert torch.equal(ku, pu)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    assert not torch.equal(qu, pu)
    s, u = args[0].clone(), args[1].clone()
    warp_fused.warp_fuse_planes(s, u, *args[2:], opt, linear,
                                ortho_rows=z_rows, out=(s, u))
    torch.cuda.synchronize()
    assert torch.equal(u, pu)
    assert torch.equal(s.view(torch.int32), ps.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("size,optin", [(48, None), (2000, None),
                                        (48, NO_TWO_ROWS)],
                         ids=["48-rows", "2000-rows", "no-two-rows"])
def test_ortho_views_that_fit_take_the_fused_kernel_on_gpu(
        cuda_device, monkeypatch, size, optin):
    """``carve_views_warp_ortho`` launches kernel A for views of any height
    its plan takes, and kernel C where the card's shared memory could not
    hold its plan; both equal the plain fold."""
    fused = optin is None
    if not fused:
        monkeypatch.setattr(warp_fused, "smem_optin_bytes",
                            lambda dev: optin)
    nz, ny, nx = 8, 9, 10
    grid = GridSpec((0.0,) * 3, (nx + 0.4, ny + 0.4, nz + 0.4), 1.0)
    rng = np.random.default_rng(1)
    w2c = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    w2c[:, :3, 3] = [32 - nx / 2, size / 2 - ny / 2, 5.0]
    w2c[1, 2, 3] = -4.0  # half of the grid lies behind view 1
    w2c = torch.from_numpy(w2c).to(cuda_device)
    imgs = torch.from_numpy(rng.normal(size=(2, size, 64)).astype(
        np.float32)).to(cuda_device)
    st = VoxelGridState.create(grid, cuda_device)
    before = (warp_fused.warp_fuse_planes.launches, interp_rows.launches)
    out = fusion_warp.carve_views_warp_ortho(st, grid, w2c, imgs)
    after = (warp_fused.warp_fuse_planes.launches, interp_rows.launches)
    assert after == ((before[0] + 1, before[1]) if fused
                     else (before[0], before[1] + 4))
    synth, zero2, one2, z_rows = fusion_warp.ortho_homography(w2c)
    plain_args = (
        st.sdf, st.update_num,
        *(grid.axis_centers_t(a, cuda_device) for a in range(3)), synth,
        zero2, one2, imgs, cfg.VoxelUpdateOption(), True, None)
    ps, pu = warp_fuse_planes_plain(*plain_args, z_rows)
    _, qu = warp_fuse_planes_plain(*plain_args)  # no behind mask
    torch.cuda.synchronize()
    assert torch.equal(out.update_num, pu) and bool((pu > 0).any())
    assert not torch.equal(qu, pu)
    assert torch.equal(out.sdf.view(torch.int32), ps.view(torch.int32))


@pytest.mark.cuda
def test_ortho_facade_takes_a_2160_row_view_to_the_fused_kernel_on_gpu(
        cuda_device):
    """``VoxelCarver.carve_batch(engine="warp")`` of one orthographic view
    of 1200 x 2160 pixels over a grid whose 60 rows of 36-unit voxels span
    the image: kernel A once, kernel C never; the state equals the plain
    fold and the two-pass engine with kernel C bit for bit."""
    from vacancy_tpu_torch import VoxelCarver
    from vacancy_tpu_torch.camera import OrthoCamera

    h, w, res = 2160, 1200, 36.0
    opt = cfg.VoxelCarverOption(bb_min=(0.0,) * 3,
                                bb_max=(32.4 * res, 60.4 * res, 24.4 * res),
                                resolution=res)
    carver = VoxelCarver(opt, cuda_device)
    assert carver.init() and carver.grid.shape_zyx == (24, 60, 32)
    w2c = np.eye(4)
    w2c[:3, 3] = [24.0, 0.0, 100.0]
    cam = OrthoCamera.create(w, h, np.linalg.inv(w2c), device=cuda_device)
    vv, uu = np.mgrid[0:h, 0:w]
    masks = ((((uu - 600) / 500.0) ** 2 + ((vv - 1080) / 1000.0) ** 2
              < 1) * 255).astype(np.uint8)[None]
    before = (warp_fused.warp_fuse_planes.launches, interp_rows.launches)
    imgs = carver.carve_batch([cam], masks, engine="warp")
    assert (warp_fused.warp_fuse_planes.launches,
            interp_rows.launches) == (before[0] + 1, before[1])
    synth, zero2, one2, z_rows = fusion_warp.ortho_homography(cam.w2c[None])
    st = VoxelGridState.create(carver.grid, cuda_device)
    args = (st.sdf, st.update_num,
            *(carver.grid.axis_centers_t(a, cuda_device) for a in range(3)),
            synth, zero2, one2, torch.from_numpy(imgs).to(cuda_device),
            opt.update_option,
            opt.update_option.sdf_interp == cfg.SdfInterpolation.BILINEAR,
            None)
    ps, pu = warp_fuse_planes_plain(*args, z_rows)
    cs, cu = fusion_warp.warp_fold(*args, interp_rows, z_rows=z_rows)
    torch.cuda.synchronize()
    assert interp_rows.launches == before[1] + 2
    for s, u in ((ps, pu), (cs, cu)):
        assert torch.equal(carver.state.update_num, u)
        assert torch.equal(carver.state.sdf.view(torch.int32),
                           s.view(torch.int32))
    assert 0.05 < float((pu > 0).float().mean()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("h,fused", [(240, True), (2000, False),
                                     (2160, True)],
                         ids=["kernel-a", "kernel-c", "kernel-a-2160-rows"])
def test_blocked_carve_equals_unblocked_on_gpu(cuda_device, monkeypatch, h,
                                               fused):
    """The z-chunked carve updates the state in place and equals one
    ``carve_views_warp`` bit for bit, through kernel A (in place, views of
    any height) and through the two-pass engine with kernel C (on a card
    whose shared memory could not hold A's plan)."""
    if not fused:
        monkeypatch.setattr(warp_fused, "smem_optin_bytes",
                            lambda dev: NO_TWO_ROWS)
    grid, (w2c, pp, fl, imgs) = _tall_case(cuda_device, h=h, w=96)
    want = fusion_warp.carve_views_warp(
        VoxelGridState.create(grid, cuda_device), grid, w2c, pp, fl, imgs)
    st = VoxelGridState.create(grid, cuda_device)
    before = (warp_fused.warp_fuse_planes.launches, interp_rows.launches)
    got = fusion_warp.carve_views_warp_blocked(st, grid, w2c, pp, fl, imgs,
                                               chunk_nz=4)  # snaps to 3
    torch.cuda.synchronize()
    after = (warp_fused.warp_fuse_planes.launches, interp_rows.launches)
    chunks = grid.shape_zyx[0] // 3
    assert grid.shape_zyx[0] == 18
    assert after == ((before[0] + chunks, before[1]) if fused
                     else (before[0], before[1] + chunks * 2 * 2))
    assert got.sdf is st.sdf and got.update_num is st.update_num
    assert torch.equal(got.update_num, want.update_num)
    assert bool((want.update_num > 0).any())
    assert torch.equal(got.sdf.view(torch.int32), want.sdf.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 7), (1, 1), (64, 1024), (128, 1024),
                                   (1024, 1024), (3, 700001)],
                         ids=["300x7", "one-tile", "64x1024", "131072",
                              "1048576", "2051-blocks-two-top-passes"])
def test_mc_scan_kernel_equals_cumsum_on_gpu(cuda_device, shape):
    """B's scan pass on its own against torch.cumsum: exclusive offsets,
    totals and per-plane counts of random tile counts, from one tile to
    more block sums than the one CTA over them takes at once."""
    nz, tpp = shape
    rng = np.random.default_rng(11)
    counts = torch.from_numpy(rng.integers(
        0, 1025, size=(nz * tpp, 4)).astype(np.int32)).to(cuda_device)
    before = mc_fused.mc_scan.launches
    k = mc_fused.mc_scan(counts, tpp)
    p = mc_fused.mc_scan_plain(counts, tpp)
    torch.cuda.synchronize()
    assert mc_fused.mc_scan.launches == before + 1
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for _ in range(3):  # and the same bytes every time
        again = mc_fused.mc_scan(counts, tpp)
        assert all(torch.equal(a, b) for a, b in zip(again, k))
    with pytest.raises(ValueError, match="planes"):
        mc_fused.mc_scan(counts, tpp + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
def test_mc_kernel_on_a_surface_inside_two_tiles_on_gpu(cuda_device, linear):
    """One voxel below the iso level: its flags lie in its own tile and in
    the one a plane below; the emit pass leaves every other tile at
    once."""
    shape = (24, 40, 52)
    args = _density_state(shape, 0.0, cuda_device)
    args[0][10, 12, 45] = -0.5
    counts = mc_fused.mc_tile_counts(*args)
    assert torch.equal(counts, mc_fused.mc_tile_counts_plain(*args[:2]))
    assert int((counts.sum(dim=1) > 0).sum()) == 2
    k = mc_fused.marching_cubes_fused(*args, linear_interp=linear)
    p = mc_fused.mc_streams_plain(*args, linear_interp=linear)
    torch.cuda.synchronize()
    assert k.c_lin.numel() == 8 and k.vx_lin.numel() == 2
    for a, b in zip(k.as_tuple(), p.as_tuple()):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.02, 0.5, 1.0])
def test_mc_count_and_emit_equal_mask_compaction_on_gpu(cuda_device,
                                                        density):
    """B's count pass against the dense flags summed per tile, and its
    emit pass against boolean-mask compaction, at flag densities of about
    0, 0.02, 0.5 and 1 per edge stream."""
    args = _density_state((24, 40, 52), density, cuda_device)
    before = mc_fused.mc_tile_counts.launches
    counts = mc_fused.mc_tile_counts(*args)
    assert mc_fused.mc_tile_counts.launches == before + 1
    assert torch.equal(counts, mc_fused.mc_tile_counts_plain(*args[:2]))
    k = mc_fused.marching_cubes_fused(*args)
    p = mc_fused.mc_streams_plain(*args)
    torch.cuda.synchronize()
    n_edges = 24 * 40 * 52
    got = k.vx_lin.numel() / n_edges
    assert abs(got - density) < 0.05, got
    for a, b in zip(k.as_tuple(), p.as_tuple()):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# the windows of one block of a (2, 2, 2) split of a 24 x 40 x 52 grid, a
# z-only split, a y/x-only split, and an empty window
WINDOW_CASES = {
    "zyx-block": dict(own_k=(1, 13), own_j=(1, 21), own_i=(1, 27), zb=11,
                      yx_base=(19, 25), gdims=(40, 52)),
    "z-first-block": dict(own_k=(1, 13), zb=-1),
    "yx-block": dict(own_j=(1, 21), own_i=(1, 27), yx_base=(-1, 25),
                     gdims=(40, 52)),
    "empty": dict(own_k=(3, 3)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_mc_windowed_count_and_emit_equal_plain_on_gpu(cuda_device, case,
                                                       linear):
    """B with emission windows and global-id bases on a halo-extended
    block: tile counts, the four streams and plane counts equal the plain
    version's byte for byte; the planes outside own_k count nothing."""
    kw = WINDOW_CASES[case]
    shape = {"zyx-block": (14, 22, 28), "z-first-block": (14, 40, 52),
             "yx-block": (24, 22, 28), "empty": (9, 21, 13)}[case]
    args = _mc_case(shape, cuda_device, seed=21)
    win = {k: kw[k] for k in ("own_k", "own_j", "own_i") if k in kw}
    counts = mc_fused.mc_tile_counts(*args, linear_interp=linear, **kw)
    assert torch.equal(
        counts, mc_fused.mc_tile_counts_plain(*args[:2], **win))
    before = mc_fused.marching_cubes_fused.launches
    k = mc_fused.marching_cubes_fused(*args, linear_interp=linear, **kw)
    p = mc_fused.mc_streams_plain(*args, linear_interp=linear, **kw)
    torch.cuda.synchronize()
    assert mc_fused.marching_cubes_fused.launches == before + 1
    for a, b in zip(k.as_tuple(), p.as_tuple()):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    lo, hi = kw.get("own_k", (0, shape[0]))
    assert int(k.plane_counts[:lo].sum()) == 0
    assert int(k.plane_counts[hi:].sum()) == 0
    assert (int(k.plane_counts.sum()) > 0) == (case != "empty")
    # and the defaults are the unwindowed kernel
    d = mc_fused.marching_cubes_fused(*args, linear_interp=linear)
    e = mc_fused.marching_cubes_fused(
        *args, linear_interp=linear, own_k=(0, shape[0]),
        own_j=(0, shape[1]), own_i=(0, shape[2]), zb=0, yx_base=(0, 0),
        gdims=shape[1:])
    for a, b in zip(d.as_tuple(), e.as_tuple()):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_mc_kernel_refuses_ids_past_int32_on_gpu(cuda_device):
    args = _mc_case((4, 8, 8), cuda_device)
    with pytest.raises(ValueError, match="global grid is too large"):
        mc_fused.marching_cubes_fused(*args, zb=2047, gdims=(1024, 1024))
    with pytest.raises(ValueError, match="leave the global plane"):
        mc_fused.marching_cubes_fused(*args, yx_base=(0, 4), gdims=(8, 8))


def _fold_on_gpu_and_plain(args, max_sdfs, roi, opt, projection):
    """E once (its launch and views counted) and its plain version on the
    same CUDA tensors; the inputs must come back unwritten."""
    sdf0, un0 = args[0].clone(), args[1].clone()
    before = (exact_fold.launches, exact_fold.views)
    ks, ku = exact_fold(*args, max_sdfs, roi, opt, projection)
    torch.cuda.synchronize()
    assert (exact_fold.launches, exact_fold.views) == (
        before[0] + 1, before[1] + args[5].shape[0])
    ps, pu = exact_fold_plain(*args, max_sdfs, roi, opt, projection)
    torch.cuda.synchronize()
    assert exact_fold.launches == before[0] + 1  # the plain version: none
    assert torch.equal(args[0].view(torch.int32), sdf0.view(torch.int32))
    assert torch.equal(args[1], un0)
    return (ks, ku), (ps, pu)


@pytest.mark.cuda
@pytest.mark.parametrize("roi", ["full", "roi"])
@pytest.mark.parametrize("projection", ["pinhole", "ortho"])
@pytest.mark.parametrize("trunc", [False, True], ids=["no-trunc", "trunc"])
@pytest.mark.parametrize("outside", ["NONE", "MAX"])
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
@pytest.mark.parametrize("interp", ["NN", "BILINEAR"])
def test_exact_kernel_equals_fold_views_on_gpu(cuda_device, interp, rule,
                                               outside, trunc, projection,
                                               roi):
    """Kernel E == ``fusion.fold_views`` bit for bit on a ragged grid with
    voxels behind the camera, at z_cam == 0, outside the image and frozen,
    for every option the launch takes."""
    *args, max_sdfs = _exact_case(projection, cuda_device)
    opt = _exact_opt(interp, rule, outside, trunc)
    (ks, ku), (ps, pu) = _fold_on_gpu_and_plain(args, max_sdfs,
                                                _exact_roi(roi), opt,
                                                projection)
    assert torch.equal(ku, pu)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    assert bool((ku != args[1]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
def test_exact_kernel_over_many_views_and_tiles_on_gpu(cuda_device, rule):
    """More views than a CTA holds coefficients for at once (the chunks of
    64), and a grid of several tiles along every axis with ragged edges."""
    *args, max_sdfs = _exact_case("pinhole", cuda_device, n_views=70,
                                  shape=(19, 17, 70), h=60, w=80)
    opt = dataclasses.replace(
        _exact_opt("BILINEAR", rule, "NONE", rule != "MAX"),
        voxel_max_update_num=255)
    roi = _exact_roi("full", 60, 80)
    (ks, ku), (ps, pu) = _fold_on_gpu_and_plain(args, max_sdfs, roi, opt,
                                                "pinhole")
    assert torch.equal(ku, pu)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    # the views past the first chunk change the state
    first = exact_fold(*args[:5], *(t[:64] for t in args[5:]),
                       max_sdfs[:64], roi, opt)
    assert not (torch.equal(first[1], ku)
                and torch.equal(first[0].view(torch.int32),
                                ks.view(torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("debug", [False, True])
def test_carve_views_launches_the_exact_kernel_on_gpu(cuda_device, debug):
    """``carve_views`` on a CUDA state folds through E once per call, with
    ``debug`` as without, to ``fold_views``' state, and counts the
    views."""
    sdf, un, _, _, _, w2c, pp, fl, imgs, _ = _exact_case("pinhole",
                                                         cuda_device)
    grid = _exact_grid("pinhole")
    state = VoxelGridState(sdf, un)
    before = (exact_fold.launches, exact_fold.views,
              fusion.carve_views.views)
    got = fusion.carve_views(state, grid, w2c, pp, fl, imgs, debug=debug)
    ref = fusion.fold_views(sdf, un, grid.centers_zyx(cuda_device), w2c, pp,
                            fl, imgs, imgs.amax(dim=(1, 2)),
                            (0, 0, imgs.shape[2] - 1, imgs.shape[1] - 1),
                            cfg.VoxelUpdateOption())
    torch.cuda.synchronize()
    assert (exact_fold.launches, exact_fold.views,
            fusion.carve_views.views) == (
        before[0] + 1, before[1] + w2c.shape[0], before[2] + w2c.shape[0])
    assert torch.equal(got.update_num, ref[1])
    assert torch.equal(got.sdf.view(torch.int32), ref[0].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(2,), (2, 2)], ids=["z", "zy"])
def test_sharded_exact_carve_launches_the_exact_kernel_per_block_on_gpu(
        cuda_device, mesh_shape):
    """``carve_views_sharded`` on the one card folds each block through E
    once, with the block's own axis centres, and the blocks gather to the
    dense plain fold bit for bit (blocks of 7 z by 11 y: no multiple of
    E's tiling)."""
    from vacancy_tpu_torch import parallel as tpar

    shape = (14, 22, 45)
    sdf, un, _, _, _, w2c, pp, fl, imgs, max_sdfs = _exact_case(
        "pinhole", cuda_device, shape=shape)
    grid = _exact_grid("pinhole", shape)
    opt = _exact_opt("BILINEAR", "WEIGHTED_AVERAGE", "MAX", True)
    roi = _exact_roi("partial")
    n_blocks = int(np.prod(mesh_shape))
    mesh = tpar.make_device_mesh(shape=mesh_shape,
                                 devices=[cuda_device] * n_blocks)
    before = (exact_fold.launches, exact_fold.views)
    out = tpar.carve_views_sharded(VoxelGridState(sdf, un), grid, w2c, pp,
                                   fl, imgs, roi=roi, opt=opt, mesh=mesh)
    assert (exact_fold.launches, exact_fold.views) == (
        before[0] + n_blocks, before[1] + n_blocks * w2c.shape[0])
    got = out.gather()
    ref = fusion.fold_views(sdf, un, grid.centers_zyx(cuda_device), w2c, pp,
                            fl, imgs, max_sdfs, roi, opt)
    torch.cuda.synchronize()
    assert torch.equal(got.update_num, ref[1])
    assert torch.equal(got.sdf.view(torch.int32), ref[0].view(torch.int32))
    assert bool((ref[1] != un).any())


@pytest.mark.cuda
def test_exact_kernel_refuses_before_launch_on_gpu(cuda_device):
    """A ROI outside the image is refused with a ValueError before any
    launch; so are a wrong dtype and a wrong per-view shape."""
    *args, max_sdfs = _exact_case("pinhole", cuda_device)
    before = exact_fold.launches
    opt = cfg.VoxelUpdateOption()
    with pytest.raises(ValueError, match="roi"):
        exact_fold(*args, max_sdfs, (0, 0, 53, 36), opt)
    with pytest.raises(TypeError):
        exact_fold(args[0].double(), *args[1:], max_sdfs,
                   _exact_roi("full"), opt)
    with pytest.raises(ValueError, match="max_sdfs"):
        exact_fold(*args, max_sdfs[:-1], _exact_roi("full"), opt)
    assert exact_fold.launches == before


@pytest.mark.cuda
def test_exact_kernel_tiling_matches_the_build_on_gpu(cuda_device):
    """The built kernel's tiling is the wrapper's, its 32 variants keep to
    the register budget of four CTAs per SM, and none spills."""
    lib = _kernels.load()
    assert tuple(lib.vt_exact_tiling(i) for i in range(4)) == (
        exact_fused.TILE_X, exact_fused.TILE_Y, exact_fused.VPT,
        exact_fused.THREADS)
    assert 0 < lib.vt_exact_tiling(4) <= exact_fused.REGISTER_BUDGET
    assert lib.vt_exact_tiling(5) == 0
