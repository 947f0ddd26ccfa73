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

import numpy as np
import pytest
import torch

from vacancy_tpu_torch import _kernels, profile_turntable
from vacancy_tpu_torch import config as cfg
from vacancy_tpu_torch.grid import GridSpec, VoxelGridState
from vacancy_tpu_torch.ops import fusion_warp, mc_fused, warp_fused
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


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    args = [t.to("meta") for t in _warp_case((4, 5, 6), 2, "cpu")]
    with pytest.raises(ValueError, match="CUDA"):
        warp_fused.warp_fuse_planes(*args, cfg.VoxelUpdateOption(), True)
    with pytest.raises(ValueError, match="CUDA"):
        mc_fused.marching_cubes_fused(*args[:5])
    tables, pos = _rows_case(True, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        interp_rows(tables, pos, tables.shape[2], share_table=True)


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


@pytest.mark.parametrize("facade", [False, True], ids=["turntable", "facade"])
def test_profile_refuses_a_cpu_device(facade):
    with pytest.raises(ValueError, match="CUDA"):
        if facade:
            profile_turntable.profile_facade(8, 2, 64, 48, "cpu")
        else:
            profile_turntable.profile_turntable(8, 2, "cpu")


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
def test_profile_sees_both_kernels_on_gpu(cuda_device):
    out = profile_turntable.profile_turntable(32, 4, cuda_device)
    names = " ".join(s["name"] for s in out["spans"])
    assert "warp_fused" in names and "mc_emit" in names
    assert 0 < out["device_s"] < out["wall_s"]
    assert out["carve_s"] > 0 and out["extract_s"] > 0


@pytest.mark.cuda
def test_profile_facade_sees_kernel_c_on_gpu(cuda_device):
    """Views of 2000 rows take the two-pass engine: the facade's profile
    shows kernel C and no fused warp kernel."""
    before = interp_rows.launches
    out = profile_turntable.profile_facade(32, 2, 96, 2000, cuda_device)
    names = " ".join(s["name"] for s in out["spans"])
    assert "interp_rows" in names and "warp_fused" not in names
    assert interp_rows.launches == before + 2 * (2 * 2)  # warm-up + profiled
    assert 0 < out["device_s"] < out["wall_s"]


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


@pytest.mark.cuda
def test_tall_views_take_the_two_pass_engine_on_gpu(cuda_device):
    """2160 rows exceed the fused kernel's shared memory on an H100:
    carve_views_warp picks the two-pass engine (kernel C) by shape, and
    the fused kernel's wrapper refuses such views with the row limit."""
    grid, (w2c, pp, fl, imgs) = _tall_case(cuda_device)
    optin = warp_fused.smem_optin_bytes(cuda_device)
    assert not warp_fused.fused_fits(2160, optin)
    st = VoxelGridState.create(grid, cuda_device)
    before = (warp_fused.warp_fuse_planes.launches, interp_rows.launches)
    out = fusion_warp.carve_views_warp(st, grid, w2c, pp, fl, imgs)
    assert warp_fused.warp_fuse_planes.launches == before[0]
    assert interp_rows.launches == before[1] + 2 * 2
    centers = [grid.axis_centers_t(a, cuda_device) for a in range(3)]
    ps, pu = warp_fuse_planes_plain(st.sdf, st.update_num, *centers, w2c, pp,
                                    fl, imgs, cfg.VoxelUpdateOption(), True)
    torch.cuda.synchronize()
    assert torch.equal(out.update_num, pu) and bool((pu > 0).any())
    assert torch.equal(out.sdf.view(torch.int32), ps.view(torch.int32))
    limit = warp_fused.max_fused_rows(optin)
    with pytest.raises(ValueError, match=f"at most {limit} rows"):
        warp_fused.warp_fuse_planes(st.sdf, st.update_num, *centers, w2c, pp,
                                    fl, imgs, cfg.VoxelUpdateOption(), True)
    assert warp_fused.warp_fuse_planes.launches == before[0]
