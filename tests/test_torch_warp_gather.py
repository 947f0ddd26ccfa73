"""The port's row sampler (kernel C's plain version), the rule by which
the warp engines are chosen, and the two-pass engine and views of 2200
rows vs the JAX package on identical numpy inputs.

Bars: nearest-neighbour samples bitwise; linear samples within one ulp
of the larger of their two taps, since XLA on the CPU contracts the
blend ``(1 - frac) * t0 + frac * t1`` into an FMA (up to ~1e2 ulp of a
result near zero). The two-pass fold as in test_torch_warp: update_num
may differ on at most 1e-4 of the voxels, |dsdf| <= 1e-5 where it
agrees. Kernel C itself runs only on a card (tests/test_torch_kernels.py),
where it must equal the plain version bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacancy_tpu import config as jcfg
from vacancy_tpu import grid as jgrid
from vacancy_tpu.ops.fusion_warp import carve_views_warp as j_carve
from vacancy_tpu.ops.warp_gather import interp_rows as j_interp_rows
from vacancy_tpu_torch import config as tcfg
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch.ops import fusion_warp, warp_fused, warp_gather
from vacancy_tpu_torch.ops.sdf2d import make_signed_distance_field
from vacancy_tpu_torch.ops.warp_gather import interp_rows, interp_rows_plain

from test_torch_warp import _assert_close_states, _initial_state, _scene


def _rows_case(share: bool, seed=0, n=3, r=8, w=40, t=16):
    rng = np.random.default_rng(seed)
    tables = rng.normal(size=(1 if share else n, r, w)).astype(np.float32)
    pos = rng.uniform(-1.0, w, size=(n, r, t)).astype(np.float32)
    # the ends of the clipped range and exact integers and half-integers
    pos[:, :, 0] = -1.0
    pos[:, :, 1] = float(w)
    pos[:, :, 2] = np.floor(pos[:, :, 2])
    pos[:, :, 3] = np.floor(pos[:, :, 3]) + 0.5
    return tables, pos


@pytest.mark.parametrize("roi", [None, (5, 30)], ids=["full", "lo-hi"])
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nn"])
@pytest.mark.parametrize("share", [True, False], ids=["shared", "per-n"])
def test_interp_rows_plain_matches_jax(share, linear, roi):
    tables, pos = _rows_case(share)
    w = tables.shape[2]
    lo, hi = roi or (0, None)
    t = interp_rows_plain(torch.from_numpy(tables), torch.from_numpy(pos), w,
                          linear, share, lo, hi).numpy()
    j = np.asarray(j_interp_rows(jnp.asarray(tables), jnp.asarray(pos), w,
                                 linear, share, lo, hi))
    assert t.shape == j.shape == pos.shape
    if not linear:
        np.testing.assert_array_equal(t, j)
        return
    hi_ = w - 1 if hi is None else hi
    p0 = np.clip(np.floor(pos).astype(np.int64), lo, hi_)
    p1 = np.minimum(p0 + 1, hi_)
    n, r = np.indices(pos.shape[:2])
    n = np.zeros_like(n) if share else n
    taps = np.maximum(np.abs(tables[n[..., None], r[..., None], p0]),
                      np.abs(tables[n[..., None], r[..., None], p1]))
    assert np.all(np.abs(t - j) <= np.spacing(taps))
    assert np.mean(t == j) > 0.5


def test_interp_rows_on_cpu_takes_the_plain_version():
    tables, pos = _rows_case(False)
    before = interp_rows.launches
    args = (torch.from_numpy(tables), torch.from_numpy(pos), 40)
    assert torch.equal(interp_rows(*args, lo=3, hi=33),
                       interp_rows_plain(*args, lo=3, hi=33))
    assert interp_rows.launches == before


@pytest.mark.parametrize("lo,hi", [(-1, 10), (5, 4), (0, 40)])
def test_interp_rows_refuses_taps_outside_the_row(lo, hi):
    tables, pos = _rows_case(True)
    with pytest.raises(ValueError, match="taps"):
        interp_rows(torch.from_numpy(tables), torch.from_numpy(pos), 40,
                    lo=lo, hi=hi)


@pytest.mark.parametrize("h", [1816, 1817, 2160, 4320, 8640])
def test_fused_fits_at_the_h100_limit(h):
    """232,448 bytes is an H100 block's shared-memory opt-in limit: the
    fused kernel holds 384 rows of its intermediate at a time and takes
    views of any height, 4K UHD (2160 rows) and 8K (4320) among them."""
    assert warp_fused.fused_refusal(512, 512, 512, h, 3840, 232_448) is None
    assert warp_fused.fused_plan(512, 512, 512, h, 3840,
                                 232_448).inter_rows == 384


@pytest.mark.parametrize("optin,takes", [(232_448, True), (600, False)],
                         ids=["h100", "no-two-rows"])
def test_engine_choice_follows_the_fused_plan(monkeypatch, optin, takes):
    """On a CUDA device the engine is chosen from the card's shared-memory
    opt-in alone, before any launch: an H100 takes 2160-row views to
    kernel A; a card whose blocks hold no two rows of its intermediate
    sends them to the two-pass engine. No card is needed to decide."""
    monkeypatch.setattr(warp_fused, "smem_optin_bytes", lambda dev: optin)
    dev = torch.device("cuda", 0)
    assert fusion_warp._fused_kernel_takes(dev, (512, 512, 512), 2160,
                                           3840) is takes
    assert fusion_warp._fused_kernel_takes(dev, (512, 512, 512), 65536,
                                           65536) is False
    assert fusion_warp._fused_kernel_takes(torch.device("cpu"),
                                           (512, 512, 512), 2160, 3840)


def test_blocked_carve_chooses_the_engine_for_one_chunk(monkeypatch):
    """The z-chunked carve asks for the engine with the shape of one
    z-chunk (18 planes at chunk_nz 4 snap to chunks of 3), once."""
    asked = []

    def takes(device, shape_zyx, h, w):
        asked.append((device.type, tuple(shape_zyx), h, w))
        return True

    monkeypatch.setattr(fusion_warp, "_fused_kernel_takes", takes)
    spec, w2c, pp, fl, imgs = _scene(shape=(18, 9, 10), n_views=2, h=52,
                                     w=44)
    grid = tgrid.GridSpec(*spec)
    assert grid.shape_zyx == (18, 9, 10)
    fusion_warp.carve_views_warp_blocked(
        tgrid.VoxelGridState.create(grid, "cpu"), grid,
        *(torch.from_numpy(a) for a in (w2c, pp, fl, imgs)), chunk_nz=4)
    assert asked == [("cpu", (3, 9, 10), 52, 44)]


def test_sharded_carve_chooses_the_engine_per_block(monkeypatch):
    """The sharded carve asks for the engine with each block's shape:
    two z blocks of a 16 x 9 x 10 grid, 8 planes each."""
    from vacancy_tpu_torch import parallel as tpar

    asked = []

    def takes(device, shape_zyx, h, w):
        asked.append((tuple(shape_zyx), h, w))
        return True

    monkeypatch.setattr(fusion_warp, "_fused_kernel_takes", takes)
    spec, w2c, pp, fl, imgs = _scene(shape=(16, 9, 10), n_views=2, h=52,
                                     w=44)
    grid = tgrid.GridSpec(*spec)
    mesh = tpar.make_device_mesh(shape=(2,), devices=["cpu"] * 2)
    tpar.carve_views_warp_sharded(
        tgrid.VoxelGridState.create(grid, sharding=tpar.grid_sharding(mesh)),
        grid, *(torch.from_numpy(a) for a in (w2c, pp, fl, imgs)),
        mesh=mesh)
    assert asked == [((8, 9, 10), 52, 44)] * 2


@pytest.mark.parametrize("linear", [True, False], ids=["bilinear", "nn"])
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
def test_two_pass_fold_matches_jax(rule, linear):
    """The two-pass engine with ``interp_rows`` (the branch that carries
    views too tall for the fused kernel) on 72-row images vs JAX's
    carve_views_warp, whose CPU path is the same two-pass scan."""
    shape = (20, 22, 24)
    spec, w2c, pp, fl, imgs = _scene(shape=shape, n_views=3, h=72, w=56,
                                     trunc=rule == "WEIGHTED_AVERAGE")
    kw = dict(voxel_update=tcfg.VoxelUpdate[rule],
              update_outside=tcfg.UpdateOutsideImage.MAX,
              use_truncation=rule == "WEIGHTED_AVERAGE", truncation_band=0.3)
    topt = tcfg.VoxelUpdateOption(**kw)
    jopt = jcfg.VoxelUpdateOption(**{
        k: getattr(jcfg, type(v).__name__)[v.name] if hasattr(v, "name")
        else v for k, v in kw.items()})
    sdf0, un0 = _initial_state(shape)
    grid = tgrid.GridSpec(*spec)
    before = (interp_rows.launches, warp_fused.warp_fuse_planes.launches)
    ts, tu = fusion_warp.warp_fold(
        torch.from_numpy(sdf0), torch.from_numpy(un0),
        *(grid.axis_centers_t(a, "cpu") for a in range(3)),
        torch.from_numpy(w2c), torch.from_numpy(pp), torch.from_numpy(fl),
        torch.from_numpy(imgs), topt, linear, None, warp_gather.interp_rows,
    )
    assert (interp_rows.launches,
            warp_fused.warp_fuse_planes.launches) == before
    jst = j_carve(
        jgrid.VoxelGridState(sdf=jnp.asarray(sdf0),
                             update_num=jnp.asarray(un0)),
        jgrid.GridSpec(*spec), jnp.asarray(w2c), jnp.asarray(pp),
        jnp.asarray(fl), jnp.asarray(imgs), opt=jopt, linear=linear,
    )
    _assert_close_states((ts.numpy(), tu.numpy()),
                         (np.asarray(jst.sdf), np.asarray(jst.update_num)))


def _projected_v(spec, w2c):
    """y / z in each camera of every voxel centre, [V, voxels]."""
    grid = tgrid.GridSpec(*spec)
    zz, yy, xx = np.meshgrid(*(grid.axis_centers(a) for a in (2, 1, 0)),
                             indexing="ij")
    pts = np.stack([xx, yy, zz], -1).reshape(-1, 3)
    cam = pts @ np.swapaxes(w2c[:, :3, :3], 1, 2) + w2c[:, None, :3, 3]
    return cam[..., 1] / cam[..., 2]


def _tall_scene(shape, h=2200, w=48, n_views=2):
    """``_scene``'s cameras with a vertical focal length and principal
    point that spread the grid over 80% of ``h`` rows, and the SDFs of
    ellipses stretched to match."""
    spec, w2c, pp, fl, _ = _scene(shape=shape, n_views=n_views, h=h, w=w,
                                  trunc=True)
    yz = _projected_v(spec, w2c)
    span = yz.max(axis=1) - yz.min(axis=1)
    stretch = (0.8 * h / span / fl[:, 1]).astype(np.float32)
    fl[:, 1] *= stretch
    pp[:, 1] = h / 2 - fl[:, 1] * (yz.max(axis=1) + yz.min(axis=1)) / 2
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.stack(
        [(((xx - 20 - i) / (7 + i)) ** 2
          + ((yy - h / 2) / ((7 + i) * stretch[i])) ** 2 < 1) * 255
         for i in range(n_views)]).astype(np.uint8)
    imgs = make_signed_distance_field(
        torch.from_numpy(masks), use_truncation=True,
        truncation_band=0.3).numpy()
    return spec, w2c, pp, fl, imgs


@pytest.mark.parametrize("linear", [True, False], ids=["bilinear", "nn"])
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
def test_tall_views_match_jax(rule, linear):
    """Two views of 2200 x 48 pixels into a 16^3 grid, whose voxels tap
    rows from top to bottom of the images: the port's carve_views_warp
    (on CPU tensors kernel A's plain version; on an H100 kernel A takes
    such views) vs JAX's, whose CPU path is its two-pass scan. Bar of
    test_two_pass_fold_matches_jax, which is exact for update_num at this
    size (1e-4 of 4096 voxels), sdf within 1e-5 (XLA contracts the row
    blend)."""
    shape = (16, 16, 16)
    spec, w2c, pp, fl, imgs = _tall_scene(shape)
    kw = dict(voxel_update=tcfg.VoxelUpdate[rule],
              update_outside=tcfg.UpdateOutsideImage.MAX,
              use_truncation=True, truncation_band=0.3)
    topt = tcfg.VoxelUpdateOption(**kw)
    jopt = jcfg.VoxelUpdateOption(**{
        k: getattr(jcfg, type(v).__name__)[v.name] if hasattr(v, "name")
        else v for k, v in kw.items()})
    sdf0, un0 = _initial_state(shape)
    before = (interp_rows.launches, warp_fused.warp_fuse_planes.launches)
    tst = fusion_warp.carve_views_warp(
        tgrid.state_from_numpy(sdf0, un0, "cpu"), tgrid.GridSpec(*spec),
        *(torch.from_numpy(a) for a in (w2c, pp, fl, imgs)), topt, linear)
    assert (interp_rows.launches,
            warp_fused.warp_fuse_planes.launches) == before
    jst = j_carve(
        jgrid.VoxelGridState(sdf=jnp.asarray(sdf0),
                             update_num=jnp.asarray(un0)),
        jgrid.GridSpec(*spec), jnp.asarray(w2c), jnp.asarray(pp),
        jnp.asarray(fl), jnp.asarray(imgs), opt=jopt, linear=linear,
    )
    ts, tu = tgrid.state_to_numpy(tst)
    np.testing.assert_array_equal(tu, np.asarray(jst.update_num))
    _assert_close_states((ts, tu), (np.asarray(jst.sdf),
                                    np.asarray(jst.update_num)))
    # the voxels project over 80% of each image's rows
    v = fl[:, 1:] * _projected_v(spec, w2c) + pp[:, 1:]
    assert (v.max(axis=1) - v.min(axis=1) > 1700).all()
    assert 0 < v.min() and v.max() < 2200
