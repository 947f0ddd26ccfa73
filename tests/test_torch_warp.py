"""The port's fusion update rule and two-pass warp engine (the fused warp
kernel's plain version) vs the JAX package on identical numpy inputs.

Bars: update_num exact and sdf within 2 ulp for the update rule (XLA on
the CPU may contract the weighted average into an FMA); for the warp,
update_num may differ on at most 1e-4 of the voxels and |dsdf| <= 1e-5
where it agrees, since an ulp in a projected coordinate can move a tap or
a border test on isolated voxels. The kernel itself runs only on a card
(tests/test_torch_kernels.py), where it must match the plain version bit
for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacancy_tpu import config as jcfg
from vacancy_tpu import grid as jgrid
from vacancy_tpu.ops import fusion as jfusion
from vacancy_tpu.ops.fusion_warp import carve_views_warp as j_carve
from vacancy_tpu.synthetic import look_at
from vacancy_tpu_torch import config as tcfg
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch.ops import fusion as tfusion
from vacancy_tpu_torch.ops import warp_fused
from vacancy_tpu_torch.ops.fusion_warp import carve_views_warp as t_carve
from vacancy_tpu_torch.ops.sdf2d import make_signed_distance_field


def _opts(**kw):
    """The same option in both packages (enums mapped by name)."""
    tkw, jkw = {}, {}
    for k, v in kw.items():
        if hasattr(v, "name"):
            tkw[k] = getattr(tcfg, type(v).__name__)[v.name]
            jkw[k] = getattr(jcfg, type(v).__name__)[v.name]
        else:
            tkw[k] = jkw[k] = v
    return tcfg.VoxelUpdateOption(**tkw), jcfg.VoxelUpdateOption(**jkw)


UPDATE_CASES = {
    "max": dict(),
    "max-cap-trunc": dict(voxel_max_update_num=2, use_truncation=True),
    "wavg": dict(voxel_update=tcfg.VoxelUpdate.WEIGHTED_AVERAGE),
    "wavg-w0.7-trunc": dict(
        voxel_update=tcfg.VoxelUpdate.WEIGHTED_AVERAGE,
        voxel_update_weight=0.7, use_truncation=True, truncation_band=0.2,
    ),
    "wavg-metric": dict(
        voxel_update=tcfg.VoxelUpdate.WEIGHTED_AVERAGE, use_truncation=True,
        truncation_band=0.3, metric_truncation=True,
    ),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_apply_view_update_matches_jax(case):
    topt, jopt = _opts(**UPDATE_CASES[case])
    rng = np.random.default_rng(11)
    shape = (6, 7, 9)
    sdf = rng.normal(size=shape).astype(np.float32)
    sdf[rng.random(shape) < 0.1] = tcfg.INVALID_SDF
    un = rng.integers(0, 5, size=shape).astype(np.int32)
    dist = (rng.normal(size=shape) * 1.5).astype(np.float32)
    skip = rng.random(shape) < 0.2
    ts, tu = tfusion.apply_view_update(
        torch.from_numpy(sdf), torch.from_numpy(un), torch.from_numpy(dist),
        torch.from_numpy(skip), topt,
    )
    js, ju = jfusion.apply_view_update(
        jnp.asarray(sdf), jnp.asarray(un), jnp.asarray(dist),
        jnp.asarray(skip), jopt,
    )
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=2)


def _scene(shape=(24, 24, 24), n_views=4, h=32, w=40, trunc=False):
    """Grid, numpy cameras (w2c, pp, fl) and f32 SDF images of discs."""
    nz, ny, nx = shape
    res = 0.1
    spec = ((-1.0, -1.1, -1.2),
            (-1.0 + (nx + 0.4) * res, -1.1 + (ny + 0.4) * res,
             -1.2 + (nz + 0.4) * res), res)
    w2c, pp, fl = [], [], []
    for i in range(n_views):
        ang = 2.0 * np.pi * i / n_views + 0.3
        eye = np.array([4.0 * np.sin(ang), 0.7 - 0.3 * i, -4.0 * np.cos(ang)])
        c2w = look_at(eye, np.array([0.1, 0.0, -0.1]))
        r, t = c2w[:3, :3], c2w[:3, 3]
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = r.T, -r.T @ t
        w2c.append(m.astype(np.float32))
        pp.append(np.array([19.5, 15.5], np.float32))
        fl.append(np.array([52.0 + i, 53.0], np.float32))
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.stack(
        [(((xx - 20 - i) ** 2 + (yy - 16) ** 2) < (7 + i) ** 2) * 255
         for i in range(n_views)]
    ).astype(np.uint8)
    imgs = make_signed_distance_field(
        torch.from_numpy(masks), use_truncation=trunc, truncation_band=0.3
    ).numpy()
    return spec, np.stack(w2c), np.stack(pp), np.stack(fl), imgs


def _initial_state(shape, seed=2):
    """A partly fused state: INVALID and untouched voxels mixed with
    running values and counts (some above a low cap)."""
    rng = np.random.default_rng(seed)
    sdf = rng.normal(size=shape).astype(np.float32)
    un = rng.integers(0, 4, size=shape).astype(np.int32)
    sdf[un == 0] = tcfg.INVALID_SDF
    return sdf, un


def _run_both(spec, w2c, pp, fl, imgs, kw, linear, roi, state0):
    topt, jopt = _opts(**kw)
    sdf0, un0 = state0
    tst = t_carve(
        tgrid.state_from_numpy(sdf0, un0, "cpu"), tgrid.GridSpec(*spec),
        torch.from_numpy(w2c), torch.from_numpy(pp), torch.from_numpy(fl),
        torch.from_numpy(imgs), topt, linear, roi,
    )
    jst = j_carve(
        jgrid.VoxelGridState(sdf=jnp.asarray(sdf0), update_num=jnp.asarray(un0)),
        jgrid.GridSpec(*spec), jnp.asarray(w2c), jnp.asarray(pp),
        jnp.asarray(fl), jnp.asarray(imgs), opt=jopt, linear=linear, roi=roi,
    )
    return tgrid.state_to_numpy(tst), (np.asarray(jst.sdf),
                                       np.asarray(jst.update_num))


def _assert_close_states(t, j):
    (ts, tu), (js, ju) = t, j
    agree = tu == ju
    assert (~agree).mean() <= 1e-4, (~agree).sum()
    both = agree & np.isfinite(ts) & np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    assert np.abs(ts[both] - js[both]).max(initial=0.0) <= 1e-5
    # the scene must actually fuse something
    assert (tu != _initial_state(tu.shape)[1]).mean() > 0.05


@pytest.mark.parametrize("outside", ["NONE", "MAX"])
@pytest.mark.parametrize("linear", [True, False], ids=["bilinear", "nn"])
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
def test_carve_views_warp_matches_jax(rule, linear, outside):
    trunc = rule == "WEIGHTED_AVERAGE"
    spec, w2c, pp, fl, imgs = _scene(trunc=trunc)
    kw = dict(
        voxel_update=tcfg.VoxelUpdate[rule],
        update_outside=tcfg.UpdateOutsideImage[outside],
        use_truncation=trunc, truncation_band=0.3, voxel_max_update_num=5,
    )
    t, j = _run_both(spec, w2c, pp, fl, imgs, kw, linear, None,
                     _initial_state((24, 24, 24)))
    _assert_close_states(t, j)


@pytest.mark.parametrize("outside", ["NONE", "MAX"])
def test_carve_views_warp_roi_matches_jax(outside):
    spec, w2c, pp, fl, imgs = _scene()
    kw = dict(update_outside=tcfg.UpdateOutsideImage[outside])
    t, j = _run_both(spec, w2c, pp, fl, imgs, kw, True, (6, 4, 33, 27),
                     _initial_state((24, 24, 24)))
    _assert_close_states(t, j)


def test_carve_views_warp_unequal_axes_matches_jax():
    shape = (14, 22, 30)
    spec, w2c, pp, fl, imgs = _scene(shape=shape, n_views=3)
    kw = dict(voxel_update=tcfg.VoxelUpdate.WEIGHTED_AVERAGE)
    t, j = _run_both(spec, w2c, pp, fl, imgs, kw, True, None,
                     _initial_state(shape))
    assert t[0].shape == shape
    _assert_close_states(t, j)


def test_single_view_and_wrapper_on_cpu_take_the_plain_version():
    """2-D (single-view) inputs fold like a batch of one; CPU tensors
    never reach the kernel."""
    spec, w2c, pp, fl, imgs = _scene(n_views=2)
    grid = tgrid.GridSpec(*spec)
    opt = tcfg.VoxelUpdateOption()
    before = warp_fused.warp_fuse_planes.launches
    st = tgrid.VoxelGridState.create(grid, "cpu")
    for i in range(2):
        st = t_carve(st, grid, torch.from_numpy(w2c[i]),
                     torch.from_numpy(pp[i]), torch.from_numpy(fl[i]),
                     torch.from_numpy(imgs[i]), opt)
    batch = t_carve(tgrid.VoxelGridState.create(grid, "cpu"), grid,
                    torch.from_numpy(w2c), torch.from_numpy(pp),
                    torch.from_numpy(fl), torch.from_numpy(imgs), opt)
    assert torch.equal(st.sdf, batch.sdf)
    assert torch.equal(st.update_num, batch.update_num)
    assert warp_fused.warp_fuse_planes.launches == before

