"""The port's exact fusion engine (``ops/fusion.py``) vs the JAX package's
``carve_views`` and ``carve_masks`` on identical numpy inputs.

Bars. Nearest-neighbour sampling with the MAX rule: update_num exact and
sdf bitwise. Otherwise XLA on the CPU contracts the bilinear blend and
the weighted average into FMAs, so sdf differs by |d| <= 2e-6 (values
are band-normalized, within 17 ulp of 1.0) with the same finite pattern,
and update_num may differ on at most 1% of the voxels under the MAX
rule: ties, where a blend of saturated taps (truncated SDF values of
exactly 1) rounds to 1 in one package and one ulp off it in the other,
flipping ``dist > sdf``. Measured on the scenes below: up to 86 of 13,824
voxels, all with equal sdf to within 1.2e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacancy_tpu import camera as jcam
from vacancy_tpu import grid as jgrid
from vacancy_tpu.ops import fusion as jfusion
from vacancy_tpu.synthetic import look_at
from vacancy_tpu_torch import camera as tcam
from vacancy_tpu_torch import config as tcfg
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch.ops import fusion as tfusion
from vacancy_tpu_torch.ops.sdf2d import make_signed_distance_field

from test_torch_warp import _initial_state, _opts, _scene


def _rot(ax, ang):
    c, s = np.cos(ang), np.sin(ang)
    m = np.eye(4)
    if ax == "z":
        m[:2, :2] = [[c, -s], [s, c]]
    else:  # x
        m[1:3, 1:3] = [[c, -s], [s, c]]
    return m


def _ortho_scene(n_views=3, zmin=0.5):
    """tests/test_warp_ortho.py's scene: a 26 x 16 x 8 grid of unit
    voxels, slightly rotated orthographic views, disc silhouettes."""
    spec = ((2.0, 3.0, zmin), (28.1, 19.1, zmin + 8.1), 1.0)
    h, w = 24, 32
    cams = []
    for i in range(n_views):
        c2w = _rot("z", 0.12 * i) @ _rot("x", 0.08 * i)
        c2w[:3, 3] = [0.4 * i, -0.3 * i, -2.0 * i]
        cams.append(jcam.OrthoCamera.create(w, h, c2w=c2w))
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.stack([
        (((xx - 18) ** 2 + (yy - 12) ** 2) < (7 + i) ** 2).astype(np.uint8)
        * 255 for i in range(n_views)])
    return spec, jcam.stack_cameras(cams), masks


def _sdf_images(masks, trunc):
    return make_signed_distance_field(
        torch.from_numpy(masks), use_truncation=trunc, truncation_band=0.3
    ).numpy()


def _case(projection, behind=False, trunc=False):
    """(grid spec, w2c, pp, fl, images, initial state) of one scene."""
    if projection == "pinhole":
        spec, w2c, pp, fl, imgs = _scene(trunc=trunc)
        if behind:  # view 0 from inside the grid: z_world < -1 is behind
            c2w = look_at(np.array([0.1, 0.1, -1.0]),
                          np.array([0.1, 0.1, 0.5]))
            w2c[0] = np.linalg.inv(c2w).astype(np.float32)
    else:
        spec, cams, masks = _ortho_scene(zmin=-4.5 if behind else 0.5)
        w2c = np.array(cams.w2c)
        pp = fl = np.zeros((w2c.shape[0], 2), np.float32)
        imgs = _sdf_images(masks, trunc)
    nx, ny, nz = tgrid.GridSpec(*spec).voxel_num
    return spec, w2c, pp, fl, imgs, _initial_state((nz, ny, nx))


def _run_both(case, kw, roi=None, projection="pinhole"):
    spec, w2c, pp, fl, imgs, (sdf0, un0) = case
    topt, jopt = _opts(**kw)
    t = tfusion.carve_views(
        tgrid.state_from_numpy(sdf0, un0, "cpu"), tgrid.GridSpec(*spec),
        torch.from_numpy(w2c), torch.from_numpy(pp), torch.from_numpy(fl),
        torch.from_numpy(imgs), roi, topt, projection,
    )
    j = jfusion.carve_views(
        jgrid.VoxelGridState(sdf=jnp.asarray(sdf0),
                             update_num=jnp.asarray(un0)),
        jgrid.GridSpec(*spec), jnp.asarray(w2c), jnp.asarray(pp),
        jnp.asarray(fl), jnp.asarray(imgs), roi, jopt, projection,
    )
    return (tgrid.state_to_numpy(t),
            (np.asarray(j.sdf), np.asarray(j.update_num)), un0)


def _assert_close(t, j, un0, exact: bool):
    (ts, tu), (js, ju) = t, j
    assert (tu != un0).mean() > 0.05  # the scene fuses something
    if exact:
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(ts.view(np.int32), js.view(np.int32))
        return
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    fin = np.isfinite(ts)
    assert np.abs(ts[fin] - js[fin]).max(initial=0.0) <= 2e-6
    assert (tu != ju).mean() <= 0.01


@pytest.mark.parametrize("interp", ["NN", "BILINEAR"])
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
@pytest.mark.parametrize("projection", ["pinhole", "ortho"])
def test_carve_views_matches_jax(projection, rule, interp):
    kw = dict(voxel_update=tcfg.VoxelUpdate[rule],
              sdf_interp=tcfg.SdfInterpolation[interp])
    t, j, un0 = _run_both(_case(projection), kw, projection=projection)
    _assert_close(t, j, un0, exact=(rule, interp) == ("MAX", "NN"))
    if rule == "WEIGHTED_AVERAGE":
        np.testing.assert_array_equal(t[1], j[1])


@pytest.mark.parametrize("projection", ["pinhole", "ortho"])
def test_carve_views_roi_and_outside_max_match_jax(projection):
    roi = (6, 4, 33, 27) if projection == "pinhole" else (3, 2, 27, 20)
    kw = dict(update_outside=tcfg.UpdateOutsideImage.MAX,
              sdf_interp=tcfg.SdfInterpolation.NN)
    t, j, un0 = _run_both(_case(projection), kw, roi, projection)
    _assert_close(t, j, un0, exact=True)


@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
@pytest.mark.parametrize("projection", ["pinhole", "ortho"])
def test_carve_views_cap_and_truncation_match_jax(projection, rule):
    kw = dict(voxel_update=tcfg.VoxelUpdate[rule], voxel_max_update_num=2,
              use_truncation=True, truncation_band=0.3)
    case = _case(projection, trunc=True)
    assert (case[4] == tcfg.INVALID_SDF).any()
    t, j, un0 = _run_both(case, kw, projection=projection)
    _assert_close(t, j, un0, exact=False)
    assert (t[1][un0 > 2] == un0[un0 > 2]).all()  # frozen above the cap


@pytest.mark.parametrize("projection", ["pinhole", "ortho"])
def test_carve_views_skips_voxels_behind_the_camera(projection):
    spec, w2c, pp, fl, imgs, (sdf0, un0) = _case(projection, behind=True)
    pos = tgrid.GridSpec(*spec).centers_zyx("cpu").numpy()
    z_cam = pos.astype(np.float64) @ w2c[0, 2, :3] + w2c[0, 2, 3]
    assert (z_cam < 0).any() and (z_cam > 0).any()  # both regions real
    assert np.abs(z_cam).min() > 0.01
    kw = dict(sdf_interp=tcfg.SdfInterpolation.NN,
              update_outside=tcfg.UpdateOutsideImage.MAX)
    view0 = (spec, w2c[:1], pp[:1], fl[:1], imgs[:1],
             (sdf0, np.zeros_like(un0)))
    t, j, _ = _run_both(view0, kw, projection=projection)
    _assert_close(t, j, np.full_like(un0, -1), exact=True)
    # outside=MAX writes every voxel in front of the camera, none behind
    np.testing.assert_array_equal(t[1] == 1, z_cam > 0)


def _cameras(projection):
    """The same stacked camera in both packages, and the silhouettes."""
    if projection == "pinhole":
        cams = [jcam.PinholeCamera.create(
            40, 32, c2w=look_at(np.array([4 * np.sin(a), 0.7,
                                          -4 * np.cos(a)]), np.zeros(3)),
            principal_point=np.array([19.5, 15.5], np.float32),
            focal_length=np.array([30.0, 30.0], np.float32))
            for a in (0.3, 2.4, 4.5)]
        j = jcam.stack_cameras(cams)
        t = tcam.from_numpy(np.asarray(j.principal_point),
                            np.asarray(j.focal_length), np.asarray(j.c2w),
                            np.asarray(j.w2c), j.width, j.height, "cpu")
        yy, xx = np.mgrid[0:32, 0:40]
        masks = np.stack([
            (((xx - 20) ** 2 + (yy - 16) ** 2) < (8 + i) ** 2) * 255
            for i in range(3)]).astype(np.uint8)
        spec = ((-1.0, -1.0, -1.0), (1.04,) * 3, 0.1)
        return spec, j, t, masks
    spec, j, masks = _ortho_scene()
    t = tcam.ortho_from_numpy(np.asarray(j.c2w), np.asarray(j.w2c), 32, 24,
                              "cpu")
    return spec, j, t, masks


@pytest.mark.parametrize("single", [False, True], ids=["batch", "one"])
@pytest.mark.parametrize("projection", ["pinhole", "ortho"])
def test_carve_masks_matches_jax(projection, single):
    spec, jc, tc, masks = _cameras(projection)
    if single:
        masks = masks[0]
    topt, jopt = _opts(voxel_update=tcfg.VoxelUpdate.WEIGHTED_AVERAGE,
                       use_truncation=True, truncation_band=0.4)
    grid_t, grid_j = tgrid.GridSpec(*spec), jgrid.GridSpec(*spec)
    t, t_img = tfusion.carve_masks(
        tgrid.VoxelGridState.create(grid_t, "cpu"), grid_t, tc,
        torch.from_numpy(masks), opt=topt)
    j, j_img = jfusion.carve_masks(jgrid.VoxelGridState.create(grid_j),
                                   grid_j, jc, jnp.asarray(masks), opt=jopt)
    np.testing.assert_array_equal(t_img.numpy(), np.asarray(j_img))
    _assert_close(tgrid.state_to_numpy(t),
                  (np.asarray(j.sdf), np.asarray(j.update_num)),
                  np.zeros(grid_t.shape_zyx, np.int32), exact=False)
    np.testing.assert_array_equal(t.update_num.numpy(),
                                  np.asarray(j.update_num))


def test_debug_fold_flags_nan():
    """debug=True: a NaN in the SDF images or in the folded state (here
    carried through the weighted-average update) raises
    FloatingPointError; a clean fold passes."""
    spec, w2c, pp, fl, imgs, (sdf0, un0) = _case("pinhole")
    grid = tgrid.GridSpec(*spec)
    args = (torch.from_numpy(w2c), torch.from_numpy(pp), torch.from_numpy(fl))
    wavg = tcfg.VoxelUpdateOption(
        voxel_update=tcfg.VoxelUpdate.WEIGHTED_AVERAGE)
    st = tgrid.state_from_numpy(sdf0, un0, "cpu")
    tfusion.carve_views(st, grid, *args, torch.from_numpy(imgs), opt=wavg,
                        debug=True)
    bad = imgs.copy()
    bad[:, 10:20, 10:30] = np.nan
    with pytest.raises(FloatingPointError, match="SDF images"):
        tfusion.carve_views(st, grid, *args, torch.from_numpy(bad),
                            debug=True)
    poisoned = sdf0.copy()
    poisoned[un0 > 0] = np.nan
    with pytest.raises(FloatingPointError, match="fusion state"):
        tfusion.carve_views(tgrid.state_from_numpy(poisoned, un0, "cpu"),
                            grid, *args, torch.from_numpy(imgs), opt=wavg,
                            debug=True)


def test_plain_fold_debug_flags_nan_per_view():
    """``fold_views(debug=True)``, the plain fold, checks each view: a NaN
    sampled from an image names the view's sampled distance, one in the
    state the view's fusion state; a clean fold passes."""
    spec, w2c, pp, fl, imgs, (sdf0, un0) = _case("pinhole")
    grid = tgrid.GridSpec(*spec)
    views = (torch.from_numpy(w2c), torch.from_numpy(pp),
             torch.from_numpy(fl))
    roi = (0, 0, imgs.shape[2] - 1, imgs.shape[1] - 1)
    wavg = tcfg.VoxelUpdateOption(
        voxel_update=tcfg.VoxelUpdate.WEIGHTED_AVERAGE)
    centers = grid.centers_zyx("cpu")

    def fold(sdf, images, opt=tcfg.VoxelUpdateOption()):
        t = torch.from_numpy(images)
        return tfusion.fold_views(
            torch.from_numpy(sdf), torch.from_numpy(un0), centers, *views,
            t, t.amax(dim=(1, 2)), roi, opt, debug=True)

    fold(sdf0, imgs, wavg)
    bad = imgs.copy()
    bad[:, 10:20, 10:30] = np.nan
    with pytest.raises(FloatingPointError, match="view 0: sampled distance"):
        fold(sdf0, bad)
    poisoned = sdf0.copy()
    poisoned[un0 > 0] = np.nan
    with pytest.raises(FloatingPointError, match="view 0: fusion state"):
        fold(poisoned, imgs, wavg)
