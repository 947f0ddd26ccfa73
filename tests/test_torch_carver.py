"""The port's ``VoxelCarver`` facade vs the JAX package's, driven with
the same numpy silhouettes, cameras and options, and the option
converter.

Bars: SDF images bitwise. Exact-engine states as in test_torch_fusion
(|dsdf| <= 2e-6, update_num on at most 1% of the voxels: MAX ties at
saturated values); warp-engine states as in test_torch_warp (update_num
on at most 1e-4 of the voxels, |dsdf| <= 1e-5 where it agrees). Meshes
are compared on one state, the JAX carver's loaded into the port's:
voxel meshes equal array for array, the iso-surface within the MC bar of
test_torch_pipeline (faces exact, vertices within one ulp of the grid's
extent)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacancy_tpu import camera as jcam
from vacancy_tpu import carver as jcarver
from vacancy_tpu import config as jcfg
from vacancy_tpu import synthetic as jsyn
from vacancy_tpu_torch import VoxelCarver, VoxelCarverOption
from vacancy_tpu_torch import camera as tcam
from vacancy_tpu_torch import config as tcfg
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch.ops import fusion_warp
from vacancy_tpu_torch.pipeline import turntable_grid

from test_torch_fusion import _ortho_scene, _rot

N, VIEWS, H, W = 24, 4, 48, 64


def _options(**update):
    grid = turntable_grid(N)
    j = jcfg.VoxelCarverOption(
        bb_min=grid.bb_min, bb_max=grid.bb_max, resolution=grid.resolution,
        update_option=jcfg.VoxelUpdateOption(**update))
    return j, tcfg.carver_option_from(j)


def _pinhole():
    """(JAX cameras, port cameras, uint8 silhouettes [V, H, W])."""
    cams = jsyn.turntable_cameras(VIEWS, radius=3.2, width=W, height=H)
    masks = jsyn.render_silhouettes(cams, *jsyn.blob_spheres(seed=3))
    t = [tcam.from_numpy(np.asarray(c.principal_point),
                         np.asarray(c.focal_length), np.asarray(c.c2w),
                         np.asarray(c.w2c), c.width, c.height, "cpu")
         for c in cams]
    return cams, t, np.asarray(masks)


def _ortho(rolled=False):
    spec, cams, masks = _ortho_scene(n_views=1 if rolled else 3)
    w2c = np.array(cams.w2c)
    if rolled:  # tests/test_warp_ortho.py's 90-degree roll, re-translated
        w2c = np.einsum("ij,vjk->vik", _rot("z", np.pi / 2), w2c)
        w2c[:, :3, 3] = [22.0, -3.0, 0.0]
        w2c = w2c.astype(np.float32)
    c2w = np.linalg.inv(w2c).astype(np.float32)
    j = [jcam.OrthoCamera(c2w=jnp.asarray(c), w2c=jnp.asarray(m), width=32,
                          height=24) for c, m in zip(c2w, w2c)]
    t = [tcam.ortho_from_numpy(c, m, 32, 24, "cpu") for c, m in zip(c2w, w2c)]
    opt = jcfg.VoxelCarverOption(bb_min=spec[0], bb_max=spec[1],
                                 resolution=spec[2])
    return j, t, masks, opt


def _carvers(jopt):
    jc = jcarver.VoxelCarver(jopt)
    tc = VoxelCarver(tcfg.carver_option_from(jopt), "cpu")
    assert jc.init() and tc.init()
    return jc, tc


def _states(jc, tc):
    return (tgrid.state_to_numpy(tc.state),
            (np.asarray(jc.state.sdf), np.asarray(jc.state.update_num)))


def _assert_close(t, j, engine):
    (ts, tu), (js, ju) = t, j
    assert (tu > 0).mean() > 0.05  # the scene fuses something
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    agree = tu == ju
    if engine == "exact":
        assert (~agree).mean() <= 0.01
        fin = np.isfinite(ts)
        assert np.abs(ts[fin] - js[fin]).max(initial=0.0) <= 2e-6
    else:
        assert (~agree).mean() <= 1e-4
        both = agree & np.isfinite(ts)
        assert np.abs(ts[both] - js[both]).max(initial=0.0) <= 1e-5


@pytest.mark.parametrize("engine", ["exact", "warp"])
def test_carve_one_view_matches_jax(engine):
    """Per-view carve from a silhouette and from an SDF image; both
    return the view's SDF image."""
    jopt, _ = _options(voxel_update=jcfg.VoxelUpdate.WEIGHTED_AVERAGE,
                       use_truncation=True, truncation_band=0.3)
    jcams, tcams, masks = _pinhole()
    jc, tc = _carvers(jopt)
    for i in range(VIEWS - 1):
        j_img = jc.carve(jcams[i], silhouette=masks[i], engine=engine)
        t_img = tc.carve(tcams[i], silhouette=masks[i], engine=engine)
        np.testing.assert_array_equal(t_img, j_img)
    sdf_img = np.array(j_img)
    j_img = jc.carve(jcams[-1], sdf=sdf_img, engine=engine)
    t_img = tc.carve(tcams[-1], sdf=sdf_img, engine=engine, debug=True)
    np.testing.assert_array_equal(t_img, j_img)
    _assert_close(*_states(jc, tc), engine)


@pytest.mark.parametrize("roi", [None, ((5, 3), (57, 44))], ids=["full", "roi"])
@pytest.mark.parametrize("engine", ["exact", "warp"])
@pytest.mark.parametrize("camera", ["pinhole", "ortho"])
def test_carve_batch_matches_jax(camera, engine, roi):
    if camera == "pinhole":
        jopt, _ = _options()
        jcams, tcams, masks = _pinhole()
    else:
        jcams, tcams, masks, jopt = _ortho()
        roi = roi and ((3, 2), (27, 20))
    jc, tc = _carvers(jopt)
    kw = dict(engine=engine)
    if roi:
        kw.update(roi_min=roi[0], roi_max=roi[1])
    j_imgs = jc.carve_batch(jcams, masks, **kw)
    t_imgs = tc.carve_batch(tcams, masks, **kw)
    np.testing.assert_array_equal(t_imgs, j_imgs)
    _assert_close(*_states(jc, tc), engine)


def test_rolled_ortho_camera_takes_the_exact_engine(monkeypatch):
    """|w2c[1,1]| < 1e-2: both packages' warp engines hand the batch to
    the exact engine, so the two states are the exact engine's, and the
    two-pass engine never runs."""
    jcams, tcams, masks, jopt = _ortho(rolled=True)
    assert max(abs(float(c.w2c[1, 1])) for c in tcams) < 1e-2
    jc, tc = _carvers(jopt)
    jc.carve_batch(jcams, masks, engine="warp")
    calls = []
    monkeypatch.setattr(fusion_warp, "warp_fold",
                        lambda *a, **k: calls.append(a))
    tc.carve_batch(tcams, masks, engine="warp")
    assert not calls
    t, j = _states(jc, tc)
    _assert_close(t, j, "exact")
    ex = VoxelCarver(tc.option, "cpu")
    assert ex.init()
    ex.carve_batch(tcams, masks, engine="exact")
    np.testing.assert_array_equal(ex.state.sdf.numpy(), t[0])
    np.testing.assert_array_equal(ex.state.update_num.numpy(), t[1])


def _fused_jax_carver():
    jopt, _ = _options(voxel_update=jcfg.VoxelUpdate.WEIGHTED_AVERAGE,
                       use_truncation=True, truncation_band=0.3)
    jcams, _, masks = _pinhole()
    jc, tc = _carvers(jopt)
    jc.carve_batch(jcams, masks, engine="warp")
    tc.state = tgrid.state_from_numpy(np.asarray(jc.state.sdf),
                                      np.asarray(jc.state.update_num), "cpu")
    return jc, tc


@pytest.mark.parametrize("inside_empty", [False, True])
def test_extract_voxel_matches_jax(inside_empty):
    jc, tc = _fused_jax_carver()
    jm = jc.extract_voxel(inside_empty=inside_empty)
    tm = tc.extract_voxel(inside_empty=inside_empty)
    assert tm.num_faces > 0
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.faces, jm.faces)


def test_extract_iso_surface_matches_jax():
    jc, tc = _fused_jax_carver()
    jm = jc.extract_iso_surface(engine="xla")
    tm = tc.extract_iso_surface(debug=True)
    assert jm.num_faces > 100
    np.testing.assert_array_equal(tm.faces, jm.faces)
    np.testing.assert_allclose(tm.vertices, jm.vertices, rtol=0,
                               atol=np.spacing(np.float32(1.1)))
    with pytest.raises(ValueError, match="unknown engine"):
        tc.extract_iso_surface(engine="pallas")


def test_carver_option_converter():
    j = jcfg.VoxelCarverOption(
        bb_min=(-1.0, -2.0, -3.0), bb_max=(1.0, 2.5, 3.0), resolution=0.25,
        sdf_minmax_normalize=False, sdf_scale=0.01,
        update_option=jcfg.VoxelUpdateOption(
            voxel_update=jcfg.VoxelUpdate.WEIGHTED_AVERAGE,
            sdf_interp=jcfg.SdfInterpolation.NN,
            update_outside=jcfg.UpdateOutsideImage.MAX,
            voxel_max_update_num=7, voxel_update_weight=0.5,
            use_truncation=True, truncation_band=0.2,
            metric_truncation=True))
    t = tcfg.carver_option_from(j)
    assert isinstance(t, VoxelCarverOption)
    assert t.update_option == tcfg.update_option_from(j.update_option)

    def named(v):
        return v.name if hasattr(v, "name") else v

    for outer, inner in ((t, j), (t.update_option, j.update_option)):
        for f in dataclasses.fields(inner):
            if f.name != "update_option":
                assert named(getattr(outer, f.name)) == \
                    named(getattr(inner, f.name)), f.name
    assert tcfg.carver_option_from(jcfg.VoxelCarverOption()) == \
        VoxelCarverOption()


def test_carver_needs_a_device_and_valid_options():
    with pytest.raises(ValueError, match="device"):
        VoxelCarver(VoxelCarverOption(bb_max=(1.0, 1.0, 1.0))).init()
    bad = VoxelCarver(VoxelCarverOption(), "cpu")  # empty bounding box
    assert not bad.init()
    ok = VoxelCarver(VoxelCarverOption(bb_max=(1.0, 1.0, 1.0)))
    assert ok.init(torch.device("cpu"))
    assert ok.state.sdf.shape == (10, 10, 10)
