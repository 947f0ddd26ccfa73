"""The sweep slice of the port vs the JAX package on identical numpy
inputs: the z-chunked carve, the fused warp kernel's plain version with
orthographic rows, and ``run_sweep``.

Bars: the z-chunked carve is bitwise the port's own unchunked carve (the
warp is separable per z) and sits at test_torch_warp's bar against JAX's
``carve_views_warp_blocked`` (update_num differs on at most 1e-4 of the
voxels, |dsdf| <= 1e-5 where it agrees). The plain version with
``ortho_rows`` against JAX's ``warp_fuse_planes(ortho_rows=...,
interpret=True)``: update_num exact except on voxels whose camera z lies
within 8 ulp of 0 (the Pallas kernel sums ``rz0*x + rz1*y + rz2*z + rt``,
the port, like both packages' two-pass engines, ``rz2*z + rz1*y + rz0*x +
rt``), and |dsdf| <= 3e-5, the bar of the JAX package's own
test_fused_kernel_ortho_equals_scan (XLA on the CPU contracts FMAs
differently in the interpreted kernel). ``run_sweep`` at 32^3 x 6: the
JAX sweep's keys and its vertex and face counts exactly, and vertices
within 1e-4 of a voxel of the JAX mesh's (the two fused states differ by
up to 1e-5 in sdf, test_torch_pipeline's bar, which the interpolation
along an edge scales by the inverse of the sdf step across it)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_warp import _initial_state, _opts, _scene
from vacancy_tpu import camera as jcam
from vacancy_tpu import grid as jgrid
from vacancy_tpu.ops import fusion_warp as jfw
from vacancy_tpu.ops.warp_fused import warp_fuse_planes as j_fuse_planes
from vacancy_tpu.pipeline import run_sweep as j_run_sweep
from vacancy_tpu_torch import config as tcfg
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch import pipeline as tpipe
from vacancy_tpu_torch.ops import fusion_warp as tfw
from vacancy_tpu_torch.ops import mc_fused, warp_fused


def _blocked_both(shape, chunk_nz, kw, linear=True, n_views=3):
    spec, w2c, pp, fl, imgs = _scene(shape=shape, n_views=n_views,
                                     trunc=kw.get("use_truncation", False))
    topt, jopt = _opts(**kw)
    sdf0, un0 = _initial_state(shape)
    cams = [torch.from_numpy(a) for a in (w2c, pp, fl, imgs)]
    whole = tfw.carve_views_warp(
        tgrid.state_from_numpy(sdf0, un0, "cpu"), tgrid.GridSpec(*spec),
        *cams, topt, linear)
    st = tgrid.state_from_numpy(sdf0, un0, "cpu")
    blocked = tfw.carve_views_warp_blocked(
        st, tgrid.GridSpec(*spec), *cams, topt, linear, chunk_nz=chunk_nz)
    jst = jfw.carve_views_warp_blocked(
        jgrid.VoxelGridState(sdf=jnp.asarray(sdf0),
                             update_num=jnp.asarray(un0)),
        jgrid.GridSpec(*spec), jnp.asarray(w2c), jnp.asarray(pp),
        jnp.asarray(fl), jnp.asarray(imgs), opt=jopt, linear=linear,
        chunk_nz=chunk_nz)
    return st, whole, blocked, jst, un0


CASES = {
    "wavg-24-chunk8": ((24, 20, 28), 8,
                       dict(voxel_update=tcfg.VoxelUpdate.WEIGHTED_AVERAGE,
                            use_truncation=True, truncation_band=0.3)),
    "max-21-snaps-to-7": ((21, 20, 28), 8, dict()),
    "max-22-snaps-to-2": ((22, 12, 16), 8,
                          dict(update_outside=tcfg.UpdateOutsideImage.MAX)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_carve_views_warp_blocked_matches_unblocked_and_jax(case):
    shape, chunk_nz, kw = CASES[case]
    st, whole, blocked, jst, un0 = _blocked_both(shape, chunk_nz, kw)
    # in place: the returned state holds the caller's tensors
    assert blocked.sdf is st.sdf and blocked.update_num is st.update_num
    assert torch.equal(blocked.update_num, whole.update_num)
    assert torch.equal(blocked.sdf.view(torch.int32),
                       whole.sdf.view(torch.int32))
    ts, tu = tgrid.state_to_numpy(blocked)
    js, ju = np.asarray(jst.sdf), np.asarray(jst.update_num)
    agree = tu == ju
    assert (~agree).mean() <= 1e-4, (~agree).sum()
    both = agree & np.isfinite(ts) & np.isfinite(js)
    assert np.abs(ts[both] - js[both]).max(initial=0.0) <= 1e-5
    assert (tu != un0).mean() > 0.05


def test_blocked_snaps_to_a_divisor_and_warns_near_a_prime(caplog):
    assert tfw._snap_chunk_nz(1024, 128) == 128
    assert tfw._snap_chunk_nz(21, 8) == 7
    assert tfw._snap_chunk_nz(22, 8) == 2
    import logging

    with caplog.at_level(logging.WARNING, logger="vacancy_tpu_torch"):
        assert tfw._snap_chunk_nz(1021, 128) == 1  # a prime
    assert "no divisor near" in caplog.text


def test_blocked_small_grid_is_one_unblocked_call():
    shape = (8, 10, 12)
    spec, w2c, pp, fl, imgs = _scene(shape=shape, n_views=2)
    grid = tgrid.GridSpec(*spec)
    st = tgrid.VoxelGridState.create(grid, "cpu")
    cams = [torch.from_numpy(a) for a in (w2c[0], pp[0], fl[0], imgs[0])]
    out = tfw.carve_views_warp_blocked(st, grid, *cams)  # one 2-D view
    ref = tfw.carve_views_warp(st, grid, *cams)
    assert out.sdf is not st.sdf  # nz <= chunk_nz: new tensors
    assert torch.equal(out.sdf, ref.sdf)
    assert torch.equal(out.update_num, ref.update_num)


def _ortho_scene(seed=31):
    """The JAX package's ortho kernel test scene
    (tests/test_warp_ortho.py): a 6 x 128 x 128 grid that spans z < 0 of
    three slightly rotated orthographic cameras."""
    rng = np.random.default_rng(seed)
    nz, ny, nx, v = 6, 128, 128, 3
    res = 0.25
    spec = ((-16.0, -16.0, -0.7),
            (-16.0 + (nx + 0.3) * res, -16.0 + (ny + 0.3) * res,
             -0.7 + (nz + 0.3) * res), res)
    h, w = 40, 56

    def rot(ax, ang):
        c, s = np.cos(ang), np.sin(ang)
        m = np.eye(4)
        i, j = {"x": (1, 2), "z": (0, 1)}[ax]
        m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
        return m

    w2cs = []
    for i in range(v):
        c2w = rot("z", 0.1 * i) @ rot("x", 0.06 * i)
        c2w[:3, 3] = [-10.0 - i, -6.0 + i, -1.0 * i]
        w2cs.append(np.asarray(jcam.OrthoCamera.create(w, h, c2w=c2w).w2c))
    imgs = rng.normal(size=(v, h, w)).astype(np.float32)
    return spec, np.stack(w2cs), imgs


@pytest.mark.parametrize("linear", [True, False], ids=["bilinear", "nn"])
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
def test_warp_fuse_planes_ortho_rows_match_jax_interpret(rule, linear):
    spec, w2c, imgs = _ortho_scene()
    topt, jopt = _opts(voxel_update=tcfg.VoxelUpdate[rule])
    tg, jg = tgrid.GridSpec(*spec), jgrid.GridSpec(*spec)
    v = len(w2c)
    # the same numpy w2c gives both packages' synthetic homography and
    # real camera-z rows
    w2c_t = torch.from_numpy(w2c)
    synth, zero2, one2, z_rows = tfw.ortho_homography(w2c_t)
    np.testing.assert_array_equal(z_rows.numpy(), w2c[:, 2, :])
    st = tgrid.VoxelGridState.create(tg, "cpu")
    before = warp_fused.warp_fuse_planes.launches
    ts, tu = warp_fused.warp_fuse_planes(
        st.sdf, st.update_num, *(tg.axis_centers_t(a, "cpu")
                                 for a in range(3)),
        synth, zero2, one2, torch.from_numpy(imgs), topt, linear,
        ortho_rows=z_rows)
    assert warp_fused.warp_fuse_planes.launches == before
    # the facade's entry point is the same fold
    via = tfw.carve_views_warp_ortho(st, tg, w2c_t, torch.from_numpy(imgs),
                                     topt, linear)
    assert torch.equal(via.sdf, ts) and torch.equal(via.update_num, tu)

    js0 = jgrid.VoxelGridState.create(jg)
    jw2c = jnp.asarray(w2c)
    jsynth = jw2c.at[:, 2, :].set(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32))
    np.testing.assert_array_equal(synth.numpy(), np.asarray(jsynth))
    js, ju = j_fuse_planes(
        js0.sdf, js0.update_num, *(jnp.asarray(jg.axis_centers(a))
                                   for a in range(3)),
        jsynth, jnp.zeros((v, 2), jnp.float32), jnp.ones((v, 2), jnp.float32),
        jnp.asarray(imgs), jopt, linear, interpret=True,
        ortho_rows=jw2c[:, 2, :])
    js, ju = np.asarray(js), np.asarray(ju)
    ts, tu = ts.numpy(), tu.numpy()
    assert ju.max() >= 1 and (ju == 0).any()  # coverage, and a behind mask

    # voxels whose camera z is within 8 ulp of 0 in some view may take the
    # other side of the behind mask (the two summation orders)
    cz, cy, cx = (tg.axis_centers(a).astype(np.float64) for a in (2, 1, 0))
    near = np.zeros(tu.shape, bool)
    for zr in w2c[:, 2, :].astype(np.float64):
        terms = (zr[2] * cz[:, None, None], zr[1] * cy[None, :, None],
                 zr[0] * cx[None, None, :])
        z_cam = terms[0] + terms[1] + terms[2] + zr[3]
        scale = sum(np.abs(t) for t in terms) + abs(zr[3])
        near |= np.abs(z_cam) <= 8 * np.spacing(scale.astype(np.float32))
    assert near.mean() < 0.01
    np.testing.assert_array_equal(tu[~near], ju[~near])
    both = ~near & np.isfinite(ts) & np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts)[~near],
                                  np.isfinite(js)[~near])
    np.testing.assert_allclose(ts[both], js[both], rtol=0, atol=3e-5)


def test_run_sweep_matches_jax(tmp_path, capsys):
    before = (warp_fused.warp_fuse_planes.launches,
              mc_fused.marching_cubes_fused.launches)
    out = tpipe.main(["sweep", "--n", "32", "--views", "6", "--device", "cpu",
                      "--out", str(tmp_path)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert (warp_fused.warp_fuse_planes.launches,
            mc_fused.marching_cubes_fused.launches) == before
    ref = j_run_sweep(n=32, n_views=6, sharded=False,
                      out_dir=str(tmp_path / "jax"))
    # the JAX sweep's keys, plus the device's name, the mesh's shape and
    # the halo transport
    assert set(out) - {"device", "mesh_shape", "transport"} == set(ref)
    assert out["devices"] == 1 and out["mesh_shape"] is None
    assert out["transport"] is None
    assert out["config"] == ref["config"] == "baseline-5-sweep"
    assert tuple(out["grid"]) == tuple(ref["grid"]) == (32, 32, 32)
    assert out["views"] == ref["views"] and out["sharded"] is False
    assert out["device"] == "cpu"
    for k in ("carve_cold_s", "carve_s", "fusions_per_s", "extract_cold_s",
              "extract_s"):
        assert out[k] > 0
    for k in ("mc_vertices", "mc_faces"):
        assert out[k] == ref[k]
    from vacancy_tpu_torch.mesh import Mesh

    mesh = Mesh.load_ply(str(tmp_path / "sweep_32.ply"))
    assert (mesh.num_vertices, mesh.num_faces) == (out["mc_vertices"],
                                                   out["mc_faces"])
    jmesh = Mesh.load_ply(str(tmp_path / "jax" / "sweep_32.ply"))
    np.testing.assert_array_equal(mesh.faces, jmesh.faces)
    np.testing.assert_allclose(mesh.vertices, jmesh.vertices, rtol=0,
                               atol=1e-4 * 2.2 / 32)


def test_run_sweep_options():
    out = tpipe.run_sweep(n=16, n_views=2, extract=False, device="cpu")
    assert "mc_vertices" not in out and out["carve_s"] > 0
    # sharded is the default, as in the JAX package, and like there a
    # single block-holder with no mesh shape runs unsharded and says so
    assert out["sharded"] is False
    out = tpipe.run_sweep(n=16, n_views=2, sharded=True, mesh_shape="auto",
                          extract=False, device="cpu")
    assert out["sharded"] is False and out["mesh_shape"] is None
    if not torch.cuda.is_available():
        # the default device is the card: no quiet run on the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            tpipe.run_sweep(n=16, n_views=2)
    assert len(jax.devices()) >= 1


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4,), (2, 2, 2)], ids=str)
def test_run_sweep_sharded_equals_unsharded(tmp_path, mesh_shape):
    """The sharded sweep over CPU blocks writes the unsharded sweep's PLY,
    byte for byte."""
    ref = tpipe.run_sweep(n=32, n_views=6, sharded=False, device="cpu",
                          out_dir=str(tmp_path / "dense"))
    out = tpipe.run_sweep(n=32, n_views=6, sharded=True,
                          mesh_shape=mesh_shape, device="cpu",
                          out_dir=str(tmp_path / "cut"))
    assert ref["sharded"] is False and out["sharded"] is True
    assert out["mesh_shape"] == list(mesh_shape)
    assert out["transport"] == "device copy" and out["devices"] == 1
    assert set(out) == set(ref)
    for k in ("grid", "views", "mc_vertices", "mc_faces"):
        assert out[k] == ref[k]
    assert ((tmp_path / "cut" / "sweep_32.ply").read_bytes()
            == (tmp_path / "dense" / "sweep_32.ply").read_bytes())
    assert out["mc_faces"] > 1000


def test_sharded_sweep_pads_a_grid_that_does_not_divide():
    out = tpipe.run_sweep(n=15, n_views=2, mesh_shape=(4,), device="cpu")
    assert out["grid"] == [15, 15, 16] and out["sharded"] is True


def test_sweep_cli_parses_the_sharding_flags(tmp_path, capsys):
    out = tpipe.main(["sweep", "--n", "16", "--views", "2", "--device", "cpu",
                      "--mesh-shape", "2,2", "--piece-dir",
                      str(tmp_path / "pieces"), "--no-extract"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["sharded"] is True and out["mesh_shape"] == [2, 2]
    out = tpipe.main(["sweep", "--n", "16", "--views", "2", "--device", "cpu",
                      "--mesh-shape", "2,2", "--no-sharded", "--no-extract"])
    assert out["sharded"] is False and out["mesh_shape"] is None
    out = tpipe.main(["sweep", "--n", "16", "--views", "2", "--device", "cpu",
                      "--mesh-shape", "auto", "--no-extract"])
    assert out["sharded"] is False  # one block-holder: nothing to cut
    with pytest.raises(SystemExit):
        tpipe.main(["sweep", "--mesh-shape"])
    with pytest.raises(ValueError, match="1-3 dims"):
        tpipe.main(["sweep", "--n", "16", "--views", "2", "--device", "cpu",
                    "--mesh-shape", "1,1,1,2", "--no-extract"])
    # --coordinator without its peers' numbers is refused before any work
    with pytest.raises(ValueError, match="num_processes"):
        tpipe.main(["sweep", "--n", "16", "--views", "2", "--device", "cpu",
                    "--coordinator", "localhost:1"])
