"""The turntable slice end to end in the port vs the same JAX functions
on the same numpy masks (n=32, 6 views), the CLI, and the port's import
boundary (no JAX).

Bars: SDF images bitwise; the fused state as in test_torch_warp
(update_num on <= 1e-4 of the voxels, |dsdf| <= 1e-5 where it agrees);
mesh vertex and face counts within 0.5%, and the port's MC on the JAX
state gives the JAX mesh: faces exact, vertices within one ulp of the
grid's extent (XLA on the CPU contracts ``p0 + t * (p1 - p0)`` into an
FMA, and near a zero coordinate that one rounding is many ulps of the
result)."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vacancy_tpu import camera as jcam
from vacancy_tpu import grid as jgrid
from vacancy_tpu import synthetic as jsyn
from vacancy_tpu.config import VoxelUpdate, VoxelUpdateOption
from vacancy_tpu.ops.fusion_warp import carve_views_warp as j_carve
from vacancy_tpu.ops.marching_cubes import extract_mesh as j_extract
from vacancy_tpu.ops.sdf2d import make_signed_distance_field as j_sdf
from vacancy_tpu.pipeline import run_turntable as j_run_turntable
from vacancy_tpu_torch import camera as tcam
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch import pipeline as tpipe
from vacancy_tpu_torch.mesh import Mesh
from vacancy_tpu_torch.ops import mc_fused, warp_fused
from vacancy_tpu_torch.ops.fusion_warp import carve_views_warp as t_carve
from vacancy_tpu_torch.ops.marching_cubes import extract_mesh as t_extract
from vacancy_tpu_torch.ops.sdf2d import make_signed_distance_field as t_sdf

N, VIEWS = 32, 6


def test_turntable_slice_matches_jax():
    grid_t = tpipe.turntable_grid(N)
    grid_j = jgrid.GridSpec(grid_t.bb_min, grid_t.bb_max, grid_t.resolution)
    opt = tpipe.turntable_option()
    opt_j = VoxelUpdateOption(
        voxel_update=VoxelUpdate.WEIGHTED_AVERAGE, use_truncation=True,
        truncation_band=opt.truncation_band,
    )
    centers, radii = jsyn.blob_spheres(seed=3)
    cams_j = jcam.stack_cameras(jsyn.turntable_cameras(VIEWS, radius=3.2))
    masks = jsyn.render_silhouettes(
        jsyn.turntable_cameras(VIEWS, radius=3.2), centers, radii
    )
    cams_t = tcam.from_numpy(
        np.asarray(cams_j.principal_point), np.asarray(cams_j.focal_length),
        np.asarray(cams_j.c2w), np.asarray(cams_j.w2c), cams_j.width,
        cams_j.height, "cpu",
    )

    # 2D SDFs: bitwise
    sdf_t = t_sdf(torch.from_numpy(masks), use_truncation=True,
                  truncation_band=opt.truncation_band)
    sdf_j = jax.vmap(lambda m: j_sdf(m, use_truncation=True,
                                     truncation_band=opt.truncation_band))(
        jnp.asarray(masks))
    np.testing.assert_array_equal(sdf_t.numpy(), np.asarray(sdf_j))

    # fusion
    st_t = t_carve(tgrid.VoxelGridState.create(grid_t, "cpu"), grid_t,
                   cams_t.w2c, cams_t.principal_point, cams_t.focal_length,
                   sdf_t, opt)
    st_j = j_carve(jgrid.VoxelGridState.create(grid_j), grid_j, cams_j.w2c,
                   cams_j.principal_point, cams_j.focal_length, sdf_j,
                   opt=opt_j)
    ts, tu = tgrid.state_to_numpy(st_t)
    js, ju = np.asarray(st_j.sdf), np.asarray(st_j.update_num)
    agree = tu == ju
    assert (~agree).mean() <= 1e-4
    both = agree & (tu > 0)
    assert np.abs(ts[both] - js[both]).max() <= 1e-5
    assert (tu > 0).mean() > 0.5

    # extraction
    m_t = t_extract(st_t, grid_t)
    m_j = j_extract(st_j, grid_j, engine="xla")
    assert m_j.num_faces > 1000
    for a, b in ((m_t.num_vertices, m_j.num_vertices),
                 (m_t.num_faces, m_j.num_faces)):
        assert abs(a - b) <= 0.005 * b
    if np.array_equal(ts.view(np.int32), js.view(np.int32)):
        np.testing.assert_array_equal(m_t.vertices, m_j.vertices)
    m_tj = t_extract(tgrid.state_from_numpy(js, ju, "cpu"), grid_t)
    np.testing.assert_array_equal(m_tj.faces, m_j.faces)
    np.testing.assert_allclose(m_tj.vertices, m_j.vertices, rtol=0,
                               atol=np.spacing(np.float32(1.1)))


def test_run_turntable_cli_on_cpu_takes_the_plain_versions(tmp_path, capsys):
    """The CLI end to end on CPU tensors: both wrappers take their plain
    versions (launch counters stay 0), the PLY reads back, and the mesh
    counts sit within 0.5% of the JAX pipeline's."""
    before = (warp_fused.warp_fuse_planes.launches,
              mc_fused.marching_cubes_fused.launches)
    out = tpipe.main(["turntable", "--n", str(N), "--views", str(VIEWS),
                      "--device", "cpu", "--out", str(tmp_path)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert (warp_fused.warp_fuse_planes.launches,
            mc_fused.marching_cubes_fused.launches) == before
    assert out["grid"] == [N, N, N] and out["views"] == VIEWS
    assert out["device"] == "cpu" and out["carve_s"] > 0
    mesh = Mesh.load_ply(out["ply"])
    assert (mesh.num_vertices, mesh.num_faces) == (
        out["mc_vertices"], out["mc_faces"])
    assert mesh.num_faces > 1000 and mesh.faces.max() < mesh.num_vertices
    ref = j_run_turntable(n=N, n_views=VIEWS)
    for k in ("mc_vertices", "mc_faces"):
        assert abs(out[k] - ref[k]) <= 0.005 * ref[k]


def test_run_turntable_sharded_equals_unsharded(tmp_path):
    """run_turntable over a (2, 2, 2) mesh of CPU blocks, from Python and
    from the CLI: the unsharded run's PLY byte for byte."""
    ref = tpipe.run_turntable(n=N, n_views=VIEWS, device="cpu",
                              out_dir=str(tmp_path / "dense"))
    assert ref["sharded"] is False and ref["mesh_shape"] is None
    out = tpipe.run_turntable(n=N, n_views=VIEWS, device="cpu", sharded=True,
                              mesh_shape=(2, 2, 2),
                              out_dir=str(tmp_path / "cut"))
    assert out["sharded"] is True and out["mesh_shape"] == [2, 2, 2]
    assert out["transport"] == "device copy"
    cli = tpipe.main(["turntable", "--n", str(N), "--views", str(VIEWS),
                      "--device", "cpu", "--mesh-shape", "2,4", "--out",
                      str(tmp_path / "cli")])
    assert cli["sharded"] is True and cli["mesh_shape"] == [2, 4]
    want = Path(ref["ply"]).read_bytes()
    assert Path(out["ply"]).read_bytes() == want
    assert Path(cli["ply"]).read_bytes() == want
    # --sharded alone on one block-holder runs unsharded and says so
    one = tpipe.main(["turntable", "--n", "16", "--views", "2", "--device",
                      "cpu", "--sharded"])
    assert one["sharded"] is False and one["devices"] == 1


def test_ply_ascii_and_binary_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    mesh = Mesh(vertices=rng.normal(size=(7, 3)),
                faces=rng.integers(0, 7, size=(5, 3)))
    for binary in (True, False):
        path = str(tmp_path / f"m{int(binary)}.ply")
        mesh.write_ply(path, binary=binary)
        back = Mesh.load_ply(path)
        np.testing.assert_array_equal(back.faces, mesh.faces)
        if binary:
            np.testing.assert_array_equal(back.vertices, mesh.vertices)
        else:
            np.testing.assert_allclose(back.vertices, mesh.vertices,
                                       rtol=1e-5)


def test_port_imports_no_jax():
    code = ("import vacancy_tpu_torch.pipeline, vacancy_tpu_torch.carver, sys; "
            "assert not any(m.startswith('jax') for m in sys.modules), "
            "[m for m in sys.modules if m.startswith('jax')]")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr
