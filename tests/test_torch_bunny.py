"""The bunny pipelines (``run_bunny``, ``run_bunny_batched``, ``load_bunny``,
the CLI's ``bunny``) in the port against the JAX package's, on a stand-in
of the six-view sequence built here: six ``look_at`` poses around the
bunny's box written as TUM lines, six 320 x 240 silhouettes of the
sphere-union blob scaled into the box, and a cube as ``GT.ply``.

Both packages read the same files at ``resolution=20`` (a 27 x 26 x 21
grid). Bars: mesh counts and faces equal; the per-view SDF images, voxel
meshes and non-interpolated MC meshes byte for byte the same; interpolated
vertices within 1e-2 world units (a 2e-6 difference of the chained fused
states, from XLA's contractions on the CPU, divided by a small
``s1 - s0`` and times the 20-unit pitch moves a vertex by up to ~1.5e-3).
"""

import json
import os

import numpy as np
import pytest
import torch

import vacancy_tpu.pipeline as jpipe
from vacancy_tpu_torch import pipeline as tpipe
from vacancy_tpu_torch.camera import PinholeCamera
from vacancy_tpu_torch.io import load_tum_poses, write_png
from vacancy_tpu_torch.mesh import Mesh, make_cube
from vacancy_tpu_torch.synthetic import (blob_spheres, look_at,
                                         render_silhouettes)

RES = 20.0
VERTEX_TOL = 1e-2  # world units


def _rotmat_to_quat(rot):
    """(qx, qy, qz, qw) of a rotation matrix (Shepperd's method)."""
    tr = np.trace(rot)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        return ((rot[2, 1] - rot[1, 2]) / s, (rot[0, 2] - rot[2, 0]) / s,
                (rot[1, 0] - rot[0, 1]) / s, 0.25 * s)
    i = int(np.argmax(np.diag(rot)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(1.0 + rot[i, i] - rot[j, j] - rot[k, k])
    q = np.zeros(3)
    q[i] = 0.25 * s
    q[j] = (rot[j, i] + rot[i, j]) / s
    q[k] = (rot[k, i] + rot[i, k]) / s
    return q[0], q[1], q[2], (rot[k, j] - rot[j, k]) / s


@pytest.fixture(scope="module")
def bunny_dir(tmp_path_factory):
    """The stand-in sequence: tumpose.txt, mask_0000{0..5}.png, GT.ply."""
    d = tmp_path_factory.mktemp("bunny")
    lo, hi = np.array(tpipe.BUNNY_BB_MIN), np.array(tpipe.BUNNY_BB_MAX)
    center, scale = (lo + hi) / 2, 0.5 * float(np.min(hi - lo))
    lines = []
    for i in range(6):
        ang = 2.0 * np.pi * i / 6
        eye = center + 700.0 * np.array(
            [np.cos(ang), 0.3 * np.sin(2 * ang + 0.4), np.sin(ang)])
        c2w = look_at(eye, center)
        qx, qy, qz, qw = _rotmat_to_quat(c2w[:3, :3])
        lines.append(" ".join(f"{v:.9f}" for v in (*c2w[:3, 3], qx, qy, qz,
                                                   qw)))
    (d / "tumpose.txt").write_text(
        "".join(f"{i} {ln}\n" for i, ln in enumerate(lines)))
    centers, radii = blob_spheres(seed=3)
    cams = [PinholeCamera.create(c2w=p, device="cpu", **tpipe.BUNNY_INTRINSICS)
            for p in load_tum_poses(str(d / "tumpose.txt"))]
    masks = render_silhouettes(
        cams, (centers * scale + center).astype(np.float32),
        (radii * scale).astype(np.float32)).numpy()
    assert masks.shape == (6, 240, 320)
    assert all(0.02 < (m > 0).mean() < 0.6 for m in masks)
    for i, m in enumerate(masks):
        write_png(str(d / f"mask_{i:05d}.png"), m)
    make_cube(2 * scale, t=center.astype(np.float32)).write_ply(
        str(d / "GT.ply"))
    return str(d)


@pytest.fixture
def both_read(bunny_dir, monkeypatch):
    """Point the port (VACANCY_DATA, read at each call) and the JAX package
    (its DATA_DIR and load_bunny's default, bound at import) at the
    stand-in."""
    monkeypatch.setenv("VACANCY_DATA", bunny_dir)
    monkeypatch.setattr(jpipe, "DATA_DIR", bunny_dir)
    monkeypatch.setattr(jpipe.load_bunny, "__defaults__", (bunny_dir,))
    return bunny_dir


def _same_counts_and_metrics(t, j):
    assert list(t["grid"]) == list(j["grid"]) == [27, 26, 21]
    assert (t["mc_vertices"], t["mc_faces"]) == (j["mc_vertices"],
                                                j["mc_faces"])
    assert t["mc_vertices"] > 100
    for key in ("chamfer", "hausdorff"):
        if key in j:
            assert abs(t[key] - j[key]) <= VERTEX_TOL, key


def _same_surface(a, b):
    ta, tb = Mesh.load_ply(a), Mesh.load_ply(b)
    np.testing.assert_array_equal(ta.faces, tb.faces)
    np.testing.assert_allclose(ta.vertices, tb.vertices, rtol=0,
                               atol=VERTEX_TOL)


def _same_artifacts(dt, dj):
    names = sorted(os.listdir(dj))
    assert sorted(os.listdir(dt)) == names
    assert len(names) == 6 * 4 + 1
    for name in names:
        a, b = os.path.join(dt, name), os.path.join(dj, name)
        if name.startswith(("sdf_", "voxel_", "surface_nointerp_")):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
        else:
            _same_surface(a, b)


@pytest.mark.parametrize("tsdf", [False, True], ids=["carve", "tsdf"])
@pytest.mark.parametrize("engine", ["exact", "warp"])
def test_run_bunny_matches_jax(both_read, tmp_path, engine, tsdf):
    dt, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    t = tpipe.run_bunny(out_dir=dt, resolution=RES, tsdf=tsdf, engine=engine,
                        device="cpu")
    j = jpipe.run_bunny(out_dir=dj, resolution=RES, tsdf=tsdf, engine=engine)
    _same_counts_and_metrics(t, j)
    assert [v["view"] for v in t["views"]] == list(range(6))
    _same_artifacts(dt, dj)


def test_run_bunny_batched_matches_jax(both_read):
    t = tpipe.run_bunny_batched(resolution=RES, tsdf=True, device="cpu")
    j = jpipe.run_bunny_batched(resolution=RES, tsdf=True)
    assert list(t["grid"]) == list(j["grid"])
    assert t["mc_vertices"] == j["mc_vertices"] > 100
    assert abs(t["chamfer_over_diag"] - j["chamfer_over_diag"]) <= 1e-5


def test_run_bunny_resumes_at_view_six(both_read, tmp_path):
    """A checkpoint after every view, then ``resume`` from the last one:
    no view is carved again and the mesh is the uninterrupted run's, in
    each package; the two packages agree."""
    out = {}
    for name, run, kw in (("port", tpipe.run_bunny, {"device": "cpu"}),
                          ("jax", jpipe.run_bunny, {})):
        ck = str(tmp_path / f"{name}.npz")
        full = run(resolution=RES, tsdf=True, write_artifacts=False,
                   checkpoint=ck, **kw)
        again = run(resolution=RES, tsdf=True, write_artifacts=False,
                    checkpoint=ck, resume=True, **kw)
        assert len(full["views"]) == 6 and again["views"] == []
        assert (again["mc_vertices"], again["mc_faces"]) == (
            full["mc_vertices"], full["mc_faces"])
        assert again["chamfer"] == full["chamfer"]
        out[name] = again
    _same_counts_and_metrics(out["port"], out["jax"])


def test_bunny_cli_matches_jax(both_read, tmp_path, capsys):
    """The CLI's ``bunny`` with metric TSDF on the warp engine: the same
    JSON keys and counts from both packages, the final surface alike."""
    args = ["bunny", "--resolution", str(RES), "--tsdf", "--sdf-scale",
            "4.0", "--engine", "warp", "--no-artifacts"]
    t = tpipe.main(args + ["--out", str(tmp_path / "port"), "--device",
                           "cpu"])
    capsys.readouterr()
    jpipe.main(args + ["--out", str(tmp_path / "jax")])
    j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(t) == set(j)
    _same_counts_and_metrics(t, j)
    _same_surface(str(tmp_path / "port" / "final_surface.ply"),
                  str(tmp_path / "jax" / "final_surface.ply"))


def test_load_bunny_takes_a_directory(bunny_dir, tmp_path, monkeypatch):
    """``load_bunny(data_dir)`` reads the named directory, whatever
    VACANCY_DATA says; without the argument it reads VACANCY_DATA, and a
    directory without the files fails where they are read (as the JAX
    package's default does), not before."""
    monkeypatch.setenv("VACANCY_DATA", str(tmp_path))
    cams, masks = tpipe.load_bunny(bunny_dir, device="cpu")
    jcams, jmasks = jpipe.load_bunny(bunny_dir)
    np.testing.assert_array_equal(masks, jmasks)
    for c, jc in zip(cams, jcams):
        np.testing.assert_array_equal(c.w2c.numpy(), np.asarray(jc.w2c))
        assert c.w2c.device == torch.device("cpu")
    with pytest.raises(FileNotFoundError):
        tpipe.load_bunny(device="cpu")
    monkeypatch.delenv("VACANCY_DATA")
    assert tpipe.default_data_dir() == tpipe.DEFAULT_DATA_DIR
    monkeypatch.setattr(tpipe, "DEFAULT_DATA_DIR", bunny_dir)
    assert len(tpipe.load_bunny(device="cpu")[0]) == 6
