"""The port's host-side modules vs the JAX package's on identical inputs:
the C++ library's loader (face expansion, PLY writer, vertex weld, ascii
parser) against its numpy plain versions, OBJ / PLY files, TUM poses,
image helpers, metrics, the SDF colour map, the look-at helpers and the
timers. Everything here is exact (equal bytes or equal arrays) unless a
test says otherwise."""

import json
import os
import time

import numpy as np
import pytest
import torch

from test_torch_mc import _random_state, _sphere_state
from vacancy_tpu import io as jio
from vacancy_tpu import mesh as jmesh
from vacancy_tpu import metrics as jmetrics
from vacancy_tpu import utils as jutils
from vacancy_tpu.ops.sdf2d import signed_distance_to_color as j_sdf_color
from vacancy_tpu.utils import common as jcommon
from vacancy_tpu_torch import _kernels
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch import io as tio
from vacancy_tpu_torch import mesh as tmesh
from vacancy_tpu_torch import metrics as tmetrics
from vacancy_tpu_torch import utils as tutils
from vacancy_tpu_torch.io import native
from vacancy_tpu_torch.ops import mc_fused
from vacancy_tpu_torch.ops.marching_cubes import extract_mesh
from vacancy_tpu_torch.ops.sdf2d import signed_distance_to_color
from vacancy_tpu_torch.utils import common as tcommon
from vacancy_tpu_torch.utils import timing


def _cube(colors=True):
    m = tmesh.make_cube(1.5, t=np.array([0.25, -1.0, 2.0], np.float32))
    if not colors:
        m.vertex_colors = None
    return m


# ---------------------------------------------------------------------------
# the C++ library
# ---------------------------------------------------------------------------


def test_native_library_builds_under_the_build_tree():
    lib = native.build()
    assert native.available()
    assert _kernels.BUILD_ROOT in lib.parents
    assert lib.parent.name.startswith("native-")
    # never beside the source
    assert os.path.dirname(str(lib)) != str(native.SOURCE.parent)
    # no OpenMP runtime: the library needs nothing a bare toolchain lacks
    assert "-fopenmp" not in native.CXX_FLAGS
    assert native.build() == lib  # cached: no second compile


def test_a_failed_native_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()


def _streams(state):
    sdf, un, spec = state
    grid = tgrid.GridSpec(*spec)
    st = tgrid.state_from_numpy(sdf, un, "cpu")
    out = mc_fused.marching_cubes_fused(
        st.sdf, st.update_num, *(grid.axis_centers_t(a, "cpu")
                                 for a in range(3)))
    host = [t.numpy() for t in out.as_tuple()[:8]]
    return (host[0:6:2], [v.astype(np.int64) for v in host[1:6:2]], host[6],
            host[7], sdf.shape[1], sdf.shape[2], grid)


@pytest.mark.parametrize("case", ["random", "sphere", "large-threaded"])
def test_native_face_expansion_equals_numpy(case):
    state = {"random": _random_state(16, 12, 20),
             "sphere": _sphere_state(),
             "large-threaded": _random_state(24, 30, 34, seed=2)}[case]
    args = _streams(state)
    plain = mc_fused.assemble_fused_streams(*args, native=False)
    fast = mc_fused.assemble_fused_streams(*args)
    assert plain.num_faces > 100
    assert fast.faces.dtype == plain.faces.dtype == np.int32
    assert fast.faces.tobytes() == plain.faces.tobytes()
    assert fast.vertices.tobytes() == plain.vertices.tobytes()


def test_native_face_expansion_of_nothing():
    faces = mc_fused.expand_faces(
        np.zeros(0, np.int32), np.zeros(0, np.int32), 4, 5,
        [np.zeros(0, np.int64)] * 3, [0, 0, 0])
    assert faces.shape == (0, 3) and faces.dtype == np.int32
    with pytest.raises(ValueError, match="disagree"):
        native.native_expand_faces(
            np.zeros(2, np.int32), np.zeros(1, np.int32),
            np.zeros(3, np.int64), mc_fused.TRI_TABLE, mc_fused.EDGE_AXIS,
            np.zeros(12, np.int64), [np.zeros(0, np.int32)] * 3)


@pytest.mark.parametrize("colors", [True, False], ids=["colors", "plain"])
def test_native_binary_ply_equals_the_numpy_writer(tmp_path, colors):
    m = _cube(colors)
    a, b = str(tmp_path / "native.ply"), str(tmp_path / "numpy.ply")
    m.write_ply(a, binary=True)
    m.write_ply(b, binary=True, native=False)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("writer", ["native", "numpy"])
def test_ply_files_load_in_both_packages(tmp_path, binary, writer):
    m = _cube()
    path = str(tmp_path / "cube.ply")
    m.write_ply(path, binary=binary, native=writer == "native")
    for loaded in (tmesh.Mesh.load_ply(path), jmesh.Mesh.load_ply(path)):
        np.testing.assert_array_equal(loaded.faces, m.faces)
        if binary:
            np.testing.assert_array_equal(loaded.vertices, m.vertices)
        else:  # "%g": six significant digits
            np.testing.assert_allclose(loaded.vertices, m.vertices,
                                       rtol=1e-5, atol=0)
    jpath = str(tmp_path / "jcube.ply")
    jmesh.Mesh(vertices=m.vertices, faces=m.faces,
               vertex_colors=m.vertex_colors).write_ply(jpath, binary=binary)
    back = tmesh.Mesh.load_ply(jpath)
    np.testing.assert_array_equal(back.faces, m.faces)
    np.testing.assert_allclose(back.vertices, m.vertices, rtol=1e-5, atol=0)


def test_native_write_to_a_missing_directory_raises(tmp_path):
    with pytest.raises(OSError, match="failed"):
        _cube().write_ply(str(tmp_path / "absent" / "x.ply"))


def test_native_weld_equals_the_numpy_weld():
    rng = np.random.default_rng(6)
    base = rng.normal(size=(40, 3)).astype(np.float32)
    pick = rng.integers(0, 40, size=300)
    faces = rng.integers(0, 300, size=(120, 3)).astype(np.int32)
    a = tmesh.Mesh(vertices=base[pick], faces=faces)
    b, j = a.copy(), jmesh.Mesh(vertices=base[pick], faces=faces)
    a.remove_duplicated_vertices()
    b.remove_duplicated_vertices(native=False)
    j.remove_duplicated_vertices()
    assert a.num_vertices == len(np.unique(pick))
    for other in (b, j):
        np.testing.assert_array_equal(a.vertices, other.vertices)
        np.testing.assert_array_equal(a.faces, other.faces)
    np.testing.assert_array_equal(a.vertices[a.faces], base[pick][faces])


def test_native_float3_parser():
    rows = np.array([[1.5, -2.25, 3e-3], [0.0, 1e6, -7.0]], np.float32)
    buf = "".join(f"{x:g} {y:g} {z:g} 255 0 0\n" for x, y, z in rows).encode()
    np.testing.assert_array_equal(native.native_parse_float3(buf, 2), rows)
    assert native.native_parse_float3(b"1 2\nx y z\n", 2) is None


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------


def test_obj_files_are_the_jax_package_s_bytes(tmp_path):
    m = _cube()
    jm = jmesh.Mesh(vertices=m.vertices, faces=m.faces)
    jm.calc_normal()
    m.write_obj(str(tmp_path / "t.obj"))
    jm.write_obj(str(tmp_path / "j.obj"))
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj"
                                                 ).read_bytes()
    t_back = tmesh.Mesh.load_obj(str(tmp_path / "j.obj"))
    j_back = jmesh.Mesh.load_obj(str(tmp_path / "t.obj"))
    for f in ("vertices", "faces", "normals", "normal_indices", "uv",
              "uv_indices"):
        a, b = getattr(t_back, f), getattr(j_back, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(t_back.faces, m.faces)


def test_textured_obj_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    kw = dict(
        vertices=_cube().vertices, faces=_cube().faces,
        uv=rng.random((24, 2)).astype(np.float32),
        uv_indices=_cube().faces.copy(),
        diffuse_texture=rng.integers(0, 256, (8, 8, 3)).astype(np.uint8))
    for pkg, d in ((tmesh, tmp_path / "t"), (jmesh, tmp_path / "j")):
        os.makedirs(d)
        mesh = pkg.Mesh(**kw)
        mesh.calc_normal()
        mesh.write_obj_textured(str(d), "cube")
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == 3
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n
                                                     ).read_bytes(), n
    back = tio.load_obj(str(tmp_path / "t" / "cube.obj"))
    np.testing.assert_allclose(back.uv, kw["uv"], atol=1e-6)
    np.testing.assert_array_equal(back.uv_indices, kw["uv_indices"])


# ---------------------------------------------------------------------------
# TUM poses, images, metrics, colour map, helpers
# ---------------------------------------------------------------------------


def test_tum_poses_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    lines = []
    for i in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3) * 100
        lines.append(" ".join(f"{v:.9g}" for v in (i, *t, *q)))
    path = tmp_path / "tumpose.txt"
    path.write_text("\n".join(lines) + "\n\n")
    t_poses, j_poses = tio.load_tum_poses(str(path)), jio.load_tum_poses(
        str(path))
    assert len(t_poses) == len(j_poses) == 5
    for a, b in zip(t_poses, j_poses):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a[:3, :3] @ a[:3, :3].T, np.eye(3),
                                   atol=1e-12)
    (tmp_path / "bad.txt").write_text("# timestamp tx ty tz qx qy qz qw\n")
    for pkg in (tio, jio):
        with pytest.raises(ValueError, match="wrong tum format"):
            pkg.load_tum_poses(str(tmp_path / "bad.txt"))
    ids = [i for i, _ in tio.load_tum_format(str(path))]
    assert ids == [i for i, _ in jio.load_tum_format(str(path))] == list(
        range(5))
    np.testing.assert_array_equal(tio.quat_to_rotmat(0.1, -0.2, 0.3, 0.9),
                                  jio.quat_to_rotmat(0.1, -0.2, 0.3, 0.9))


def test_image_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    mask = (rng.random((12, 16)) > 0.5).astype(np.uint8) * 255
    rgb = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
    tio.write_png(str(tmp_path / "m.png"), mask)
    jio.write_png(str(tmp_path / "c.png"), rgb)
    for pkg in (tio, jio):
        np.testing.assert_array_equal(pkg.load_mask(str(tmp_path / "m.png")),
                                      mask)
        np.testing.assert_array_equal(pkg.load_image(str(tmp_path / "c.png")),
                                      rgb)
        # a colour file read as a mask: its first channel
        np.testing.assert_array_equal(pkg.load_mask(str(tmp_path / "c.png")),
                                      rgb[..., 0])
    depth = rng.random((12, 16)).astype(np.float32) * 5
    np.testing.assert_array_equal(tio.depth_to_gray(depth, 1.0, 4.0),
                                  jio.depth_to_gray(depth, 1.0, 4.0))
    normal = rng.normal(size=(12, 16, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    np.testing.assert_array_equal(tio.normal_to_color(normal),
                                  jio.normal_to_color(normal))
    ids = rng.integers(-1, 30, (12, 16))
    np.testing.assert_array_equal(tio.face_id_to_random_color(ids, seed=4),
                                  jio.face_id_to_random_color(ids, seed=4))
    img = rng.normal(size=(6, 7)).astype(np.float32) * 300
    for dtype, scale in ((np.uint8, 0.5), (np.int32, -2.0),
                         (np.float32, 0.25)):
        with np.errstate(invalid="ignore"):
            np.testing.assert_array_equal(
                tio.convert_image(img, dtype, scale),
                jio.convert_image(img, dtype, scale))


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(500, 3)).astype(np.float32)
    b = (a + rng.normal(size=a.shape) * 0.05).astype(np.float32)[:400]
    mesh = tmesh.Mesh(vertices=a)
    assert tmetrics.chamfer_distance(mesh, b) == jmetrics.chamfer_distance(
        jmesh.Mesh(vertices=a), b)
    assert tmetrics.chamfer_distance(a, b, max_points=100) == \
        jmetrics.chamfer_distance(a, b, max_points=100)
    assert tmetrics.hausdorff_distance(a, b) == jmetrics.hausdorff_distance(
        a, b)
    assert tmetrics.bbox_diagonal(mesh) == jmetrics.bbox_diagonal(a)
    ch, ab, ba = tmetrics.chamfer_distance(a, a)
    assert ch == ab == ba == 0.0


def test_sdf_colour_map_matches_jax():
    rng = np.random.default_rng(7)
    sdf = rng.normal(size=(10, 14)).astype(np.float32)
    sdf[0, :3] = [0.0, 1.0, -1.0]
    for lo, hi in ((-1.0, 1.0), (-0.25, 2.0)):
        out = signed_distance_to_color(sdf, lo, hi)
        assert out.dtype == np.uint8 and out.shape == (10, 14, 3)
        np.testing.assert_array_equal(out, j_sdf_color(sdf, lo, hi))
    with pytest.raises(AssertionError):
        signed_distance_to_color(sdf, 0.5, 1.0)


def test_common_helpers_match_jax():
    assert tcommon.radians(37.5) == jcommon.radians(37.5)
    assert tcommon.degrees(1.25) == jcommon.degrees(1.25)
    args = ([3.0, 0.5, -2.0], [0.1, 0.2, 0.3], [0.0, -1.0, 0.0])
    pose = tcommon.c2w(*args)
    assert pose.dtype == np.float64
    np.testing.assert_array_equal(pose, jcommon.c2w(*args))
    for n, w in ((7, 5), (123, 2), (0, 1)):
        assert tutils.zfill(n, w) == jutils.zfill(n, w)
    assert tutils.zfill(42) == "00042"


# ---------------------------------------------------------------------------
# timers and the profiler trace
# ---------------------------------------------------------------------------


def test_timer_keeps_a_bounded_history():
    t = timing.Timer(history=3)
    assert t.average_msec == 0.0
    with pytest.raises(AssertionError, match="without start"):
        t.end()
    ends = []
    for _ in range(5):
        t.start()
        time.sleep(0.002)
        ends.append(t.end())
        assert ends[-1] == t.elapsed_msec >= 1.0
    # the average is over the last three only
    assert t.average_msec == pytest.approx(sum(ends[-3:]) / 3)


def test_device_timer_on_the_cpu_reads_the_host_clock():
    holder = {}
    with timing.device_timer("matmul", holder, device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
        time.sleep(0.002)
    (ms,) = [v for v in holder.values() if isinstance(v, float)]
    assert ms >= 1.0


def test_trace_writes_one_file_and_none_without_a_directory(tmp_path):
    with timing.trace(None):
        pass
    assert os.listdir(tmp_path) == []
    out = tmp_path / "prof"
    with timing.trace(str(out)):
        torch.ones(8, 8).sum()
    assert os.listdir(out) == ["trace.json"]
    assert "traceEvents" in json.loads((out / "trace.json").read_text())


def test_extract_mesh_takes_the_native_expansion():
    """The main path's assembly is the native one: the mesh of
    ``extract_mesh`` equals the numpy assembly byte for byte."""
    sdf, un, spec = _sphere_state()
    mesh = extract_mesh(tgrid.state_from_numpy(sdf, un, "cpu"),
                        tgrid.GridSpec(*spec))
    plain = mc_fused.assemble_fused_streams(
        *_streams((sdf, un, spec)), native=False)
    assert mesh.faces.tobytes() == plain.faces.tobytes()
    assert mesh.vertices.tobytes() == plain.vertices.tobytes()
