"""The port's foundation modules vs the JAX package on identical inputs:
grid centers, cameras, the synthetic scene and silhouettes, and the
numpy converters between the two packages' states and cameras."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacancy_tpu import camera as jcam
from vacancy_tpu import grid as jgrid
from vacancy_tpu import synthetic as jsyn
from vacancy_tpu_torch import camera as tcam
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch import synthetic as tsyn
from vacancy_tpu_torch.config import INVALID_SDF

GRIDS = [
    ((-1.1, -1.1, -1.1), (1.1 + 0.4 * 2.2 / 48,) * 3, 2.2 / 48),
    ((-270.0, -364.586151, -149.982697), (270.0, 170.542343, 277.329224),
     10.0),
    ((0.0, 0.0, 0.0), (20.4, 12.4, 9.4), 1.0),
]


@pytest.mark.parametrize("spec", GRIDS, ids=["turntable48", "bunny", "unit"])
def test_axis_centers_bitwise(spec):
    jg, tg = jgrid.GridSpec(*spec), tgrid.GridSpec(*spec)
    assert tg.voxel_num == jg.voxel_num
    assert tg.shape_zyx == jg.shape_zyx
    for a in range(3):
        np.testing.assert_array_equal(tg.axis_centers(a), jg.axis_centers(a))
        assert tg.axis_centers(a).dtype == np.float32
        c = tg.axis_centers_t(a, "cpu")
        assert c.dtype == torch.float32
        np.testing.assert_array_equal(c.numpy(), jg.axis_centers(a))


def _cam_fields(cam):
    return [np.asarray(cam.principal_point), np.asarray(cam.focal_length),
            np.asarray(cam.c2w), np.asarray(cam.w2c)]


def _assert_cam_equal(tc, jc):
    assert (tc.width, tc.height) == (jc.width, jc.height)
    for t, j in zip(
        [tc.principal_point, tc.focal_length, tc.c2w, tc.w2c],
        _cam_fields(jc),
    ):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.cpu().numpy(), j)


@pytest.mark.parametrize("kind", ["fov", "intrinsics", "default"])
def test_pinhole_create_bitwise(kind):
    c2w = jsyn.look_at([1.3, -0.4, 2.9], np.zeros(3))
    kw = dict(c2w=c2w)
    if kind == "fov":
        kw["fov_y_deg"] = 45.0
    elif kind == "intrinsics":
        kw["principal_point"] = np.array([159.3, 127.65], np.float32)
        kw["focal_length"] = np.array([258.65, 258.25], np.float32)
    _assert_cam_equal(tcam.PinholeCamera.create(320, 240, **kw),
                      jcam.PinholeCamera.create(320, 240, **kw))


def test_turntable_cameras_and_stack_bitwise():
    tc = tsyn.turntable_cameras(7, radius=3.2)
    jc = jsyn.turntable_cameras(7, radius=3.2)
    for a, b in zip(tc, jc):
        _assert_cam_equal(a, b)
    _assert_cam_equal(tcam.stack_cameras(tc), jcam.stack_cameras(jc))


def test_camera_from_numpy_round_trip():
    js = jcam.stack_cameras(jsyn.turntable_cameras(4, radius=2.0))
    ts = tcam.from_numpy(*_cam_fields(js), js.width, js.height, "cpu")
    _assert_cam_equal(ts, js)
    with pytest.raises(ValueError):
        tcam.stack_cameras([
            tcam.PinholeCamera.create(320, 240),
            tcam.PinholeCamera.create(160, 120),
        ])


def test_blob_spheres_bitwise():
    for seed in (0, 3):
        for t, j in zip(tsyn.blob_spheres(seed), jsyn.blob_spheres(seed)):
            assert t.dtype == np.float32
            np.testing.assert_array_equal(t, j)


def test_render_silhouettes_matches_jax():
    """Equal on >= 99.99% of pixels: the two frameworks sum the ray-sphere
    dot products in different orders, so a pixel whose discriminant sits
    within an ulp of 0 can flip."""
    centers, radii = jsyn.blob_spheres(seed=3)
    jm = jsyn.render_silhouettes(
        jsyn.turntable_cameras(4, radius=3.2), centers, radii
    )
    tm = tsyn.render_silhouettes(
        tsyn.turntable_cameras(4, radius=3.2), centers, radii
    )
    assert tm.dtype == torch.uint8 and tuple(tm.shape) == jm.shape
    tm = tm.numpy()
    assert set(np.unique(tm)) <= {0, 255}
    assert 0.05 < (tm == 255).mean() < 0.95
    assert (tm == jm).mean() >= 0.9999


def test_state_numpy_round_trip():
    spec = tgrid.GridSpec((0.0, 0.0, 0.0), (5.4, 4.4, 3.4), 1.0)
    st = tgrid.VoxelGridState.create(spec, "cpu")
    js = jgrid.VoxelGridState.create(jgrid.GridSpec(*GRIDS[2]))
    assert tuple(st.sdf.shape) == (3, 4, 5)
    assert st.sdf.dtype == torch.float32 and st.update_num.dtype == torch.int32
    assert bool((st.sdf == float(INVALID_SDF)).all())
    assert not bool(st.update_num.any())

    rng = np.random.default_rng(0)
    sdf = rng.normal(size=js.sdf.shape).astype(np.float32)
    un = rng.integers(0, 9, size=js.sdf.shape).astype(np.int32)
    js = jgrid.VoxelGridState(sdf=jnp.asarray(sdf), update_num=jnp.asarray(un))
    ts = tgrid.state_from_numpy(np.asarray(js.sdf), np.asarray(js.update_num),
                                "cpu")
    s2, u2 = tgrid.state_to_numpy(ts)
    np.testing.assert_array_equal(s2, sdf)
    np.testing.assert_array_equal(u2, un)
    with pytest.raises(ValueError):
        tgrid.state_from_numpy(sdf, un[:1], "cpu")


@pytest.mark.parametrize("spec", GRIDS, ids=["turntable48", "bunny", "unit"])
def test_centers_zyx_bitwise(spec):
    t = tgrid.GridSpec(*spec).centers_zyx("cpu")
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jgrid.GridSpec(*spec).centers_zyx()))


@pytest.mark.parametrize("length", [0.25, (1.0, 2.0, 0.5)],
                         ids=["scalar", "xyz"])
def test_make_cube_matches_jax(length):
    from vacancy_tpu import mesh as jmesh
    from vacancy_tpu_torch import mesh as tmesh

    t, j = tmesh.make_cube(length), jmesh.make_cube(length)
    np.testing.assert_array_equal(t.vertices, j.vertices)
    np.testing.assert_array_equal(t.faces, j.faces)


def test_ortho_camera_matches_jax():
    """create / with_c2w fields bitwise; projection, unprojection and ray
    directions bitwise; the two products (world_to_camera, ray origins)
    within two ulp of their largest value, as CPU matmuls may sum in
    another order."""
    c2w = jsyn.look_at([0.8, -2.5, 1.9], np.array([0.1, 0.2, -0.3]))
    jc = jcam.OrthoCamera.create(64, 48, c2w=c2w)
    tc = tcam.OrthoCamera.create(64, 48, c2w=c2w)
    c2w2 = jsyn.look_at([-1.5, 0.4, 2.2], np.zeros(3))
    jc2, tc2 = jc.with_c2w(c2w2), tc.with_c2w(c2w2)
    for t, j in ((tc, jc), (tc2, jc2),
                 (tcam.ortho_from_numpy(np.asarray(jc2.c2w),
                                        np.asarray(jc2.w2c), 64, 48, "cpu"),
                  jc2)):
        assert (t.width, t.height) == (j.width, j.height)
        np.testing.assert_array_equal(t.c2w.numpy(), np.asarray(j.c2w))
        np.testing.assert_array_equal(t.w2c.numpy(), np.asarray(j.w2c))

    rng = np.random.default_rng(2)
    pts = rng.uniform(-3, 3, size=(5, 7, 3)).astype(np.float32)
    uv = rng.uniform(0, 64, size=(5, 7, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 4, size=(5, 7)).astype(np.float32)

    def close(t, j):
        j = np.asarray(j)
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=2 * np.spacing(np.abs(j).max()))

    pc = tc2.world_to_camera(torch.from_numpy(pts))
    close(pc, jc2.world_to_camera(jnp.asarray(pts)))
    (tuv, td), (juv, jd) = tc2.project(pc), jc2.project(jnp.asarray(pc))
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(
        tc2.unproject(torch.from_numpy(uv), torch.from_numpy(depth)).numpy(),
        np.asarray(jc2.unproject(jnp.asarray(uv), jnp.asarray(depth))))
    np.testing.assert_array_equal(tc2.ray_c(torch.from_numpy(uv)).numpy(),
                                  np.asarray(jc2.ray_c(jnp.asarray(uv))))
    (to, td), (jo, jd) = (tc2.ray_w(torch.from_numpy(uv)),
                          jc2.ray_w(jnp.asarray(uv)))
    close(to, jo)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_stack_cameras_takes_either_type_not_both():
    ortho = [tcam.OrthoCamera.create(32, 24, c2w=jsyn.look_at(
        [0.0, 0.0, -2.0 - i], np.zeros(3))) for i in range(3)]
    st = tcam.stack_cameras(ortho)
    assert isinstance(st, tcam.OrthoCamera) and st.w2c.shape == (3, 4, 4)
    j = jcam.stack_cameras([jcam.OrthoCamera.create(32, 24, c2w=jsyn.look_at(
        [0.0, 0.0, -2.0 - i], np.zeros(3))) for i in range(3)])
    np.testing.assert_array_equal(st.w2c.numpy(), np.asarray(j.w2c))
    with pytest.raises(ValueError, match="one type"):
        tcam.stack_cameras([ortho[0], tcam.PinholeCamera.create(32, 24)])


def _pinhole_pair():
    c2w = jsyn.look_at([1.3, -0.4, 2.9], np.array([0.1, 0.0, -0.2]))
    kw = dict(c2w=c2w, principal_point=np.array([159.3, 127.65], np.float32),
              focal_length=np.array([258.65, 258.25], np.float32))
    return (tcam.PinholeCamera.create(320, 240, **kw),
            jcam.PinholeCamera.create(320, 240, **kw))


@pytest.mark.parametrize("setter", ["c2w", "principal_point", "focal_length",
                                    "fov_x", "fov_y"])
def test_pinhole_functional_setters_bitwise(setter):
    tc, jc = _pinhole_pair()
    arg = {
        "c2w": jsyn.look_at([-1.5, 0.4, 2.2], np.zeros(3)),
        "principal_point": np.array([100.25, 90.5], np.float32),
        "focal_length": np.array([300.0, 310.5], np.float32),
        "fov_x": 61.5,
        "fov_y": 38.25,
    }[setter]
    t2 = getattr(tc, f"with_{setter}")(arg)
    j2 = getattr(jc, f"with_{setter}")(arg)
    _assert_cam_equal(t2, j2)
    # functional: the camera it was made from is unchanged
    _assert_cam_equal(tc, jc)
    assert t2 is not tc


def test_pinhole_fov_properties_match_jax():
    """atan and the degree conversion may differ by an ulp between the
    two libraries: 4 ulp of the angle."""
    tc, jc = _pinhole_pair()
    for t, j in ((tc.fov_x, jc.fov_x), (tc.fov_y, jc.fov_y)):
        np.testing.assert_array_max_ulp(np.float32(t), np.float32(j),
                                        maxulp=4)
    assert float(tc.with_fov_y(40.0).fov_y) == pytest.approx(40.0, abs=1e-4)
    assert float(tc.with_fov_x(70.0).fov_x) == pytest.approx(70.0, abs=1e-4)
    st = tcam.stack_cameras([tc, tc.with_fov_y(40.0)])
    assert st.fov_y.shape == (2,)


def test_pinhole_projection_methods_match_jax():
    """Projection, unprojection and ray directions: elementwise f32 with
    a division, within 2 ulp (XLA may fuse the multiply and the add);
    the two products (world_to_camera, world rays) within two ulp of
    their largest value, as CPU matmuls may sum in another order."""
    tc, jc = _pinhole_pair()
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, size=(5, 7, 3)).astype(np.float32)
    uv = rng.uniform(0, 240, size=(5, 7, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 4, size=(5, 7)).astype(np.float32)

    def close(t, j):
        j = np.asarray(j)
        assert t.shape == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=2 * np.spacing(np.abs(j).max()))

    pc = tc.world_to_camera(torch.from_numpy(pts))
    close(pc, jc.world_to_camera(jnp.asarray(pts)))
    assert float(pc[..., 2].min()) > 0  # all in front of the camera
    (tuv, td), (juv, jd) = tc.project(pc), jc.project(jnp.asarray(pc.numpy()))
    close(tuv, juv)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    close(tc.unproject(torch.from_numpy(uv), torch.from_numpy(depth)),
          jc.unproject(jnp.asarray(uv), jnp.asarray(depth)))
    # project and unproject invert one another
    back = tc.unproject(tuv, td)
    np.testing.assert_allclose(back.numpy(), pc.numpy(), atol=1e-4)
    rc = tc.ray_c(torch.from_numpy(uv))
    close(rc, jc.ray_c(jnp.asarray(uv)))
    np.testing.assert_allclose(torch.linalg.norm(rc, dim=-1).numpy(), 1.0,
                               atol=1e-6)
    (to, tdir), (jo, jdir) = (tc.ray_w(torch.from_numpy(uv)),
                              jc.ray_w(jnp.asarray(uv)))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    close(tdir, jdir)


def _mesh_pair(seed=3):
    from vacancy_tpu import mesh as jmesh
    from vacancy_tpu_torch import mesh as tmesh

    rng = np.random.default_rng(seed)
    v = rng.normal(size=(30, 3)).astype(np.float32)
    f = rng.integers(0, 30, size=(50, 3)).astype(np.int32)
    f[0] = [4, 4, 9]  # a degenerate face: zero normal, no NaN
    c = rng.integers(0, 256, size=(30, 3)).astype(np.float32)
    return (tmesh.Mesh(vertices=v, faces=f, vertex_colors=c),
            jmesh.Mesh(vertices=v, faces=f, vertex_colors=c))


def _assert_mesh_fields_equal(t, j):
    for name in ("vertices", "faces", "vertex_colors", "normals",
                 "face_normals", "uv", "uv_indices", "normal_indices",
                 "diffuse_texture"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("op", ["calc_face_normal", "calc_normal", "rotate",
                                "translate", "transform", "scale",
                                "scale_xyz", "copy", "clear",
                                "random_color"])
def test_mesh_methods_match_jax(op):
    from vacancy_tpu import mesh as jmesh
    from vacancy_tpu_torch import mesh as tmesh

    t, j = _mesh_pair()
    ang = 0.4
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang),
                                                   0], [0, 0, 1]], np.float32)
    tr = np.array([0.5, -1.25, 3.0], np.float32)
    for m, pkg in ((t, tmesh), (j, jmesh)):
        if op in ("rotate", "transform"):
            m.calc_normal()  # the normals turn with the vertices
        if op == "rotate":
            m.rotate(R)
        elif op == "translate":
            m.translate(tr)
        elif op == "transform":
            m.transform(R, tr)
        elif op == "scale":
            m.scale(2.5)
        elif op == "scale_xyz":
            m.scale(2.0, 0.5, -1.0)
        elif op == "clear":
            m.calc_normal()
            m.clear()
        elif op == "random_color":
            pkg.set_random_vertex_color(m, seed=11)
        elif op != "copy":
            getattr(m, op)()
    if op == "copy":
        tc, jc = t.copy(), j.copy()
        _assert_mesh_fields_equal(tc, jc)
        tc.vertices[0] = 99.0
        assert t.vertices[0, 0] != 99.0  # a deep copy
    if op == "clear":
        assert t.num_vertices == t.num_faces == 0
    if op == "calc_face_normal":
        assert not np.isnan(t.face_normals).any()
        np.testing.assert_array_equal(t.face_normals[0], 0.0)
    _assert_mesh_fields_equal(t, j)


def test_mesh_stats_match_jax():
    from vacancy_tpu_torch import mesh as tmesh

    t, j = _mesh_pair()
    for m in (t, j):
        m.translate(np.array([10.0, -20.0, 0.5], np.float32))
    ts, js = t.calc_stats(), j.calc_stats()
    for name in ("bb_min", "bb_max", "center"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    empty = tmesh.Mesh().calc_stats()
    assert (empty.bb_min > empty.bb_max).all()
    np.testing.assert_array_equal(empty.center, 0.0)


@pytest.mark.parametrize("spec", GRIDS + [((-5.0, -4.0, -3.0), (7.0, 6.0, 5.0),
                                           0.25)],
                         ids=["turntable48", "bunny", "unit", "roundtrip"])
def test_world_to_index_bitwise(spec):
    """``GridSpec.world_to_index`` equals the JAX package's bit for bit on
    random world points, and inverts ``axis_centers`` as the reference's
    round-trip test requires (``tests/test_grid.py``)."""
    jg, tg = jgrid.GridSpec(*spec), tgrid.GridSpec(*spec)
    lo, hi = np.asarray(spec[0]), np.asarray(spec[1])
    pts = np.random.default_rng(4).uniform(lo - 1, hi + 1, size=(257, 3))
    got = tg.world_to_index(pts)
    assert got.dtype == np.float32 and got.shape == (257, 3)
    np.testing.assert_array_equal(got, jg.world_to_index(pts))
    for axis in range(3):
        c = tg.axis_centers(axis)
        p = np.zeros((len(c), 3), np.float32)
        p[:, axis] = c
        np.testing.assert_allclose(tg.world_to_index(p)[:, axis],
                                   np.arange(len(c)), atol=1e-3)


def _bound_names(init_py):
    """The names a package's ``__init__.py`` binds at its top level: its
    imports, assignments, functions and classes (read with ``ast``, so
    nothing of the package is imported)."""
    import ast

    names = set()
    for node in ast.parse(init_py.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return names


def test_port_binds_every_name_the_reference_packages_bind():
    """Each of the JAX package's ``__init__.py`` files (the package, ``io``,
    ``ops``, ``parallel``, ``utils``): every name it binds is an attribute
    of the port's package at the same path."""
    import importlib
    from pathlib import Path

    ref = Path(jgrid.__file__).resolve().parent
    inits = sorted(ref.rglob("__init__.py"))
    assert len(inits) == 5
    for init in inits:
        rel = init.parent.relative_to(ref).parts
        port = importlib.import_module(".".join(("vacancy_tpu_torch",) + rel))
        missing = sorted(n for n in _bound_names(init)
                         if not hasattr(port, n))
        assert not missing, (port.__name__, missing)
