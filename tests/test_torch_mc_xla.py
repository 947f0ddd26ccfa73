"""The port's plain-torch marching-cubes routines (``engine="xla"``: the
dense routine and the z-slab blocked routine) vs the JAX package's XLA
routines on states loaded from the same numpy arrays.

Bars: vertex and face counts, faces and vertex order exact; vertex
positions within 1 ulp (XLA on the CPU contracts the interpolation
``p0 + t * (p1 - p0)`` into an FMA, the port rounds product and sum
separately). Inside the port the routines and the fused engine's plain
version give the same mesh byte for byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mc import _assert_same_mesh, _random_state, _sphere_state
from vacancy_tpu import grid as jgrid
from vacancy_tpu.ops import marching_cubes as jmc
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch.ops import marching_cubes as tmc


def _states(sdf, un, spec):
    return (tgrid.state_from_numpy(sdf, un, "cpu"), tgrid.GridSpec(*spec),
            jgrid.VoxelGridState(sdf=jnp.asarray(sdf),
                                 update_num=jnp.asarray(un)),
            jgrid.GridSpec(*spec))


def _assert_bytes_equal(a, b):
    np.testing.assert_array_equal(a.faces, b.faces)
    np.testing.assert_array_equal(a.vertices.view(np.int32),
                                  b.vertices.view(np.int32))


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
@pytest.mark.parametrize("shape", [(16, 12, 20), (9, 21, 13)])
def test_dense_routine_matches_jax_xla(shape, linear):
    ts, tg, js, jg = _states(*_random_state(*shape))
    t = tmc.extract_mesh(ts, tg, linear_interp=linear, engine="xla")
    j = jmc.extract_mesh(js, jg, linear_interp=linear, engine="xla")
    assert j.num_vertices > 0 and j.num_faces > 0
    _assert_same_mesh(t, j)
    # the engines of the port agree to the byte
    _assert_bytes_equal(
        t, tmc.extract_mesh(ts, tg, linear_interp=linear, engine="fused"))


@pytest.mark.parametrize("iso", [0.0, 0.25])
def test_dense_routine_returns_components_sized_by_the_counts(iso):
    ts, tg, js, jg = _states(*_sphere_state())
    vcomps, nv, fcomps, nf = tmc.marching_cubes_dense(ts, tg, iso_level=iso)
    assert all(c.shape == (nv,) and c.dtype == torch.float32 for c in vcomps)
    assert all(c.shape == (nf,) and c.dtype == torch.int32 for c in fcomps)
    _, jnv, _, jnf = jmc.marching_cubes_dense(
        js, jg, iso_level=iso, vertex_capacity=1 << 14,
        face_capacity=1 << 15)
    assert (nv, nf) == (int(jnv), int(jnf))
    assert nf > 100


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
@pytest.mark.parametrize("case", ["random-slab4", "random-slab5-uneven",
                                  "sphere-slab6"])
def test_blocked_routine_matches_jax_blocked_and_dense(case, linear):
    state, slab = {
        "random-slab4": (_random_state(16, 12, 20), 4),
        # 17 planes in slabs of 5: the last slab overlaps the one before
        "random-slab5-uneven": (_random_state(17, 9, 11, seed=8), 5),
        "sphere-slab6": (_sphere_state(), 6),
    }[case]
    ts, tg, js, jg = _states(*state)
    t = tmc.extract_mesh_blocked(ts, tg, linear_interp=linear, slab_nz=slab)
    j = jmc.extract_mesh_blocked(js, jg, linear_interp=linear, slab_nz=slab)
    assert j.num_faces > 0
    _assert_same_mesh(t, j)
    _assert_bytes_equal(
        t, tmc.extract_mesh(ts, tg, linear_interp=linear, engine="xla"))


def test_blocked_routine_on_a_short_grid_is_the_dense_routine():
    ts, tg, _, _ = _states(*_random_state(9, 8, 10))
    _assert_bytes_equal(tmc.extract_mesh_blocked(ts, tg, slab_nz=48),
                        tmc.extract_mesh(ts, tg, engine="xla"))


def test_one_slab_matches_jax_counts():
    sdf, un, spec = _random_state(16, 12, 20)
    ts, tg, js, jg = _states(sdf, un, spec)
    v_counts, v_pos, v_lin, n_faces, f_ax, f_lin = tmc.marching_cubes_slab(
        ts.sdf, ts.update_num, tg, slice_lo=4, own_lo=4, own_hi=8, slab_nz=4)
    jout = jmc.marching_cubes_slab(
        js.sdf, js.update_num, jg, jnp.int32(4), jnp.int32(4), jnp.int32(8),
        slab_nz=4, vertex_capacity=1 << 13, face_capacity=1 << 14)
    assert tuple(v_counts) == tuple(int(c) for c in jout[0])
    assert n_faces == int(jout[3])
    for a in range(3):
        assert v_lin[a].shape == (v_counts[a],)
        assert all(p.shape == (v_counts[a],) for p in v_pos[a])
        # owner ids ascend: the assembly's searchsorted relies on it
        assert bool((v_lin[a][1:] > v_lin[a][:-1]).all())
    assert all(f.shape == (n_faces,) for f in (*f_ax, *f_lin))


@pytest.mark.parametrize("dims", [(1024, 1024, 1024), (32, 2048, 2048),
                                  (40, 64, 64), (5, 8192, 8192), (3, 4, 5)])
def test_pick_slab_nz_equals_jax(dims):
    assert tmc._pick_slab_nz(*dims) == jmc._pick_slab_nz(*dims)
    assert tmc._DENSE_MAX_VOXELS == jmc._DENSE_MAX_VOXELS


def test_extract_mesh_blocks_a_grid_past_the_dense_budget(monkeypatch):
    ts, tg, js, jg = _states(*_sphere_state())
    dense = tmc.extract_mesh(ts, tg, engine="xla")
    monkeypatch.setattr(tmc, "_DENSE_MAX_VOXELS", 18 * 22 * 5)
    calls = []
    blocked = tmc.extract_mesh_blocked

    def spy(*a, **k):
        calls.append(k["slab_nz"])
        return blocked(*a, **k)

    monkeypatch.setattr(tmc, "extract_mesh_blocked", spy)
    out = tmc.extract_mesh(ts, tg, engine="xla")
    assert calls == [5]
    _assert_bytes_equal(out, dense)
    # "auto" stays the fused engine whatever the size
    tmc.extract_mesh(ts, tg)
    assert calls == [5]


def test_empty_grid_and_unknown_engine():
    sdf = np.ones((7, 8, 9), np.float32)
    un = np.ones(sdf.shape, np.int32)
    ts, tg, js, jg = _states(sdf, un, ((0.0, 0.0, 0.0), (9.4, 8.4, 7.4), 1.0))
    for mesh in (tmc.extract_mesh(ts, tg, engine="xla"),
                 tmc.extract_mesh_blocked(ts, tg, slab_nz=2)):
        assert mesh.num_vertices == mesh.num_faces == 0
        assert mesh.vertices.shape == (0, 3) and mesh.faces.shape == (0, 3)
    with pytest.raises(ValueError, match="unknown engine"):
        tmc.extract_mesh(ts, tg, engine="pallas")
