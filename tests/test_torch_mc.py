"""The port's one marching-cubes engine -- the fused kernel's plain
version and the host assembly -- vs the JAX package's fused kernel and
its XLA routines (dense, z-slab and blocked), on states loaded from the
same numpy arrays.

Bars: vertex and face counts and faces exact; vertices within 1 ulp.
The compacted streams equal the JAX fused kernel's (interpret mode): ids,
cases and counts exactly, positions within 1 ulp, because XLA on the CPU
contracts the interpolation ``p0 + t * (p1 - p0)`` into an FMA where the
port rounds the product and the sum separately (IEEE, as the CUDA build
with -fmad=false does). The kernel itself runs only on a card
(tests/test_torch_kernels.py), where its streams must equal the plain
version's byte for byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacancy_tpu import grid as jgrid
from vacancy_tpu.ops import marching_cubes as jmc
from vacancy_tpu.ops.marching_cubes import extract_mesh as j_extract
from vacancy_tpu.ops.mc_fused import marching_cubes_fused as j_mc_fused
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch.config import INVALID_SDF
from vacancy_tpu_torch.mesh import Mesh
from vacancy_tpu_torch.ops import marching_cubes as tmc
from vacancy_tpu_torch.ops import mc_fused
from vacancy_tpu_torch.ops.marching_cubes import extract_mesh as t_extract
from vacancy_tpu_torch.ops.mc_tables import TRI_COUNT
from vacancy_tpu_torch.ops.mesh_assembly import assemble_on_card


def _random_state(nz, ny, nx, seed=5, p_invalid=0.05, p_updated=0.9):
    rng = np.random.default_rng(seed)
    sdf = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    sdf[[0, -1], :, :] = 1.0
    sdf[:, [0, -1], :] = 1.0
    sdf[:, :, [0, -1]] = 1.0
    sdf[rng.random((nz, ny, nx)) < p_invalid] = INVALID_SDF
    un = (rng.random((nz, ny, nx)) < p_updated).astype(np.int32)
    spec = ((0.0, 0.0, 0.0), (nx + 0.4, ny + 0.4, nz + 0.4), 1.0)
    return sdf, un, spec


def _sphere_state(nz=24, ny=18, nx=22):
    """A small sphere TSDF in a mostly empty grid, with an untouched
    (update_num 0) slab so the corner-6 rule trims part of it."""
    spec = ((0.0, 0.0, 0.0), (nx + 0.4, ny + 0.4, nz + 0.4), 1.0)
    g = tgrid.GridSpec(*spec)
    cz, cy, cx = (g.axis_centers(a) for a in (2, 1, 0))
    r = np.sqrt((cz[:, None, None] - 12.0) ** 2
                + (cy[None, :, None] - 9.0) ** 2
                + (cx[None, None, :] - 8.0) ** 2)
    sdf = np.clip((r - 5.0) / 2.0, -1, 1).astype(np.float32)
    un = np.ones(sdf.shape, np.int32)
    un[14:16] = 0
    return sdf, un, spec


def _both_meshes(sdf, un, spec, linear):
    t = t_extract(tgrid.state_from_numpy(sdf, un, "cpu"),
                  tgrid.GridSpec(*spec), linear_interp=linear)
    j = j_extract(
        jgrid.VoxelGridState(sdf=jnp.asarray(sdf), update_num=jnp.asarray(un)),
        jgrid.GridSpec(*spec), linear_interp=linear, engine="xla",
    )
    return t, j


def _assert_same_mesh(t, j):
    assert (t.num_vertices, t.num_faces) == (j.num_vertices, j.num_faces)
    np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_array_max_ulp(t.vertices, j.vertices, maxulp=1)


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
@pytest.mark.parametrize("shape", [(16, 12, 20), (9, 21, 13)])
def test_plain_mc_matches_jax_random(shape, linear):
    t, j = _both_meshes(*_random_state(*shape), linear)
    assert j.num_vertices > 0 and j.num_faces > 0
    _assert_same_mesh(t, j)


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
def test_plain_mc_matches_jax_sparse_sphere(linear):
    t, j = _both_meshes(*_sphere_state(), linear)
    assert j.num_faces > 100
    _assert_same_mesh(t, j)


def test_plain_mc_empty_grid():
    sdf = np.ones((7, 8, 9), np.float32)
    un = np.ones(sdf.shape, np.int32)
    spec = ((0.0, 0.0, 0.0), (9.4, 8.4, 7.4), 1.0)
    t, j = _both_meshes(sdf, un, spec, True)
    assert t.num_vertices == t.num_faces == j.num_faces == 0
    _assert_same_mesh(t, j)


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
def test_plain_streams_equal_jax_fused_kernel(linear):
    """Element for element against the JAX fused kernel's compacted
    per-plane blocks (interpret mode), trimmed to its counts; positions
    (streams 0, 2, 4) within 1 ulp, see the module doc."""
    nz, ny, nx = 10, 12, 14
    sdf, un, spec = _random_state(nz, ny, nx, seed=9)
    g = tgrid.GridSpec(*spec)
    t = mc_fused.marching_cubes_fused(
        torch.from_numpy(sdf), torch.from_numpy(un),
        *(torch.from_numpy(g.axis_centers(a)) for a in range(3)),
        linear_interp=linear,
    )
    outs = j_mc_fused(
        jgrid.VoxelGridState(sdf=jnp.asarray(sdf), update_num=jnp.asarray(un)),
        jgrid.GridSpec(*spec), linear_interp=linear, y_parts=1,
        rows_e=ny + 2, rows_c=ny + 2, interpret=True,
    )
    counts = np.asarray(outs[8]).reshape(nz, 8)[:, :4]
    np.testing.assert_array_equal(t.plane_counts.numpy(), counts)
    streams = t.as_tuple()[:8]
    for s in range(8):
        blocks = np.asarray(outs[s]).reshape(nz, -1)
        ref = np.concatenate(
            [blocks[k, : counts[k, s // 2]] for k in range(nz)]
        )
        got = streams[s].numpy()
        assert got.dtype == ref.dtype
        if s in (0, 2, 4):
            np.testing.assert_array_max_ulp(got, ref, maxulp=1)
        else:
            np.testing.assert_array_equal(got, ref)
    assert counts.sum() > 0


def test_wrapper_on_cpu_takes_the_plain_version():
    before = mc_fused.marching_cubes_fused.launches
    sdf, un, spec = _sphere_state()
    t_extract(tgrid.state_from_numpy(sdf, un, "cpu"), tgrid.GridSpec(*spec))
    assert mc_fused.marching_cubes_fused.launches == before



# ----------------------------------------------------------------------
# the one engine against the JAX package's XLA routines
# ----------------------------------------------------------------------


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
def test_extract_mesh_matches_jax_xla_engine(shape, linear):
    """The JAX package's engine name on both sides, on other random
    states than ``test_plain_mc_matches_jax_random``'s."""
    ts, tg, js, jg = _states(*_random_state(*shape, seed=21))
    t = t_extract(ts, tg, linear_interp=linear, engine="xla")
    j = j_extract(js, jg, linear_interp=linear, engine="xla")
    assert j.num_vertices > 0 and j.num_faces > 0
    _assert_same_mesh(t, j)


@pytest.mark.parametrize("iso", [0.0, 0.25])
def test_marching_cubes_dense_returns_components_sized_by_the_counts(iso):
    ts, tg, js, jg = _states(*_sphere_state())
    vcomps, nv, fcomps, nf = tmc.marching_cubes_dense(ts, tg, iso_level=iso)
    assert all(c.shape == (nv,) and c.dtype == torch.float32
               and c.device == ts.sdf.device for c in vcomps)
    assert all(c.shape == (nf,) and c.dtype == torch.int32 for c in fcomps)
    _, jnv, _, jnf = jmc.marching_cubes_dense(
        js, jg, iso_level=iso, vertex_capacity=1 << 14,
        face_capacity=1 << 15)
    assert (nv, nf) == (int(jnv), int(jnf))
    assert nf > 100
    # the components of extract_mesh's mesh, byte for byte
    _assert_bytes_equal(
        Mesh(vertices=torch.stack(vcomps, dim=1).numpy(),
             faces=torch.stack(fcomps, dim=1).numpy()),
        t_extract(ts, tg, iso_level=iso))


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
@pytest.mark.parametrize("case", ["random-slab4", "random-slab5-uneven",
                                  "sphere-slab6"])
def test_extract_mesh_matches_jax_blocked(case, linear):
    state, slab = {
        "random-slab4": (_random_state(16, 12, 20), 4),
        # 17 planes in slabs of 5: the last slab overlaps the one before
        "random-slab5-uneven": (_random_state(17, 9, 11, seed=8), 5),
        "sphere-slab6": (_sphere_state(), 6),
    }[case]
    ts, tg, js, jg = _states(*state)
    j = jmc.extract_mesh_blocked(js, jg, linear_interp=linear, slab_nz=slab)
    assert j.num_faces > 0
    _assert_same_mesh(t_extract(ts, tg, linear_interp=linear), j)


def test_short_grid_matches_jax_blocked():
    """A grid no taller than one slab and its halos: the JAX blocked
    routine falls back to its dense one."""
    ts, tg, js, jg = _states(*_random_state(9, 8, 10))
    j = jmc.extract_mesh_blocked(js, jg, slab_nz=48)
    assert j.num_faces > 0
    _assert_same_mesh(t_extract(ts, tg), j)


@pytest.mark.parametrize("nz, slab, own, slice_lo, edge", [
    (16, 4, (4, 8), 4, "middle"),
    (16, 4, (0, 4), 0, "bottom"),
    # the uneven last window of 17 planes in slabs of 5
    (17, 5, (15, 17), 12, "top"),
], ids=["middle", "bottom", "top-uneven"])
def test_windowed_streams_match_jax_slab_counts(nz, slab, own, slice_lo,
                                                edge):
    """An emission window on planes ``own`` of the whole grid emits the
    vertices and cubes that the JAX slab routine owns there: per-axis
    vertex counts and the face count its cubes expand to."""
    sdf, un, spec = _random_state(nz, 12, 20)
    ts, tg, js, jg = _states(sdf, un, spec)
    st = mc_fused.marching_cubes_fused(
        ts.sdf, ts.update_num, *(tg.axis_centers_t(a, "cpu")
                                 for a in range(3)), own_k=own)
    jout = jmc.marching_cubes_slab(
        js.sdf, js.update_num, jg, jnp.int32(slice_lo), jnp.int32(own[0]),
        jnp.int32(own[1]), slab_nz=slab, vertex_capacity=1 << 13,
        face_capacity=1 << 14, edge=edge)
    lins = (st.vx_lin, st.vy_lin, st.vz_lin)
    assert tuple(len(v) for v in lins) == tuple(int(c) for c in jout[0])
    assert int(TRI_COUNT[st.c_case.numpy()].sum()) == int(jout[3]) > 0
    plane = 12 * 20
    for lin in (*lins, st.c_lin):
        # owner ids ascend and lie in the window's planes
        assert bool((lin[1:] > lin[:-1]).all())
        assert bool(((lin // plane >= own[0]) & (lin // plane < own[1]))
                    .all())


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
@pytest.mark.parametrize("case", ["sphere", "random"])
def test_extract_mesh_on_a_cpu_state_keeps_the_host_assembly(case, linear):
    """A CPU state never reaches the on-card assembly, and its mesh is
    the JAX routine's."""
    state = {"sphere": _sphere_state(),
             "random": _random_state(12, 15, 11, seed=31)}[case]
    before = assemble_on_card.meshes
    t, j = _both_meshes(*state, linear)
    assert assemble_on_card.meshes == before
    assert j.num_faces > 0
    _assert_same_mesh(t, j)


def test_empty_grid_and_unknown_engine():
    sdf = np.ones((7, 8, 9), np.float32)
    un = np.ones(sdf.shape, np.int32)
    ts, tg, _, _ = _states(sdf, un, ((0.0, 0.0, 0.0), (9.4, 8.4, 7.4), 1.0))
    for engine in tmc.ENGINES:
        mesh = t_extract(ts, tg, engine=engine)
        assert mesh.num_vertices == mesh.num_faces == 0
        assert mesh.vertices.shape == (0, 3) and mesh.faces.shape == (0, 3)
    vcomps, nv, fcomps, nf = tmc.marching_cubes_dense(ts, tg)
    assert nv == nf == 0
    assert all(c.shape == (0,) for c in (*vcomps, *fcomps))
    with pytest.raises(ValueError, match="unknown engine"):
        t_extract(ts, tg, engine="pallas")
