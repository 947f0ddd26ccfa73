"""The fused marching-cubes kernel's plain version and the host assembly
vs the JAX package, on states loaded from the same numpy arrays.

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
from vacancy_tpu.ops.marching_cubes import extract_mesh as j_extract
from vacancy_tpu.ops.mc_fused import marching_cubes_fused as j_mc_fused
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch.config import INVALID_SDF
from vacancy_tpu_torch.ops import mc_fused
from vacancy_tpu_torch.ops.marching_cubes import extract_mesh as t_extract


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

