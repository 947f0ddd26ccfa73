"""The port's block-mesh helpers (``vacancy_tpu_torch/parallel/mesh_utils.py``)
vs the JAX package's on the same arguments.

Bars: everything here is host arithmetic, so every comparison is exact:
mesh shapes, axis names, padded bounding boxes (float for float), block
extents and the errors raised. The JAX side runs on the virtual 8-device
CPU mesh of ``tests/conftest.py``; the port's meshes are made of eight
CPU blocks."""

import jax
import numpy as np
import pytest
import torch

from vacancy_tpu import config as jcfg
from vacancy_tpu import grid as jgrid
from vacancy_tpu import parallel as jpar
from vacancy_tpu.parallel import mesh_utils as jmu
from vacancy_tpu_torch import config as tcfg
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch import parallel as tpar
from vacancy_tpu_torch.parallel import mesh_utils as tmu

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("shape,n", [
    ((128, 128, 128), 8), ((4, 128, 128), 8), ((2, 128, 128), 8),
    ((1, 256, 256), 8), ((1, 16, 2), 8), ((6, 64, 64), 6), ((3, 64, 64), 6),
    ((1024, 1024, 1024), 4), ((5, 7, 9), 1), ((30, 30, 30), 30),
])
def test_pick_mesh_shape_equals_jax(shape, n):
    assert tpar.pick_mesh_shape(shape, n) == jpar.pick_mesh_shape(shape, n)


def test_pick_mesh_shape_refuses_what_jax_refuses():
    for pick in (tpar.pick_mesh_shape, jpar.pick_mesh_shape):
        with pytest.raises(ValueError, match="cannot place 8 devices"):
            pick((1, 1, 2), 8)
    assert tmu._prime_factors(360) == jmu._prime_factors(360)


def _meshes(**kw):
    """The same mesh in both packages: eight CPU blocks here, the virtual
    eight-device CPU mesh there."""
    assert len(jax.devices()) >= 8
    return (tpar.make_device_mesh(devices=CPU8, **kw),
            jpar.make_device_mesh(**kw))


MESH_CASES = {
    "default": dict(),
    "n4": dict(n_devices=4),
    "named": dict(n_devices=2, axis_name="model"),
    "z": dict(shape=(8,)),
    "zy": dict(shape=(2, 4)),
    "zyx": dict(shape=(2, 2, 2)),
    "flat": dict(shape=(1, 4, 2)),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_make_device_mesh_equals_jax(case):
    t, j = _meshes(**MESH_CASES[case])
    assert t.axis_names == tuple(j.axis_names)
    assert t.shape == dict(j.shape)
    assert t.size == j.devices.size
    assert tmu.mesh_grid_axes(t) == jmu.mesh_grid_axes(j) or case == "named"
    assert all(d == torch.device("cpu") for d in t.devices)
    assert t.ranks == (0,) * t.size and (t.rank, t.world_size) == (0, 1)


@pytest.mark.parametrize("n_devices", [None, 4, (4,), (2, 4), (2, 2, 2)])
def test_make_device_mesh_from_config_equals_jax(n_devices):
    jc = jcfg.ShardingConfig(n_devices=n_devices)
    tc = tcfg.sharding_config_from(jc)
    assert tc == tcfg.ShardingConfig(axis_name="z", n_devices=n_devices)
    t = tpar.make_device_mesh(devices=CPU8, config=tc)
    j = jpar.make_device_mesh(config=jc)
    assert t.axis_names == tuple(j.axis_names) and t.shape == dict(j.shape)


def test_make_device_mesh_refuses_what_jax_refuses():
    for make, kw in ((tpar.make_device_mesh, dict(devices=CPU8)),
                     (jpar.make_device_mesh, {})):
        with pytest.raises(ValueError, match="needs 16 devices, have 8"):
            make(shape=(4, 4), **kw)
        with pytest.raises(ValueError, match="1-3 dims"):
            make(shape=(1, 2, 2, 2), **kw)


def test_default_devices_are_cards_and_never_the_cpu():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in tmu.default_devices())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.make_device_mesh(shape=(2,))


def test_a_mesh_over_two_processes_splits_its_blocks_in_order():
    """Block k lives on rank k // (blocks per rank): each rank a
    contiguous run of the z-major order, as JAX's process-major device
    order gives."""
    for rank in (0, 1):
        m = tpar.make_device_mesh(shape=(2, 4), devices=["cpu"] * 4,
                                  rank=rank, world_size=2)
        assert m.ranks == (0, 0, 0, 0, 1, 1, 1, 1) and m.size == 8
        sh = tpar.grid_sharding(m)
        assert sh.parts == (2, 4, 1)
        assert sh.local_blocks() == [(rank, by, 0) for by in range(4)]
        assert [d is not None for d in m.devices] == [
            r == rank for r in m.ranks]
        with pytest.raises(ValueError, match="lives on rank"):
            sh.device_of((1 - rank, 0, 0))
    with pytest.raises(ValueError, match="do not divide"):
        tpar.make_device_mesh(shape=(3,), devices=["cpu"] * 2, rank=0,
                              world_size=2)


def _grids(bb_max, res=1.0):
    spec = ((0.0, 0.0, 0.0), tuple(bb_max), res)
    return tgrid.GridSpec(*spec), jgrid.GridSpec(*spec)


@pytest.mark.parametrize("bb_max", [(5.2, 5.2, 5.2), (20.4, 12.4, 16.4),
                                    (7.3, 9.9, 3.1)])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8, (2, 4), (2, 2, 2),
                                      (1, 4, 2)])
def test_pad_bbox_for_sharding_equals_jax(bb_max, n_shards):
    tg, jg = _grids(bb_max)
    if isinstance(n_shards, tuple):
        tm, jm = _meshes(shape=n_shards)
    else:
        tm = jm = n_shards
    tp, jp = tpar.pad_bbox_for_sharding(tg, tm), jpar.pad_bbox_for_sharding(
        jg, jm)
    assert tp.bb_min == jp.bb_min and tp.bb_max == jp.bb_max
    assert tp.resolution == jp.resolution and tp.shape_zyx == jp.shape_zyx
    parts = n_shards if isinstance(n_shards, tuple) else (n_shards,)
    assert all(d % n == 0 for d, n in zip(tp.shape_zyx, parts))
    # and then the extents divide: the block both packages report
    assert tpar.validate_divisible(tp, tm) == jpar.validate_divisible(jp, jm)


def test_pad_bbox_cases_of_the_jax_tests():
    tg, _ = _grids((5.2, 5.2, 5.2))
    padded = tpar.pad_bbox_for_sharding(tg, 4)
    assert padded.shape_zyx[0] == 8
    assert padded.voxel_num[:2] == tg.voxel_num[:2]
    mesh = tpar.make_device_mesh(shape=(2, 2, 2), devices=CPU8)
    assert tpar.pad_bbox_for_sharding(tg, mesh).shape_zyx == (6, 6, 6)
    assert tpar.pad_bbox_for_sharding(padded, 4) is padded


def test_validate_divisible_equals_jax():
    tg, jg = _grids((20.4, 12.4, 16.4))  # 16 x 12 x 20
    tm, jm = _meshes(shape=(2, 4))
    for axis in ("z", "y", "x"):
        assert (tpar.validate_divisible(tg, tm, axis)
                == jpar.validate_divisible(jg, jm, axis))
    assert tpar.validate_divisible(tg, 8) == jpar.validate_divisible(jg, 8)
    tm, jm = _meshes(shape=(1, 8))  # 12 rows over 8 blocks
    for fn, g, m in ((tpar.validate_divisible, tg, tm),
                     (jpar.validate_divisible, jg, jm)):
        with pytest.raises(ValueError, match="y extent 12 not divisible by 8"):
            fn(g, m)


def test_grid_sharding_blocks_and_slices():
    tm, jm = _meshes(shape=(2, 2, 2))
    sh = tpar.grid_sharding(tm)
    shape = (8, 12, 16)
    # the blocks in mesh order cover what JAX's NamedSharding gives its
    # devices in mesh order
    jsh = jpar.grid_sharding(jm)
    jmap = jsh.devices_indices_map(shape)
    want = [tuple((ix.start or 0, ix.stop) for ix in jmap[d])
            for d in jm.devices.reshape(-1)]
    got = [tuple((s.start, s.stop) for s in sh.slices(b, shape))
           for b in sh.blocks()]
    assert got == want
    assert sh.block_shape(shape) == (4, 6, 8)
    with pytest.raises(ValueError, match="not divisible"):
        sh.block_shape((8, 12, 15))
    assert tpar.replicated(tm).parts == (1, 1, 1)
    named = tpar.make_device_mesh(2, devices=CPU8, axis_name="model")
    assert tpar.grid_sharding(named, "model").parts == (2, 1, 1)


def test_sharded_entries_refuse_axes_that_are_not_grid_named():
    """A mesh whose axes are not grid-named (z/y/x) must raise, as in the
    JAX package, and not cut the grid some other way."""
    grid = tgrid.GridSpec((0.0,) * 3, (4.4, 4.4, 4.4), 1.0)
    bad = tpar.make_device_mesh(2, devices=CPU8, axis_name="model")
    st = tgrid.VoxelGridState.create(grid, "cpu")
    views = (torch.eye(4)[None], torch.zeros(1, 2), torch.ones(1, 2),
             torch.zeros(1, 6, 8))
    with pytest.raises(ValueError, match="grid-named"):
        tpar.carve_views_sharded(st, grid, *views, mesh=bad)
    with pytest.raises(ValueError, match="grid-named"):
        tpar.carve_views_warp_sharded(st, grid, *views, mesh=bad)
    with pytest.raises(ValueError, match="grid-named"):
        tpar.extract_mesh_sharded(st, grid, bad)
    with pytest.raises(ValueError, match="need a mesh"):
        tpar.carve_views_warp_sharded(st, grid, *views)


def test_state_create_with_sharding():
    grid = tgrid.GridSpec((0.0,) * 3, (4.4, 4.4, 8.4), 1.0)
    mesh = tpar.make_device_mesh(8, devices=CPU8)
    state = tgrid.VoxelGridState.create(grid, sharding=tpar.grid_sharding(mesh))
    assert len(state.blocks) == 8 and state.shape == (8, 4, 4)
    assert all(tuple(b.sdf.shape) == (1, 4, 4) for b in state.blocks.values())
    dense = state.gather()
    ref = tgrid.VoxelGridState.create(grid, "cpu")
    assert torch.equal(dense.sdf, ref.sdf)
    assert torch.equal(dense.update_num, ref.update_num)
    with pytest.raises(ValueError, match="device or sharding"):
        tgrid.VoxelGridState.create(grid, "cpu",
                                    sharding=tpar.grid_sharding(mesh))
    with pytest.raises(ValueError, match="needs a device"):
        tgrid.VoxelGridState.create(grid)


def test_sharded_state_numpy_round_trip():
    rng = np.random.default_rng(3)
    sdf = rng.normal(size=(8, 6, 4)).astype(np.float32)
    un = rng.integers(0, 5, size=(8, 6, 4)).astype(np.int32)
    mesh = tpar.make_device_mesh(shape=(2, 3, 2), devices=["cpu"] * 12)
    sh = tgrid.sharded_state_from_numpy(sdf, un, mesh)
    assert sorted(sh.blocks) == tpar.grid_sharding(mesh).blocks()
    s, u = tgrid.sharded_state_to_numpy(sh)
    np.testing.assert_array_equal(s, sdf)
    np.testing.assert_array_equal(u, un)
    sh.blocks[(0, 0, 0)].sdf.fill_(7.0)  # blocks are copies
    assert sdf[0, 0, 0] != 7.0
    half = tpar.make_device_mesh(shape=(2,), devices=["cpu"], rank=1,
                                 world_size=2)
    part = tgrid.sharded_state_from_numpy(sdf, un, half)
    assert list(part.blocks) == [(1, 0, 0)]
    np.testing.assert_array_equal(part.blocks[(1, 0, 0)].sdf.numpy(), sdf[4:])
    with pytest.raises(ValueError, match="other processes"):
        part.gather()
