"""The fused MC kernel's emission windows and global-id bases: the port's
plain windowed streams vs the JAX kernel
(``vacancy_tpu.ops.mc_fused.mc_fused_call(..., own_k, own_j, own_i, gdims,
yx_base, zb, interpret=True)``) on the same halo-extended random block.

Bars: per-plane counts, every linear id and every case exact; positions
within 1 ulp, the bar of ``tests/test_torch_mc.py`` (XLA on the CPU
contracts the interpolation ``p0 + t * (p1 - p0)`` into an FMA where the
port rounds twice). With the default keywords the streams are bitwise the
unwindowed ones. The CUDA kernel runs only on a card
(``tests/test_torch_kernels.py``), where it must equal this plain version
byte for byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacancy_tpu.ops.mc_fused import mc_fused_call
from vacancy_tpu_torch.config import INVALID_SDF
from vacancy_tpu_torch.ops import mc_fused


def _block(shape, seed):
    """A random local block with invalid voxels and untouched ones, and
    centre vectors that are not uniform (a sharded block's halo centres
    at the grid's boundary are sentinels)."""
    rng = np.random.default_rng(seed)
    sdf = rng.normal(size=shape).astype(np.float32)
    sdf[rng.random(shape) < 0.05] = INVALID_SDF
    un = (rng.random(shape) < 0.9).astype(np.int32)
    centers = [np.cumsum(rng.uniform(0.5, 1.5, size=n)).astype(np.float32)
               for n in shape[::-1]]  # cx, cy, cz
    return sdf, un, centers


def _jax_streams(sdf, un, centers, linear, kw):
    nz, ny, nx = sdf.shape
    outs = mc_fused_call(
        jnp.asarray(sdf), jnp.asarray((un >= 1).astype(np.int8)),
        *(jnp.asarray(c) for c in centers), kw.get("zb"), y_parts=1,
        iso_level=0.0, linear_interp=linear, rows_e=ny + 2, rows_c=ny + 2,
        own_k=kw.get("own_k"), own_j=kw.get("own_j"), own_i=kw.get("own_i"),
        gdims=kw.get("gdims"), yx_base=kw.get("yx_base"), interpret=True)
    counts = np.asarray(outs[8]).reshape(nz, 8)[:, :4]
    streams = []
    for s in range(8):
        blocks = np.asarray(outs[s]).reshape(nz, -1)
        streams.append(np.concatenate(
            [blocks[k, : counts[k, s // 2]] for k in range(nz)]))
    return streams, counts


# a block of a (z, y, x) mesh in the middle of the grid; the first z block
# (zb = -1: plane 0 is a halo outside the grid); a y/x-only split at the
# grid's lower y edge; a window that owns nothing
CASES = {
    "zyx-middle": ((10, 16, 14), dict(
        own_k=(1, 9), own_j=(1, 15), own_i=(1, 13), zb=7,
        yx_base=(13, 11), gdims=(56, 48))),
    "z-first": ((8, 12, 14), dict(own_k=(1, 7), zb=-1)),
    "yx-edge": ((6, 16, 14), dict(
        own_j=(1, 15), own_i=(1, 13), yx_base=(-1, 11), gdims=(28, 36))),
    "empty": ((6, 8, 10), dict(own_k=(2, 2), zb=3)),
}


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
@pytest.mark.parametrize("case", list(CASES))
def test_windowed_plain_streams_equal_jax_kernel(case, linear):
    shape, kw = CASES[case]
    sdf, un, centers = _block(shape, seed=41)
    t = mc_fused.marching_cubes_fused(
        torch.from_numpy(sdf), torch.from_numpy(un),
        *(torch.from_numpy(c) for c in centers), linear_interp=linear, **kw)
    ref, counts = _jax_streams(sdf, un, centers, linear, kw)
    np.testing.assert_array_equal(t.plane_counts.numpy(), counts)
    for s, (got, want) in enumerate(zip(t.as_tuple()[:8], ref)):
        got = got.numpy()
        assert got.dtype == want.dtype
        if s in (0, 2, 4):
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want)
    assert (counts.sum() > 0) == (case != "empty")
    lo, hi = kw.get("own_k", (0, shape[0]))
    assert counts[:lo].sum() == 0 and counts[hi:].sum() == 0


def test_windows_clear_flags_and_bases_shift_ids():
    """What the window does, against the unwindowed streams of the same
    block: exactly the voxels inside it survive, with their ids moved to
    the global grid, and nothing else changes."""
    shape, kw = CASES["zyx-middle"]
    sdf, un, centers = _block(shape, seed=43)
    args = (torch.from_numpy(sdf), torch.from_numpy(un),
            *(torch.from_numpy(c) for c in centers))
    full = mc_fused.mc_streams_plain(*args)
    win = mc_fused.mc_streams_plain(*args, **kw)
    nz, ny, nx = shape
    gny, gnx = kw["gdims"]
    for s in range(4):
        lin = full.as_tuple()[2 * s + 1 if s < 3 else 6].numpy().astype(
            np.int64)
        val = full.as_tuple()[2 * s if s < 3 else 7].numpy()
        k, j, i = lin // (ny * nx), (lin // nx) % ny, lin % nx
        keep = ((k >= 1) & (k < 9) & (j >= 1) & (j < 15) & (i >= 1)
                & (i < 13))
        glin = (((k + 7) * gny + (j + 13)) * gnx + (i + 11))[keep]
        np.testing.assert_array_equal(
            win.as_tuple()[2 * s + 1 if s < 3 else 6].numpy(), glin)
        np.testing.assert_array_equal(
            win.as_tuple()[2 * s if s < 3 else 7].numpy(), val[keep])
        assert 0 < keep.sum() < len(keep)
        assert np.all(np.diff(glin) > 0)  # a block's ids ascend


def test_default_keywords_reproduce_the_unwindowed_streams():
    sdf, un, centers = _block((7, 9, 11), seed=47)
    args = (torch.from_numpy(sdf), torch.from_numpy(un),
            *(torch.from_numpy(c) for c in centers))
    for linear in (True, False):
        a = mc_fused.marching_cubes_fused(*args, linear_interp=linear)
        b = mc_fused.marching_cubes_fused(
            *args, linear_interp=linear, own_k=(0, 7), own_j=(0, 9),
            own_i=(0, 11), zb=0, yx_base=(0, 0), gdims=(9, 11))
        for x, y in zip(a.as_tuple(), b.as_tuple()):
            assert x.dtype == y.dtype
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    np.testing.assert_array_equal(
        mc_fused.mc_tile_counts(*args).numpy(),
        mc_fused.mc_tile_counts(*args, own_k=(0, 7)).numpy())
    one = mc_fused.mc_tile_counts(*args, own_k=(3, 4))
    tpp = mc_fused.tiles_per_plane(9, 11)
    assert int(one[: 3 * tpp].sum()) == int(one[4 * tpp:].sum()) == 0
    assert int(one.sum()) > 0


def test_linear_ids_are_bounded_by_the_global_grid():
    """int32 ids: the bound is on the GLOBAL grid the ids address, not on
    the local array, so a small block of a grid past 2**31 voxels is
    refused and a 1024^3 grid's last block is taken."""
    sdf, un, centers = _block((4, 8, 8), seed=53)
    args = (torch.from_numpy(sdf), torch.from_numpy(un),
            *(torch.from_numpy(c) for c in centers))
    last = dict(own_k=(1, 3), own_j=(1, 7), own_i=(1, 7),
                yx_base=(1017, 1017), gdims=(1024, 1024))
    ok = mc_fused.marching_cubes_fused(*args, zb=1020, **last)
    assert int(ok.c_lin.max()) < 2**31 - 1 and int(ok.c_lin.min()) > 0
    with pytest.raises(ValueError, match="global grid is too large"):
        mc_fused.marching_cubes_fused(*args, zb=2046, **last)
    with pytest.raises(ValueError, match="global grid is too large"):
        mc_fused.mc_tile_counts_plain(
            torch.zeros((3, 2**15, 2**15), device="meta"),
            torch.zeros((3, 2**15, 2**15), device="meta", dtype=torch.int32))
    with pytest.raises(ValueError, match="leave the global plane"):
        mc_fused.marching_cubes_fused(*args, yx_base=(0, 4), gdims=(8, 8))
    with pytest.raises(ValueError, match="leave the global plane"):
        mc_fused.marching_cubes_fused(*args, zb=-1)  # plane 0 is owned
    with pytest.raises(ValueError, match="outside the local extent"):
        mc_fused.marching_cubes_fused(*args, own_j=(1, 9))


def test_sharded_extraction_refuses_a_global_grid_past_int32():
    from vacancy_tpu_torch import grid as tgrid
    from vacancy_tpu_torch import parallel as tpar

    mesh = tpar.make_device_mesh(shape=(2,), devices=["cpu"] * 2)
    sharding = tpar.grid_sharding(mesh)
    shape = (2048, 1024, 1024)
    huge = tgrid.ShardedGridState(blocks={}, sharding=sharding, shape=shape)
    g = tgrid.GridSpec((0.0,) * 3, (1024.4, 1024.4, 2048.4), 1.0)
    assert g.shape_zyx == shape
    with pytest.raises(ValueError, match="global grid is too large"):
        tpar.marching_cubes_fused_sharded(huge, g, mesh=mesh)
    with pytest.raises(ValueError, match="too many voxels"):
        tgrid.VoxelGridState.create(g, sharding=sharding)
