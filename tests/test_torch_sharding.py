"""Sharded == unsharded in the port, and the port's sharded routines vs the
JAX package's, on meshes of CPU blocks (``tests/test_sharding.py`` case by
case).

Bars. Within the port everything is exact: a block's fusion is the dense
engine restricted to the block (update_num equal, sdf bitwise, both
engines, with a ROI), and sharded marching cubes gives the dense mesh
byte for byte (vertex and face order included).
Against the JAX package on its virtual 8-device mesh, on the same numpy
inputs, the bars are the dense engines' own (ROADMAP Queue 3; sharding
adds nothing to them, since each package's sharded result is its dense
one bit for bit): the exact engine's update_num equal but for at most 1%
of ties under MAX, and its sdf within 1e-5 -- Queue 3's 2e-6 was read on
smooth, band-normalized SDF images, while this scene's images are
unit-normal noise, where a last-ulp difference in a projected coordinate
(JAX's dot order) moves a bilinear sample by the local gradient times
1e-6: up to 7e-6 here, and past 2e-6 on 2% of the voxels; the warp engine's update_num differing on at most 1e-4 of the
voxels and |dsdf| <= 1e-5 where it agrees; fused MC fed JAX's state gives
its faces and counts exactly and its vertices within one ulp of the grid
extent (XLA on the CPU contracts the vertex interpolation into an FMA)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sharding import _setup_grid_and_views
from vacancy_tpu import grid as jgrid
from vacancy_tpu import parallel as jpar
from vacancy_tpu_torch import config as tcfg
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch import parallel as tpar
from vacancy_tpu_torch.carver import VoxelCarver
from vacancy_tpu_torch.ops import mc_fused
from vacancy_tpu_torch.ops.fusion import carve_views
from vacancy_tpu_torch.ops.fusion_warp import carve_views_warp
from vacancy_tpu_torch.ops.marching_cubes import extract_mesh
from vacancy_tpu_torch.pipeline import facade_inputs

Z_MESHES = [(2,), (4,), (8,)]
MULTI_AXIS_SHAPES = [(2, 2), (2, 4), (2, 2, 2), (1, 4, 2)]


def _mesh(shape):
    return tpar.make_device_mesh(shape=shape,
                                 devices=["cpu"] * int(np.prod(shape)))


def _views(seed=0, update="MAX"):
    """The JAX sharding tests' 16^3 grid and three views, as numpy arrays
    for both packages: (port grid, JAX grid, (w2c, pp, fl, imgs), roi,
    port option, JAX option)."""
    from vacancy_tpu.config import VoxelUpdate

    jg, w2c, pp, fl, imgs, roi, jopt = _setup_grid_and_views(
        seed=seed, update=VoxelUpdate[update])
    tg = tgrid.GridSpec(jg.bb_min, jg.bb_max, jg.resolution)
    arrays = tuple(np.asarray(a) for a in (w2c, pp, fl, imgs))
    topt = tcfg.VoxelUpdateOption(voxel_update=tcfg.VoxelUpdate[update])
    return tg, jg, arrays, roi, topt, jopt


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _assert_same_state(sharded, dense):
    got = sharded.gather()
    assert torch.equal(got.update_num, dense.update_num)
    assert torch.equal(got.sdf.view(torch.int32), dense.sdf.view(torch.int32))
    assert int((dense.update_num > 0).sum()) > 0


def _assert_same_mesh(a, b):
    assert a.num_faces > 0
    np.testing.assert_array_equal(a.vertices.view(np.int32),
                                  b.vertices.view(np.int32))
    np.testing.assert_array_equal(a.faces, b.faces)


# ----------------------------------------------------------------------
# fusion
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", Z_MESHES + MULTI_AXIS_SHAPES, ids=str)
def test_sharded_fusion_bitwise_equal(shape):
    tg, _, arrays, roi, topt, _ = _views()
    dense = carve_views(tgrid.VoxelGridState.create(tg, "cpu"), tg,
                        *_t(arrays), roi, topt)
    mesh = _mesh(shape)
    # a dense state is cut by the callee; a sharded one is taken as it is
    for state in (tgrid.VoxelGridState.create(tg, "cpu"),
                  tgrid.VoxelGridState.create(
                      tg, sharding=tpar.grid_sharding(mesh))):
        sharded = tpar.carve_views_sharded(state, tg, *_t(arrays), roi, topt,
                                           mesh=mesh)
        assert len(sharded.blocks) == int(np.prod(shape))
        _assert_same_state(sharded, dense)


@pytest.mark.parametrize("shape", Z_MESHES + MULTI_AXIS_SHAPES, ids=str)
def test_sharded_warp_fusion_bitwise_equal(shape):
    """The warp is a per-voxel closed form in the centre vectors, so
    z, y and x block slicing must not change any voxel's update."""
    tg, _, arrays, _, topt, _ = _views(seed=7)
    dense = carve_views_warp(tgrid.VoxelGridState.create(tg, "cpu"), tg,
                             *_t(arrays), opt=topt)
    mesh = _mesh(shape)
    sharded = tpar.carve_views_warp_sharded(
        tgrid.VoxelGridState.create(tg, sharding=tpar.grid_sharding(mesh)),
        tg, *_t(arrays), opt=topt, mesh=mesh)
    _assert_same_state(sharded, dense)


@pytest.mark.parametrize("shape", [(2,), (2, 2, 2)], ids=str)
def test_sharded_fusion_roi_bitwise_equal(shape):
    """A real sub-image ROI through both sharded fusion routines: it is
    purely image-space, so block slicing must not interact with it."""
    tg, _, arrays, _, topt, _ = _views(seed=11)
    _, h, w = arrays[3].shape
    roi = (5, 3, w - 9, h - 6)
    mesh = _mesh(shape)
    new = lambda: tgrid.VoxelGridState.create(tg, "cpu")  # noqa: E731
    _assert_same_state(
        tpar.carve_views_sharded(new(), tg, *_t(arrays), roi, topt,
                                 mesh=mesh),
        carve_views(new(), tg, *_t(arrays), roi, topt))
    dense_w = carve_views_warp(new(), tg, *_t(arrays), opt=topt, roi=roi)
    _assert_same_state(
        tpar.carve_views_warp_sharded(new(), tg, *_t(arrays), opt=topt,
                                      mesh=mesh, roi=roi), dense_w)
    full_w = carve_views_warp(new(), tg, *_t(arrays), opt=topt)
    assert not torch.equal(dense_w.sdf, full_w.sdf)  # the ROI bit


def test_sharded_warp_fusion_chunks_tall_blocks_in_place():
    """A block of more than 128 planes is fused z-chunk by z-chunk into
    its own tensors, as carve_views_warp_blocked does."""
    r = 2.2 / 260
    tg = tgrid.GridSpec((-1.0, -1.0, -1.1),
                        (-1.0 + 12.4 * r, -1.0 + 12.4 * r, -1.1 + 260.4 * r),
                        r)
    assert tg.shape_zyx == (260, 12, 12)  # two blocks of 130 planes
    _, _, arrays, _, topt, _ = _views(seed=7)
    mesh = _mesh((2,))
    state = tgrid.VoxelGridState.create(tg, sharding=tpar.grid_sharding(mesh))
    before = {b: st.sdf for b, st in state.blocks.items()}
    assert all(t.shape[0] == 130 for t in before.values())
    out = tpar.carve_views_warp_sharded(state, tg, *_t(arrays), opt=topt,
                                        mesh=mesh)
    assert all(out.blocks[b].sdf is t for b, t in before.items())
    _assert_same_state(out, carve_views_warp(
        tgrid.VoxelGridState.create(tg, "cpu"), tg, *_t(arrays), opt=topt))


# ----------------------------------------------------------------------
# marching cubes
# ----------------------------------------------------------------------


def _random_state(shape, seed, invalid=0.05, updated=0.9, border=True):
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    sdf = rng.normal(size=shape).astype(np.float32)
    if border:
        sdf[[0, -1], :, :] = 1.0
        sdf[:, [0, -1], :] = 1.0
        sdf[:, :, [0, -1]] = 1.0
    sdf[rng.random(shape) < invalid] = tcfg.INVALID_SDF
    un = (rng.random(shape) < updated).astype(np.int32)
    spec = ((0.0, 0.0, 0.0), (nx + 0.4, ny + 0.4, nz + 0.4), 1.0)
    assert tgrid.GridSpec(*spec).shape_zyx == shape
    return sdf, un, spec


@pytest.mark.parametrize("linear_interp", [True, False],
                         ids=["linear", "nointerp"])
@pytest.mark.parametrize("shape", Z_MESHES, ids=str)
def test_sharded_mc_equals_dense(shape, linear_interp):
    sdf, un, spec = _random_state((16, 12, 20), 5, invalid=0.0, updated=1.0)
    grid, state = tgrid.GridSpec(*spec), tgrid.state_from_numpy(sdf, un, "cpu")
    sh = tpar.extract_mesh_sharded(state, grid, _mesh(shape),
                                   linear_interp=linear_interp)
    _assert_same_mesh(sh, extract_mesh(state, grid,
                                       linear_interp=linear_interp))


@pytest.mark.parametrize("shape", [(2,), (3,), (4,)], ids=str)
@pytest.mark.parametrize("linear_interp", [True, False],
                         ids=["linear", "nointerp"])
def test_sharded_mc_exact_equality_with_invalids(linear_interp, shape):
    sdf, un, spec = _random_state((12, 9, 10), 11, invalid=0.15,
                                  border=False)
    grid, state = tgrid.GridSpec(*spec), tgrid.state_from_numpy(sdf, un, "cpu")
    dense = extract_mesh(state, grid, linear_interp=linear_interp)
    sh = tpar.extract_mesh_sharded(state, grid, _mesh(shape),
                                   linear_interp=linear_interp)
    _assert_same_mesh(sh, dense)


def test_sharded_mc_seams_watertight():
    """A sphere crossing every block boundary stays closed."""
    grid = tgrid.GridSpec((-8.0, -8.0, -16.0), (8.4, 8.4, 16.4), 1.0)
    nz, ny, nx = grid.shape_zyx
    c = grid.centers_zyx("cpu").numpy()
    center = c.reshape(-1, 3).mean(axis=0)
    sdf = (np.linalg.norm(c - center, axis=-1) - 6.0).astype(np.float32)
    state = tgrid.state_from_numpy(sdf, np.ones(sdf.shape, np.int32), "cpu")
    dense = extract_mesh(state, grid)
    for shape in ((8,), (2, 2, 2)):
        sh = tpar.extract_mesh_sharded(state, grid, _mesh(shape))
        e = np.concatenate([sh.faces[:, [0, 1]], sh.faces[:, [1, 2]],
                            sh.faces[:, [2, 0]]])
        _, counts = np.unique(np.sort(e, axis=1), axis=0, return_counts=True)
        assert np.all(counts == 2)  # every edge shared by exactly 2 faces
        _assert_same_mesh(sh, dense)


@pytest.mark.parametrize("shape", MULTI_AXIS_SHAPES, ids=str)
@pytest.mark.parametrize("linear_interp", [True, False],
                         ids=["linear", "nointerp"])
def test_multiaxis_fused_mc_equals_dense(shape, linear_interp):
    """Per-axis sequential halo exchange, local (own_k, own_j, own_i)
    emission windows, global linear ids and the sorted host assembly: the
    byte-identical mesh."""
    sdf, un, spec = _random_state((8, 12, 16), 17)
    grid, state = tgrid.GridSpec(*spec), tgrid.state_from_numpy(sdf, un, "cpu")
    dense = extract_mesh(state, grid, linear_interp=linear_interp)
    mesh = _mesh(shape)
    sh = tpar.extract_mesh_fused_sharded(state, grid, mesh,
                                         linear_interp=linear_interp)
    _assert_same_mesh(sh, dense)
    assert tpar.halo_exchange.last["transport"] == "device copy"
    # a state that is sharded already gives the same mesh
    cut = tgrid.sharded_state_from_numpy(sdf, un, mesh)
    _assert_same_mesh(tpar.extract_mesh_sharded(
        cut, grid, mesh, linear_interp=linear_interp), dense)


def test_halo_exchange_carries_edges_and_corners():
    """Every local block's extended copy equals the global state padded
    with invalid voxels and cut with a one-voxel rim: faces, edges and
    corners, by three axis exchanges and no diagonal one."""
    from vacancy_tpu_torch.parallel import sharded

    sdf, un, _ = _random_state((6, 8, 10), 29, border=False)
    mesh = _mesh((3, 2, 2))
    sh = tgrid.sharded_state_from_numpy(sdf, un, mesh)
    halos = tpar.halo_exchange(sh)
    pad_s = np.pad(sdf, 1, constant_values=tcfg.INVALID_SDF)
    pad_u = np.pad(un, 1, constant_values=0)
    for b in sh.blocks:
        es, eu = sharded._extended_block(sh, halos, b)
        lo = [i * n for i, n in zip(b, (2, 4, 5))]
        sl = tuple(slice(o, o + n + 2) for o, n in zip(lo, (2, 4, 5)))
        np.testing.assert_array_equal(es.numpy(), pad_s[sl])
        np.testing.assert_array_equal(eu.numpy(), pad_u[sl])
    # 12 blocks; bytes: each seam crossed both ways, sdf and update_num
    assert tpar.halo_exchange.last["bytes"] == 8 * sum((
        2 * 2 * (4 * 5) * 4,        # z: 2 seams x 4 columns of blocks
        2 * 1 * (4 * 5) * 6,        # y: slices [2 + 2, 1, 5]
        2 * 1 * (4 * 6) * 6))       # x: slices [2 + 2, 4 + 2, 1]


def test_sharded_extraction_refusals():
    grid = tgrid.GridSpec((0, 0, 0), (8.4, 8.4, 8.4), 1.0)
    state = tgrid.VoxelGridState.create(grid, "cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        tpar.extract_mesh_sharded(state, grid, _mesh((2,)), engine="pallas")
    cut = tgrid.VoxelGridState.create(
        grid, sharding=tpar.grid_sharding(_mesh((2,))))
    with pytest.raises(ValueError, match="is cut"):
        tpar.extract_mesh_sharded(cut, grid, _mesh((4,)))


def test_marching_cubes_sharded_is_the_fused_routine():
    """The JAX package's name gives the fused routine's streams."""
    sdf, un, spec = _random_state((8, 12, 16), 17)
    grid, state = tgrid.GridSpec(*spec), tgrid.state_from_numpy(sdf, un, "cpu")
    mesh = _mesh((2, 2))
    got = tpar.marching_cubes_sharded(state, grid, mesh=mesh)
    want = tpar.marching_cubes_fused_sharded(state, grid, mesh=mesh)
    assert sorted(got) == sorted(want) and len(got) == 4
    for b in want:
        for g, w in zip(got[b].as_tuple(), want[b].as_tuple()):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert sum(len(st.c_lin) for st in got.values()) > 0


@pytest.mark.parametrize("engine", ["auto", "fused", "xla"])
def test_engine_names_give_one_mesh(engine):
    """Each of the JAX package's engine names gives the one engine's
    mesh, byte for byte: through the facade (dense and on a mesh),
    ``extract_mesh`` and ``extract_mesh_sharded``."""
    opt, cams, masks = facade_inputs(16, 3, 64, 48, "cpu")
    dense = VoxelCarver(opt, "cpu")
    assert dense.init()
    dense.carve_batch(cams, masks, engine="warp")
    mesh = _mesh((2,))
    cut = VoxelCarver(opt)
    assert cut.init(sharding=tpar.grid_sharding(mesh))
    cut.carve_batch(cams, masks, engine="warp")
    ref = extract_mesh(dense.state, dense.grid)
    for got in (dense.extract_iso_surface(engine=engine),
                cut.extract_iso_surface(engine=engine),
                extract_mesh(dense.state, dense.grid, engine=engine),
                tpar.extract_mesh_sharded(dense.state, dense.grid, mesh,
                                          engine=engine)):
        _assert_same_mesh(got, ref)


def test_sharded_extraction_launches_no_kernel_on_cpu_blocks():
    before = (mc_fused.marching_cubes_fused.launches,
              mc_fused.mc_tile_counts.launches)
    sdf, un, spec = _random_state((8, 8, 8), 3)
    tpar.extract_mesh_sharded(tgrid.state_from_numpy(sdf, un, "cpu"),
                              tgrid.GridSpec(*spec), _mesh((2, 2)))
    assert (mc_fused.marching_cubes_fused.launches,
            mc_fused.mc_tile_counts.launches) == before


def test_missing_piece_dir_raises_before_any_work():
    """More than one process and no piece_dir: refused at entry, before a
    halo is exchanged or a kernel launched."""
    grid = tgrid.GridSpec((0, 0, 0), (8.4, 8.4, 8.4), 1.0)
    mesh = tpar.make_device_mesh(shape=(2,), devices=["cpu"], rank=0,
                                 world_size=2)
    cut = tgrid.VoxelGridState.create(grid, sharding=tpar.grid_sharding(mesh))
    tpar.halo_exchange.last = {}
    for engine in ("fused", "xla"):
        with pytest.raises(ValueError, match="needs a piece_dir"):
            tpar.extract_mesh_sharded(cut, grid, mesh, engine=engine)
    assert tpar.halo_exchange.last == {}
    with pytest.raises(RuntimeError, match="initialize_distributed first"):
        tpar.pick_transport(mesh)


# ----------------------------------------------------------------------
# the facade on a sharded state
# ----------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["exact", "warp"])
def test_carver_with_a_sharding_equals_the_dense_carver(engine):
    opt, cams, masks = facade_inputs(16, 3, 64, 48, "cpu")
    dense = VoxelCarver(opt, "cpu")
    assert dense.init()
    mesh = _mesh((2, 2))
    cut = VoxelCarver(opt)
    assert cut.init(sharding=tpar.grid_sharding(mesh))
    assert isinstance(cut.state, tgrid.ShardedGridState)
    a = dense.carve_batch(cams[:2], masks[:2], engine=engine)
    b = cut.carve_batch(cams[:2], masks[:2], engine=engine)
    np.testing.assert_array_equal(a, b)
    a = dense.carve(cams[2], silhouette=masks[2], engine=engine)
    b = cut.carve(cams[2], silhouette=masks[2], engine=engine, debug=True)
    np.testing.assert_array_equal(a, b)
    _assert_same_state(cut.state, dense.state)
    _assert_same_mesh(cut.extract_iso_surface(), dense.extract_iso_surface())
    assert (cut.extract_voxel().num_faces
            == dense.extract_voxel().num_faces > 0)
    other = VoxelCarver(opt, "cpu")
    other.restore(cut.state, cut.grid)
    assert other.state is cut.state


# ----------------------------------------------------------------------
# against the JAX package's sharded routines
# ----------------------------------------------------------------------


def _jax_state(jg, sharding=None):
    return jgrid.VoxelGridState.create(jg, sharding=sharding)


@pytest.mark.parametrize("shape", [(8,), (2, 4), (2, 2, 2)], ids=str)
@pytest.mark.parametrize("update", ["MAX", "WEIGHTED_AVERAGE"])
def test_carve_views_sharded_matches_jax(shape, update):
    tg, jg, arrays, roi, topt, jopt = _views(update=update)
    jm = jpar.make_device_mesh(shape=shape)
    j = jpar.carve_views_sharded(
        _jax_state(jg, jpar.grid_sharding(jm)), jg,
        *(jnp.asarray(a) for a in arrays), roi, jopt, mesh=jm)
    t = tpar.carve_views_sharded(tgrid.VoxelGridState.create(tg, "cpu"), tg,
                                 *_t(arrays), roi, topt, mesh=_mesh(shape))
    ts, tu = tgrid.sharded_state_to_numpy(t)
    js, ju = np.asarray(j.sdf), np.asarray(j.update_num)
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    fin = np.isfinite(ts)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=1e-5)
    assert (tu != ju).mean() <= 0.01
    assert (tu > 0).mean() > 0.05


@pytest.mark.parametrize("shape", [(8,), (2, 4), (2, 2, 2)], ids=str)
def test_carve_views_warp_sharded_matches_jax(shape):
    tg, jg, arrays, _, topt, jopt = _views(seed=7)
    jm = jpar.make_device_mesh(shape=shape)
    j = jpar.carve_views_warp_sharded(
        _jax_state(jg, jpar.grid_sharding(jm)), jg,
        *(jnp.asarray(a) for a in arrays), opt=jopt, mesh=jm)
    t = tpar.carve_views_warp_sharded(
        tgrid.VoxelGridState.create(tg, "cpu"), tg, *_t(arrays), opt=topt,
        mesh=_mesh(shape))
    ts, tu = tgrid.sharded_state_to_numpy(t)
    js, ju = np.asarray(j.sdf), np.asarray(j.update_num)
    agree = tu == ju
    assert (~agree).mean() <= 1e-4, (~agree).sum()
    both = agree & np.isfinite(ts) & np.isfinite(js)
    assert np.abs(ts[both] - js[both]).max(initial=0.0) <= 1e-5
    assert (tu > 0).mean() > 0.05


@pytest.mark.parametrize("shape", [(4,), (2, 4), (2, 2, 2)], ids=str)
@pytest.mark.parametrize("linear_interp", [True, False],
                         ids=["linear", "nointerp"])
def test_extract_mesh_fused_sharded_matches_jax(shape, linear_interp):
    """Both packages start from the same numpy state; JAX runs its fused
    kernel in interpret mode under shard_map."""
    sdf, un, spec = _random_state((8, 12, 16), 17)
    tg, jg = tgrid.GridSpec(*spec), jgrid.GridSpec(*spec)
    j = jpar.extract_mesh_fused_sharded(
        jgrid.VoxelGridState(sdf=jnp.asarray(sdf), update_num=jnp.asarray(un)),
        jg, jpar.make_device_mesh(shape=shape), linear_interp=linear_interp,
        interpret=True)
    mesh = _mesh(shape)
    t = tpar.extract_mesh_fused_sharded(
        tgrid.sharded_state_from_numpy(sdf, un, mesh), tg, mesh,
        linear_interp=linear_interp)
    assert (t.num_vertices, t.num_faces) == (j.num_vertices, j.num_faces)
    assert t.num_faces > 0
    np.testing.assert_array_equal(t.faces, j.faces)
    extent = max(b - a for a, b in zip(spec[0], spec[1]))
    np.testing.assert_allclose(t.vertices, j.vertices, rtol=0,
                               atol=float(np.spacing(np.float32(extent))))
