"""Checkpoints of the port vs the JAX package: a snapshot written by
either ``save_state`` loads through the other's ``load_state`` with equal
sdf and update_num (bitwise), grid, next view and extra; and a carving
run that saves, restores into a new ``VoxelCarver`` and goes on equals the
uninterrupted run bit for bit. The per-process layout of a sharded state
(``path.proc{K}.npz``, blocks keyed by their global offsets) is held the
same way: files written by ``vacancy_tpu.checkpoint.save_state(
force_sharded=True)`` on the virtual 8-device mesh load in the port on a
mesh of CPU blocks, and the reverse, block for block and bitwise."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from vacancy_tpu import checkpoint as jck
from vacancy_tpu import grid as jgrid
from vacancy_tpu import parallel as jpar
from vacancy_tpu_torch import checkpoint as tck
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch import parallel as tpar
from vacancy_tpu_torch.carver import VoxelCarver
from vacancy_tpu_torch.config import INVALID_SDF
from vacancy_tpu_torch.pipeline import facade_inputs

SPEC = ((-1.0, -2.0, 0.5), (1.45, 0.9, 2.2), 0.25)


def _state(seed=4):
    rng = np.random.default_rng(seed)
    shape = tgrid.GridSpec(*SPEC).shape_zyx
    sdf = rng.normal(size=shape).astype(np.float32)
    sdf[rng.random(shape) < 0.2] = INVALID_SDF
    un = rng.integers(0, 7, size=shape).astype(np.int32)
    return sdf, un


def _assert_loaded(state, grid, next_view, extra, sdf, un, spec_cls):
    s, u = np.asarray(state.sdf), np.asarray(state.update_num)
    assert s.dtype == np.float32 and u.dtype == np.int32
    np.testing.assert_array_equal(s.view(np.int32), sdf.view(np.int32))
    np.testing.assert_array_equal(u, un)
    assert grid == spec_cls(*SPEC)
    assert next_view == 3 and extra == {"run": "a", "views": [0, 1, 2]}


EXTRA = {"run": "a", "views": [0, 1, 2]}


def test_port_checkpoint_loads_in_jax(tmp_path):
    sdf, un = _state()
    path = str(tmp_path / "sub" / "ckpt")  # the directory is made
    tck.save_state(path, tgrid.state_from_numpy(sdf, un, "cpu"),
                   tgrid.GridSpec(*SPEC), next_view=3, extra=EXTRA)
    assert os.listdir(tmp_path / "sub") == ["ckpt.npz"]  # no temp file left
    _assert_loaded(*jck.load_state(path), sdf, un, jgrid.GridSpec)


def test_jax_checkpoint_loads_in_port(tmp_path):
    sdf, un = _state()
    path = str(tmp_path / "ckpt.npz")
    jck.save_state(path, jgrid.VoxelGridState(sdf=jnp.asarray(sdf),
                                              update_num=jnp.asarray(un)),
                   jgrid.GridSpec(*SPEC), next_view=3, extra=EXTRA)
    state, grid, nv, extra = tck.load_state(path, device="cpu")
    assert state.sdf.device.type == "cpu" and state.sdf.is_contiguous()
    _assert_loaded(state, grid, nv, extra, sdf, un, tgrid.GridSpec)


def test_both_packages_write_the_same_keys_and_meta(tmp_path):
    sdf, un = _state()
    tck.save_state(str(tmp_path / "t"), tgrid.state_from_numpy(sdf, un, "cpu"),
                   tgrid.GridSpec(*SPEC), next_view=3, extra=EXTRA)
    jck.save_state(str(tmp_path / "j"),
                   jgrid.VoxelGridState(sdf=jnp.asarray(sdf),
                                        update_num=jnp.asarray(un)),
                   jgrid.GridSpec(*SPEC), next_view=3, extra=EXTRA)
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files) == ["meta", "sdf",
                                                      "update_num"]
        assert json.loads(str(t["meta"])) == json.loads(str(j["meta"]))
        for k in ("sdf", "update_num"):
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])


def test_port_round_trip_defaults_and_overwrite(tmp_path):
    sdf, un = _state()
    path = str(tmp_path / "c.npz")
    st = tgrid.state_from_numpy(sdf, un, "cpu")
    tck.save_state(path, st, tgrid.GridSpec(*SPEC))
    _, _, nv, extra = tck.load_state(path, device="cpu")
    assert nv == 0 and extra == {}
    st.update_num.add_(1)
    tck.save_state(path, st, tgrid.GridSpec(*SPEC), next_view=1)
    state, _, nv, _ = tck.load_state(str(tmp_path / "c"), device="cpu")
    assert nv == 1
    np.testing.assert_array_equal(state.update_num.numpy(), un + 1)


def test_what_waits_for_the_multi_device_port_raises(tmp_path):
    """Nothing waits any more: the per-process layout is written and read.
    What still raises is what the JAX package refuses too."""
    sdf, un = _state()
    st, grid = tgrid.state_from_numpy(sdf, un, "cpu"), tgrid.GridSpec(*SPEC)
    tck.save_state(str(tmp_path / "c"), st, grid, force_sharded=True)
    assert os.listdir(tmp_path) == ["c.proc0.npz"]
    with np.load(tmp_path / "c.proc0.npz") as z:
        assert sorted(z.files) == ["meta", "sdf_z0_y0_x0",
                                   "update_num_z0_y0_x0"]
    with pytest.raises(ValueError, match="requires a sharding"):
        tck.load_state(str(tmp_path / "c"), device="cpu")
    whole = tpar.grid_sharding(tpar.make_device_mesh(1, devices=["cpu"]))
    state, grid2, nv, extra = tck.load_state(str(tmp_path / "c"),
                                             sharding=whole)
    assert grid2 == grid and nv == 0 and extra == {}
    assert torch.equal(state.gather().sdf.view(torch.int32),
                       st.sdf.view(torch.int32))
    with pytest.raises(FileNotFoundError):
        tck.load_state(str(tmp_path / "absent"), device="cpu")
    with pytest.raises(FileNotFoundError):
        tck.load_state(str(tmp_path / "absent"), sharding=whole)


# a grid that a (2, 2, 2) and a (2, 4) mesh both divide: 8 x 8 x 8
SPEC8 = ((0.0, 0.0, 0.0), (8.4, 8.4, 8.4), 1.0)


def _state8(seed=6):
    rng = np.random.default_rng(seed)
    sdf = rng.normal(size=(8, 8, 8)).astype(np.float32)
    sdf[rng.random((8, 8, 8)) < 0.2] = INVALID_SDF
    return sdf, rng.integers(0, 7, size=(8, 8, 8)).astype(np.int32)


def _cpu_mesh(shape):
    return tpar.make_device_mesh(shape=shape,
                                 devices=["cpu"] * int(np.prod(shape)))


@pytest.mark.parametrize("shape", [(8,), (2, 4), (2, 2, 2)], ids=str)
def test_jax_per_process_checkpoint_loads_in_port(tmp_path, shape):
    sdf, un = _state8()
    jm = jpar.make_device_mesh(shape=shape)
    jsh = jpar.grid_sharding(jm)
    jck.save_state(
        str(tmp_path / "j"),
        jgrid.VoxelGridState(sdf=jax.device_put(sdf, jsh),
                             update_num=jax.device_put(un, jsh)),
        jgrid.GridSpec(*SPEC8), next_view=3, extra=EXTRA, force_sharded=True)
    assert os.listdir(tmp_path) == ["j.proc0.npz"]
    mesh = _cpu_mesh(shape)
    state, grid, nv, extra = tck.load_state(
        str(tmp_path / "j"), sharding=tpar.grid_sharding(mesh))
    assert grid == tgrid.GridSpec(*SPEC8) and nv == 3 and extra == EXTRA
    assert len(state.blocks) == 8
    s, u = tgrid.sharded_state_to_numpy(state)
    np.testing.assert_array_equal(s.view(np.int32), sdf.view(np.int32))
    np.testing.assert_array_equal(u, un)


@pytest.mark.parametrize("shape", [(8,), (2, 4), (2, 2, 2)], ids=str)
def test_port_per_process_checkpoint_loads_in_jax(tmp_path, shape):
    sdf, un = _state8()
    mesh = _cpu_mesh(shape)
    tck.save_state(str(tmp_path / "t"),
                   tgrid.sharded_state_from_numpy(sdf, un, mesh),
                   tgrid.GridSpec(*SPEC8), next_view=3, extra=EXTRA)
    assert os.listdir(tmp_path) == ["t.proc0.npz"]  # no temp file left
    jsh = jpar.grid_sharding(jpar.make_device_mesh(shape=shape))
    state, grid, nv, extra = jck.load_state(str(tmp_path / "t"), sharding=jsh)
    assert grid == jgrid.GridSpec(*SPEC8) and nv == 3 and extra == EXTRA
    assert state.sdf.sharding.num_devices == 8
    np.testing.assert_array_equal(np.asarray(state.sdf).view(np.int32),
                                  sdf.view(np.int32))
    np.testing.assert_array_equal(np.asarray(state.update_num), un)
    # and the two packages write the same keys for the same cut
    jck.save_state(str(tmp_path / "j"), state, grid, next_view=3,
                   extra=EXTRA, force_sharded=True)
    with np.load(tmp_path / "t.proc0.npz") as t, \
            np.load(tmp_path / "j.proc0.npz") as j:
        assert sorted(t.files) == sorted(j.files) and len(t.files) == 17
        assert json.loads(str(t["meta"])) == json.loads(str(j["meta"]))
        for k in t.files:
            if k != "meta":
                assert t[k].dtype == j[k].dtype
                np.testing.assert_array_equal(t[k], j[k])


def test_sharded_checkpoint_reads_old_z_only_keys(tmp_path):
    """Files from before the multi-axis meshes keyed a block by its z
    offset alone."""
    sdf, un = _state8()
    meta = json.dumps({"bb_min": SPEC8[0], "bb_max": SPEC8[1],
                       "resolution": SPEC8[2], "next_view": 2, "extra": {}})
    np.savez(tmp_path / "old.proc0.npz", meta=meta,
             **{f"{f}_z{z0}": a[z0:z0 + 4] for f, a in
                (("sdf", sdf), ("update_num", un)) for z0 in (0, 4)})
    state, _, nv, _ = tck.load_state(
        str(tmp_path / "old"), sharding=tpar.grid_sharding(_cpu_mesh((2,))))
    assert nv == 2
    s, u = tgrid.sharded_state_to_numpy(state)
    np.testing.assert_array_equal(s.view(np.int32), sdf.view(np.int32))
    np.testing.assert_array_equal(u, un)


def test_sharded_checkpoint_refuses_a_different_layout(tmp_path):
    sdf, un = _state8()
    grid = tgrid.GridSpec(*SPEC8)
    tck.save_state(str(tmp_path / "c"), tgrid.sharded_state_from_numpy(
        sdf, un, _cpu_mesh((2,))), grid)
    for shape in ((4,), (2, 2)):
        with pytest.raises(ValueError, match="different process layout"):
            tck.load_state(str(tmp_path / "c"),
                           sharding=tpar.grid_sharding(_cpu_mesh(shape)))
    # an orphaned temp of a crashed save is never read
    (tmp_path / "c.proc1.tmp99.npz").write_bytes(b"half a zip")
    state, *_ = tck.load_state(
        str(tmp_path / "c"), sharding=tpar.grid_sharding(_cpu_mesh((2,))))
    assert len(state.blocks) == 2
    # a single-file snapshot loads onto a mesh too, cut on the way in
    tck.save_state(str(tmp_path / "one"),
                   tgrid.state_from_numpy(sdf, un, "cpu"), grid)
    cut, *_ = tck.load_state(
        str(tmp_path / "one"),
        sharding=tpar.grid_sharding(_cpu_mesh((2, 2, 2))))
    assert len(cut.blocks) == 8
    np.testing.assert_array_equal(
        tgrid.sharded_state_to_numpy(cut)[0].view(np.int32),
        sdf.view(np.int32))


def test_load_refuses_a_state_that_does_not_fit_its_grid(tmp_path):
    sdf, un = _state()
    meta = json.dumps({"bb_min": SPEC[0], "bb_max": SPEC[1],
                       "resolution": SPEC[2], "next_view": 0, "extra": {}})
    np.savez(tmp_path / "bad.npz", sdf=sdf[1:], update_num=un[1:], meta=meta)
    with pytest.raises(ValueError, match="does not fit"):
        tck.load_state(str(tmp_path / "bad.npz"), device="cpu")


def test_a_failed_write_leaves_no_file(tmp_path, monkeypatch):
    def boom(path, **payload):
        with open(path, "wb") as f:
            f.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(tck.np, "savez_compressed", boom)
    with pytest.raises(OSError, match="disk full"):
        tck.save_state(str(tmp_path / "c"), tgrid.state_from_numpy(
            *_state(), "cpu"), tgrid.GridSpec(*SPEC))
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("engine", ["exact", "warp"])
def test_carver_resumes_from_a_checkpoint(tmp_path, engine):
    """Views 0-1, save; a new carver restores and fuses views 2-3: the
    state of the uninterrupted run, bit for bit."""
    opt, cams, masks = facade_inputs(20, 4, 64, 48, "cpu")
    whole = VoxelCarver(opt, "cpu")
    assert whole.init()
    for i in range(4):
        whole.carve(cams[i], silhouette=masks[i], engine=engine)

    first = VoxelCarver(opt, "cpu")
    assert first.init()
    path = str(tmp_path / "run")
    for i in range(2):
        first.carve(cams[i], silhouette=masks[i], engine=engine)
        tck.save_state(path, first.state, first.grid, next_view=i + 1)

    state, grid, start, _ = tck.load_state(path, device="cpu")
    assert start == 2 and grid == first.grid
    second = VoxelCarver(opt, "cpu")
    second.restore(state, grid)
    for i in range(start, 4):
        second.carve(cams[i], silhouette=masks[i], engine=engine)
    assert torch.equal(second.state.update_num, whole.state.update_num)
    assert torch.equal(second.state.sdf.view(torch.int32),
                       whole.state.sdf.view(torch.int32))
    assert int((whole.state.update_num > 0).sum()) > 0
    with pytest.raises(ValueError, match="does not fit"):
        second.restore(tgrid.VoxelGridState(sdf=state.sdf[1:],
                                            update_num=state.update_num[1:]),
                       grid)
