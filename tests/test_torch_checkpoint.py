"""Checkpoints of the port vs the JAX package: a snapshot written by
either ``save_state`` loads through the other's ``load_state`` with equal
sdf and update_num (bitwise), grid, next view and extra; and a carving
run that saves, restores into a new ``VoxelCarver`` and goes on equals the
uninterrupted run bit for bit."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacancy_tpu import checkpoint as jck
from vacancy_tpu import grid as jgrid
from vacancy_tpu_torch import checkpoint as tck
from vacancy_tpu_torch import grid as tgrid
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
    sdf, un = _state()
    st, grid = tgrid.state_from_numpy(sdf, un, "cpu"), tgrid.GridSpec(*SPEC)
    with pytest.raises(NotImplementedError, match="parallel/"):
        tck.save_state(str(tmp_path / "c"), st, grid, force_sharded=True)
    assert os.listdir(tmp_path) == []
    tck.save_state(str(tmp_path / "c"), st, grid)
    with pytest.raises(NotImplementedError, match="parallel/"):
        tck.load_state(str(tmp_path / "c"), sharding=object(), device="cpu")
    (tmp_path / "s.proc0.npz").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="per-process"):
        tck.load_state(str(tmp_path / "s"), device="cpu")
    with pytest.raises(FileNotFoundError):
        tck.load_state(str(tmp_path / "absent"), device="cpu")


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
