"""The scene generator: one seed gives the same frames, two seeds give
different frames with the same set of shapes."""

import numpy as np
import torch

from harness import driver, scene
from bench_small import small_cell


def _pool(seed):
    _, pool = driver.make_inputs(small_cell(), seed, "cpu")
    return torch.stack(pool)


def test_same_seed_same_frames():
    assert torch.equal(_pool(2**33 + 5), _pool(2**33 + 5))


def test_different_seeds_different_frames():
    a, b = _pool(7), _pool(8)
    assert a.shape == b.shape
    assert not torch.equal(a, b)


def test_seeds_share_the_shapes():
    """Two seeds give the same shapes, moved by small shifts, in another
    order."""
    obj = small_cell().traffic["object"]
    a, b = scene.pool_objects(11, 5, obj), scene.pool_objects(12, 5, obj)
    assert sorted(map(float, np.concatenate([r for _, r in a]))) == \
        sorted(map(float, np.concatenate([r for _, r in b])))
    lo, hi = obj["shift_range"]
    for (ca, ra), (cb, rb) in zip(sorted(a, key=lambda o: float(o[1][0])),
                                  sorted(b, key=lambda o: float(o[1][0]))):
        assert np.array_equal(ra, rb)
        d = (ca - cb).astype(np.float64)
        assert np.all(np.abs(d) <= hi - lo + 1e-6)
        np.testing.assert_allclose(d, np.broadcast_to(d[0], d.shape),
                                   atol=1e-6)  # one shift a frame
    assert [float(r[0]) for _, r in a] != [float(r[0]) for _, r in b]


def test_masks_see_the_object():
    pool = _pool(3)
    assert pool.dtype == torch.uint8
    share = (pool == 255).float().mean().item()
    assert 0.02 < share < 0.6
    assert set(torch.unique(pool).tolist()) == {0, 255}


def test_pool_is_cut_by_mask_bytes():
    cell = small_cell()
    assert driver.pool_frames(cell.config, cell.traffic) == 3
    uhd = small_cell(name="uhd36-512.frames")
    uhd.config["rig"].update(width=3840, height=2160, views=36)
    assert driver.pool_frames(uhd.config, dict(uhd.traffic,
                                                pool_frames=8)) == 4
