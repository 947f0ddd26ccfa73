"""The port's row sampler (kernel C's plain version), the fused kernel's
row limit and the two-pass engine vs the JAX package on identical numpy
inputs.

Bars: nearest-neighbour samples bitwise; linear samples within one ulp
of the larger of their two taps, since XLA on the CPU contracts the
blend ``(1 - frac) * t0 + frac * t1`` into an FMA (up to ~1e2 ulp of a
result near zero). The two-pass fold as in test_torch_warp: update_num
may differ on at most 1e-4 of the voxels, |dsdf| <= 1e-5 where it
agrees. Kernel C itself runs only on a card (tests/test_torch_kernels.py),
where it must equal the plain version bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vacancy_tpu import config as jcfg
from vacancy_tpu import grid as jgrid
from vacancy_tpu.ops.fusion_warp import carve_views_warp as j_carve
from vacancy_tpu.ops.warp_gather import interp_rows as j_interp_rows
from vacancy_tpu_torch import config as tcfg
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch.ops import fusion_warp, warp_fused, warp_gather
from vacancy_tpu_torch.ops.warp_gather import interp_rows, interp_rows_plain

from test_torch_warp import _assert_close_states, _initial_state, _scene


def _rows_case(share: bool, seed=0, n=3, r=8, w=40, t=16):
    rng = np.random.default_rng(seed)
    tables = rng.normal(size=(1 if share else n, r, w)).astype(np.float32)
    pos = rng.uniform(-1.0, w, size=(n, r, t)).astype(np.float32)
    # the ends of the clipped range and exact integers and half-integers
    pos[:, :, 0] = -1.0
    pos[:, :, 1] = float(w)
    pos[:, :, 2] = np.floor(pos[:, :, 2])
    pos[:, :, 3] = np.floor(pos[:, :, 3]) + 0.5
    return tables, pos


@pytest.mark.parametrize("roi", [None, (5, 30)], ids=["full", "lo-hi"])
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nn"])
@pytest.mark.parametrize("share", [True, False], ids=["shared", "per-n"])
def test_interp_rows_plain_matches_jax(share, linear, roi):
    tables, pos = _rows_case(share)
    w = tables.shape[2]
    lo, hi = roi or (0, None)
    t = interp_rows_plain(torch.from_numpy(tables), torch.from_numpy(pos), w,
                          linear, share, lo, hi).numpy()
    j = np.asarray(j_interp_rows(jnp.asarray(tables), jnp.asarray(pos), w,
                                 linear, share, lo, hi))
    assert t.shape == j.shape == pos.shape
    if not linear:
        np.testing.assert_array_equal(t, j)
        return
    hi_ = w - 1 if hi is None else hi
    p0 = np.clip(np.floor(pos).astype(np.int64), lo, hi_)
    p1 = np.minimum(p0 + 1, hi_)
    n, r = np.indices(pos.shape[:2])
    n = np.zeros_like(n) if share else n
    taps = np.maximum(np.abs(tables[n[..., None], r[..., None], p0]),
                      np.abs(tables[n[..., None], r[..., None], p1]))
    assert np.all(np.abs(t - j) <= np.spacing(taps))
    assert np.mean(t == j) > 0.5


def test_interp_rows_on_cpu_takes_the_plain_version():
    tables, pos = _rows_case(False)
    before = interp_rows.launches
    args = (torch.from_numpy(tables), torch.from_numpy(pos), 40)
    assert torch.equal(interp_rows(*args, lo=3, hi=33),
                       interp_rows_plain(*args, lo=3, hi=33))
    assert interp_rows.launches == before


@pytest.mark.parametrize("lo,hi", [(-1, 10), (5, 4), (0, 40)])
def test_interp_rows_refuses_taps_outside_the_row(lo, hi):
    tables, pos = _rows_case(True)
    with pytest.raises(ValueError, match="taps"):
        interp_rows(torch.from_numpy(tables), torch.from_numpy(pos), 40,
                    lo=lo, hi=hi)


@pytest.mark.parametrize("h,fits", [(1816, True), (1817, False),
                                    (2160, False)])
def test_fused_fits_at_the_h100_limit(h, fits):
    """232,448 bytes is an H100 block's shared-memory opt-in limit: the
    fused kernel's intermediate of h x 32 f32 fits up to 1816 rows."""
    assert warp_fused.max_fused_rows(232_448) == 1816
    assert warp_fused.fused_fits(h, 232_448) is fits


@pytest.mark.parametrize("linear", [True, False], ids=["bilinear", "nn"])
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
def test_two_pass_fold_matches_jax(rule, linear):
    """The two-pass engine with ``interp_rows`` (the branch that carries
    views too tall for the fused kernel) on 72-row images vs JAX's
    carve_views_warp, whose CPU path is the same two-pass scan."""
    shape = (20, 22, 24)
    spec, w2c, pp, fl, imgs = _scene(shape=shape, n_views=3, h=72, w=56,
                                     trunc=rule == "WEIGHTED_AVERAGE")
    kw = dict(voxel_update=tcfg.VoxelUpdate[rule],
              update_outside=tcfg.UpdateOutsideImage.MAX,
              use_truncation=rule == "WEIGHTED_AVERAGE", truncation_band=0.3)
    topt = tcfg.VoxelUpdateOption(**kw)
    jopt = jcfg.VoxelUpdateOption(**{
        k: getattr(jcfg, type(v).__name__)[v.name] if hasattr(v, "name")
        else v for k, v in kw.items()})
    sdf0, un0 = _initial_state(shape)
    grid = tgrid.GridSpec(*spec)
    before = (interp_rows.launches, warp_fused.warp_fuse_planes.launches)
    ts, tu = fusion_warp.warp_fold(
        torch.from_numpy(sdf0), torch.from_numpy(un0),
        *(grid.axis_centers_t(a, "cpu") for a in range(3)),
        torch.from_numpy(w2c), torch.from_numpy(pp), torch.from_numpy(fl),
        torch.from_numpy(imgs), topt, linear, None, warp_gather.interp_rows,
    )
    assert (interp_rows.launches,
            warp_fused.warp_fuse_planes.launches) == before
    jst = j_carve(
        jgrid.VoxelGridState(sdf=jnp.asarray(sdf0),
                             update_num=jnp.asarray(un0)),
        jgrid.GridSpec(*spec), jnp.asarray(w2c), jnp.asarray(pp),
        jnp.asarray(fl), jnp.asarray(imgs), opt=jopt, linear=linear,
    )
    _assert_close_states((ts.numpy(), tu.numpy()),
                         (np.asarray(jst.sdf), np.asarray(jst.update_num)))
