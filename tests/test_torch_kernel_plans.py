"""The launch plans of the port's redesigned kernels, on the CPU.

Kernel A (``csrc/warp_fused.cu``) and kernel B's scan (``csrc/mc_fused.cu``)
run only on a card; what decides their launches is plain Python
(``warp_fused.fused_plan``, ``mc_fused.scan_blocks``) or is small enough to
emulate here in numpy and torch: the tiling must cover every voxel or tile
exactly once, fit the card's shared memory and registers, and the blocked
scan must be ``torch.cumsum``. The last tests hold ``warp_fuse_planes`` on
CPU tensors (its plain version) against the JAX package's
``warp_fuse_planes`` in interpret mode on shapes that straddle the new
tiling, at test_torch_warp's bar: update_num differs on at most 1e-4 of
the voxels, and where it agrees the sdf is finite in the same places and
within 1e-5 (XLA on the CPU contracts multiply-adds that the port rounds
twice); with nearest-neighbour sampling at most 2e-4 of the voxels (one
of the 8880 at 6 x 37 x 40) may take the neighbouring pixel instead, where
a sample position lies within an ulp of a half pixel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_warp import _initial_state, _opts, _scene
from vacancy_tpu import grid as jgrid
from vacancy_tpu.ops.warp_fused import _extend_centers
from vacancy_tpu.ops.warp_fused import warp_fuse_planes as j_fuse_planes
from vacancy_tpu_torch import config as tcfg
from vacancy_tpu_torch import grid as tgrid
from vacancy_tpu_torch.ops import mc_fused, warp_fused

H100_OPTIN = 232_448  # bytes of shared memory a block may opt into
SM_REGISTERS = 65_536
WARPS = warp_fused.THREADS // 32


@pytest.mark.parametrize("optin", [H100_OPTIN, 101_376, 49_152])
def test_max_fused_rows_is_unchanged(optin):
    """``carve_views_warp`` still hands kernel A what ``h * 32`` f32 of
    shared memory would hold: 1816 rows on an H100."""
    assert warp_fused.max_fused_rows(optin) == optin // (32 * 4)
    assert warp_fused.max_fused_rows(H100_OPTIN) == 1816
    assert warp_fused.fused_fits(1816, H100_OPTIN)
    assert not warp_fused.fused_fits(1817, H100_OPTIN)


PLAN_SHAPES = [
    (1, 1, 1, 1), (6, 37, 40, 48), (5, 130, 33, 48), (72, 80, 96, 240),
    (128, 1024, 1024, 240), (512, 512, 512, 240), (4, 64, 32, 385),
    (3, 65, 31, 1816), (65535, 2, 2, 8),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_fused_plan_covers_every_voxel_once_and_fits(shape):
    nz, ny, nx, h = shape
    plan = warp_fused.fused_plan(nz, ny, nx, h, H100_OPTIN)
    # shared memory: the card's limit, and two rows for a linear tap pair
    assert plan.smem_bytes <= H100_OPTIN
    assert plan.smem_bytes == (plan.inter_rows * warp_fused.TILE_X * 4
                               + warp_fused.STATIC_SMEM_BYTES)
    assert plan.inter_rows == min(h, warp_fused.INTER_ROWS_CAP)
    assert plan.inter_rows >= min(h, 2)
    # registers: the budget the kernel is compiled to lets four CTAs of 256
    # threads share an SM, and so does their shared memory
    ctas = SM_REGISTERS // (warp_fused.REGISTER_BUDGET * warp_fused.THREADS)
    assert ctas == 4
    assert ctas * (warp_fused.INTER_ROWS_CAP * warp_fused.TILE_X * 4
                   + warp_fused.STATIC_SMEM_BYTES + 1024) <= 233_472
    # the grid, walked as the kernel walks it: x = bx * 32 + lane,
    # y = by * TILE_Y + r * warps + warp
    gx, gz, gy = plan.grid
    assert gz == nz and gz <= 65535 and gy <= 65535
    vpt = warp_fused.TILE_Y // WARPS
    seen = np.zeros((ny, nx), np.int32)
    for by in range(gy):
        y = (by * warp_fused.TILE_Y + np.arange(vpt)[:, None] * WARPS
             + np.arange(WARPS)[None, :]).reshape(-1)
        y = y[y < ny]
        for bx in range(gx):
            x = bx * warp_fused.TILE_X + np.arange(warp_fused.TILE_X)
            seen[np.ix_(y, x[x < nx])] += 1
    assert (seen == 1).all()


def test_fused_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="at most 1816 rows"):
        warp_fused.fused_plan(8, 8, 8, 1817, H100_OPTIN)
    with pytest.raises(ValueError, match="65535"):
        warp_fused.fused_plan(65536, 8, 8, 48, H100_OPTIN)
    with pytest.raises(ValueError, match="empty"):
        warp_fused.fused_plan(8, 0, 8, 48, H100_OPTIN)
    # a card too small for two rows beside the kernel's fixed arrays
    with pytest.raises(ValueError, match="no two rows"):
        warp_fused.fused_plan(8, 8, 8, 4,
                              warp_fused.STATIC_SMEM_BYTES + 4 * 32 * 4 - 300)
    small = warp_fused.fused_plan(8, 8, 8, 310, 40_000)
    assert small.inter_rows == (40_000 - warp_fused.STATIC_SMEM_BYTES) // 128
    assert small.smem_bytes <= 40_000


def _band_chunks(blo, pmax, y1, inter_rows, linear):
    """The kernel's walk over a band of tapped rows: [(first row, last row
    computed, first tap rows handled)] per chunk, as csrc/warp_fused.cu's
    loop over ``rc`` makes them."""
    step = max(inter_rows - 1, 1) if linear else inter_rows
    bhi = min(pmax + 1, y1) if linear else pmax
    chunks, rc = [], blo
    while True:
        rend = min(rc + inter_rows - 1, bhi)
        chunks.append((rc, rend, range(rc, rc + step)))
        if rc + step > pmax:
            return chunks
        rc += step


@pytest.mark.parametrize("linear", [True, False], ids=["bilinear", "nn"])
@pytest.mark.parametrize("band", [(0, 0, 0), (5, 5, 239), (0, 239, 239),
                                  (3, 1799, 1799), (100, 867, 1815),
                                  (0, 383, 1000), (0, 382, 1000),
                                  (17, 17 + 2 * 383, 1815)])
def test_band_chunks_hold_every_tap_once(band, linear):
    """Every first tap row of the band falls into exactly one chunk, whose
    computed rows hold it and, for a linear pair, the row after it."""
    blo, pmax, y1 = band
    rows = min(y1 + 1, warp_fused.INTER_ROWS_CAP)
    chunks = _band_chunks(blo, pmax, y1, rows, linear)
    for p0 in range(blo, pmax + 1):
        holders = [c for c in chunks if p0 in c[2]]
        assert len(holders) == 1
        rc, rend, _ = holders[0]
        p1 = min(p0 + 1, y1) if linear else p0
        assert rc <= p0 <= p1 <= rend and rend - rc < rows
    assert len(chunks) == 1 or pmax - blo + 1 > rows - int(linear)


SCAN_SIZES = [1, 7, 2100, 3 * mc_fused.SCAN_BLOCK + 5, 131_072]


@pytest.mark.parametrize("n_tiles", SCAN_SIZES + [1_048_576])
def test_scan_blocks_cover_every_tile_once(n_tiles):
    blocks = mc_fused.scan_blocks(n_tiles)
    assert blocks >= 1
    assert (blocks - 1) * mc_fused.SCAN_BLOCK < n_tiles
    assert blocks * mc_fused.SCAN_BLOCK >= n_tiles
    # the scratch array: one int4 per block
    assert blocks * 16 <= 16 * (n_tiles // mc_fused.SCAN_BLOCK + 1)


def _scan_blocked(tile_counts, tpp, block=mc_fused.SCAN_BLOCK, top=1024):
    """The scan pass as csrc/mc_fused.cu makes it, in plain torch without
    ``cumsum``: the sum of each block of tiles; one pass over the block
    sums, ``top`` at a time with a running carry; every block's tiles from
    its block's prefix; the per-plane differences."""
    n = tile_counts.shape[0]
    blocks = mc_fused.scan_blocks(n)
    sums = torch.zeros((blocks, 4), dtype=torch.int32)
    for b in range(blocks):
        sums[b] = tile_counts[b * block:(b + 1) * block].sum(
            dim=0, dtype=torch.int32)
    prefix = torch.zeros_like(sums)
    carry = torch.zeros(4, dtype=torch.int32)
    for b0 in range(0, blocks, top):
        for b in range(b0, min(b0 + top, blocks)):
            prefix[b] = carry
            carry = carry + sums[b]
    totals = carry
    offsets = torch.empty_like(tile_counts)
    for b in range(blocks):
        run = prefix[b].clone()
        for t in range(b * block, min((b + 1) * block, n)):
            offsets[t] = run
            run = run + tile_counts[t]
    nz = n // tpp
    ends = torch.cat([offsets[tpp::tpp], totals[None]])
    return offsets, totals, ends - offsets[::tpp][:nz]


@pytest.mark.parametrize("n_tiles,tpp", [(1, 1), (7, 1), (2100, 7),
                                         (3 * 1024 + 5, 17)])
def test_blocked_scan_equals_plain_and_cumsum(n_tiles, tpp):
    assert n_tiles % tpp == 0
    rng = np.random.default_rng(n_tiles)
    counts = torch.from_numpy(rng.integers(
        0, mc_fused.TILE + 1, size=(n_tiles, 4)).astype(np.int32))
    got = _scan_blocked(counts, tpp)
    plain = mc_fused.mc_scan_plain(counts, tpp)
    wrapper = mc_fused.mc_scan(counts, tpp)  # CPU tensors: the plain version
    incl = torch.cumsum(counts, dim=0, dtype=torch.int32)
    for g, p, w in zip(got, plain, wrapper):
        assert g.dtype == p.dtype == torch.int32
        assert torch.equal(g, p) and torch.equal(w, p)
    assert torch.equal(got[0], incl - counts)
    assert torch.equal(got[1], incl[-1])


@pytest.mark.parametrize("linear", [True, False], ids=["bilinear", "nn"])
@pytest.mark.parametrize("rule", ["MAX", "WEIGHTED_AVERAGE"])
@pytest.mark.parametrize("shape", [(6, 37, 40), (5, 130, 33)],
                         ids=["6x37x40", "5x130x33"])
def test_warp_fuse_planes_matches_jax_interpret_across_tiles(shape, rule,
                                                             linear):
    """ny under one y-tile, and ny two y-tiles and two rows with nx one
    x-tile and one lane: 4 views of 48 rows into a partly fused state."""
    trunc = rule == "WEIGHTED_AVERAGE"
    spec, w2c, pp, fl, imgs = _scene(shape=shape, n_views=4, h=48, w=40,
                                     trunc=trunc)
    topt, jopt = _opts(voxel_update=tcfg.VoxelUpdate[rule],
                       use_truncation=trunc, truncation_band=0.3)
    sdf0, un0 = _initial_state(shape)
    tg, jg = tgrid.GridSpec(*spec), jgrid.GridSpec(*spec)
    assert tg.shape_zyx == shape
    plan = warp_fused.fused_plan(*shape, 48, H100_OPTIN)
    assert plan.grid == (2, shape[0], -(-shape[1] // warp_fused.TILE_Y))
    before = warp_fused.warp_fuse_planes.launches
    ts, tu = warp_fused.warp_fuse_planes(
        torch.from_numpy(sdf0), torch.from_numpy(un0),
        *(tg.axis_centers_t(a, "cpu") for a in range(3)),
        *(torch.from_numpy(a) for a in (w2c, pp, fl, imgs)), topt, linear)
    assert warp_fused.warp_fuse_planes.launches == before
    # the Pallas kernel wants planes of 128-multiples and pads by itself
    # only where that costs little: pad here as it does (the state with
    # zeros, the centers continued at their pitch) and slice the result
    nz, ny, nx = shape
    pad = ((0, 0), (0, -ny % 128), (0, -nx % 128))
    cx, cy, cz = (jnp.asarray(jg.axis_centers(a)) for a in range(3))
    js, ju = j_fuse_planes(
        jnp.pad(jnp.asarray(sdf0), pad), jnp.pad(jnp.asarray(un0), pad),
        _extend_centers(cx, nx + pad[2][1]),
        _extend_centers(cy, ny + pad[1][1]), cz,
        *(jnp.asarray(a) for a in (w2c, pp, fl, imgs)), jopt, linear,
        interpret=True)
    ts, tu = ts.numpy(), tu.numpy()
    js, ju = np.asarray(js)[:, :ny, :nx], np.asarray(ju)[:, :ny, :nx]
    agree = tu == ju
    assert (~agree).mean() <= 1e-4, (~agree).sum()
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    both = agree & np.isfinite(ts) & np.isfinite(js)
    off = np.abs(ts[both] - js[both]) > 1e-5
    assert off.mean() <= (0.0 if linear else 2e-4), off.sum()
    assert (tu != un0).mean() > 0.05
