"""The launch plans of the port's redesigned kernels, on the CPU.

Kernel A (``csrc/warp_fused.cu``), kernel B's scan (``csrc/mc_fused.cu``),
kernel C (``csrc/interp_rows.cu``) and kernel E (``csrc/exact_fused.cu``)
run only on a card; what decides their launches is plain Python
(``warp_fused.fused_plan``, ``mc_fused.scan_blocks``,
``warp_gather.interp_plan``, ``exact_fused.exact_plan`` and
``exact_refusal``) or is small enough to emulate here in numpy and torch:
the tiling must cover every voxel, tile or output exactly once, fit the
card's shared memory and registers,
the blocked scan must be ``torch.cumsum``, and kernel C's indexing into
its staged copy of a row (or straight into the row) must give
``interp_rows_plain`` bit for bit. The last tests hold ``warp_fuse_planes`` on
CPU tensors (its plain version) against the JAX package's
``warp_fuse_planes`` in interpret mode on shapes that straddle the new
tiling, at test_torch_warp's bar: update_num differs on at most 1e-4 of
the voxels, and where it agrees the sdf is finite in the same places and
within 1e-5 (XLA on the CPU contracts multiply-adds that the port rounds
twice); with nearest-neighbour sampling at most 2e-4 of the voxels (one
of the 8880 at 6 x 37 x 40) may take the neighbouring pixel instead, where
a sample position lies within an ulp of a half pixel. The last tests hold
every ctypes signature in ``_kernels._SIGNATURES`` against its C entry
point's parameters.
"""

import re

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
from vacancy_tpu_torch import _kernels
from vacancy_tpu_torch.ops import exact_fused, mc_fused, warp_fused, warp_gather
from vacancy_tpu_torch.ops.warp_gather import interp_plan, interp_rows_plain

H100_OPTIN = 232_448  # bytes of shared memory a block may opt into
SM_REGISTERS = 65_536
WARPS = warp_fused.THREADS // 32


TALL_ROWS = [1816, 1817, 2160, 4320, 8640]


@pytest.mark.parametrize("optin", [H100_OPTIN, 101_376, 49_152])
def test_fused_fits_views_of_any_height(optin):
    """``carve_views_warp`` hands kernel A views of any height: a CTA holds
    at most ``INTER_ROWS_CAP`` rows of the intermediate (fewer where the
    card's opt-in is smaller) and walks a taller band in chunks."""
    rows = min(warp_fused.INTER_ROWS_CAP,
               (optin - warp_fused.STATIC_SMEM_BYTES) // (32 * 4))
    for h in TALL_ROWS:
        assert warp_fused.fused_refusal(512, 512, 512, h, 3840, optin) is None
        plan = warp_fused.fused_plan(512, 512, 512, h, 3840, optin)
        assert plan.inter_rows == rows and plan.smem_bytes <= optin
    assert rows == (warp_fused.INTER_ROWS_CAP if optin >= 101_376 else 380)


PLAN_SHAPES = [
    (1, 1, 1, 1), (6, 37, 40, 48), (5, 130, 33, 48), (72, 80, 96, 240),
    (128, 1024, 1024, 240), (512, 512, 512, 240), (4, 64, 32, 385),
    (3, 65, 31, 1816), (65535, 2, 2, 8), (3, 65, 31, 2160),
    (512, 512, 512, 2160), (9, 70, 40, 8640),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_fused_plan_covers_every_voxel_once_and_fits(shape):
    nz, ny, nx, h = shape
    plan = warp_fused.fused_plan(nz, ny, nx, h, 3840, H100_OPTIN)
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


# (nz, ny, nx, h, w, optin, what the refusal names): the kernel's true
# limits -- a grid's 65535 planes and y-tiles, two rows of shared memory
# for a linear tap pair, 32-bit offsets within an image, an empty state
REFUSED = [
    (65536, 8, 8, 48, 40, H100_OPTIN, "65535"),
    (8, 65535 * 64 + 1, 8, 48, 40, H100_OPTIN, "65535"),
    (8, 8, 8, 65536, 65536, H100_OPTIN, "2\\*\\*32"),
    (8, 8, 8, 2**31, 2, H100_OPTIN, "2\\*\\*32"),
    (8, 8, 8, 4, 40, warp_fused.STATIC_SMEM_BYTES + 2 * 32 * 4 - 1,
     "no two rows"),
    (8, 8, 8, 2160, 3840, 48, "no two rows"),
    (8, 0, 8, 48, 40, H100_OPTIN, "empty"),
    (8, 8, 8, 48, 0, H100_OPTIN, "empty"),
]


def test_fused_plan_refuses_what_the_kernel_does_not_take():
    for nz, ny, nx, h, w, optin, what in REFUSED:
        with pytest.raises(ValueError, match=what):
            warp_fused.fused_plan(nz, ny, nx, h, w, optin)
        assert re.search(what, warp_fused.fused_refusal(nz, ny, nx, h, w,
                                                        optin))
    # one pixel under 2**32, 65535 planes, two rows: each taken
    assert warp_fused.fused_refusal(8, 8, 8, 65535, 65537, H100_OPTIN) is None
    assert warp_fused.fused_refusal(65535, 65535 * 64, 8, 48, 40,
                                    H100_OPTIN) is None
    two = warp_fused.fused_plan(8, 8, 8, 4, 40,
                                warp_fused.STATIC_SMEM_BYTES + 2 * 32 * 4)
    assert two.inter_rows == 2
    assert warp_fused.fused_plan(8, 8, 8, 1, 40, warp_fused.STATIC_SMEM_BYTES
                                 + 32 * 4).inter_rows == 1
    small = warp_fused.fused_plan(8, 8, 8, 310, 40, 40_000)
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
                                  (17, 17 + 2 * 383, 1815), (0, 2159, 2159),
                                  (900, 1170, 2159), (0, 8639, 8639)])
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
    plan = warp_fused.fused_plan(*shape, 48, 40, H100_OPTIN)
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


# (n, r, t, width, shared table, lo, hi): the UHD facade's two launches and
# phase 6's, the blocked sweep's pass 1, ortho views, and the edges: t of 1
# and 5, width 1, one plane more than a group, a row wider than the staging
# budget, more planes than a grid's 65535
INTERP_SHAPES = [
    (512, 2160, 512, 3840, True, 0, 3839),
    (512, 512, 512, 2160, False, 0, 2159),
    (64, 2160, 512, 3840, True, 200, 3600),
    (64, 512, 512, 2160, False, 100, 2000),
    (128, 2160, 1024, 3840, True, 0, 3839),
    (128, 192, 128, 192, True, 0, 191),
    (3, 8, 1, 40, True, 0, 39),
    (3, 8, 5, 40, False, 5, 30),
    (4, 7, 16, 1, True, 0, 0),
    (warp_gather.GROUP_MAX + 1, 4200, 8, 40, True, 1, 38),
    (9, 3, 512, warp_gather.STAGE_BYTES_MAX // 4 + 8, True, 0, 12295),
    (70000, 2, 4, 9, True, 2, 6),
    (70000, 2, 4, 9, False, 2, 6),
]


def _plan_ids(shapes):
    return ["{}x{}x{}w{}{}".format(*s[:4], "s" if s[4] else "p")
            for s in shapes]


def _plan_cover(plan, n, r, t):
    """How often the kernel's walk over ``plan`` writes each output,
    counted as [n, r] (the CTAs over planes and rows) and [k, t] (one CTA's
    items over its k planes or rows and the t outputs of each), both
    walked as csrc/interp_rows.cu walks them."""
    gx, gy = plan.grid
    per_row = np.zeros((n, r), np.int64)
    if plan.mode == "staged":
        assert gx == r and plan.rows == 1
        for by in range(gy):
            per_row[by * plan.group:min(n, (by + 1) * plan.group)] += 1
        k = plan.group
    else:
        assert plan.group == 1
        for bx in range(gx):
            # blockIdx.y strides over the planes past the grid's 65535
            for by in range(gy):
                per_row[by::gy, bx * plan.rows:(bx + 1) * plan.rows] += 1
        k = plan.rows
    # one CTA's items: j -> (plane or row j // tq, lanes (j % tq) * vec + v)
    tq = t // plan.vec
    items = np.arange(k * tq)
    lanes = ((items // tq * t + items % tq * plan.vec)[:, None]
             + np.arange(plan.vec)[None, :]).reshape(-1)
    return per_row, np.bincount(lanes, minlength=k * t).reshape(k, t)


@pytest.mark.parametrize("shape", INTERP_SHAPES, ids=_plan_ids(INTERP_SHAPES))
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "unaligned"])
def test_interp_plan_covers_every_output_once_and_fits(shape, aligned):
    n, r, t, width, share, lo, hi = shape
    plan = interp_plan(n, r, t, width, share, lo, hi, H100_OPTIN, aligned)
    gx, gy = plan.grid
    assert 1 <= gy <= warp_gather.MAX_GRID_Y and gx >= 1
    assert plan.vec == (4 if aligned and t % 4 == 0 else 1)
    per_row, per_t = _plan_cover(plan, n, r, t)
    assert (per_row == 1).all() and (per_t == 1).all()
    # shared memory: 48 KB without an opt-in, and the H100's opt-in
    assert plan.smem_bytes <= min(48 * 1024, H100_OPTIN)
    if plan.mode == "staged":
        assert share and aligned and t % 4 == 0
        assert plan.stage_lo == lo - lo % 4 and plan.smem_bytes % 16 == 0
        assert plan.smem_bytes >= 4 * (hi + 1 - plan.stage_lo)
        # the 16-byte chunks of a row of a multiple of 4 taps end in it
        if width % 4 == 0:
            assert plan.stage_lo + plan.smem_bytes // 4 <= width
        assert plan.group * (t // 4) <= warp_gather.MAX_ITEMS
        ctas = gx * gy
        assert ctas >= min(warp_gather.MIN_CTAS, r * n // plan.group) or (
            plan.group == 1)
        assert plan.group <= warp_gather.GROUP_MAX
    else:
        assert plan.smem_bytes == 0
        assert plan.rows * (t // plan.vec) <= max(warp_gather.DIRECT_ITEMS,
                                                  t // plan.vec)
    # registers: the budget lets four CTAs of 256 threads share an SM, and
    # so does a staged row's shared memory
    assert SM_REGISTERS // (warp_gather.REGISTER_BUDGET
                            * warp_gather.THREADS) == 4
    assert 4 * (warp_gather.STAGE_BYTES_MAX + 1024) <= 233_472


def test_interp_plan_takes_the_direct_gather_off_the_fast_way():
    """Wide rows, ragged or unaligned t and per-row tables take the direct
    variants; the facade's launches take the staged and direct4 ones."""
    uhd = (512, 2160, 512, 3840, True, 0, 3839)
    assert interp_plan(*uhd, H100_OPTIN, True).mode == "staged"
    assert interp_plan(*uhd, H100_OPTIN, True).group == 512
    assert interp_plan(*uhd, H100_OPTIN, True).grid == (2160, 1)
    # phase 6's 64 planes: one group; four planes of 192 rows: groups of 1
    assert interp_plan(64, 2160, 512, 3840, True, 0, 3839, H100_OPTIN,
                       True).grid == (2160, 1)
    assert interp_plan(4, 192, 128, 192, True, 0, 191, H100_OPTIN,
                       True).grid == (192, 4)
    assert interp_plan(*uhd, H100_OPTIN, False).mode == "direct1"
    assert interp_plan(512, 2160, 511, 3840, True, 0, 3839, H100_OPTIN,
                       True).mode == "direct1"
    assert interp_plan(512, 512, 512, 2160, False, 0, 2159, H100_OPTIN,
                       True).mode == "direct4"
    wide = warp_gather.STAGE_BYTES_MAX // 4 + 1
    assert interp_plan(4, 8, 16, wide, True, 0, wide - 1, H100_OPTIN,
                       True).mode == "direct4"
    # the taps, not the row, are staged: a ROI of a wide row fits
    assert interp_plan(4, 8, 16, wide, True, 100, 4000, H100_OPTIN,
                       True).mode == "staged"
    # a card that could not opt into the row's bytes
    assert interp_plan(*uhd, 8 * 1024, True).mode == "direct4"
    with pytest.raises(ValueError, match="empty"):
        interp_plan(0, 8, 16, 40, True, 0, 39, H100_OPTIN, True)
    with pytest.raises(ValueError, match="taps"):
        interp_plan(2, 8, 16, 40, True, 0, 40, H100_OPTIN, True)


def _taps_from(row, off, idx):
    """Taps ``idx`` of a row held from tap ``off`` on (``row[idx - off]``)."""
    return row[idx - off]


def _sample_staged(row, off, pos, lo, hi, linear):
    """csrc/interp_rows.cu's ``sample`` on one row, in torch."""
    if linear:
        p0f = torch.floor(pos)
        frac = pos - p0f
        p0 = p0f.to(torch.int64).clamp(lo, hi)
        p1 = torch.clamp_max(p0 + 1, hi)
        a = (1.0 - frac) * _taps_from(row, off, p0)
        b = frac * _taps_from(row, off, p1)
        return a + b
    p = torch.floor(pos + 0.5).to(torch.int64).clamp(lo, hi)
    return _taps_from(row, off, p)


def _emulate_interp(plan, tables, pos, width, share, lo, hi, linear):
    """Kernel C's launch of ``plan`` in torch: staged, each CTA copies its
    row's taps from ``stage_lo`` into a buffer of ``smem_bytes`` and samples
    it at ``p - stage_lo`` for its group of planes; direct, each CTA
    samples its rows where they lie in the flat tables."""
    n, r, t = pos.shape
    out = torch.full_like(pos, float("nan"))
    gx, gy = plan.grid
    if plan.mode == "staged":
        for bx in range(gx):
            src = tables[0, bx, plan.stage_lo:plan.stage_lo
                         + plan.smem_bytes // 4]
            staged = torch.zeros(plan.smem_bytes // 4)
            staged[:src.numel()] = src
            for by in range(gy):
                g = slice(by * plan.group, (by + 1) * plan.group)
                out[g, bx] = _sample_staged(staged, plan.stage_lo,
                                            pos[g, bx], lo, hi, linear)
        return out
    flat = tables.reshape(-1)
    for by in range(gy):
        for nn in range(by, n, gy):
            for bx in range(gx):
                r0 = bx * plan.rows
                for lr in range(min(plan.rows, r - r0)):
                    base = ((0 if share else nn * r) + r0 + lr) * width
                    out[nn, r0 + lr] = _sample_staged(
                        flat, -base, pos[nn, r0 + lr], lo, hi, linear)
    return out


ROW_CASES = [
    (5, 6, 16, 40, True, 0, 39, True),
    (5, 6, 16, 40, True, 5, 30, True),
    (5, 6, 16, 42, True, 3, 41, True),  # a row that is not 16-byte aligned
    (5, 6, 16, 40, False, 0, 39, True),
    (5, 6, 16, 40, False, 7, 22, True),
    (3, 6, 13, 40, True, 2, 33, True),
    (3, 6, 16, 40, True, 0, 39, False),
    (3, 5, 12, 1, True, 0, 0, True),
]


@pytest.mark.parametrize("case", ROW_CASES,
                         ids=[f"{'x'.join(map(str, c[:4]))}-"
                              f"{'s' if c[4] else 'p'}-{c[5]}-{c[6]}-"
                              f"{'a' if c[7] else 'u'}" for c in ROW_CASES])
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nn"])
def test_kernel_c_indexing_equals_plain(case, linear):
    """The kernel's indexing, emulated launch by launch: the staged copy
    read at ``p - stage_lo`` (shared tables) or the row read in place
    (direct), for the full row and a ROI, equals ``interp_rows_plain`` bit
    for bit; positions run past both ends of the row."""
    n, r, t, width, share, lo, hi, aligned = case
    rng = np.random.default_rng(n * 100 + width)
    tables = torch.from_numpy(rng.normal(
        size=(1 if share else n, r, width)).astype(np.float32))
    pos = torch.from_numpy(rng.uniform(-1.0, width, size=(n, r, t)).astype(
        np.float32))
    pos[..., 0], pos[..., -1] = -1.0, float(width)
    pos[0, 0, 1 % t] = width - 0.5  # NN rounds half up, into the clamp
    plan = interp_plan(n, r, t, width, share, lo, hi, H100_OPTIN, aligned)
    want = "staged" if share and aligned and t % 4 == 0 else (
        "direct4" if aligned and t % 4 == 0 else "direct1")
    assert plan.mode == want
    got = _emulate_interp(plan, tables, pos, width, share, lo, hi, linear)
    ref = interp_rows_plain(tables, pos, width, linear, share, lo, hi)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


# kernel E (csrc/exact_fused.cu): a CTA owns 32 x by 8 y, a thread 8
# consecutive z of its (y, x) column
EXACT_SHAPES = [
    (1, 1, 1), (13, 21, 45), (8, 8, 32), (9, 9, 33), (17, 3, 100),
    (512, 512, 512), (65535 * 8, 1, 1), (1, 65535 * 8, 1),
]


@pytest.mark.parametrize("shape", EXACT_SHAPES,
                         ids=["x".join(map(str, s)) for s in EXACT_SHAPES])
def test_exact_plan_covers_every_voxel_once(shape):
    """The grid, walked as the kernel walks it (x = bx * 32 + lane,
    y = by * 8 + warp, z = bz * 8 + r), covers every voxel once; the
    grid's y and z dimensions fit the card."""
    nz, ny, nx = shape
    gx, gy, gz = exact_fused.exact_plan(nz, ny, nx, 240, 320,
                                        (0, 0, 319, 239))
    assert gy <= 65535 and gz <= 65535
    assert exact_fused.THREADS == exact_fused.TILE_X * exact_fused.TILE_Y
    # each axis is cut on its own: count the cover of each and multiply
    covers = []
    for n, blocks, per in ((nx, gx, exact_fused.TILE_X),
                           (ny, gy, exact_fused.TILE_Y),
                           (nz, gz, exact_fused.VPT)):
        idx = (np.arange(blocks)[:, None] * per
               + np.arange(per)[None, :]).reshape(-1)
        seen = np.bincount(idx[idx < n], minlength=n)
        covers.append(seen)
        assert blocks == -(-n // per) and len(seen) == n
    assert all((c == 1).all() for c in covers)


# (nz, ny, nx, h, w, roi, what the refusal names): E's true limits -- a
# grid's 65535 CTAs along y and z, 32-bit signed offsets within an image,
# taps that must lie inside the image
EXACT_REFUSED = [
    (65535 * 8 + 1, 8, 8, 48, 40, None, "65535"),
    (8, 65535 * 8 + 1, 8, 48, 40, None, "65535"),
    (8, 8, 8, 46341, 46341, None, "2\\*\\*31"),
    (8, 8, 8, 2**31, 1, None, "2\\*\\*31"),
    (8, 8, 8, 48, 40, (0, 0, 40, 47), "roi"),
    (8, 8, 8, 48, 40, (-1, 0, 39, 47), "roi"),
    (8, 8, 8, 48, 40, (5, 0, 4, 47), "roi"),
    (8, 8, 8, 48, 40, (0, 0, 39, 48), "roi"),
    (8, 0, 8, 48, 40, None, "empty"),
]


@pytest.mark.parametrize("case", EXACT_REFUSED,
                         ids=[c[-1].replace("\\", "") + f"-{i}"
                              for i, c in enumerate(EXACT_REFUSED)])
def test_exact_refusal_names_what_the_kernel_cannot_take(case):
    nz, ny, nx, h, w, roi, what = case
    roi = roi or (0, 0, max(w - 1, 0), max(h - 1, 0))
    assert re.search(what, exact_fused.exact_refusal(nz, ny, nx, h, w, roi))
    with pytest.raises(ValueError, match=what):
        exact_fused.exact_plan(nz, ny, nx, h, w, roi)


def test_exact_refusal_takes_the_limits_themselves():
    # 65535 CTAs along y and z, one pixel under 2**31, a one-pixel ROI
    assert exact_fused.exact_refusal(65535 * 8, 65535 * 8, 8, 48, 40,
                                     (0, 0, 39, 47)) is None
    assert exact_fused.exact_refusal(8, 8, 8, 1, 2**31 - 1,
                                     (0, 0, 2**31 - 2, 0)) is None
    assert exact_fused.exact_refusal(8, 8, 8, 48, 40, (7, 9, 7, 9)) is None
    # the benchmark's shape, and the largest grid a state holds
    assert exact_fused.exact_refusal(512, 512, 512, 240, 320,
                                     (0, 0, 319, 239)) is None
    assert exact_fused.exact_refusal(1290, 1290, 1290, 2160, 3840,
                                     (0, 0, 3839, 2159)) is None


def _c_signature(name):
    """The kinds ('p' pointer, 'i' int, 'f' float) of the parameters of
    the C entry point ``name`` in csrc/*.cu."""
    for src in _kernels._sources():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                      src.read_text())
        if m:
            kinds = []
            for p in m.group(1).split(","):
                p = " ".join(p.split())
                kinds.append("p" if "*" in p else
                             "f" if p.startswith("float") else
                             "i" if p.startswith("int") else p)
            return kinds
    raise AssertionError(f"no C entry point {name} in csrc/")


def _ctypes_kind(t):
    import ctypes

    if t is ctypes.c_void_p or (isinstance(t, type)
                                and issubclass(t, ctypes._Pointer)):
        return "p"
    return {ctypes.c_int: "i", ctypes.c_float: "f"}[t]


@pytest.mark.parametrize("name", sorted(_kernels._SIGNATURES))
def test_signatures_match_the_c_entry_points(name):
    """Each ``_SIGNATURES`` entry declares the C entry point's parameters
    in order: a pointer where C takes one, an int for an int, a float for
    a float (ctypes would otherwise pass a pointer cut to 32 bits, or a
    float as an int)."""
    assert [_ctypes_kind(t) for t in _kernels._SIGNATURES[name]] == (
        _c_signature(name))
