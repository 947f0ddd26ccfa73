"""Kernel set S (``csrc/sdf2d_fused.cu``, ``ops/sdf2d_fused.py``) against the
plain 2D SDF, ``ops/sdf2d.signed_distance_field_plain``.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_sdf2d_fused.py -m cuda

There S's images must equal the plain version's on the same CUDA masks bit
for bit (the float32 bits compared as int32), for uint8 and bool masks, full
and partial ROIs, every option, the degenerate images and the shapes of the
benchmark's cells. On a machine without a card the ``cuda`` tests skip; the
rest check that CPU tensors keep the plain version and launch nothing, what S
refuses, its ctypes signature, and S's algorithm, emulated pass by pass in
Python (the column pass on 32-row bit words, the row pass over per-thread
chunks with carries in closed form, the float finish), against the plain
version at small shapes.
"""

import ctypes

import numpy as np
import pytest
import torch

from vacancy_tpu_torch import _kernels
from vacancy_tpu_torch.config import INVALID_SDF
from vacancy_tpu_torch.ops import sdf2d, sdf2d_fused
from vacancy_tpu_torch.ops.sdf2d import (make_signed_distance_field,
                                         signed_distance_field_plain)
from vacancy_tpu_torch.ops.sdf2d_fused import sdf2d_fused as fused

SDF_CASES = {
    "minmax": dict(),
    "raw": dict(minmax_normalize=False),
    "minmax-trunc": dict(use_truncation=True, truncation_band=0.05),
    "raw-trunc": dict(minmax_normalize=False, use_truncation=True,
                      truncation_band=0.1),
    "scale": dict(sdf_scale=0.013),
    "scale-trunc": dict(sdf_scale=0.013, use_truncation=True,
                        truncation_band=0.05),
}


def _masks(seed, n, h, w):
    """uint8 masks (255 = foreground) of random discs and scattered single
    pixels, so that some rows and columns hold one class only."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros((n, h, w), bool)
    for m in out:
        for _ in range(3):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(1, max(2.0, min(h, w) / 3))
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        m ^= rng.random((h, w)) < 0.01
    return out.astype(np.uint8) * 255


def _degenerate(h, w):
    """All foreground, all background, one foreground pixel, and a band
    whose rows hold one class only."""
    one = np.zeros((h, w), np.uint8)
    one[h // 2, w // 3] = 255
    band = np.zeros((h, w), np.uint8)
    band[: max(1, h // 3)] = 255
    return np.stack([np.full((h, w), 255, np.uint8), np.zeros((h, w), np.uint8),
                     one, band])


def _bits_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


# --- CPU: the plain path, the refusals, the signature ----------------------

@pytest.mark.parametrize("kw", list(SDF_CASES.values()), ids=list(SDF_CASES))
@pytest.mark.parametrize("dtype", ["uint8", "bool"])
def test_cpu_masks_take_the_plain_version_and_launch_nothing(dtype, kw):
    m = torch.from_numpy(_masks(3, 3, 17, 23))
    if dtype == "bool":
        m = m == 255
    before = (fused.launches, fused.images)
    plain = signed_distance_field_plain(m, (2, 1, 20, 15), **kw)
    assert _bits_equal(fused(m, (2, 1, 20, 15), **kw), plain)
    assert _bits_equal(make_signed_distance_field(m, (2, 1, 20, 15), **kw),
                       plain)
    assert (fused.launches, fused.images) == before


REFUSED = [
    (1, 32767, 2, None, "h \\+ w = 32769"),
    (1, 2, 32767, None, "h \\+ w = 32769"),
    (2, 24, 32, (0, 0, 32, 23), "not inside"),
    (2, 24, 32, (0, 0, 31, 24), "not inside"),
    (2, 24, 32, (5, 0, 4, 23), "not inside"),
    (2, 24, 32, (-1, 0, 31, 23), "not inside"),
    (2**26, 64, 64, None, "rows in one launch"),
]


@pytest.mark.parametrize("case", REFUSED,
                         ids=[f"{c[-1].split(' ')[0]}-{i}"
                              for i, c in enumerate(REFUSED)])
def test_refusal_names_what_s_cannot_take(case):
    import re

    n, h, w, roi, what = case
    roi = roi or (0, 0, w - 1, h - 1)
    assert re.search(what, sdf2d_fused.sdf2d_refusal(n, h, w, roi))


@pytest.mark.parametrize("n,h,w,roi", [
    (1, 32766, 2, None), (1, 16384, 16384, None), (36, 2160, 3840, None),
    (1, 1, 1, None), (3, 24, 32, (7, 9, 7, 9)), (2**25 - 1, 64, 64, None)])
def test_refusal_takes_the_limits_themselves(n, h, w, roi):
    assert sdf2d_fused.sdf2d_refusal(n, h, w,
                                     roi or (0, 0, w - 1, h - 1)) is None


def test_signature_passes_pointers_at_full_width():
    """``vt_sdf2d`` takes four device pointers, ten ints, three floats and
    the stream; every pointer is declared c_void_p (a c_int would cut it to
    32 bits)."""
    sig = _kernels._SIGNATURES["vt_sdf2d"]
    assert sig[:4] == [ctypes.c_void_p] * 4 and sig[-1] is ctypes.c_void_p
    assert sig[4:14] == [ctypes.c_int] * 10
    assert sig[14:17] == [ctypes.c_float] * 3


def test_wrapper_refuses_a_tensor_off_the_card():
    m = torch.zeros((2, 8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused(m)


# --- CPU: S's algorithm, emulated pass by pass -----------------------------

SENT, INF = 32767, 1 << 29


def _lowest(b):
    return (b & -b).bit_length() - 1


def _emulate_columns(fg):
    """Pass 1 on a ROI's bool mask [rh, rw]: the column distance to the
    nearest row of the other class, signed by class (-c on the
    foreground), from 32-row bit words, each of up to four warps sweeping
    its segment of the words with carries between words."""
    rh, rw = fg.shape
    nwords = -(-rh // 32)
    segs = min(4, nwords)
    per = -(-nwords // segs)
    out = np.zeros((rh, rw), np.int64)
    for x in range(rw):
        words = [sum(1 << i for i in range(min(32, rh - 32 * k))
                     if fg[32 * k + i, x]) for k in range(nwords)]
        valid = [(1 << min(32, rh - 32 * k)) - 1 for k in range(nwords)]
        for seg in range(segs):
            k0 = min(seg * per, nwords)
            k1 = min(k0 + per, nwords)
            last_fg = last_bg = -INF
            for k in range(k0 - 1, -1, -1):
                if words[k]:
                    last_fg = 32 * k + words[k].bit_length() - 1
                    break
            for k in range(k0 - 1, -1, -1):
                if ~words[k] & valid[k]:
                    last_bg = 32 * k + (~words[k] & valid[k]).bit_length() - 1
                    break
            next_fg = next_bg = INF
            fg_word = bg_word = k0
            for k in range(k0, k1):
                base = 32 * k
                fgb, bgb = words[k], ~words[k] & valid[k]
                if fg_word <= k:
                    next_fg, fg_word = INF, k + 1
                    while fg_word < nwords:
                        if words[fg_word]:
                            next_fg = 32 * fg_word + _lowest(words[fg_word])
                            break
                        fg_word += 1
                if bg_word <= k:
                    next_bg, bg_word = INF, k + 1
                    while bg_word < nwords:
                        b = ~words[bg_word] & valid[bg_word]
                        if b:
                            next_bg = 32 * bg_word + _lowest(b)
                            break
                        bg_word += 1
                for i in range(min(32, rh - base)):
                    is_fg = (fgb >> i) & 1
                    other = bgb if is_fg else fgb
                    below = other & ((1 << i) - 1)
                    above = other & ~((2 << i) - 1)
                    y = base + i
                    up = (i - (below.bit_length() - 1) if below
                          else y - (last_bg if is_fg else last_fg))
                    dn = (_lowest(above) - i if above
                          else (next_bg if is_fg else next_fg) - y)
                    c = min(up, dn, SENT)
                    out[y, x] = -c if is_fg else c
                if fgb:
                    last_fg = base + fgb.bit_length() - 1
                if bgb:
                    last_bg = base + bgb.bit_length() - 1
    return out


def _excl_min(vals, suffix):
    return [min((vals[i] for i in range(len(vals))
                 if (i > t if suffix else i < t)), default=INF)
            for t in range(len(vals))]


def _emulate_row(c_row, nt, chunk):
    """Pass 2 on one ROI row of pass 1's values, as ``nt`` threads of
    ``chunk`` pixels: the signed row distance and the row's largest |D|.
    Each thread runs the forward and the backward chains over its chunk
    from no carry; the carries are closed forms of a prefix minimum of the
    chunks' ends and a suffix minimum of their starts."""
    rw = len(c_row)
    row = [int(v) for v in c_row]
    fwd = [0] * rw
    lo = [min(t * chunk, rw) for t in range(nt)]
    hi = [min(a + chunk, rw) for a in lo]
    ends, starts = [], []
    for t in range(nt):
        fa = fb = INF
        for x in range(lo[t], hi[t]):
            s = row[x]
            fa = min(-s, fa + 1) if s < 0 else 0
            fb = 0 if s < 0 else min(s, fb + 1)
            fwd[x] = min(fa if s < 0 else fb, SENT)
        ba = bb = INF
        for x in range(hi[t] - 1, lo[t] - 1, -1):
            s = row[x]
            ba = min(-s, ba + 1) if s < 0 else 0
            bb = 0 if s < 0 else min(s, bb + 1)
            own = min(ba if s < 0 else bb, SENT)
            row[x] = -own if s < 0 else own
        ends.append((fa - chunk * t, fb - chunk * t))
        starts.append((ba + chunk * t, bb + chunk * t))
    pre = [_excl_min([e[k] for e in ends], False) for k in (0, 1)]
    suf = [_excl_min([s[k] for s in starts], True) for k in (0, 1)]
    out, most = [], 0
    for x in range(rw):
        s, t = row[x], x // chunk
        k = 0 if s < 0 else 1
        d = min(abs(s), fwd[x], pre[k][t] + 1 - chunk + x, suf[k][t] - x,
                SENT)
        most = max(most, d)
        out.append(-d if s < 0 else d)
    return out, most


def _row_plan(rw):
    """The C entry point's pass-2 launch: threads and chunk for a row."""
    nt = min(-(-(-(-rw // 8)) // 32) * 32, 256)
    return nt, -(-rw // nt)


def _emulate(masks, roi, kw, chunk=None):
    """S on a uint8 stack [V, H, W]; ``chunk`` overrides pass 2's plan."""
    v, h, w = masks.shape
    x0, y0, x1, y1 = roi
    rw = x1 - x0 + 1
    if chunk is None:
        nt, chunk = _row_plan(rw)
    else:
        nt = -(-(-(-rw // chunk)) // 32) * 32
    f32 = np.float32
    out = np.zeros((v, h, w), f32)
    for i in range(v):
        col = _emulate_columns(masks[i, y0:y1 + 1, x0:x1 + 1] == 255)
        rows = [_emulate_row(r, nt, chunk) for r in col]
        dist = np.array([r[0] for r in rows])
        most = max(r[1] for r in rows)
        mag = np.where(np.abs(dist) >= SENT, np.finfo(f32).max,
                       np.abs(dist).astype(f32)).astype(f32)
        r = np.where(dist < 0, -mag, mag).astype(f32)
        scale = kw.get("sdf_scale")
        if scale is not None:
            r = r * f32(scale)
        elif kw.get("minmax_normalize", True):
            af = np.finfo(f32).max if most >= SENT else f32(most)
            norm = f32(1.0) / af if af > np.finfo(f32).tiny else f32(1.0)
            r = r * norm
        if kw.get("use_truncation", False):
            band = f32(kw["truncation_band"])
            with np.errstate(over="ignore"):  # FLT_MAX / band: inf, then 1
                clamp = (np.minimum(band, r) if scale is not None
                         else np.minimum(f32(1.0), r / band))
            r = np.where(-band >= r, INVALID_SDF, clamp).astype(f32)
        out[i, y0:y1 + 1, x0:x1 + 1] = r
    return torch.from_numpy(out)


EMULATED = [  # (h, w, roi): across word edges, one-pixel-wide ROIs
    (1, 1, None), (1, 19, None), (37, 1, None), (70, 13, None),
    (33, 45, (3, 1, 40, 32)), (40, 29, (5, 0, 5, 39)),
    (40, 29, (0, 7, 28, 7)),
]


@pytest.mark.parametrize("kw", list(SDF_CASES.values()), ids=list(SDF_CASES))
@pytest.mark.parametrize("h,w,roi", EMULATED,
                         ids=[f"{h}x{w}" + ("-roi" if r else "")
                              for h, w, r in EMULATED])
def test_emulated_s_equals_plain(h, w, roi, kw):
    masks = np.concatenate([_masks(h * w, 2, h, w), _degenerate(h, w)])
    full = sdf2d._full_roi(h, w, roi)
    got = _emulate(masks, full, kw)
    assert _bits_equal(
        got, signed_distance_field_plain(torch.from_numpy(masks), roi, **kw))


@pytest.mark.parametrize("chunk", [1, 3, 7, 64])
def test_emulated_row_carries_for_any_chunk(chunk):
    """Pass 2's carries between chunks in closed form hold for any chunk
    length, empty chunks past the row's end included."""
    masks = np.concatenate([_masks(chunk, 3, 21, 150), _degenerate(21, 150)])
    kw = SDF_CASES["raw"]
    assert _bits_equal(
        _emulate(masks, (0, 0, 149, 20), kw, chunk=chunk),
        signed_distance_field_plain(torch.from_numpy(masks), **kw))


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _check(masks, roi, kw, device, as_bool=False):
    m = torch.from_numpy(masks).to(device)
    if as_bool:
        m = m == 255
    before = (fused.launches, fused.images)
    got = make_signed_distance_field(m, roi, **kw)
    views = int(np.prod(masks.shape[:-2]))
    assert (fused.launches, fused.images) == (before[0] + 3,
                                              before[1] + views)
    want = signed_distance_field_plain(m, roi, **kw)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert _bits_equal(got, want)


SHAPES = [(1, 1), (1, 37), (45, 1), (33, 47), (64, 31), (97, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", list(SDF_CASES.values()), ids=list(SDF_CASES))
@pytest.mark.parametrize("dtype", ["uint8", "bool"])
@pytest.mark.parametrize("h,w", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_s_equals_plain_full_roi(cuda_device, h, w, dtype, kw):
    masks = np.concatenate([_masks(h + w, 3, h, w), _degenerate(h, w)])
    _check(masks, None, kw, cuda_device, dtype == "bool")


ROIS = [(3, 2, 40, 30), (0, 0, 46, 32), (10, 4, 10, 30), (2, 17, 45, 17),
        (20, 20, 20, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", list(SDF_CASES.values()), ids=list(SDF_CASES))
@pytest.mark.parametrize("roi", ROIS, ids=["inner", "full", "one-column",
                                           "one-row", "one-pixel"])
def test_s_equals_plain_partial_roi(cuda_device, roi, kw):
    masks = np.concatenate([_masks(5, 3, 33, 47), _degenerate(33, 47)])
    _check(masks, roi, kw, cuda_device)
    _check(masks, roi, kw, cuda_device, as_bool=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", list(SDF_CASES.values()), ids=list(SDF_CASES))
def test_s_equals_plain_on_degenerate_images(cuda_device, kw):
    """All foreground and all background (|sdf| = FLT_MAX, normalised by
    the denormal 1/FLT_MAX to -+0.99999994), a single foreground pixel, and
    rows and columns with no pixel of the other class."""
    masks = _degenerate(61, 77)
    _check(masks, None, kw, cuda_device)
    got = make_signed_distance_field(torch.from_numpy(masks).to(cuda_device))
    below_one = np.float32(1.0) - np.float32(2.0) ** -24
    assert torch.all(got[0] == -float(below_one))
    assert torch.all(got[1] == float(below_one))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [SDF_CASES["minmax-trunc"], SDF_CASES["raw"]],
                         ids=["minmax-trunc", "raw"])
def test_s_equals_plain_at_the_cells_shapes(cuda_device, kw):
    """36 views of 320 x 240 (the turntable's masks) and 2 of 3840 x 2160."""
    from vacancy_tpu_torch.pipeline import facade_inputs, turntable_masks

    _, masks = turntable_masks(36, cuda_device)
    _check(masks.cpu().numpy(), None, kw, cuda_device)
    _, _, uhd = facade_inputs(64, 2, 3840, 2160, cuda_device)
    _check(uhd.cpu().numpy(), None, kw, cuda_device)
    _check(uhd.cpu().numpy(), (100, 50, 3700, 2100), kw, cuda_device)


@pytest.mark.cuda
def test_s_takes_any_leading_dims_and_strides(cuda_device):
    masks = torch.from_numpy(_masks(11, 6, 24, 36)).to(cuda_device)
    kw = SDF_CASES["minmax-trunc"]
    for m in (masks[0], masks.reshape(2, 3, 24, 36), masks.transpose(1, 2)):
        got = make_signed_distance_field(m, **kw)
        assert got.shape == m.shape
        assert _bits_equal(got, signed_distance_field_plain(m, **kw))


@pytest.mark.cuda
def test_the_facade_takes_s_for_every_view(cuda_device):
    """``carve_batch`` on the card transforms every view through S: the
    counter's images equal the views carved."""
    from vacancy_tpu_torch import VoxelCarver
    from vacancy_tpu_torch.pipeline import facade_inputs

    opt, cams, masks = facade_inputs(32, 6, 64, 48, cuda_device)
    carver = VoxelCarver(opt, cuda_device)
    assert carver.init()
    before = (fused.launches, fused.images)
    imgs = carver.carve_batch(cams, masks)
    assert (fused.launches - before[0], fused.images - before[1]) == (3, 6)
    want = signed_distance_field_plain(
        masks, None, minmax_normalize=opt.sdf_minmax_normalize,
        use_truncation=opt.update_option.use_truncation,
        truncation_band=opt.update_option.truncation_band,
        sdf_scale=opt.sdf_scale)
    assert _bits_equal(torch.as_tensor(np.asarray(imgs)), want.cpu())


@pytest.mark.cuda
def test_s_refuses_what_it_cannot_take(cuda_device):
    before = (fused.launches, fused.images)
    with pytest.raises(ValueError, match="h \\+ w = 32769"):
        fused(torch.zeros((1, 32768, 1), dtype=torch.uint8,
                          device=cuda_device))
    with pytest.raises(ValueError, match="not inside"):
        fused(torch.zeros((1, 8, 8), dtype=torch.uint8, device=cuda_device),
              (0, 0, 8, 7))
    with pytest.raises(TypeError, match="uint8 or bool"):
        fused(torch.zeros((1, 8, 8), dtype=torch.float32, device=cuda_device))
    assert (fused.launches, fused.images) == before
    # the largest h + w it takes, one column of 32767 rows
    m = torch.zeros((1, 32767, 1), dtype=torch.uint8, device=cuda_device)
    m[0, 5] = 255
    assert _bits_equal(fused(m), signed_distance_field_plain(m))
