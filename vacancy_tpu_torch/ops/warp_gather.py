"""Batched 1-D row interpolation, the warp engine's gather
(``vacancy_tpu/ops/warp_gather.py``).

``interp_rows`` samples ``tables[n or 0, r, :]`` at ``pos[n, r, t]``:
linear between two taps or nearest neighbour. It is the inner loop of the
two-pass warp engine (``ops/fusion_warp.py``): pass 1 resamples image rows
at ``u_eq``, pass 2 the transposed pass-1 field at ``v*``.

CUDA tensors launch kernel C (``csrc/interp_rows.cu``), which replaces
``vacancy_tpu/ops/warp_gather.py::_interp_rows_kernel``; CPU tensors run
``interp_rows_plain``. The TPU kernel's 128-lane chunking, width and T
padding and chunk select have no counterpart: a CUDA thread gathers from
any address.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels


def _sample_rows(table: torch.Tensor, row_index: torch.Tensor,
                 pos: torch.Tensor, lo: int, hi: int,
                 linear: bool) -> torch.Tensor:
    """Sample ``table`` (any shape, flattened) at ``row_index + tap``
    where the taps come from ``pos``: floor + clamp to [lo, hi], second
    linear tap at min(p0 + 1, hi); NN rounds half up. ``row_index`` is
    the flat offset of each sample's row (broadcast against ``pos``).
    The blend is ``(1 - frac) * t0`` plus ``frac * t1``, two products and
    then the sum, as kernels A and C compute it."""
    flat = table.reshape(-1)
    if linear:
        p0f = torch.floor(pos)
        frac = pos - p0f
        p0 = p0f.to(torch.int64).clamp(lo, hi)
        p1 = torch.clamp_max(p0 + 1, hi)
        t0 = flat[row_index + p0]
        t1 = flat[row_index + p1]
        return (1.0 - frac) * t0 + frac * t1
    p0 = torch.floor(pos + 0.5).to(torch.int64).clamp(lo, hi)
    return flat[row_index + p0]


def _taps(width: int, lo: int, hi: Optional[int]):
    """(lo, hi) with ``hi=None`` as ``width - 1``; raises unless
    0 <= lo <= hi < width."""
    hi = width - 1 if hi is None else hi
    if not 0 <= lo <= hi < width:
        raise ValueError(f"taps [{lo}, {hi}] outside the row [0, {width})")
    return lo, hi


def interp_rows_plain(
    tables: torch.Tensor,  # f32[N, R, W] (or f32[1, R, W] with share_table)
    pos: torch.Tensor,  # f32[N, R, T], finite
    width: int,
    linear: bool = True,
    share_table: bool = False,
    lo: int = 0,
    hi: Optional[int] = None,
) -> torch.Tensor:
    """Kernel C's plain version: ``interp_rows`` in PyTorch ops."""
    lo, hi = _taps(width, lo, hi)
    n, r, _ = pos.shape
    rows = torch.arange(r, device=pos.device).reshape(1, r, 1)
    if not share_table:
        rows = torch.arange(n, device=pos.device).reshape(n, 1, 1) * r + rows
    return _sample_rows(tables, rows * width, pos, lo, hi, linear)


def interp_rows(
    tables: torch.Tensor,  # f32[N, R, W] (or f32[1, R, W] with share_table)
    pos: torch.Tensor,  # f32[N, R, T], finite
    width: int,
    linear: bool = True,
    share_table: bool = False,
    lo: int = 0,
    hi: Optional[int] = None,
) -> torch.Tensor:
    """For each (n, r, t): sample ``tables[n, r, :]`` (``tables[0, r, :]``
    with ``share_table``) at ``pos[n, r, t]``. Returns f32[N, R, T].

    Positions must be finite (the callers clip them); taps clamp to
    [lo, hi], by default the whole row. CPU tensors take the plain
    version. CUDA tensors launch kernel C (``interp_rows.launches`` counts
    those launches) or raise: on inputs the kernel does not take, or on a
    non-zero cudaError_t from the launch."""
    lo, hi = _taps(width, lo, hi)
    if pos.device.type == "cpu" and tables.device.type == "cpu":
        return interp_rows_plain(tables, pos, width, linear, share_table,
                                 lo, hi)
    n, r, t = pos.shape
    _kernels.check_tensor("pos", pos, torch.float32, (n, r, t))
    _kernels.check_tensor("tables", tables, torch.float32,
                          (1 if share_table else n, r, width))
    if tables.device != pos.device:
        raise ValueError(f"tables on {tables.device}, pos on {pos.device}")
    out = torch.empty_like(pos)
    if out.numel() == 0:
        return out
    err = _kernels.load().vt_interp_rows(
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(), n, r, t, width,
        int(bool(share_table)), int(bool(linear)), lo, hi,
        _kernels.stream_ptr(pos.device),
    )
    _kernels.check(err, "interp_rows kernel launch")
    interp_rows.launches += 1
    return out


interp_rows.launches = 0
