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
any address. ``interp_plan`` mirrors the launch: with a shared table a CTA
stages one table row's taps in shared memory and samples it for a group of
planes ("staged"); otherwise each CTA gathers from global memory for a run
of rows ("direct4" with float4 positions and outputs, "direct1" one at a
time where ``t % 4 != 0`` or a pointer is not 16-byte aligned).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from .. import _kernels

# the launch constants of csrc/interp_rows.cu (checked once per process)
THREADS = 256
VEC = 4  # positions and outputs a thread moves at once (float4)
STAGE_BYTES_MAX = 48 * 1024  # shared memory a staged row may take
REGISTER_BUDGET = 64  # __launch_bounds__(256, 4)
# the plan's choices, passed to the kernel
GROUP_MAX = 512  # planes a staged CTA samples its row for
# a staged grid of at least four waves of 132 SMs at four CTAs each (64
# registers a thread); fewer planes per CTA cost more row copies (the
# groups' times: PERF.md, kernel C)
MIN_CTAS = 4 * 132 * 4
DIRECT_ITEMS = 4 * THREADS  # items (float4 or float) of a direct CTA
MAX_GRID_Y = 65535
MAX_ITEMS = 1 << 30  # items one CTA may walk (32-bit indices)
MODES = {"staged": 0, "direct4": 1, "direct1": 2}


@dataclasses.dataclass(frozen=True)
class InterpPlan:
    """One launch of kernel C, as the C entry point takes it."""

    mode: str  # "staged", "direct4" or "direct1"
    grid: Tuple[int, int]  # staged: (table rows, plane groups);
    #                        direct: (row runs, planes up to 65535)
    group: int  # planes per staged CTA (1 for direct)
    rows: int  # table rows per direct CTA (1 for staged)
    vec: int  # positions and outputs a thread moves at once
    stage_lo: int  # first staged tap: lo rounded down to a multiple of 4
    smem_bytes: int  # dynamic shared memory of a CTA


def interp_plan(n: int, r: int, t: int, width: int, share: bool, lo: int,
                hi: int, optin_bytes: int, aligned: bool) -> InterpPlan:
    """The launch for positions ``[n, r, t]`` into rows of ``width`` taps
    clamped to ``[lo, hi]`` (one table row per ``r`` with ``share``) on a
    card whose blocks may opt into ``optin_bytes`` of shared memory;
    ``aligned``: the positions and outputs start on 16 bytes. Raises
    ValueError on an empty shape or taps outside the row."""
    if min(n, r, t, width) < 1:
        raise ValueError(f"empty rows: n={n} r={r} t={t} width={width}")
    lo, hi = _taps(width, lo, hi)
    vec = VEC if aligned and t % VEC == 0 else 1
    stage_lo = lo & ~3
    smem = -(-(hi + 1 - stage_lo) // 4) * 16
    items_row = t // vec
    if share and vec == VEC and smem <= min(STAGE_BYTES_MAX, optin_bytes):
        group = min(n, GROUP_MAX, max(1, n * r // MIN_CTAS),
                    MAX_ITEMS // items_row)
        group = max(group, -(-n // MAX_GRID_Y), 1)
        return InterpPlan("staged", (r, -(-n // group)), group, 1, vec,
                          stage_lo, smem)
    rows = max(1, min(r, DIRECT_ITEMS // items_row))
    return InterpPlan("direct4" if vec == VEC else "direct1",
                      (-(-r // rows), min(n, MAX_GRID_Y)), 1, rows, vec,
                      stage_lo, 0)


@functools.lru_cache(maxsize=None)
def _check_tiling() -> None:
    """Once per process: the built kernel's constants are this module's."""
    lib = _kernels.load()
    got = tuple(lib.vt_interp_tiling(i) for i in range(5))
    if got[:3] != (THREADS, VEC, STAGE_BYTES_MAX) or not (
            0 < got[3] <= REGISTER_BUDGET) or got[4] != 0:
        raise RuntimeError(f"csrc/interp_rows.cu's constants {got} differ "
                           f"from ops/warp_gather.py's")


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
    version. CUDA tensors launch kernel C once, as ``interp_plan`` lays it
    out (``interp_rows.launches`` counts those launches), or raise: on
    inputs the kernel does not take, or on a non-zero cudaError_t from the
    launch."""
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
    plan = interp_plan(
        n, r, t, width, share_table, lo, hi,
        _kernels.smem_optin_bytes(pos.device),
        pos.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    _check_tiling()
    err = _kernels.load().vt_interp_rows(
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(), n, r, t, width,
        int(bool(share_table)), int(bool(linear)), lo, hi, MODES[plan.mode],
        plan.group, plan.rows, _kernels.stream_ptr(pos.device),
    )
    _kernels.check(err, "interp_rows kernel launch")
    interp_rows.launches += 1
    return out


interp_rows.launches = 0
