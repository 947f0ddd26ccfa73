"""NaN/Inf debug checks (``vacancy_tpu/utils/debug.py``).

``debug=True`` on the ``VoxelCarver`` entry points validates inputs and
results with ``assert_finite`` (the INVALID_SDF sentinel is float32
lowest, which is finite, so a plain scan is exact). The JAX package also
runs its exact fold under checkify's float checks (``checked_call``),
which flag NaNs generated inside the compiled step; PyTorch has no
checkify, so the port's exact fold checks each view's sampled distance
for NaN and the updated state for NaN/Inf instead
(``ops/fusion.fold_views``). Each check reads a count back to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _counts(arr):
    t = arr if torch.is_tensor(arr) else torch.as_tensor(np.asarray(arr))
    if not t.is_floating_point():
        return 0, 0, t.numel()
    return int(torch.isnan(t).sum()), int(torch.isinf(t).sum()), t.numel()


def assert_finite(name: str, arr) -> None:
    """Raise FloatingPointError if ``arr`` (a tensor on any device, or an
    array) holds any NaN/Inf."""
    n_nan, n_inf, size = _counts(arr)
    if n_nan or n_inf:
        raise FloatingPointError(
            f"{name}: {n_nan} NaN / {n_inf} Inf values out of {size}"
        )


def assert_no_nan(name: str, arr) -> None:
    """Raise FloatingPointError if ``arr`` holds any NaN (infinities are
    legitimate there, e.g. a bilinear blend of truncation sentinels that
    the truncation skip then drops)."""
    n_nan, _, size = _counts(arr)
    if n_nan:
        raise FloatingPointError(f"{name}: {n_nan} NaN values out of {size}")
