"""Wall-clock and device timing (``vacancy_tpu/utils/timing.py``;
reference: src/vacancy/timer.h:13-46).

``Timer`` is the reference's start/end timer with its 30-sample rolling
average. ``device_timer`` times a block of CUDA work with CUDA events (on
the CPU, where nothing is asynchronous, with the host clock). ``trace``
captures a ``torch.profiler`` trace of a scope. ``span`` names a stretch
of the program's own work in such a trace, and costs a flag check when no
profiler records.
"""

from __future__ import annotations

import collections
import os
import time
from contextlib import contextmanager, nullcontext
from typing import Optional

import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import record_function

# what ``span`` returns when no profiler records: one context manager that
# does nothing, shared by every call
_NO_SPAN = nullcontext()


def span(name: str):
    """A ``vt.<name>`` range in a ``torch.profiler`` trace around the
    ``with`` block while a profiler records, on the profiler's host clock;
    otherwise the shared no-op ``_NO_SPAN``. The check reads the flag
    that the profiler sets for this purpose when it starts and clears
    when it stops: far cheaper than ``record_function``, which costs
    ~13 us a call even with no profiler."""
    if not autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return record_function(f"vt.{name}")


class Timer:
    """Start/End wall-clock timer with a rolling average (default 30)."""

    def __init__(self, history: int = 30):
        self._start: Optional[float] = None
        self._elapsed_ms: float = 0.0
        self._history = collections.deque(maxlen=history)

    def start(self) -> None:
        self._start = time.perf_counter()

    def end(self) -> float:
        assert self._start is not None, "end() without start()"
        self._elapsed_ms = (time.perf_counter() - self._start) * 1e3
        self._history.append(self._elapsed_ms)
        self._start = None
        return self._elapsed_ms

    @property
    def elapsed_msec(self) -> float:
        return self._elapsed_ms

    @property
    def average_msec(self) -> float:
        if not self._history:
            return 0.0
        return sum(self._history) / len(self._history)


@contextmanager
def device_timer(label: str = "", result_holder: Optional[dict] = None,
                 device="cuda"):
    """Times a block of work on ``device``. On a CUDA device ``ms`` is the
    time between two CUDA events recorded on the current stream around
    the block, read after a synchronize; on the CPU it is the host clock."""
    device = torch.device(device)
    out = {}
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(device))
    else:
        t0 = time.perf_counter()
    try:
        yield out
    finally:
        if device.type == "cuda":
            end.record(torch.cuda.current_stream(device))
            end.synchronize()
            out["ms"] = start.elapsed_time(end)
        else:
            out["ms"] = (time.perf_counter() - t0) * 1e3
        out["label"] = label
        if result_holder is not None:
            result_holder.update(out)


@contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace scope. With a ``log_dir``, records the
    CPU and (where there is a card) CUDA activity of everything inside
    the scope and writes ``log_dir/trace.json`` (Chrome trace format,
    readable by Perfetto and chrome://tracing); with None it does
    nothing, so call sites can wrap hot phases unconditionally."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
