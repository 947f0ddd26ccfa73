"""Reading a ``torch.profiler`` trace of the measured window.

From the Chrome trace that ``export_chrome_trace`` writes:

* busy time: the union of the intervals in which a kernel, a copy or a
  memset ran on the card, clipped to the window (overlapping work is
  counted once);
* device time and launches per kernel name;
* idle gaps: each stretch of the window with nothing on the card, named
  by what the host's main thread was inside at the gap's middle: the
  innermost ``bench.*`` label and the innermost operator, if any.
"""

import collections
import dataclasses
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]  # name -> (seconds, launches)
    device_ops: List[Tuple[str, float]]  # the longest by total time
    idle_gaps: List[Tuple[str, float]]  # the longest by total time

    def kernel_time(self, *fragments: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds any of
        ``fragments``."""
        s, n = 0.0, 0
        for name, (t, k) in self.kernels.items():
            if any(f in name for f in fragments):
                s, n = s + t, n + k
        return s, n


def _union(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _innermost(events, times):
    """For each of the sorted ``times``, the innermost of the properly
    nested ``events`` (start, end, name) open at that time, or None."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(events) and events[k][0] <= t:
            while stack and stack[-1][1] <= events[k][0]:
                stack.pop()
            stack.append(events[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def summarize(path: str, window_label: str, top: int = 10) -> TraceSummary:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events
           if e.get("ph") == "X" and e.get("name") == window_label
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} {window_label!r} "
                           f"ranges, not one")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")

    kernels = collections.defaultdict(lambda: [0.0, 0])
    busy, labels, ops = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        lo = float(e["ts"])
        hi = lo + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            lo, hi = max(lo, w0), min(hi, w1)
            if hi <= lo:
                continue
            busy.append((lo, hi))
            k = kernels[e["name"]]
            k[0] += (hi - lo) * 1e-6
            k[1] += 1
        elif cat in HOST_CATS and e.get("tid") == main_tid:
            if cat == "user_annotation":
                if e["name"].startswith("bench.") and e is not win[0]:
                    labels.append((lo, hi, e["name"]))
            else:
                ops.append((lo, hi, e["name"]))
    merged = _union(busy)
    busy_s = sum(hi - lo for lo, hi in merged) * 1e-6

    gaps, edge = [], w0
    for lo, hi in merged + [[w1, w1]]:
        if lo > edge:
            gaps.append((edge, lo))
        edge = max(edge, hi)
    mids = [(lo + hi) / 2 for lo, hi in gaps]
    where = zip(_innermost(labels, mids), _innermost(ops, mids))
    by = collections.defaultdict(float)
    for (lo, hi), (label, op) in zip(gaps, where):
        name = label or "outside bench labels"
        by[name + (f" / {op}" if op else "")] += (hi - lo) * 1e-6

    def longest(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:top]

    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
        device_ops=[[k, v] for k, v in longest(
            {k: v[0] for k, v in kernels.items()})],
        idle_gaps=[[k, v] for k, v in longest(by)])
