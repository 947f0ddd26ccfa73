"""The program's own spans and counters in a traced run.

The program names stretches of its work ``vt.<name>`` in a
``torch.profiler`` trace (``vacancy_tpu_torch.utils.timing.span``), on
the profiler's host clock, and counts the active cubes kernel B emits
(``marching_cubes_fused.cubes``). From the Chrome trace of the window
``read`` gives:

* per span name, one ``Instance`` per occurrence on the main thread: the
  ``bench.<call>`` instance it sits in (the facade call, which names the
  request), its host seconds, its self seconds (less its child ``vt.*``
  spans), its device seconds (the kernels, copies and memsets, clipped
  to the window as ``busy_s`` is, whose launch, joined by
  ``args.correlation``, starts inside it and outside its children) and
  its idle seconds (the window's idle stretches inside it and outside
  its children);
* the idle gaps labelled as ``harness.trace`` labels them, with the
  innermost ``vt.*`` span open at the gap's middle between the
  ``bench.*`` label and the operator; where none is open, the label is
  ``harness.trace``'s.

``attach`` hooks this into ``driver.run`` without changing what the
driver measures: the summary of a traced window becomes a
``SpanSummary``, a ``TraceSummary`` that also holds ``spans`` and
``counters`` (the program's counters over the window, ``counters()``),
and whose ``idle_gaps`` carry the span labels. Every other field is
``harness.trace.summarize``'s own, and ``harness.trace`` and
``harness.driver`` stay as they are. A reader of these metrics calls it
when it is loaded, which ``run.py`` does before the window. A program
without spans or counters gives empty ``spans`` and ``counters``, and
labels equal to ``harness.trace``'s.
"""

import bisect
import collections
import contextlib
import dataclasses
import json
import statistics
from typing import Dict, List, Optional, Tuple

from . import driver
from .trace import DEVICE_CATS, TraceSummary, _innermost, _union

PREFIX = "vt."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Instance:
    call: Optional[str]  # the bench.<call> label it sits in, or None
    call_index: int  # which instance of that call in the window, from 0
    host_s: float
    self_s: float
    device_s: float
    idle_s: float


@dataclasses.dataclass
class SpanSummary(TraceSummary):
    spans: Dict[str, List[Instance]] = dataclasses.field(
        default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)


def counters() -> Dict[str, int]:
    """The program's counters, by the name the benchmark gives them: the
    active cubes kernel B emitted. Empty for a program without them."""
    from vacancy_tpu_torch.ops import mc_fused

    cubes = getattr(mc_fused.marching_cubes_fused, "cubes", None)
    return {} if cubes is None else {"mc_active_cubes": cubes}


class _Gaps:
    """The idle stretches of the window, measured over any interval."""

    def __init__(self, gaps: List[Tuple[float, float]]):
        self.lo = [lo for lo, _ in gaps]
        self.hi = [hi for _, hi in gaps]
        self.before = [0.0]  # idle time before each gap
        for lo, hi in gaps:
            self.before.append(self.before[-1] + hi - lo)

    def _upto(self, t: float) -> float:
        k = bisect.bisect_right(self.lo, t)
        if k == 0:
            return 0.0
        return self.before[k - 1] + min(t, self.hi[k - 1]) - self.lo[k - 1]

    def within(self, lo: float, hi: float) -> float:
        return self._upto(hi) - self._upto(lo)


def read(path: str, window_label: str, top: int = 10):
    """(spans, idle_gaps) of the window ``window_label`` in the Chrome
    trace at ``path``: ``{name: [Instance, ...]}`` in order of start, and
    the ``top`` labelled idle gaps by total seconds."""
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

    busy, device, labels, ops, spans, names, launched = ([], [], [], [],
                                                         [], [], {})
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        lo = float(e["ts"])
        hi = lo + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            lo, hi = max(lo, w0), min(hi, w1)
            if hi > lo:
                busy.append((lo, hi))
                device.append((e.get("args", {}).get("correlation"),
                               hi - lo))
        elif e.get("tid") != main_tid:
            continue
        elif cat in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launched[c] = lo
        elif cat == "cpu_op":
            ops.append((lo, hi, e["name"]))
        elif cat == "user_annotation" and e is not win[0]:
            if e["name"].startswith("bench."):
                labels.append((lo, hi, e["name"]))
            elif e["name"].startswith(PREFIX) and w0 <= lo < w1:
                spans.append((lo, min(hi, w1), len(spans)))
                names.append(e["name"])
    spans.sort(key=lambda s: (s[0], -s[1]))
    # each facade call's instances, numbered in order of start
    labels.sort()
    seen = collections.Counter()
    for k, (lo, hi, name) in enumerate(labels):
        labels[k] = (lo, hi, (name, seen[name]))
        seen[name] += 1

    merged = _union(busy)
    gaps, edge = [], w0
    for lo, hi in merged + [[w1, w1]]:
        if lo > edge:
            gaps.append((edge, lo))
        edge = max(edge, hi)
    idle = _Gaps(gaps)

    # each span's parent span, from a walk in order of start
    parent, stack = {}, []
    for lo, hi, i in spans:
        while stack and stack[-1][1] <= lo:
            stack.pop()
        parent[i] = stack[-1][2] if stack else None
        stack.append((lo, hi, i))
    child_s = collections.defaultdict(float)
    child_idle = collections.defaultdict(float)
    for lo, hi, i in spans:
        if parent[i] is not None:
            child_s[parent[i]] += hi - lo
            child_idle[parent[i]] += idle.within(lo, hi)

    # a device event goes to the innermost span open at its launch
    at = sorted((launched[c], s) for c, s in device if c in launched)
    dev_s = collections.defaultdict(float)
    for i, (_, s) in zip(_innermost(spans, [t for t, _ in at]), at):
        if i is not None:
            dev_s[i] += s

    by_name = collections.defaultdict(list)
    calls = _innermost(labels, [lo for lo, _, _ in spans])
    for (lo, hi, i), call in zip(spans, calls):
        by_name[names[i]].append(Instance(
            call=call[0] if call else None,
            call_index=call[1] if call else -1,
            host_s=(hi - lo) * 1e-6,
            self_s=(hi - lo - child_s[i]) * 1e-6,
            device_s=dev_s[i] * 1e-6,
            idle_s=(idle.within(lo, hi) - child_idle[i]) * 1e-6))

    mids = [(lo + hi) / 2 for lo, hi in gaps]
    named = [(lo, hi, names[i]) for lo, hi, i in spans]
    where = zip(_innermost(labels, mids), _innermost(named, mids),
                _innermost(ops, mids))
    by = collections.defaultdict(float)
    for (lo, hi), (label, span, op) in zip(gaps, where):
        name = label[0] if label else "outside bench labels"
        name += f" / {span}" if span else ""
        by[name + (f" / {op}" if op else "")] += (hi - lo) * 1e-6
    longest = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return dict(by_name), [[k, v] for k, v in longest]


def per_request(summary, name: str, field: str) -> List[float]:
    """``field`` of span ``name`` summed over each request's instances
    (those in one ``bench.<call>`` instance), in order; empty where the
    summary holds no such span."""
    sums = collections.defaultdict(float)
    for inst in getattr(summary, "spans", {}).get(name, []):
        sums[(inst.call, inst.call_index)] += getattr(inst, field)
    return list(sums.values())


def median_ms(run, name: str, field: str) -> Optional[float]:
    """The median over the window's requests of ``field`` of span
    ``name`` per request, in ms; None for an untraced run, a trace with
    no device work (a CPU run) or no such span."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    vals = per_request(run.trace, name, field)
    return statistics.median(vals) * 1e3 if vals else None


def attach() -> None:
    """Route ``driver.run``'s traced windows through this module: the
    program's counters are read just before and after the profiled
    window, and its summary is a ``SpanSummary``. Idempotent."""
    if getattr(driver.summarize, "reads_spans", False):
        return
    profiled, plain = driver._profiled, driver.summarize
    window = {}  # a trace's path -> the counters over its window

    @contextlib.contextmanager
    def counted(enabled, device):
        before = counters()
        with profiled(enabled, device) as exported:
            yield exported
        after = counters()
        if exported:
            window[exported[0]] = {k: after[k] - before[k] for k in after
                                   if k in before}

    def summarize_with_spans(path, window_label, top=10):
        base = plain(path, window_label, top)
        spans, idle_gaps = read(path, window_label, top)
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(TraceSummary)}
        fields["idle_gaps"] = idle_gaps
        return SpanSummary(**fields, spans=spans,
                           counters=window.pop(path, {}))

    summarize_with_spans.reads_spans = True
    driver._profiled, driver.summarize = counted, summarize_with_spans
