"""One run of a cell: set-up, the measured window, the trace and the
check, with the one general generator that reads every traffic mix.

A mix (``traffic/<mix>.json``) is data: the pool of frames made in
set-up and cycled (how many, the object each frame holds), the warm and
checked requests, and ``request``, the facade calls one request makes,
in order. Each step names a ``VoxelCarver`` method, the inputs it takes
(``cameras``, ``masks``), the configuration's section passed as its
keyword arguments (``config``), further ``options``, and what of its
return value the check compares (``returns``: ``sdf_images`` or
``mesh``); the fused state the carver holds after the request is
compared as well. The loop is closed with one client: the next request
is issued when the last one has returned, as a caller of the facade,
which answers one call at a time, issues them. A request ends when its
last step has returned and a device synchronize after it; each step's
span ends in a synchronize too. Nothing is written to disk.
"""

import contextlib
import dataclasses
import gc
import os
import random
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import cells, check, program, scene
from .cells import Cell
from .trace import TraceSummary, summarize

WINDOW_LABEL = "bench.window"


@dataclasses.dataclass
class Request:
    frame: int
    latency_s: float
    spans: Dict[str, float]  # seconds of each facade call, by its name
    mesh_size: Optional[Tuple[int, int]]  # (vertices, faces), if meshed


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    shape: dict  # nz, ny, nx, views, height, width
    setup_s: float
    window_s: float
    requests: List[Request]
    failed: int
    launches: dict  # per request in the window
    memory_peak_bytes: int
    setup_phases: dict  # seconds of each part of set-up
    process_peak_bytes: int  # the peak with the check's samples held
    trace: Optional[TraceSummary] = None
    readings: dict = dataclasses.field(default_factory=dict)
    correct: bool = False

    def p50_ms(self, call: str) -> Optional[float]:
        """Median span of the facade call ``call``, or None where no
        request made it."""
        vals = [r.spans[call] for r in self.requests if call in r.spans]
        return statistics.median(vals) * 1e3 if vals else None


def describe(requests: List[Request]) -> dict:
    """Quantiles of the latency (ms), the first three latencies in the
    window (ms), the medians of the spans (ms), the mean mesh size, and
    each frame's median latency (ms)."""
    if len(requests) < 2:
        return {}
    lat = [r.latency_s * 1e3 for r in requests]
    q = statistics.quantiles(lat, n=100, method="inclusive")
    frames = sorted({r.frame for r in requests})
    calls = sorted({c for r in requests for c in r.spans})
    meshed = [r.mesh_size[1] for r in requests if r.mesh_size]
    return {
        "latency_ms": {"p50": q[49], "p90": q[89], "p95": q[94],
                       "p99": q[98], "max": max(lat)},
        "first_ms": lat[:3],
        "span_ms": {c: statistics.median(
            r.spans[c] for r in requests if c in r.spans) * 1e3
            for c in calls},
        "faces": statistics.mean(meshed) if meshed else None,
        "frame_ms": [round(statistics.median(
            r.latency_s * 1e3 for r in requests if r.frame == f), 3)
            for f in frames],
    }


def kept_outputs(traffic: dict) -> set:
    """The outputs of a request that the check compares: what its steps
    return, and the state."""
    return {s["returns"] for s in traffic["request"] if "returns" in s} | {
        "state"}


def pool_frames(config: dict, traffic: dict) -> int:
    """Frames in the pool: ``pool_frames``, fewer where their masks would
    pass ``pool_mask_bytes_max``."""
    rig = config["rig"]
    frame_bytes = rig["views"] * rig["width"] * rig["height"]
    return max(1, min(int(traffic["pool_frames"]),
                      int(traffic["pool_mask_bytes_max"]) // frame_bytes))


def make_inputs(cell: Cell, seed: int, device):
    """((c2w, principal_point, focal_length) of the rig, the pool of
    frames: uint8 masks [V, H, W] on ``device``), all from ``seed``."""
    rig = cell.config["rig"]
    c2w, pp, fl = scene.rig(rig)
    objects = scene.pool_objects(seed, pool_frames(cell.config, cell.traffic),
                                 cell.traffic["object"])
    pool = [scene.render_masks(c2w, pp, fl, rig["width"], rig["height"],
                               c, r, device) for c, r in objects]
    return (c2w, pp, fl), pool


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``rng``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def wants(self) -> Optional[int]:
        """The slot the next item goes to, or None; counts the item."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None


class Facade:
    """The steps of a request run against one carver. On a CUDA device it
    also keeps the memory peak of the steps, less the device bytes that
    the check's sample holds beside the carver's own state, taken before
    and after each step: the peak a deployment, which keeps no samples,
    would reach. (The ``init`` after a sampled request lets go of the
    state the sample keeps, which is the carver's own before the call and
    not after it.)"""

    def __init__(self, carver, cell: Cell, inputs: dict, device):
        self.carver, self.cell, self.inputs = carver, cell, inputs
        self.device, self.peak, self.process_peak = device, 0, 0
        self.cuda = device.type == "cuda"

    def _held(self, sample) -> int:
        items = [item for item in (sample.items if sample else [])
                 if item is not None]
        if not items:
            return 0
        own = {t.data_ptr() for t in program.state(self.carver)}
        return sum(t.numel() * t.element_size() for _, kept in items
                   for t in kept["state"]
                   if t.device.type == "cuda" and t.data_ptr() not in own)

    def __call__(self, masks, sample=None):
        """(spans, outputs) of one reconstruction of ``masks``."""
        inputs = dict(self.inputs, masks=masks)
        spans, outputs = {}, {}
        for step in self.cell.traffic["request"]:
            name = step["call"]
            if self.cuda:
                held = self._held(sample)
                torch.cuda.reset_peak_memory_stats(self.device)
            t = time.perf_counter()
            with torch.profiler.record_function(f"bench.{name}"):
                value = program.call(self.carver, step, self.cell.config,
                                     inputs)
                _sync(self.device)
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t
            if self.cuda:
                peak = torch.cuda.max_memory_allocated(self.device)
                self.process_peak = max(self.process_peak, peak)
                self.peak = max(self.peak,
                                peak - max(held, self._held(sample)))
            if "returns" in step:
                outputs[step["returns"]] = value
        return spans, outputs


@contextlib.contextmanager
def _profiled(enabled: bool, device):
    """A torch profiler over the block when ``enabled``; yields a list
    that holds the path of its exported trace afterwards."""
    out = []
    if not enabled:
        yield out
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield out
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    out.append(path)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        started: float, clock=time.perf_counter) -> Run:
    """Set up, measure for ``seconds``, check. ``started`` is the time,
    on ``clock``, at which the process started; set-up runs from then to
    the first timed request."""
    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    rig = cfg["rig"]
    phases = {"before_run": clock() - started}
    t = time.perf_counter()
    (c2w, pp, fl), pool = make_inputs(cell, seed, device)
    _sync(device)
    phases["inputs"] = time.perf_counter() - t
    n_frames = len(pool)
    t = time.perf_counter()
    carver = program.carver(cfg, device)
    cams = program.cameras(c2w, pp, fl, rig["width"], rig["height"], device)
    request = Facade(carver, cell, {"cameras": cams}, device)
    for i in range(int(traffic["warm_requests"])):
        request(pool[i % n_frames])
        phases[f"warm_{i}"] = time.perf_counter() - t
        t = time.perf_counter()
    nz, ny, nx = carver.grid.shape_zyx
    shape = dict(nz=nz, ny=ny, nx=nx, views=rig["views"],
                 height=rig["height"], width=rig["width"])

    sample = Reservoir(int(traffic["check_requests"]), random.Random(seed))
    requests, failed = [], 0
    request.peak = request.process_peak = 0
    before = program.launches()
    with _profiled(trace, device) as exported:
        setup_s = clock() - started
        t0 = t_issue = time.perf_counter()
        with torch.profiler.record_function(WINDOW_LABEL):
            while True:
                f = (len(requests) + failed) % n_frames
                try:
                    spans, outputs = request(pool[f], sample)
                except (RuntimeError, ValueError) as e:
                    failed += 1
                    print(f"request failed: {e!r}", file=sys.stderr,
                          flush=True)
                    t_issue = time.perf_counter()
                    if t_issue - t0 >= seconds:
                        break
                    continue
                t_end = time.perf_counter()
                with torch.profiler.record_function("bench.between"):
                    mesh = outputs.get("mesh")
                    requests.append(Request(
                        f, t_end - t_issue, spans,
                        (len(mesh.vertices), len(mesh.faces))
                        if mesh is not None else None))
                    slot = sample.wants()
                    if slot is not None:
                        kept = {k: program.returned(k, v)
                                for k, v in outputs.items()}
                        kept["state"] = program.state(carver)
                        sample.items[slot] = (f, kept)
                    del outputs, mesh
                t_issue = t_end
                if t_end - t0 >= seconds:
                    break
        window_s = t_issue - t0
    after = program.launches()
    n = max(1, len(requests) + failed)
    result = Run(cell, seed, shape, setup_s, window_s, requests, failed,
                 {k: (after[k] - before[k]) / n for k in after},
                 request.peak, phases, request.process_peak)
    if exported:
        try:
            result.trace = summarize(exported[0], WINDOW_LABEL)
        finally:
            os.remove(exported[0])

    # the program's state is freed before the reference runs
    del carver, request
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    kept = [item for item in sample.items if item is not None]
    result.correct = failed == 0 and len(kept) > 0
    result.readings = compare(cfg, kept, pool, (c2w, pp, fl))
    result.correct &= check.verdict(result.readings, cell.limits)
    return result


def compare(cfg: dict, kept, pool, rig, store=torch.float32) -> dict:
    """The compared numbers over the kept requests, each the widest gap
    of any of them against the reference that the configuration names
    (``reference/<name>.py``), computed in ``store`` between stages;
    only the outputs the requests kept are compared
    (``harness.check``)."""
    reference = cells.load_reference(cfg["reference"])
    readings = {}
    while kept:
        f, out = kept.pop(0)
        ref = reference.reconstruct(pool[f], *rig, cfg, set(out),
                                    store=store)
        for k, v in check.gaps(cfg, out, ref).items():
            readings[k] = max(readings.get(k, 0.0), v)
        del ref, out
        if pool[f].device.type == "cuda":
            torch.cuda.empty_cache()
    return readings
