"""The reader of the program's spans and counters (``harness.spans``):
on a hand-made Chrome trace, what each span instance holds, and that the
trace reader's own fields and labels are the same with and without the
program's spans; on traced runs, the four metrics that read them."""

import json
import time

import pytest

from harness import cells, driver, spans, trace
from bench_small import small_cell

US = 1e-6
NEW = ("sdf2d.device_ms", "image_return.idle_ms", "assemble.idle_ms",
       "expand_faces.mcubes_per_s")
OLD = ("carve.p50_ms", "extract.p50_ms", "warp_a.roofline_pct",
       "mc_b.roofline_pct", "device.idle_pct")
MAIN, OTHER = 7, 8


def _x(name, cat, ts, dur, tid=MAIN, correlation=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def _launched(name, cat, corr, at, ts, dur):
    """A launch on the main thread at ``at`` and its device event."""
    return [_x("cudaLaunchKernel", "cuda_runtime", at, 2, correlation=corr),
            _x(name, cat, ts, dur, tid=OTHER, correlation=corr)]


# One request of two facade calls in a window of 1000 us. The device runs
# [40,90] [165,245] [275,300] [445,495] [555,560] [700,720] [990,1000]
# (the last launched at 985, clipped at the window's end), so the idle
# gaps are [0,40] [90,165] [245,275] [300,445] [495,555] [560,700]
# [720,990]: 760 us, and one lies in each span.
CALLS = [
    _x("bench.window", "user_annotation", 0, 1000),
    _x("bench.carve_batch", "user_annotation", 10, 390),
    _x("bench.extract_iso_surface", "user_annotation", 420, 500),
    _x("aten::copy_", "cpu_op", 310, 68),
    *_launched("sdf_kernel", "kernel", 1, 30, 40, 50),
    *_launched("warp_fused_kernel<1>", "kernel", 2, 160, 165, 80),
    *_launched("Memcpy DtoH", "gpu_memcpy", 3, 270, 275, 25),
    *_launched("mc_count_kernel", "kernel", 4, 440, 445, 50),
    *_launched("aten_kernel", "kernel", 5, 550, 555, 5),
    *_launched("mc_emit_kernel", "kernel", 6, 650, 700, 20),
    *_launched("late_kernel", "kernel", 7, 985, 990, 20),
    _x("cudaLaunchKernel", "cuda_runtime", 100, 2, tid=OTHER,
       correlation=99),
]
SPANS = [
    _x("vt.sdf2d", "user_annotation", 15, 105),
    _x("vt.warp", "user_annotation", 150, 100),
    _x("vt.image_return", "user_annotation", 255, 125),
    _x("vt.mc_b", "user_annotation", 430, 70),
    _x("vt.assemble", "user_annotation", 520, 380),
    _x("vt.expand_faces", "user_annotation", 600, 200),
]
# name: (call, host, self, device, idle), in us
EXPECTED = {
    "vt.sdf2d": ("bench.carve_batch", 105, 105, 50, 25 + 30),
    "vt.warp": ("bench.carve_batch", 100, 100, 80, 15 + 5),
    "vt.image_return": ("bench.carve_batch", 125, 125, 25, 20 + 80),
    "vt.mc_b": ("bench.extract_iso_surface", 70, 70, 50, 15 + 5),
    "vt.assemble": ("bench.extract_iso_surface", 380, 180, 5,
                    35 + 140 + 180 - (100 + 80)),
    "vt.expand_faces": ("bench.extract_iso_surface", 200, 200, 20,
                        100 + 80),
}
# the idle labels without the program's spans, in us
PLAIN_GAPS = {"bench.extract_iso_surface": 60 + 140 + 270,
              "bench.carve_batch": 40 + 75 + 30,
              "bench.carve_batch / aten::copy_": 145}
SPAN_GAPS = {"bench.extract_iso_surface / vt.assemble": 60 + 270,
             "bench.carve_batch / vt.image_return / aten::copy_": 145,
             "bench.extract_iso_surface / vt.expand_faces": 140,
             "bench.carve_batch": 75,
             "bench.carve_batch / vt.sdf2d": 40,
             "bench.carve_batch / vt.image_return": 30}


def _write(tmp_path, events, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


@pytest.fixture
def traces(tmp_path):
    """(the trace with the program's spans, the same without them)."""
    return (_write(tmp_path, CALLS + SPANS, "spans.json"),
            _write(tmp_path, CALLS, "plain.json"))


def test_each_span_instance_holds_its_seconds(traces):
    found, _ = spans.read(traces[0], driver.WINDOW_LABEL)
    assert set(found) == set(EXPECTED)
    for name, (call, host, own, device, idle) in EXPECTED.items():
        (inst,) = found[name]
        assert (inst.call, inst.call_index) == (call, 0), name
        assert inst.host_s == host * US, name
        assert inst.self_s == own * US, name
        assert inst.device_s == device * US, name
        assert inst.idle_s == idle * US, name


def test_the_idle_labels_gain_the_innermost_span(traces):
    _, gaps = spans.read(traces[0], driver.WINDOW_LABEL)
    assert {k: pytest.approx(v * US, rel=1e-12)
            for k, v in SPAN_GAPS.items()} == dict(gaps)
    assert sum(v for _, v in gaps) == pytest.approx(760 * US, rel=1e-12)


def test_without_spans_the_summary_is_the_trace_readers(traces):
    """With no ``vt.*`` event every field and label is
    ``harness.trace.summarize``'s, and holds the pinned values."""
    spans.attach()
    plain = trace.summarize(traces[1], driver.WINDOW_LABEL)
    read = driver.summarize(traces[1], driver.WINDOW_LABEL)
    assert isinstance(read, spans.SpanSummary) and read.spans == {}
    for field in ("window_s", "busy_s", "kernels", "device_ops",
                  "idle_gaps"):
        assert getattr(read, field) == getattr(plain, field), field
    assert plain.window_s == pytest.approx(1000 * US, rel=1e-12)
    assert plain.busy_s == pytest.approx(240 * US, rel=1e-12)
    assert plain.kernels["warp_fused_kernel<1>"] == (80 * US, 1)
    assert plain.kernels["late_kernel"] == (10 * US, 1)
    assert {k for k, _ in plain.device_ops} == set(plain.kernels)
    assert {k: pytest.approx(v * US, rel=1e-12)
            for k, v in PLAIN_GAPS.items()} == dict(plain.idle_gaps)


def _run(summary):
    """A run of one request around ``summary``, as the readers see it."""
    request = driver.Request(0, 1e-3, {"carve_batch": 4e-4,
                                       "extract_iso_surface": 5e-4},
                             (100, 200))
    return driver.Run(None, 1, dict(nz=64, ny=64, nx=64, views=4,
                                    height=48, width=64), 1.0, 1e-3,
                      [request], 0, {}, 0, {}, 0, trace=summary)


def test_the_readers_of_the_trace_read_the_same_with_spans(traces):
    spans.attach()
    with_spans = _run(driver.summarize(traces[0], driver.WINDOW_LABEL))
    without = _run(trace.summarize(traces[1], driver.WINDOW_LABEL))
    for name in OLD:
        read = cells.load_reader("layer_metrics", name)
        value = read(with_spans)
        assert value is not None and value == read(without), name


def test_the_new_readers_on_the_hand_made_trace(traces):
    spans.attach()
    summary = driver.summarize(traces[0], driver.WINDOW_LABEL)
    summary.counters = {"mc_active_cubes": 4000}
    run = _run(summary)
    read = {n: cells.load_reader("layer_metrics", n)(run) for n in NEW}
    assert read["sdf2d.device_ms"] == pytest.approx(0.05, rel=1e-12)
    assert read["image_return.idle_ms"] == pytest.approx(0.1, rel=1e-12)
    assert read["assemble.idle_ms"] == pytest.approx(0.175, rel=1e-12)
    # 4000 cubes in 200 us
    assert read["expand_faces.mcubes_per_s"] == pytest.approx(20.0,
                                                              rel=1e-12)
    plain = _run(trace.summarize(traces[1], driver.WINDOW_LABEL))
    assert all(cells.load_reader("layer_metrics", n)(plain) is None
               for n in NEW)


def test_instances_are_grouped_by_request(tmp_path):
    """Two requests: each span's per-request sums, in order."""
    second = [dict(e, ts=e["ts"] + 2000) for e in CALLS[1:] + SPANS]
    for e in second:
        if "args" in e:
            e["args"] = {"correlation": e["args"]["correlation"] + 100}
    window = dict(CALLS[0], dur=3000)
    path = _write(tmp_path, [window] + CALLS[1:] + SPANS + second)
    found, _ = spans.read(path, driver.WINDOW_LABEL)
    assert [(i.call, i.call_index) for i in found["vt.warp"]] == [
        ("bench.carve_batch", 0), ("bench.carve_batch", 1)]
    summary = spans.SpanSummary(3e-3, 0, {}, [], [], spans=found)
    assert spans.per_request(summary, "vt.expand_faces", "host_s") == [
        200 * US, 200 * US]


@pytest.fixture(scope="module")
def traced_cpu_run():
    spans.attach()
    return driver.run(small_cell(), 2**31 + 7, 0.3, True, "cpu",
                      time.perf_counter())


def test_a_traced_cpu_run_holds_every_span_and_the_counter(traced_cpu_run):
    run = traced_cpu_run
    assert run.correct, run.readings
    assert isinstance(run.trace, spans.SpanSummary)
    assert set(run.trace.spans) == {
        "vt.sdf2d", "vt.warp", "vt.image_return", "vt.mc_b",
        "vt.stream_copy", "vt.assemble", "vt.expand_faces"}
    for name, inst in run.trace.spans.items():
        assert len(inst) == len(run.requests), name
    assert run.trace.counters["mc_active_cubes"] > 0


def test_the_new_readers_on_a_traced_cpu_run(traced_cpu_run):
    """The device readers find no device work on the CPU and return None,
    never 0; the expansion's rate is a number."""
    read = {n: cells.load_reader("layer_metrics", n)(traced_cpu_run)
            for n in NEW}
    assert read["expand_faces.mcubes_per_s"] > 0
    assert [read[n] for n in NEW[:3]] == [None, None, None]


def test_the_new_readers_on_an_untraced_cpu_run():
    run = driver.run(small_cell(), 2**31 + 8, 0.2, False, "cpu",
                     time.perf_counter())
    assert all(cells.load_reader("layer_metrics", n)(run) is None
               for n in NEW)


def test_a_program_without_spans_or_counter(monkeypatch):
    """The parent program, which has neither: the readers find nothing
    and return None, and nothing raises."""
    import types

    from vacancy_tpu_torch import ops
    from vacancy_tpu_torch.ops import mc_fused
    from vacancy_tpu_torch.utils import timing

    for module in ("carver", "ops.fusion_warp", "ops.mc_fused",
                   "ops.marching_cubes"):
        monkeypatch.setattr(f"vacancy_tpu_torch.{module}.span",
                            lambda name: timing._NO_SPAN)

    # what the benchmark's readers import: kernel B's function with its
    # launch counter and no count of cubes
    def marching_cubes_fused():
        pass

    marching_cubes_fused.launches = 0
    monkeypatch.setattr(ops, "mc_fused", types.SimpleNamespace(
        marching_cubes_fused=marching_cubes_fused,
        mc_tile_counts=mc_fused.mc_tile_counts, mc_scan=mc_fused.mc_scan))
    spans.attach()
    assert spans.counters() == {}
    run = driver.run(small_cell(), 2**31 + 9, 0.2, True, "cpu",
                     time.perf_counter())
    assert run.correct and run.trace.spans == {} and run.trace.counters == {}
    assert all(cells.load_reader("layer_metrics", n)(run) is None
               for n in NEW)


@pytest.mark.cuda
def test_the_new_readers_on_the_card():
    """A traced run of a cut-down cell: the four readers read positive
    numbers, and kernel A's device time lies in ``vt.warp``."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spans.attach()
    cell = small_cell(n=128, views=8, width=320, height=240)
    run = driver.run(cell, 2**31 + 98, 1.0, True, "cuda:0",
                     time.perf_counter())
    assert run.correct, run.readings
    for name in NEW:
        value = cells.load_reader("layer_metrics", name)(run)
        assert value is not None and value > 0, name
    a_s, a_n = run.trace.kernel_time("warp_fused_kernel")
    warp_s = sum(i.device_s for i in run.trace.spans["vt.warp"])
    assert a_n == len(run.requests) and a_s > 0
    assert warp_s >= a_s * (1 - 1e-9)
