"""The naive-carving cell: the plain reference of upstream's per-voxel
``Carve`` (``reference/naive_carving.py``) against the facade's exact
engine on the CPU, the bound of the exact fold
(``harness/roofline_exact.py``), and the two readers of the exact engine
on a hand-made trace and on traced CPU runs."""

import json
import time

import numpy as np
import pytest
import torch

from harness import cells, driver, exact_views, program, roofline, \
    roofline_exact
from bench_small import small_cell

CELL = "carving36-512.exact"
STAGES = {"sdf_images", "state", "mesh"}
NEW = ("exact.device_ms", "exact.roofline_pct")
US = 1e-6


@pytest.fixture(autouse=True)
def _restore_driver(monkeypatch):
    """The hooks that the readers install on ``driver`` last for one
    test only."""
    monkeypatch.setattr(driver, "_profiled", driver._profiled)
    monkeypatch.setattr(driver, "summarize", driver.summarize)


@pytest.mark.parametrize("n,views,size", [(16, 4, (64, 48)),
                                          (32, 6, (64, 48)),
                                          (48, 8, (48, 36))])
def test_reference_matches_the_facades_exact_engine(n, views, size):
    """Tolerance 0 for all three outputs: the reference keeps upstream's
    order of every float expression (its docstring lists where the order
    decides bits), and so does the exact engine, so images, state and
    mesh agree exactly; the update counts agree as integers."""
    cell = small_cell(n=n, views=views, width=size[0], height=size[1],
                      name=CELL)
    cfg = cell.config
    rig, pool = driver.make_inputs(cell, 2**35 + n, "cpu")
    carver = program.carver(cfg, "cpu")
    cams = program.cameras(*rig, size[0], size[1], "cpu")
    reference = cells.load_reference(cfg["reference"])
    for masks in pool:
        carver.init()
        images = carver.carve_batch(cams, masks, engine="exact")
        mesh = carver.extract_iso_surface(**cfg["extract"])
        ref = reference.reconstruct(masks, *rig, cfg, STAGES)
        (r_sdf, r_un), (r_verts, r_faces) = ref["state"], ref["mesh"]
        np.testing.assert_array_equal(images, ref["sdf_images"].numpy())
        assert torch.equal(carver.state.update_num, r_un)
        assert torch.equal(carver.state.sdf, r_sdf)
        assert int(r_un.max()) > 1 and len(r_faces) > 20
        np.testing.assert_array_equal(mesh.vertices, r_verts)
        np.testing.assert_array_equal(mesh.faces, r_faces)


@pytest.mark.parametrize("section,key,value", [
    ("update", "rule", "WEIGHTED_AVERAGE"), ("update", "sdf_interp", "NN"),
    ("update", "update_outside", "MAX"), ("update", "use_truncation", True),
    ("update", "sdf_minmax_normalize", False),
    ("extract", "linear_interp", False), ("precision", None, "float64")])
def test_reference_refuses_what_it_does_not_compute(section, key, value):
    cell = small_cell(n=16, views=2, name=CELL)
    cfg = dict(cell.config)
    if key is None:
        cfg[section] = value
    else:
        cfg[section] = dict(cfg[section], **{key: value})
    rig, pool = driver.make_inputs(cell, 3, "cpu")
    with pytest.raises(ValueError):
        cells.load_reference(cfg["reference"]).reconstruct(
            pool[0], *rig, cfg, STAGES)


def test_reference_fold_is_blocked_exactly():
    """Voxels are independent: folding in blocks of planes gives the
    whole grid's fold bit for bit."""
    from reference import naive_carving
    from reference.geometry import axis_centers, world_to_camera

    cell = small_cell(n=24, views=5, name=CELL)
    g = cell.config["grid"]
    (c2w, pp, fl), pool = driver.make_inputs(cell, 5, "cpu")
    images = naive_carving.sdf_images(pool[0])
    cx, cy, cz = (torch.from_numpy(axis_centers(g["bb_min"], g["bb_max"],
                                                g["resolution"], a))
                  for a in range(3))
    w2c = torch.from_numpy(np.stack([world_to_camera(m) for m in c2w]))
    args = (images, w2c, torch.from_numpy(pp), torch.from_numpy(fl),
            cx, cy, cz, 255)
    whole = naive_carving.fold(*args, planes=24)
    blocks = naive_carving.fold(*args, planes=5)
    assert torch.equal(whole[0].view(torch.int32), blocks[0].view(torch.int32))
    assert torch.equal(whole[1], blocks[1])
    assert int(whole[1].max()) > 1


def test_reference_images_are_untruncated_and_normalised():
    from reference import naive_carving

    cell = small_cell(n=16, views=3, name=CELL)
    _, pool = driver.make_inputs(cell, 6, "cpu")
    images = naive_carving.sdf_images(pool[0])
    assert bool((images > -1.0 - 1e-7).all() & (images <= 1.0).all())
    peak = torch.maximum(images.amax(dim=(1, 2)), -images.amin(dim=(1, 2)))
    assert torch.equal(peak, torch.ones(3))
    # at the default band of 0.1 truncation would have dropped these
    assert float(images.min()) < -0.1


def test_exact_bound_at_a_hand_worked_shape():
    # 512^3 voxels x 36 views x 66 operations = 318,901,321,728
    # operations over 67e12 /s = 4.75972 ms; the bytes, 16 per voxel
    # (2,147,483,648) and 36 images of 320 x 240 float32 (11,059,200),
    # take 0.64434 ms
    assert roofline_exact.EXACT_OPS_PER_FUSION == 66
    t, by = roofline_exact.exact_bound_s(512, 512, 512, 36, 240, 320)
    assert by == "operations"
    assert t == pytest.approx(318_901_321_728 / 67e12, rel=1e-12)
    assert t * 1e3 == pytest.approx(4.75972, abs=5e-6)
    # one voxel and one 1000 x 1000 image: 4,000,016 bytes bound it
    t, by = roofline_exact.exact_bound_s(1, 1, 1, 1, 1000, 1000)
    assert by == "bytes"
    assert t == pytest.approx(4_000_016 / roofline.PEAK_BYTES_S, rel=1e-12)


def _x(name, cat, ts, dur, tid=7, correlation=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def _request(k, t0, fold_us):
    """Request ``k`` at ``t0``: a carve with ``vt.sdf2d`` and ``vt.exact``
    (two kernels inside it, ``fold_us`` in all), then an extract."""
    c = 10 * k
    return [
        _x("bench.carve_batch", "user_annotation", t0, 600),
        _x("vt.sdf2d", "user_annotation", t0 + 10, 40),
        _x("cudaLaunchKernel", "cuda_runtime", t0 + 15, 2, correlation=c + 1),
        _x("sdf_kernel", "kernel", t0 + 20, 20, tid=8, correlation=c + 1),
        _x("vt.exact", "user_annotation", t0 + 60, 500),
        _x("cudaLaunchKernel", "cuda_runtime", t0 + 70, 2, correlation=c + 2),
        _x("elementwise", "kernel", t0 + 80, fold_us // 2, tid=8,
           correlation=c + 2),
        _x("cudaLaunchKernel", "cuda_runtime", t0 + 90, 2, correlation=c + 3),
        _x("gather", "kernel", t0 + 80 + fold_us // 2, fold_us // 2, tid=8,
           correlation=c + 3),
        _x("bench.extract_iso_surface", "user_annotation", t0 + 610, 300),
        _x("cudaLaunchKernel", "cuda_runtime", t0 + 620, 2, correlation=c + 4),
        _x("mc_count_kernel", "kernel", t0 + 630, 50, tid=8,
           correlation=c + 4),
    ]


def _trace(tmp_path, folds):
    events = [_x("bench.window", "user_annotation", 0, 1000 * len(folds))]
    for k, fold_us in enumerate(folds):
        events += _request(k, 1000 * k, fold_us)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _run(summary, requests):
    reqs = [driver.Request(k, 1e-3, {"carve_batch": 6e-4}, (10, 20))
            for k in range(requests)]
    return driver.Run(None, 1, dict(nz=64, ny=64, nx=64, views=36,
                                    height=240, width=320), 1.0, 1e-3,
                      reqs, 0, {}, 0, {}, 0, trace=summary)


def test_the_readers_on_a_hand_made_trace(tmp_path):
    """Three requests whose folds take 300, 400 and 420 us on the card:
    the median is 400 us, and the bound at 36 views a request over it is
    the roofline share."""
    read = {n: cells.load_reader("layer_metrics", n) for n in NEW}
    summary = driver.summarize(_trace(tmp_path, [300, 400, 420]),
                               driver.WINDOW_LABEL)
    assert [i.device_s for i in summary.spans["vt.exact"]] == [
        300 * US, 400 * US, 420 * US]
    assert [i.device_s for i in summary.spans["vt.sdf2d"]] == [20 * US] * 3
    run = _run(summary, 3)
    assert read["exact.roofline_pct"](run) is None  # no count of views
    summary.counters = dict(summary.counters,
                            **{exact_views.KEY: 3 * 36})
    assert read["exact.device_ms"](run) == pytest.approx(0.4, rel=1e-12)
    bound, _ = roofline_exact.exact_bound_s(64, 64, 64, 36, 240, 320)
    assert read["exact.roofline_pct"](run) == pytest.approx(
        100 * bound / 400e-6, rel=1e-12)
    # fewer views a request read a smaller bound
    summary.counters[exact_views.KEY] = 3 * 18
    half, _ = roofline_exact.exact_bound_s(64, 64, 64, 18, 240, 320)
    assert read["exact.roofline_pct"](run) == pytest.approx(
        100 * half / 400e-6, rel=1e-12)


@pytest.fixture(scope="module")
def exact_cpu_run():
    """A traced run of the cut-down naive-carving cell on the CPU, with
    the readers' hooks installed for it alone."""
    saved = driver._profiled, driver.summarize
    try:
        exact_views.attach()
        return driver.run(small_cell(name=CELL), 2**31 + 11, 0.3, True,
                          "cpu", time.perf_counter())
    finally:
        driver._profiled, driver.summarize = saved


def test_a_traced_cpu_run_counts_the_views_and_opens_the_spans(
        exact_cpu_run):
    run = exact_cpu_run
    assert run.correct, run.readings
    assert set(run.readings) == {"sdf_images.gap", "state.gap", "mesh.gap"}
    assert run.trace.counters[exact_views.KEY] == 6 * len(run.requests)
    for name in ("vt.exact", "vt.sdf2d"):
        assert len(run.trace.spans[name]) == len(run.requests), name
    assert "vt.warp" not in run.trace.spans


def test_the_readers_find_no_device_work_on_the_cpu(exact_cpu_run):
    """The CPU run has no device time: both readers return None, never
    0."""
    for name in NEW:
        assert cells.load_reader("layer_metrics", name)(
            exact_cpu_run) is None, name


def test_a_program_without_the_span_or_the_counter(monkeypatch):
    """A program whose exact engine opens no ``vt.exact``, and where the
    hook finds no counter to read. It adds no count, the readers return
    None, and nothing raises."""
    from vacancy_tpu_torch.utils import timing

    monkeypatch.setattr("vacancy_tpu_torch.ops.fusion.span",
                        lambda name: timing._NO_SPAN)
    monkeypatch.setattr(exact_views, "views", lambda: None)
    exact_views.attach()
    run = driver.run(small_cell(name=CELL), 2**31 + 12, 0.2, True, "cpu",
                     time.perf_counter())
    assert run.correct, run.readings
    assert exact_views.KEY not in run.trace.counters
    assert "vt.exact" not in run.trace.spans
    summary = run.trace
    summary.busy_s = 1.0  # as if the card had run: still nothing to read
    for name in NEW:
        assert cells.load_reader("layer_metrics", name)(run) is None, name


def test_a_warp_window_adds_no_count():
    """A traced window on the warp engine folds no exact view, and the
    counters stay what ``harness.spans`` gives."""
    exact_views.attach()
    run = driver.run(small_cell(), 2**31 + 13, 0.2, True, "cpu",
                     time.perf_counter())
    assert exact_views.KEY not in run.trace.counters
    assert "mc_active_cubes" in run.trace.counters


def test_the_hull_cell_checks_images_and_state_only():
    run = driver.run(small_cell(name="qvga36-512.hull"), 2**31 + 14, 0.3,
                     False, "cpu", time.perf_counter())
    assert run.correct, run.readings
    assert set(run.readings) == {"sdf_images.gap", "state.gap"}
    assert all(r.mesh_size is None for r in run.requests)
    assert set(run.requests[0].spans) == {"init", "carve_batch"}


def test_the_control_fails_the_exact_cell():
    """The reference with its images and state kept in bfloat16 fails at
    least one of the cell's limits."""
    cell = small_cell(name=CELL)
    rig, pool = driver.make_inputs(cell, 2**31 + 15, "cpu")
    reference = cells.load_reference(cell.config["reference"])
    out = reference.reconstruct(pool[0], *rig, cell.config, STAGES,
                                store=torch.bfloat16)
    out["sdf_images"] = out["sdf_images"].numpy()
    readings = driver.compare(cell.config, [(0, out)], pool, rig)
    assert not all(readings[k] <= v for k, v in cell.limits.items()), \
        readings
