"""On the card: a traced run of a cut-down cell drives kernels A and B,
reads every per-layer metric, and comes out correct; the memory peak
counts the program's one state while the check keeps others. Skips
without a CUDA device (decided inside each test)."""

import gc
import time

import pytest

from harness import cells, driver, program
from bench_small import small_cell


@pytest.mark.cuda
def test_traced_run_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = small_cell(n=128, views=8, width=320, height=240)
    run = driver.run(cell, 2**31 + 99, 1.0, True, "cuda:0",
                     time.perf_counter())
    assert run.correct, run.readings
    assert run.launches["warp_fuse_planes"] == 1
    assert run.launches["marching_cubes_fused"] == 1
    assert run.launches["interp_rows"] == 0
    assert run.launches["sdf2d_fused"] == 3
    assert run.launches["assemble_on_card"] == 1
    assert run.launches["exact_fold"] == 0
    assert 0 < run.trace.busy_s < run.trace.window_s
    assert 0 < run.memory_peak_bytes < run.process_peak_bytes
    for name in ("carve.p50_ms", "extract.p50_ms", "warp_a.roofline_pct",
                 "mc_b.roofline_pct", "device.idle_pct"):
        value = cells.load_reader("layer_metrics", name)(run)
        assert value is not None and value > 0, name
        if name.endswith("_pct"):
            assert value <= 100, (name, value)


@pytest.mark.cuda
def test_the_peak_is_one_states_when_every_request_is_sampled():
    """The check keeps the state of every request of the window, and the
    reading is still the peak of a request on a carver that keeps no
    other state, not one state more (each ``init`` after a sampled
    request lets go of a kept state)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, seed, device = 128, 2**31 + 101, torch.device("cuda:0")
    cell = small_cell(n=n, views=8, width=320, height=240)
    cell.traffic = dict(cell.traffic, check_requests=10**4)

    (c2w, pp, fl), pool = driver.make_inputs(cell, seed, device)
    carver = program.carver(cell.config, device)
    cams = program.cameras(c2w, pp, fl, 320, 240, device)
    request = driver.Facade(carver, cell, {"cameras": cams}, device)
    for masks in pool * 2:
        request(masks)
    request.peak = 0
    for masks in pool:
        request(masks)
    own = request.peak
    del carver, cams, request, pool
    gc.collect()
    torch.cuda.empty_cache()

    run = driver.run(cell, seed, 0.3, False, "cuda:0", time.perf_counter())
    state = n ** 3 * 8
    assert run.correct, run.readings
    assert 3 <= len(run.requests) <= 10**4  # every request sampled
    assert abs(run.memory_peak_bytes - own) < state // 4, (
        run.memory_peak_bytes, own)
    assert run.process_peak_bytes >= own + state
