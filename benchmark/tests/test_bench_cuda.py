"""On the card: a traced run of a cut-down cell drives kernels A and B,
reads every per-layer metric, and comes out correct. Skips without a
CUDA device (decided inside the test)."""

import time

import pytest

from harness import cells, driver
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
    assert 0 < run.trace.busy_s < run.trace.window_s
    assert 0 < run.memory_peak_bytes < run.process_peak_bytes
    for name in ("carve.p50_ms", "extract.p50_ms", "warp_a.roofline_pct",
                 "mc_b.roofline_pct", "device.idle_pct"):
        value = cells.load_reader("layer_metrics", name)(run)
        assert value is not None and value > 0, name
        if name.endswith("_pct"):
            assert value <= 100, (name, value)
