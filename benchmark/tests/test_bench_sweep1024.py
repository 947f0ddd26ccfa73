"""The cell ``sweep1024-v100.frames`` (BASELINE config 5 on one card):
the configuration's grid is the 1024^3 grid, and the cell cut to a CPU
size, and on the card to 128^3, comes out correct with every gap 0."""

import time

import pytest

from harness import cells, driver, spans
from bench_small import small_cell

CELL = "sweep1024-v100.frames"


def test_the_configuration_is_the_1024_grid_of_the_sweep():
    from vacancy_tpu_torch.grid import GridSpec
    from vacancy_tpu_torch.pipeline import turntable_grid

    cell = cells.load_cell(CELL)
    g = cell.config["grid"]
    grid = GridSpec(bb_min=tuple(g["bb_min"]), bb_max=tuple(g["bb_max"]),
                    resolution=g["resolution"])
    assert grid.shape_zyx == (1024, 1024, 1024)
    assert grid == turntable_grid(1024)
    assert cell.config["rig"]["views"] == 100
    assert cell.config["reduced"] == []
    assert cell.chips == 1


def test_the_cut_down_cell_is_correct_on_the_cpu():
    run = driver.run(small_cell(name=CELL, views=100), 2**33 + 19, 0.3,
                     False, "cpu", time.perf_counter())
    assert run.correct, run.readings
    assert run.readings == {"sdf_images.gap": 0.0, "state.gap": 0.0,
                            "mesh.gap": 0.0}
    assert run.shape["views"] == 100


@pytest.mark.cuda
def test_the_cut_down_cell_on_the_card():
    """128^3 and 100 views of 320 x 240, traced: correct, every gap 0,
    kernel A once a request and in place, and the span readers of the
    cell's metrics read numbers."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vacancy_tpu_torch.ops import warp_fused

    spans.attach()
    fn = warp_fused.warp_fuse_planes
    before = (fn.launches, fn.in_place)
    cell = small_cell(n=128, views=100, width=320, height=240, name=CELL)
    run = driver.run(cell, 2**31 + 119, 1.0, True, "cuda:0",
                     time.perf_counter())
    assert run.correct, run.readings
    assert set(run.readings.values()) == {0.0}
    requests = len(run.requests) + int(cell.traffic["warm_requests"])
    assert (fn.launches - before[0], fn.in_place - before[1]) == (
        requests, requests)
    for name in ("warp_a.roofline_pct", "sdf2d.device_ms"):
        value = cells.load_reader("layer_metrics", name)(run)
        assert value is not None and value > 0, name
