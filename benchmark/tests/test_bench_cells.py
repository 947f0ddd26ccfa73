"""The harness takes a cell as data, and BENCHMARK.json keeps to the
benchmark's naming rules."""

import json
import re
import shutil
from pathlib import Path

import pytest

from harness import cells, driver
from bench_small import small_cell

BENCH = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _benchmark():
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    """A workload file and a per-layer metric file that name an existing
    configuration and traffic mix are found by their names, with no
    other file edited."""
    for d in ("configs", "traffic", "layer_metrics"):
        shutil.copytree(BENCH / d, tmp_path / d)
    (tmp_path / "workloads").mkdir()
    (tmp_path / "workloads" / "qvga36-512.again.json").write_text(
        json.dumps({"name": "qvga36-512.again", "config": "qvga36-512",
                    "traffic": "frames", "chips": 1, "why": "a test",
                    "limits": {"mesh.gap": 0.5}}))
    (tmp_path / "layer_metrics" / "requests.count.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    cell = cells.load_cell("qvga36-512.again", root=tmp_path)
    assert cell.config["name"] == "qvga36-512"
    assert [s["call"] for s in cell.traffic["request"]] == [
        "init", "carve_batch", "extract_iso_surface"]
    assert cell.limits == {"mesh.gap": 0.5}
    read = cells.load_reader("layer_metrics", "requests.count",
                             root=tmp_path)

    class Run:
        requests = [1, 2, 3]

    assert read(Run()) == 3.0
    bench = {"end_to_end": [], "per_layer": [
        {"name": "requests.count", "workloads": ["qvga36-512.again"]},
        {"name": "everywhere"}, {"name": "elsewhere", "workloads": ["x"]}]}
    assert set(cells.metrics_of("qvga36-512.again", "per_layer",
                                bench)) == {"requests.count", "everywhere"}


def _new_mix(tmp_path, mix: dict, limits: dict) -> str:
    """A copy of the benchmark's data under ``tmp_path`` with one more
    traffic file and a cell on it; nothing that was there is edited."""
    for d in ("configs", "traffic", "workloads"):
        shutil.copytree(BENCH / d, tmp_path / d)
    base = json.loads((BENCH / "traffic" / "frames.json").read_text())
    name = "qvga36-512." + mix["name"]
    (tmp_path / "traffic" / f"{mix['name']}.json").write_text(
        json.dumps(dict(base, **mix)))
    (tmp_path / "workloads" / f"{name}.json").write_text(json.dumps(
        {"name": name, "config": "qvga36-512", "traffic": mix["name"],
         "chips": 1, "why": "a test", "limits": limits}))
    return name


def test_a_new_mix_of_facade_calls_is_data(tmp_path):
    """A mix whose requests stop at the carve (the visual hull kept on
    the device) runs from a new traffic file alone: its spans, its check
    of the images and the state, and no mesh."""
    import time

    name = _new_mix(tmp_path, {"name": "hull", "request": [
        {"call": "init"},
        {"call": "carve_batch", "inputs": ["cameras", "masks"],
         "options": {"engine": "warp"}, "returns": "sdf_images"}]},
        {"sdf_images.gap": 1e-4, "state.gap": 1e-3})
    run = driver.run(small_cell(name=name, root=tmp_path), 2**33 + 1, 0.3,
                     False, "cpu", time.perf_counter())
    assert run.correct, run.readings
    assert set(run.readings) == {"sdf_images.gap", "state.gap"}
    assert all(r.mesh_size is None for r in run.requests)
    assert set(run.requests[0].spans) == {"init", "carve_batch"}
    assert cells.load_reader("layer_metrics", "carve.p50_ms")(run) > 0
    for metric in ("extract.p50_ms", "mc_b.roofline_pct"):
        assert cells.load_reader("layer_metrics", metric)(run) is None


def test_a_new_object_mix_is_data(tmp_path):
    """A mix of one small sphere a frame (few surface voxels) runs from a
    new traffic file alone, and its meshes are smaller."""
    import time

    name = _new_mix(tmp_path, {"name": "small", "object": {
        "spheres": 1, "center_range": [-0.05, 0.05],
        "radius_range": [0.3, 0.3], "shift_range": [-0.01, 0.01]}},
        {"sdf_images.gap": 1e-4, "state.gap": 1e-3, "mesh.gap": 1e-2})
    cell = small_cell(name=name, root=tmp_path)
    run = driver.run(cell, 2**33 + 2, 0.3, False, "cpu", time.perf_counter())
    assert run.correct, run.readings
    base = driver.run(small_cell(), 2**33 + 2, 0.3, False, "cpu",
                      time.perf_counter())
    assert max(r.mesh_size[1] for r in run.requests) < min(
        r.mesh_size[1] for r in base.requests)


def test_loader_refuses_a_path_for_a_name():
    with pytest.raises(ValueError):
        cells.load_cell("../run")


def test_every_cell_loads_and_has_its_readers():
    b = _benchmark()
    for w in b["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cell.chips == w["chips"]
        on_disk = json.loads((BENCH / "workloads" /
                              f"{w['name']}.json").read_text())
        assert {k: on_disk[k] for k in w} == w
        assert cell.config["name"] == w["config"]
        conf = next(c for c in b["configs"] if c["name"] == w["config"])
        assert json.loads((BENCH.parent / conf["file"]).read_text()) == \
            cell.config
        for section, kind in (("end_to_end", "end_to_end"),
                              ("per_layer", "layer_metrics")):
            for m in cells.metrics_of(w["name"], section, b):
                assert callable(cells.load_reader(kind, m))


def test_names_and_units():
    b = _benchmark()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    names += [w["config"] for w in b["workloads"]]
    names += [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for section in ("end_to_end", "per_layer", "workloads", "configs"):
        own = [e["name"] for e in b[section]]
        assert len(own) == len(set(own)), section
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    b = _benchmark()
    cell_names = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cell_names):
            assert cell in e2e[m["moves"]].get("workloads", cell_names), \
                (m["name"], cell)
    for cell in cell_names:
        assert "setup_s" in cells.metrics_of(cell, "end_to_end", b)
        assert len(cells.metrics_of(cell, "end_to_end", b)) >= 2
        assert cells.metrics_of(cell, "per_layer", b)


def test_readers_on_a_small_cpu_run(tiny_run):
    """Every end-to-end reader reads a CPU run; the device readers find
    nothing to read there and return None, never 0."""
    run = tiny_run
    b = _benchmark()
    for m in b["end_to_end"]:
        value = cells.load_reader("end_to_end", m["name"])(run)
        assert value is not None and value > 0, m["name"]
    for name in ("carve.p50_ms", "extract.p50_ms"):
        assert cells.load_reader("layer_metrics", name)(run) > 0
    for name in ("warp_a.roofline_pct", "mc_b.roofline_pct",
                 "device.idle_pct"):
        assert cells.load_reader("layer_metrics", name)(run) is None


@pytest.fixture(scope="module")
def tiny_run():
    import time

    return driver.run(small_cell(), 17, 0.3, False, "cpu",
                      time.perf_counter())
