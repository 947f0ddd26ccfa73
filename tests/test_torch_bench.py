"""The port's bench entry point (``python -m vacancy_tpu_torch.bench``) vs
the JAX package's ``bench.py``: the same fusion case and sphere states
from the same seeds (bitwise; the sphere TSDF within 4.8e-6, an ulp of
the radius over the 0.05 band), the warm-up probe's wrapper, and the
one-line contract: one parseable JSON line on ``--device cpu`` at a tiny
size, and a null value with an error, exit code 0 and nothing run when
the default device is a card that is not there."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vacancy_tpu_torch import bench as tbench
from vacancy_tpu_torch.io import native
from vacancy_tpu_torch.ops import mc_fused, warp_fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--n", "16", "--views", "2", "--iters", "1", "--mc-n", "12",
        "--mc-n-large", "20"]


@pytest.fixture(scope="module")
def jbench():
    """The JAX package's bench.py, loaded from the repository root."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launches():
    return (warp_fused.warp_fuse_planes.launches,
            mc_fused.marching_cubes_fused.launches,
            tbench.probe_scale.launches)


def test_build_case_equals_jax(jbench):
    tg, ts, *t_rest = tbench.build_case(n=16, n_views=5, h=24, w=32,
                                        device="cpu")
    jg, js, *j_rest = jbench.build_case(n=16, n_views=5, h=24, w=32)
    assert (tg.bb_min, tg.bb_max, tg.resolution) == (jg.bb_min, jg.bb_max,
                                                     jg.resolution)
    assert tg.shape_zyx == jg.shape_zyx == (16, 16, 16)
    for t, j, name in zip(t_rest, j_rest, ("w2c", "pp", "fl", "imgs")):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    np.testing.assert_array_equal(ts.sdf.numpy(), np.asarray(js.sdf))
    np.testing.assert_array_equal(ts.update_num.numpy(),
                                  np.asarray(js.update_num))


@pytest.mark.parametrize("radius", [0.8, 0.04])
def test_sphere_state_matches_jax(jbench, radius):
    tg, ts = tbench._sphere_state(24, radius, device="cpu")
    jg, js = jbench._sphere_state(24, radius)
    assert tg.shape_zyx == jg.shape_zyx
    # one ulp of the radius r ~ 1 in sqrt(r2), over the 0.05 band
    np.testing.assert_allclose(ts.sdf.numpy(), np.asarray(js.sdf), rtol=0,
                               atol=2 * np.spacing(np.float32(1.0)) / 0.05)
    assert ts.sdf.is_contiguous() and int(ts.update_num.min()) == 1
    assert float(ts.sdf.min()) == -1.0 or radius < 0.05
    assert float(ts.sdf.max()) == 1.0


def test_probe_on_the_cpu_is_the_plain_version():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(tbench.PROBE_SHAPE)
    before = tbench.probe_scale.launches
    assert torch.equal(tbench.probe_scale(x), tbench.probe_scale_plain(x))
    assert torch.equal(tbench.probe_scale(x), x * 2.0)
    ok, seconds = tbench.warm_probe("cpu")
    assert ok is True and 0 < seconds < 5
    assert tbench.probe_scale.launches == before  # no kernel on a CPU tensor


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_probe_on_an_absent_card_raises():
    # no quiet run of the plain version in the card's place
    with pytest.raises((RuntimeError, AssertionError)):
        tbench.warm_probe("cuda")


def test_bench_on_the_cpu_prints_one_parseable_line(capsys):
    out = tbench.main(["--device", "cpu", *TINY])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert list(out)[:3] == ["metric", "value", "unit"]
    assert set(out) == {
        "metric", "value", "unit", "probe_s", "device", "power_limit_w",
        "mc_cubes_per_sec_12^3", "mc_extract_warm_s_12^3",
        "mc_device_s_12^3", "native_fast_path", "mc_vertices_12^3",
        "mc_extract_warm_s_20^3", "mc_vertices_20^3",
        "mc_extract_warm_s_20^3_near_empty", "mc_vertices_20^3_near_empty"}
    # the TPU-only keys are not carried over
    assert not {"vs_baseline", "warm_compile_s", "host_link_mb_s",
                "error"} & set(out)
    assert out["metric"] == "voxel_view_fusions_per_sec_per_chip_16^3"
    assert out["unit"] == "fusions/s" and out["value"] > 0
    assert out["device"] == "cpu" and out["power_limit_w"] is None
    assert out["native_fast_path"] is native.available() is True
    assert out["mc_vertices_12^3"] > 0 and out["mc_vertices_20^3"] > 0
    assert out["mc_cubes_per_sec_12^3"] > 0


def test_bench_without_a_card_prints_the_null_line_and_runs_nothing(
        capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(tbench, "run_bench",
                        lambda *a, **k: ran.append("bench"))
    monkeypatch.setattr(tbench, "warm_probe",
                        lambda *a, **k: ran.append("probe"))
    before = _launches()
    out = tbench.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert out["value"] is None and "no CUDA device" in out["error"]
    assert out["metric"] == "voxel_view_fusions_per_sec_per_chip_512^3"
    assert ran == [] and _launches() == before


@pytest.mark.parametrize("fault", ["raises", "wrong-sum"])
def test_a_failed_probe_yields_the_null_line(capsys, monkeypatch, fault):
    def probe(device):
        if fault == "raises":
            raise RuntimeError("nvcc failed: " + "x" * 500 + " the tail")
        return False, 0.25

    monkeypatch.setattr(tbench, "warm_probe", probe)
    monkeypatch.setattr(tbench, "run_bench", lambda *a, **k: 1 / 0)
    out = tbench.main(["--device", "cpu", *TINY])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert out["value"] is None
    if fault == "raises":
        assert out["error"].startswith("warm-up probe failed")
        assert out["error"].endswith("the tail") and len(out["error"]) < 340
    else:
        assert "wrong sum" in out["error"] and out["probe_s"] == 0.25


def test_bench_module_runs_as_a_program_and_exits_0():
    """``python -m vacancy_tpu_torch.bench`` in a process of its own: one
    line on stdout and exit code 0, also where there is no card."""
    proc = subprocess.run(
        [sys.executable, "-m", "vacancy_tpu_torch.bench"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-500:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    if torch.cuda.is_available():
        assert out["value"] > 0
    else:
        assert out["value"] is None and "error" in out


def test_run_bench_and_mc_benches_at_a_tiny_size():
    rate, dt = tbench.run_bench(n=12, n_views=2, iters=2, device="cpu")
    assert rate == pytest.approx(12 ** 3 * 2 / dt) and dt > 0
    cubes_s, best, verts = tbench.run_mc_bench(n=12, iters=1, device="cpu")
    assert cubes_s == pytest.approx(11 ** 3 / best) and verts > 0
    assert tbench.run_mc_device_bench(n=12, iters=1, device="cpu") > 0
    assert tbench.power_limit_w(torch.device("cpu")) is None
