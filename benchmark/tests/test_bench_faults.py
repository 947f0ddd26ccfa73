"""A run whose timed path is broken underneath comes out not correct,
and so does the control; a sound run comes out correct. Each drives a
whole run of a small cell on the CPU, skipping only the look for a
card."""

import time

import pytest
import torch

import control
from harness import driver
from bench_small import small_cell


def _run(seed=2**32 + 3):
    return driver.run(small_cell(), seed, 0.3, False, "cpu",
                      time.perf_counter())


def test_sound_run_is_correct():
    run = _run()
    assert run.correct, run.readings
    assert run.readings == {"sdf_images.gap": 0.0, "state.gap": 0.0,
                            "mesh.gap": 0.0}
    assert len(run.requests) >= 3


def _state_unchanged(state, *args, **kwargs):
    return state


def _half_the_views(real):
    def carve(state, grid, w2c, pp, fl, images, **kwargs):
        half = w2c.shape[0] // 2
        return real(state, grid, w2c[:half], pp[:half], fl[:half],
                    images[:half], **kwargs)
    return carve


def _vertex_moved(real):
    def extract(*args, **kwargs):
        mesh = real(*args, **kwargs)
        mesh.vertices = mesh.vertices.copy()
        mesh.vertices[len(mesh.vertices) // 2, 0] += 1e-3
        return mesh
    return extract


def _pixel_altered(real):
    def sdf(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[0, 0, 0] += 0.01  # a background pixel, 1 before
        return out
    return sdf


@pytest.mark.parametrize("fault,target", [
    ("state unchanged", "carve_views_warp"),
    ("half the views, the mean over the rest", "carve_views_warp"),
    ("a mesh vertex altered where produced", "extract_mesh"),
    ("an SDF image pixel altered where produced",
     "make_signed_distance_field"),
])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, target):
    import vacancy_tpu_torch.carver as facade

    real = getattr(facade, target)
    patched = {
        "state unchanged": _state_unchanged,
        "half the views, the mean over the rest": _half_the_views(real),
        "a mesh vertex altered where produced": _vertex_moved(real),
        "an SDF image pixel altered where produced": _pixel_altered(real),
    }[fault]
    monkeypatch.setattr(facade, target, patched)
    run = _run()
    assert not run.correct, (fault, run.readings)
    assert any(run.readings[k] > v for k, v in run.cell.limits.items())


def test_control_is_not_correct():
    """The reference with its images and state kept in bfloat16, put in
    the program's place, fails the checks."""
    for seed in (1, 2**40 + 7, 99):
        readings, passed = control.control_readings(small_cell(), seed,
                                                    "cpu")
        assert not passed, readings
        assert readings["sdf_images.gap"] > 1e-3
        assert readings["state.gap"] > 1e-3


def test_control_keeps_the_sentinel():
    from reference.geometry import INVALID_SDF, rounded

    x = torch.tensor([INVALID_SDF, 0.1, -0.3])
    y = rounded(x, torch.bfloat16)
    assert y[0] == INVALID_SDF
    assert y[1] != x[1] and abs(float(y[1] - x[1])) < 1e-3
