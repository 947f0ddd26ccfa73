"""The port's trace spans (``utils/timing.span``) and kernel B's count of
active cubes (``marching_cubes_fused.cubes``).

A span is a ``vt.<name>`` range in a ``torch.profiler`` trace while a
profiler records, and one shared no-op otherwise. A facade request on
the CPU, ``carve_batch(engine="warp")`` then ``extract_iso_surface()``,
opens each span of the main path once, where its work happens."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vacancy_tpu_torch import VoxelCarver, VoxelCarverOption
from vacancy_tpu_torch.camera import stack_cameras
from vacancy_tpu_torch.ops import mc_fused
from vacancy_tpu_torch.pipeline import turntable_grid, turntable_option
from vacancy_tpu_torch.synthetic import (blob_spheres, render_silhouettes,
                                         turntable_cameras)
from vacancy_tpu_torch.utils import timing
from vacancy_tpu_torch.utils.timing import span

N, VIEWS, W, H = 32, 6, 64, 48
# the spans of a request, in the order they open
SPANS = ("sdf2d", "warp", "image_return", "mc_b", "stream_copy", "assemble",
         "expand_faces")


@pytest.fixture(scope="module")
def scene():
    """(carver, stacked cameras, uint8 silhouettes [V, H, W]) on the CPU:
    a 32^3 grid and six views of 64 x 48."""
    grid = turntable_grid(N)
    carver = VoxelCarver(VoxelCarverOption(
        bb_min=grid.bb_min, bb_max=grid.bb_max, resolution=grid.resolution,
        update_option=turntable_option(True)), device="cpu")
    cams = turntable_cameras(VIEWS, radius=3.2, width=W, height=H)
    masks = render_silhouettes(cams, *blob_spheres(seed=3))
    return carver, stack_cameras(cams), masks


def _request(carver, cams, masks):
    assert carver.init()
    images = carver.carve_batch(cams, masks, engine="warp")
    return images, carver.extract_iso_surface()


@pytest.fixture(scope="module")
def traced(scene):
    """The ``vt.*`` events of one request under a CPU profiler, as
    (name, start, end) in order of their start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, mesh = _request(*scene)
    assert len(mesh.faces) > 0
    return sorted((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name.startswith("vt."))


def _one(traced, name):
    found = [e for e in traced if e[0] == f"vt.{name}"]
    assert len(found) == 1, (name, traced)
    return found[0]


def test_span_is_the_shared_no_op_without_a_profiler():
    assert span("sdf2d") is span("assemble") is timing._NO_SPAN
    with span("sdf2d") as inside:
        assert inside is None


def test_a_span_opened_without_a_profiler_reaches_no_trace():
    """A span entered before the profiler starts stays the no-op, so the
    trace holds the work inside it and no ``vt.*`` event."""
    with span("assemble"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(8).sum()
    names = [e.name for e in prof.events()]
    assert names and not [n for n in names if n.startswith("vt.")]


@pytest.mark.parametrize("name", SPANS)
def test_a_request_opens_each_span_once(traced, name):
    _, lo, hi = _one(traced, name)
    assert lo <= hi


def test_spans_open_in_the_order_of_the_main_path(traced):
    """The carve's spans and the extract's follow one another, apart from
    the face expansion, which nests in the assembly."""
    spans = [_one(traced, name) for name in SPANS[:-1]]
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start, spans


def test_expand_faces_lies_inside_assemble(traced):
    _, a_lo, a_hi = _one(traced, "assemble")
    _, e_lo, e_hi = _one(traced, "expand_faces")
    assert a_lo <= e_lo <= e_hi <= a_hi


def test_cube_counter_grows_by_the_plain_streams_cube_count(scene):
    carver, cams, masks = scene
    _request(carver, cams, masks)
    st, grid = carver.state, carver.grid
    before = mc_fused.marching_cubes_fused.cubes
    streams = mc_fused.marching_cubes_fused(
        st.sdf, st.update_num, *(grid.axis_centers_t(a, "cpu")
                                 for a in range(3)))
    n = len(streams.c_case)
    assert n > 0
    assert mc_fused.marching_cubes_fused.cubes == before + n


def test_a_request_adds_its_cubes_to_the_counter(scene):
    """One extract adds the cubes its faces came from: each active cube
    gives one to five faces."""
    carver, cams, masks = scene
    before = mc_fused.marching_cubes_fused.cubes
    _, mesh = _request(carver, cams, masks)
    cubes = mc_fused.marching_cubes_fused.cubes - before
    assert cubes <= len(mesh.faces) <= 5 * cubes


def _refuse(name):
    raise AssertionError(f"record_function({name!r}) called")


def test_a_request_without_a_profiler_never_calls_record_function(
        scene, monkeypatch):
    """With the profiler call made to raise, a whole request runs: no
    span enters it while no profiler records."""
    monkeypatch.setattr(timing, "record_function", _refuse)
    images, mesh = _request(*scene)
    assert images.shape == (VIEWS, H, W) and len(mesh.faces) > 0


def test_a_recording_profiler_does_enter_record_function(monkeypatch):
    """The other side of the test above: under a profiler the span calls
    the patched name, so that test would have seen a call."""
    monkeypatch.setattr(timing, "record_function", _refuse)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="vt.mc_b"):
            span("mc_b")


def test_the_images_and_the_mesh_are_the_same_with_and_without_spans(
        scene):
    """Tracing changes no result."""
    plain_images, plain_mesh = _request(*scene)
    with profile(activities=[ProfilerActivity.CPU]):
        images, mesh = _request(*scene)
    np.testing.assert_array_equal(images, plain_images)
    np.testing.assert_array_equal(mesh.vertices, plain_mesh.vertices)
    np.testing.assert_array_equal(mesh.faces, plain_mesh.faces)
