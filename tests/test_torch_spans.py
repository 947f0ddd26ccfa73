"""The port's trace spans (``utils/timing.span``) and kernel B's count of
active cubes (``marching_cubes_fused.cubes``).

A span is a ``vt.<name>`` range in a ``torch.profiler`` trace while a
profiler records, and one shared no-op otherwise. A facade request on
the CPU, ``carve_batch(engine="warp")`` then ``extract_iso_surface()``,
opens each span of the main path once, where its work happens. The
exact engine, the facade's default, opens ``vt.exact`` around its fold
and counts the views it folds (``carve_views.views``)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vacancy_tpu_torch import VoxelCarver, VoxelCarverOption
from vacancy_tpu_torch.camera import stack_cameras
from vacancy_tpu_torch.grid import VoxelGridState
from vacancy_tpu_torch.ops import fusion, mc_fused
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


@pytest.fixture(scope="module")
def naive(scene):
    """(a carver at the facade's defaults, which fold by the kMax rule
    with no truncation, one camera, the stacked cameras, silhouettes) on
    the CPU."""
    _, cams, masks = scene
    grid = turntable_grid(N)
    return (VoxelCarver(VoxelCarverOption(
        bb_min=grid.bb_min, bb_max=grid.bb_max, resolution=grid.resolution),
        device="cpu"),
        turntable_cameras(VIEWS, radius=3.2, width=W, height=H)[0], cams,
        masks)


def _spans_of(run):
    """The ``vt.*`` names that ``run()`` opens under a CPU profiler, in
    order of their start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return [name for _, name in sorted(
        (e.time_range.start, e.name) for e in prof.events()
        if e.name.startswith("vt."))]


def test_an_exact_carve_batch_opens_sdf2d_then_exact_once(naive):
    carver, _, cams, masks = naive
    assert carver.init()
    assert _spans_of(lambda: carver.carve_batch(cams, masks)) == [
        "vt.sdf2d", "vt.exact", "vt.image_return"]


def test_an_exact_carve_opens_exact_once(naive):
    carver, cam, _, masks = naive
    assert carver.init()
    assert _spans_of(lambda: carver.carve(cam, silhouette=masks[0])) == [
        "vt.sdf2d", "vt.exact"]
    image = carver.carve(cam, silhouette=masks[1])
    assert _spans_of(lambda: carver.carve(cam, sdf=image)) == ["vt.exact"]


def test_the_view_counter_grows_by_the_views_exact_folds(naive):
    carver, cam, cams, masks = naive
    assert carver.init()
    before = fusion.carve_views.views
    carver.carve_batch(cams, masks)
    assert fusion.carve_views.views == before + VIEWS
    carver.carve(cam, silhouette=masks[0])
    assert fusion.carve_views.views == before + VIEWS + 1
    carver.carve_batch(cams, masks, engine="warp")
    assert fusion.carve_views.views == before + VIEWS + 1


def _exact(carver, cams, masks):
    assert carver.init()
    images = carver.carve_batch(cams, masks)
    return images, carver.state.sdf.clone(), carver.state.update_num.clone()


def test_the_exact_state_is_the_same_with_and_without_a_profiler(naive):
    carver, _, cams, masks = naive
    plain = _exact(carver, cams, masks)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _exact(carver, cams, masks)
    np.testing.assert_array_equal(traced[0], plain[0])
    assert torch.equal(traced[1].view(torch.int32), plain[1].view(torch.int32))
    assert torch.equal(traced[2], plain[2])
    assert int(plain[2].max()) > 1


@pytest.mark.parametrize("tsdf", [False, True])
def test_the_facades_exact_path_is_carve_masks(naive, tsdf):
    """The facade takes its images from its own 2D SDF step and folds them
    with ``carve_views``: images and state are bit for bit those of the
    library's one-call ``carve_masks``."""
    _, _, cams, masks = naive
    grid = turntable_grid(N)
    opt = turntable_option(True) if tsdf else VoxelCarverOption().update_option
    carver = VoxelCarver(VoxelCarverOption(
        bb_min=grid.bb_min, bb_max=grid.bb_max, resolution=grid.resolution,
        update_option=opt), device="cpu")
    images, sdf, un = _exact(carver, cams, masks)
    state, want = fusion.carve_masks(
        VoxelGridState.create(carver.grid, "cpu"), carver.grid, cams, masks,
        opt=opt)
    np.testing.assert_array_equal(images, want.numpy())
    assert torch.equal(sdf.view(torch.int32), state.sdf.view(torch.int32))
    assert torch.equal(un, state.update_num)
