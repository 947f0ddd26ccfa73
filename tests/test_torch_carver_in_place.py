"""The facade holds one dense state: ``VoxelCarver.init`` lets go of the
state it held before it allocates the next, a warp carve that kernel A
takes on the card writes over the carver's own state, bit for bit what
the out-of-place fold gives, and a state handed over through ``restore``
or the ``state`` setter is copied once and never written. The two-pass
engine, the exact engine, CPU states and sharded states return new
tensors.

Imports no JAX, so that the ``cuda`` cases run on the card:
``python -m pytest --noconftest tests/test_torch_carver_in_place.py -m
cuda``."""

import weakref

import numpy as np
import pytest
import torch

from vacancy_tpu_torch import VoxelCarver, VoxelCarverOption
from vacancy_tpu_torch import parallel as tpar
from vacancy_tpu_torch.camera import OrthoCamera, stack_cameras
from vacancy_tpu_torch.config import SdfInterpolation, VoxelUpdateOption
from vacancy_tpu_torch.grid import ShardedGridState, VoxelGridState
from vacancy_tpu_torch.ops import fusion_warp, warp_fused
from vacancy_tpu_torch.pipeline import facade_inputs

N, VIEWS, W, H = 16, 3, 64, 48


def _pinhole(n=N, views=VIEWS, width=W, height=H, device="cpu"):
    """(option, cameras, uint8 masks [V, H, W]) of the turntable."""
    return facade_inputs(n, views, width, height, device)


def _ortho(device="cpu"):
    """(option, cameras, uint8 masks [V, 36, 40]): three orthographic
    views, turned about y, of a 16^3 grid of 2-unit voxels."""
    res, w, h = 2.0, 40, 36
    opt = VoxelCarverOption(bb_min=(0.0,) * 3, bb_max=((N + 0.4) * res,) * 3,
                            resolution=res,
                            update_option=VoxelUpdateOption())
    cams = []
    for angle in (0.0, 0.2, -0.25):
        c, s = np.cos(angle), np.sin(angle)
        w2c = np.array([[c, 0, s, 4.0], [0, 1, 0, 2.0], [-s, 0, c, 100.0],
                        [0, 0, 0, 1]])
        cams.append(OrthoCamera.create(w, h, np.linalg.inv(w2c),
                                       device=device))
    vv, uu = np.mgrid[0:h, 0:w]
    ellipse = ((uu - 20) / 12.0) ** 2 + ((vv - 18) / 14.0) ** 2 < 1
    masks = np.repeat((ellipse * 255).astype(np.uint8)[None], len(cams), 0)
    return opt, cams, masks


SCENES = {"pinhole": _pinhole, "ortho": _ortho}


def _ptrs(state):
    return state.sdf.data_ptr(), state.update_num.data_ptr()


def _bitwise_equal(a, b):
    return (torch.equal(a.update_num, b.update_num)
            and torch.equal(a.sdf.view(torch.int32), b.sdf.view(torch.int32)))


def _out_of_place(carver, cams, images):
    """The out-of-place warp fold of the SDF images ``images`` [V, H, W]
    (numpy) into a fresh state, view by view as ``carve`` folds them
    when ``cams`` is a list, in one call when it is stacked."""
    dev = carver.device
    opt = carver.option.update_option
    linear = opt.sdf_interp == SdfInterpolation.BILINEAR
    state = VoxelGridState.create(carver.grid, dev)
    batches = ([(stack_cameras([c]), images[i:i + 1])
                for i, c in enumerate(cams)] if isinstance(cams, list)
               else [(cams, images)])
    for cam, imgs in batches:
        imgs = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
        before = _ptrs(state)
        if isinstance(cam, OrthoCamera):
            state = fusion_warp.carve_views_warp_ortho(
                state, carver.grid, cam.w2c.to(dev), imgs, opt=opt,
                linear=linear)
        else:
            state = fusion_warp.carve_views_warp(
                state, carver.grid, cam.w2c.to(dev),
                cam.principal_point.to(dev), cam.focal_length.to(dev), imgs,
                opt=opt, linear=linear)
        assert _ptrs(state) != before  # new tensors
    return state


def _carve_and_fold(scene, call, device):
    """(carver, the state's tensors after ``init``, the out-of-place fold
    of the same SDF images) after ``call`` over the scene's views."""
    opt, cams, masks = SCENES[scene](device=device)
    carver = VoxelCarver(opt, device)
    assert carver.init()
    held = carver.state  # so that no new tensor can take its addresses
    if call == "carve":
        images = np.stack([carver.carve(c, silhouette=m, engine="warp")
                           for c, m in zip(cams, masks)])
        ref = _out_of_place(carver, cams, images)
    else:
        images = carver.carve_batch(cams, masks, engine="warp")
        ref = _out_of_place(carver, stack_cameras(cams), images)
    assert int((ref.update_num > 0).sum()) > 0
    return carver, held, ref


@pytest.mark.parametrize("call", ["carve", "carve_batch"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_the_warp_carve_writes_over_the_carvers_state(scene, call,
                                                      monkeypatch):
    """The facade asks the warp engine to write over its state; on CPU
    tensors the plain fold returns new tensors, bit for bit the
    out-of-place fold (the card's addresses: the ``cuda`` case below)."""
    asked = []
    centers = fusion_warp.warp_carve_centers

    def spy(*args, **kwargs):
        asked.append(kwargs.get("in_place", False))
        return centers(*args, **kwargs)

    monkeypatch.setattr(fusion_warp, "warp_carve_centers", spy)
    carver, held, ref = _carve_and_fold(scene, call, "cpu")
    calls = len(SCENES[scene]()[1]) if call == "carve" else 1
    assert asked[:calls] == [True] * calls  # then the out-of-place folds
    assert _ptrs(carver.state) != _ptrs(held)
    assert _bitwise_equal(carver.state, ref)


def test_init_lets_go_of_the_old_state_before_it_allocates(monkeypatch):
    opt, _, _ = _pinhole()
    carver = VoxelCarver(opt, "cpu")
    assert carver.init()
    old = weakref.ref(carver.state.sdf)
    create = VoxelGridState.create
    alive_at_create = []

    def watched(*args, **kwargs):
        alive_at_create.append(old() is not None)
        return create(*args, **kwargs)

    monkeypatch.setattr(VoxelGridState, "create", staticmethod(watched))
    assert carver.init()
    assert alive_at_create == [False]
    assert old() is None


@pytest.mark.parametrize("how", ["restore", "setter"])
def test_a_state_handed_over_is_copied_and_not_written(how):
    opt, cams, masks = _pinhole()
    carver = VoxelCarver(opt, "cpu")
    assert carver.init()
    carver.carve_batch(cams[:1], masks[:1], engine="warp")
    given = carver.state
    kept = VoxelGridState(sdf=given.sdf.clone(),
                          update_num=given.update_num.clone())
    other = VoxelCarver(opt, "cpu")
    if how == "restore":
        other.restore(given, carver.grid)
    else:
        assert other.init()
        other.state = given
    assert _ptrs(other.state) != _ptrs(given)
    assert _bitwise_equal(other.state, kept)
    other.carve_batch(cams[1:], masks[1:], engine="warp")
    assert _bitwise_equal(given, kept)
    carver.carve_batch(cams[1:], masks[1:], engine="warp")
    assert _bitwise_equal(other.state, carver.state)


@pytest.mark.parametrize("route", ["two_pass", "exact", "sharded"])
def test_the_other_routes_return_new_tensors(route, monkeypatch):
    opt, cams, masks = _pinhole()
    carver = VoxelCarver(opt, "cpu")
    if route == "sharded":
        assert carver.init(sharding=tpar.grid_sharding(
            tpar.make_device_mesh(shape=(2,), devices=["cpu"] * 2)))
        held = dict(carver.state.blocks)
        carver.carve_batch(cams, masks, engine="warp")
        assert isinstance(carver.state, ShardedGridState)
        assert all(_ptrs(carver.state.blocks[b]) != _ptrs(st)
                   for b, st in held.items())
        return
    if route == "two_pass":  # as for a plan that kernel A refuses
        monkeypatch.setattr(fusion_warp, "_fused_kernel_takes",
                            lambda *args: False)
    assert carver.init()
    held = carver.state
    carver.carve_batch(cams, masks,
                       engine="exact" if route == "exact" else "warp")
    assert _ptrs(carver.state) != _ptrs(held)
    assert int((carver.state.update_num > 0).sum()) > 0


def _needs_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["carve", "carve_batch"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_the_warp_carve_writes_over_the_carvers_state_on_the_card(scene,
                                                                  call):
    """Kernel A once a carve call, over the state's own tensors, bit for
    bit the out-of-place launch."""
    _needs_the_card()
    fn = warp_fused.warp_fuse_planes
    before = (fn.launches, fn.in_place)
    carver, held, ref = _carve_and_fold(scene, call, torch.device("cuda"))
    torch.cuda.synchronize()
    calls = len(SCENES[scene]()[1]) if call == "carve" else 1
    # the carver's launches in place, the reference's out of place
    assert (fn.launches - before[0], fn.in_place - before[1]) == (
        2 * calls, calls)
    assert _ptrs(carver.state) == _ptrs(held)
    assert _bitwise_equal(carver.state, ref)


@pytest.mark.cuda
def test_the_facade_folds_in_place_on_the_card():
    """128^3 and 100 views of 320 x 240: kernel A once a carve, in place,
    bit for bit the out-of-place launch; init() twice holds one state."""
    _needs_the_card()
    dev = torch.device("cuda")
    opt, cams, masks = _pinhole(128, 100, 320, 240, dev)
    carver = VoxelCarver(opt, dev)
    assert carver.init()
    torch.cuda.synchronize()
    one_state = torch.cuda.memory_allocated(dev)
    assert carver.init()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == one_state
    held = carver.state
    ptrs = _ptrs(held)
    fn = warp_fused.warp_fuse_planes
    before = (fn.launches, fn.in_place)
    images = carver.carve_batch(cams, masks, engine="warp")
    torch.cuda.synchronize()
    assert (fn.launches, fn.in_place) == (before[0] + 1, before[1] + 1)
    assert _ptrs(carver.state) == ptrs
    ref = _out_of_place(carver, stack_cameras(cams), images)
    torch.cuda.synchronize()
    assert (fn.launches, fn.in_place) == (before[0] + 2, before[1] + 1)
    assert int((ref.update_num > 0).sum()) > 0
    assert _bitwise_equal(carver.state, ref)
    for cam, mask in zip(cams[:2], masks[:2]):
        carver.carve(cam, silhouette=mask, engine="warp")
    torch.cuda.synchronize()
    assert (fn.launches, fn.in_place) == (before[0] + 4, before[1] + 3)
    assert _ptrs(carver.state) == ptrs


@pytest.mark.cuda
@pytest.mark.parametrize("n, views, limit", [(512, 36, 1.4e9),
                                             (1024, 100, 9.3e9)])
def test_a_request_peaks_at_one_state_on_the_card(n, views, limit):
    """The qvga cell's 512^3 x 36 views and the sweep's 1024^3 x 100
    views of 320 x 240: the device's peak over ``init``, ``carve_batch``
    and ``extract_iso_surface``, less what was allocated before, stays
    within one state (8 B a voxel) plus the images, kernel B's streams
    and the mesh, below the two states the carver held before it wrote
    over its own."""
    _needs_the_card()
    dev = torch.device("cuda")
    opt, cams, masks = _pinhole(n, views, 320, 240, dev)
    carver = VoxelCarver(opt, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):  # the second init and request find a state held
        assert carver.init()
        carver.carve_batch(cams, masks, engine="warp")
        mesh = carver.extract_iso_surface()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    state = 8 * n ** 3
    assert len(mesh.faces) > 0
    assert state < peak <= limit < 2 * state, (peak, state)
