"""Rig layouts: every configuration of the benchmark keeps the inputs it
had before layouts could be chosen, the hemisphere's geometry holds, a
hemisphere copy of a cell runs and comes out correct on the CPU, and the
loader refuses a layout or a band it cannot lay out."""

import hashlib
import json
import math
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import cells, driver, scene
from bench_small import small_cell

BENCH = Path(__file__).resolve().parents[1]
SEED = 2**31 + 7

# sha256 of the rig (c2w, principal point, focal length) that
# ``driver.make_inputs`` gives each cell at its full size, and of the rig
# and the pool's masks of ``small_cell`` at ``SEED``, taken when every
# configuration was a ring
FULL = {
    "qvga36-512.frames":
        "8cbe330c40794b36045d2339a601cdb790ad3764b5ec80aea138fa49e31a4615",
    "uhd36-512.frames":
        "5c98b33fce9ce7d2ea478ebd4b2eb0fa4a6d53373afe6a5a820e681675d552c4",
    "carving36-512.exact":
        "8cbe330c40794b36045d2339a601cdb790ad3764b5ec80aea138fa49e31a4615",
    "qvga36-512.hull":
        "8cbe330c40794b36045d2339a601cdb790ad3764b5ec80aea138fa49e31a4615",
    "sweep1024-v100.frames":
        "a88fbd0d767391b1ae90d47c691cb29388486915a3404b8e9c3573f622beaf49",
}
SMALL = "8b247b3bc98eb842bdf7ae799afada94a88210f15c8c8f0389dafea377e5e2fa"


def _digest(rig, pool=()) -> str:
    h = hashlib.sha256()
    for a in rig:
        h.update(np.ascontiguousarray(a).tobytes())
    for masks in pool:
        h.update(masks.cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(FULL))
def test_a_ring_cell_keeps_its_full_size_rig(name, monkeypatch):
    """The rig that ``make_inputs`` lays out at the cell's own size (the
    masks' rendering left out) is the one it laid out before."""
    monkeypatch.setattr(scene, "render_masks",
                        lambda *a, **k: torch.empty(0, dtype=torch.uint8))
    rig, _ = driver.make_inputs(cells.load_cell(name), SEED, "cpu")
    assert _digest(rig) == FULL[name]


@pytest.mark.parametrize("name", sorted(FULL))
def test_a_ring_cell_keeps_its_inputs(name):
    """At a small size the rig and the masks are the ones of before."""
    rig, pool = driver.make_inputs(small_cell(name=name), SEED, "cpu")
    assert _digest(rig, pool) == SMALL


def _elevations(c2w):
    eye = c2w[:, :3, 3]
    return np.arcsin(eye[:, 1] / np.linalg.norm(eye, axis=1))


def _orthonormal(c2w, tol=1e-12):
    r = c2w[:, :3, :3]
    np.testing.assert_allclose(np.swapaxes(r, 1, 2) @ r,
                               np.broadcast_to(np.eye(3), r.shape), atol=tol)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=tol)
    np.testing.assert_array_equal(c2w[:, 3], [[0, 0, 0, 1]] * len(c2w))


@pytest.mark.parametrize("band", [(10, 80), (0, 90)])
@pytest.mark.parametrize("views", [1, 7, 363])
def test_hemisphere_geometry(views, band):
    radius, width, height = 3.2, 640, 480
    c2w, pp, fl = scene.hemisphere_rig(views, width, height, radius, 45.0,
                                       list(band))
    assert c2w.shape == (views, 4, 4) and c2w.dtype == np.float64
    assert pp.shape == fl.shape == (views, 2)
    assert pp.dtype == fl.dtype == np.float32
    eye = c2w[:, :3, 3]
    np.testing.assert_allclose(np.linalg.norm(eye, axis=1), radius,
                               rtol=1e-12)
    lo, hi = np.radians(band)
    el = _elevations(c2w)
    assert np.all(el >= lo - 1e-12) and np.all(el <= hi + 1e-12)
    _orthonormal(c2w)
    # the origin projects to the principal point
    cam = np.linalg.inv(c2w)[:, :3, 3]
    uv = fl * cam[:, :2] / cam[:, 2:] + pp
    np.testing.assert_allclose(uv, pp, atol=1e-6, rtol=0)
    assert np.all(cam[:, 2] > 0)
    # intrinsics of the ring
    _, ring_pp, ring_fl = scene.turntable_rig(views, width, height, radius,
                                              45.0, 0.25)
    np.testing.assert_array_equal(pp, ring_pp)
    np.testing.assert_array_equal(fl, ring_fl)
    # the same arrays from a second call
    for a, b in zip((c2w, pp, fl), scene.hemisphere_rig(
            views, width, height, radius, 45.0, list(band))):
        np.testing.assert_array_equal(a, b)
    # equal area: the two halves of the sine range hold as many views
    s = eye[:, 1] / radius
    mid = 0.5 * (np.sin(lo) + np.sin(hi))
    assert abs(int(np.sum(s < mid)) - int(np.sum(s >= mid))) <= 1


@pytest.mark.parametrize("phi", [0.0, 0.7, 2.0, math.pi, 5.5])
def test_a_view_at_the_pole_has_a_pose(phi):
    """Views within 1e-9 rad of the pole, and at it, looking straight
    down, get a finite orthonormal pose that still looks at the origin."""
    theta = 0.5 * math.pi - 1e-9
    eye = 3.2 * np.array([math.cos(theta) * math.cos(phi), math.sin(theta),
                          math.cos(theta) * math.sin(phi)])
    c2w = np.stack([scene.look_at(eye, np.zeros(3)),
                    scene.look_at([0.0, 3.2, 0.0], np.zeros(3)),
                    scene.hemisphere_rig(1, 64, 48, 3.2, 45.0,
                                         [90 - 1e-7, 90])[0][0]])
    assert np.all(np.isfinite(c2w))
    _orthonormal(c2w)
    assert np.all(_elevations(c2w) >= 0.5 * math.pi - 1e-9)
    np.testing.assert_allclose(c2w[:, :3, 2] * 3.2, -c2w[:, :3, 3],
                               atol=1e-12)


def _hemisphere_copy(root: Path, name: str, band) -> str:
    """Under ``root``, the benchmark's data with one more configuration,
    a copy of the cell ``name``'s with its cameras on a hemisphere over
    ``band``, and a cell on it; nothing that was there is edited."""
    for d in ("configs", "traffic", "workloads"):
        shutil.copytree(BENCH / d, root / d, dirs_exist_ok=True)
    w = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
    config = w["config"] + "-hemi"
    rig = {k: cfg["rig"][k] for k in ("views", "width", "height", "radius",
                                      "fov_y_deg")}
    cfg.update(name=config, rig=dict(rig, layout="hemisphere",
                                     elevation_deg=list(band)))
    (root / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    cell = config + "." + w["traffic"]
    (root / "workloads" / f"{cell}.json").write_text(
        json.dumps(dict(w, name=cell, config=config)))
    return cell


def test_hemisphere_masks_see_the_object(tmp_path):
    name = _hemisphere_copy(tmp_path, "qvga36-512.frames", (10, 85))
    cell = small_cell(n=32, views=12, width=64, height=48, name=name,
                      root=tmp_path)
    _, pool = driver.make_inputs(cell, SEED, "cpu")
    for masks in pool:
        assert masks.shape == (12, 48, 64)
        share = (masks == 255).float().mean(dim=(1, 2))
        assert torch.all(share > 0) and torch.all(share < 0.6), share


@pytest.mark.parametrize("name", ["carving36-512.exact",
                                  "qvga36-512.frames"])
def test_a_hemisphere_copy_runs_correct(name, tmp_path):
    """The exact engine (``naive_carving``) and the warp engine
    (``weighted_average``) on 12 views over elevations 10 to 85 degrees
    come out correct, every gap 0."""
    hemi = _hemisphere_copy(tmp_path, name, (10, 85))
    cell = small_cell(n=32, views=12, width=64, height=48, name=hemi,
                      root=tmp_path)
    assert cell.config["rig"]["layout"] == "hemisphere"
    run = driver.run(cell, 2**33 + 11, 0.3, False, "cpu",
                     time.perf_counter())
    assert run.failed == 0 and len(run.requests) >= 2
    assert run.correct, run.readings
    assert set(run.readings.values()) == {0.0}, run.readings


def _ring(**change):
    rig = {"views": 36, "width": 320, "height": 240, "radius": 3.2,
           "fov_y_deg": 45.0, "elevation": 0.25}
    rig.update(change)
    return {k: v for k, v in rig.items() if v is not None}


def _hemisphere(**change):
    rig = _ring(layout="hemisphere", elevation=None, elevation_deg=[10, 80])
    rig.update(change)
    return {k: v for k, v in rig.items() if v is not None}


@pytest.mark.parametrize("rig,named", [
    (_ring(layout="dome"), "dome"),
    (_ring(layuot="hemisphere"), "layuot"),
    (_hemisphere(elevation_deg=None), "elevation_deg"),
    (_hemisphere(elevation_deg=[80, 10]), "elevation_deg"),
    (_hemisphere(elevation_deg=[10, 95]), "elevation_deg"),
    (_hemisphere(elevation_deg=[-5, 80]), "elevation_deg"),
    (_hemisphere(elevation_deg=[10]), "elevation_deg"),
    (_hemisphere(elevation=0.25), "elevation"),
    (_ring(elevation=None), "elevation"),
    (_hemisphere(views=0), "views"),
    (_ring(radius=-1.0), "radius"),
    (_hemisphere(fov_y_deg=180.0), "fov_y_deg"),
])
def test_the_loader_refuses_a_rig_it_cannot_lay_out(rig, named, tmp_path):
    """A cell whose configuration names an unknown layout, lacks a key
    of its layout, holds one it does not take (a typo never runs as a
    ring) or holds one out of range is refused when it loads, by a
    ``ValueError`` that names it."""
    for d in ("configs", "traffic", "workloads"):
        shutil.copytree(BENCH / d, tmp_path / d)
    cfg = json.loads((BENCH / "configs" / "qvga36-512.json").read_text())
    cfg.update(name="bad", rig=rig)
    (tmp_path / "configs" / "bad.json").write_text(json.dumps(cfg))
    (tmp_path / "workloads" / "bad.frames.json").write_text(json.dumps(
        {"name": "bad.frames", "config": "bad", "traffic": "frames",
         "chips": 1, "why": "a test", "limits": {"mesh.gap": 0.01}}))
    with pytest.raises(ValueError, match=named):
        cells.load_cell("bad.frames", root=tmp_path)
    with pytest.raises(ValueError, match=named):
        scene.rig(rig)


def test_the_loader_takes_both_layouts(tmp_path):
    name = _hemisphere_copy(tmp_path, "carving36-512.exact", (10, 80))
    assert cells.load_cell(name, root=tmp_path).config["rig"][
        "elevation_deg"] == [10, 80]
    c2w, _, _ = scene.rig(_hemisphere())
    assert c2w.shape == (36, 4, 4)
    for a, b in zip(scene.rig(_ring()), scene.rig(_ring(layout="ring"))):
        np.testing.assert_array_equal(a, b)
