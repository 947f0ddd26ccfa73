"""The plain reference agrees with the port's CPU path (its plain
versions of kernels A and B) bit for bit at a small size."""

import numpy as np
import pytest
import torch

from harness import cells, driver, program
from bench_small import small_cell

STAGES = {"sdf_images", "state", "mesh"}


@pytest.mark.parametrize("n,views,size", [(32, 6, (64, 48)),
                                          (40, 5, (96, 80))])
def test_reference_matches_port_cpu(n, views, size):
    cell = small_cell(n=n, views=views, width=size[0], height=size[1])
    cfg = cell.config
    rig, pool = driver.make_inputs(cell, 2**35 + n, "cpu")
    carver = program.carver(cfg, "cpu")
    cams = program.cameras(*rig, size[0], size[1], "cpu")
    for masks in pool:
        carver.init()
        images = carver.carve_batch(cams, masks, engine="warp")
        mesh = carver.extract_iso_surface()
        ref = cells.load_reference(cfg["reference"]).reconstruct(
            masks, *rig, cfg, STAGES)
        r_images, (r_sdf, r_un), (r_verts, r_faces) = (
            ref["sdf_images"], ref["state"], ref["mesh"])
        np.testing.assert_array_equal(images, r_images.numpy())
        assert torch.equal(carver.state.update_num, r_un)
        assert torch.equal(carver.state.sdf.view(torch.int32),
                           r_sdf.view(torch.int32))
        assert len(r_faces) > 100
        np.testing.assert_array_equal(mesh.vertices, r_verts)
        np.testing.assert_array_equal(mesh.faces, r_faces)


@pytest.mark.parametrize("section,key,value", [
    ("update", "rule", "MAX"), ("update", "sdf_interp", "NN"),
    ("extract", "linear_interp", False), ("precision", None, "float64")])
def test_reference_refuses_what_it_does_not_compute(section, key, value):
    """A configuration whose update rule this reference does not compute
    is refused, not compared against the wrong result."""
    cell = small_cell(n=16, views=2)
    cfg = dict(cell.config)
    if key is None:
        cfg[section] = value
    else:
        cfg[section] = dict(cfg[section], **{key: value})
    rig, pool = driver.make_inputs(cell, 3, "cpu")
    with pytest.raises(ValueError):
        cells.load_reference(cfg["reference"]).reconstruct(
            pool[0], *rig, cfg, STAGES)


def test_reference_computes_only_the_stages_asked():
    cell = small_cell(n=16, views=2)
    rig, pool = driver.make_inputs(cell, 4, "cpu")
    ref = cells.load_reference(cell.config["reference"])
    assert set(ref.reconstruct(pool[0], *rig, cell.config,
                               {"sdf_images"})) == {"sdf_images"}
    assert set(ref.reconstruct(pool[0], *rig, cell.config,
                               {"state"})) == {"state"}


def test_reference_fold_is_blocked_exactly():
    """Planes are independent: fusing in blocks of planes gives the
    whole-grid fold's bits."""
    from reference import fold, sdf2d
    from reference.geometry import axis_centers, world_to_camera

    cell = small_cell(n=24, views=4)
    cfg = cell.config
    (c2w, pp, fl), pool = driver.make_inputs(cell, 5, "cpu")
    g = cfg["grid"]
    images = sdf2d.sdf_images(pool[0], cfg["update"]["truncation_band"])
    cx, cy, cz = (torch.from_numpy(axis_centers(g["bb_min"], g["bb_max"],
                                                g["resolution"], a))
                  for a in range(3))
    w2c = torch.from_numpy(np.stack([world_to_camera(m) for m in c2w]))
    args = (images, w2c, torch.from_numpy(pp), torch.from_numpy(fl),
            cx, cy, cz, 255, 1.0)
    whole = fold.fuse(*args, planes=24)
    blocks = fold.fuse(*args, planes=5)
    assert torch.equal(whole[0].view(torch.int32), blocks[0].view(torch.int32))
    assert torch.equal(whole[1], blocks[1])
