"""The reference of the weighted-average update rule, as a configuration
names it (``"reference": "weighted_average"``): masks and cameras in;
SDF images, state and mesh out."""

import numpy as np
import torch

from . import fold, mc, sdf2d
from .geometry import axis_centers, world_to_camera

# the options this reference computes; a configuration that asks for
# others needs a reference of its own
RULE = dict(rule="WEIGHTED_AVERAGE", sdf_interp="BILINEAR",
            update_outside="NONE", use_truncation=True,
            sdf_minmax_normalize=True)


def reconstruct(masks, c2w, principal_point, focal_length, config, stages,
                store=torch.float32):
    """``masks`` uint8 [V, H, W] on the device the work runs on;
    ``c2w`` float64 [V, 4, 4], ``principal_point`` and ``focal_length``
    float32 [V, 2] (numpy); ``config`` a configuration's ``grid``,
    ``update``, ``extract`` and ``precision``. Returns, of ``stages``,
    ``sdf_images`` (float32 [V, H, W] on that device), ``state`` (sdf
    float32 and update_num int32 [nz, ny, nx] on that device) and
    ``mesh`` (vertices float32 [N, 3] and faces int32 [M, 3] in numpy),
    with the images and the state kept in ``store`` between stages."""
    grid, update = config["grid"], config["update"]
    if (any(update[k] != v for k, v in RULE.items())
            or not config["extract"]["linear_interp"]
            or config["precision"] != "float32"):
        raise ValueError(f"this reference computes {RULE} in float32 with "
                         f"interpolated vertices, not {config}")
    dev = masks.device
    out = {}
    images = sdf2d.sdf_images(masks, update["truncation_band"], store)
    if "sdf_images" in stages:
        out["sdf_images"] = images
    if not {"state", "mesh"} & set(stages):
        return out
    box = (grid["bb_min"], grid["bb_max"], grid["resolution"])
    centers = [axis_centers(*box, a) for a in range(3)]
    w2c = torch.from_numpy(np.stack([world_to_camera(m) for m in c2w]))
    sdf, un = fold.fuse(
        images, w2c.to(dev),
        torch.from_numpy(np.asarray(principal_point, np.float32)).to(dev),
        torch.from_numpy(np.asarray(focal_length, np.float32)).to(dev),
        *(torch.from_numpy(c).to(dev) for c in centers),
        cap=int(update["voxel_max_update_num"]),
        weight=float(update["voxel_update_weight"]), store=store)
    del images
    out["state"] = (sdf, un)
    if "mesh" in stages:
        out["mesh"] = mc.extract(sdf, un, *centers,
                                 iso=config["extract"]["iso_level"])
    return out
