"""The comparison that decides ``correct``: what the timed path returned
for a sample of its requests, against the plain reference worked out
again from the same masks and cameras.

A number for each output a request keeps (the SDF images, the fused
state, the mesh), each the widest gap over the sampled requests:

* ``sdf_images.gap``: the widest absolute gap between a returned SDF
  image pixel and the reference's (values lie in [-1, 1]); a pixel that
  holds the sentinel on one side only reads 2;
* ``state.gap``: the widest absolute gap between the fused states' sdf
  values; a voxel whose update count differs, or that is untouched on
  one side only, reads 2;
* ``mesh.gap``: the widest gap between a vertex coordinate and the
  reference's, in grid pitches; a mesh whose vertex count or faces
  differ from the reference's reads 1, the length of a grid edge.
"""

import numpy as np
import torch

NUMBERS = {"sdf_images": "sdf_images.gap", "state": "state.gap",
           "mesh": "mesh.gap"}
MISMATCH_VALUE = 2.0
MISMATCH_TOPOLOGY = 1.0
INVALID_SDF = float(np.finfo(np.float32).min)


def images_gap(got: np.ndarray, ref: torch.Tensor, block: int = 4) -> float:
    if tuple(got.shape) != tuple(ref.shape):
        return MISMATCH_VALUE
    worst = 0.0
    for lo in range(0, got.shape[0], block):
        g = torch.from_numpy(np.ascontiguousarray(got[lo:lo + block])).to(
            ref.device)
        r = ref[lo:lo + block]
        gs, rs = g == INVALID_SDF, r == INVALID_SDF
        if bool((gs != rs).any()):
            return MISMATCH_VALUE
        d = torch.where(gs, 0.0, (g - r).abs())
        worst = max(worst, float(torch.nan_to_num(d, nan=MISMATCH_VALUE)
                                 .max()))
    return worst


def state_gap(sdf, un, ref_sdf, ref_un) -> float:
    if sdf.shape != ref_sdf.shape or bool((un != ref_un).any()):
        return MISMATCH_VALUE
    touched = un > 0
    if bool(((sdf == INVALID_SDF) != (ref_sdf == INVALID_SDF))[
            ~touched].any()):
        return MISMATCH_VALUE
    d = torch.where(touched, (sdf - ref_sdf).abs(), 0.0)
    return float(torch.nan_to_num(d, nan=MISMATCH_VALUE).max())


def mesh_gap(verts, faces, ref_verts, ref_faces, pitch: float) -> float:
    if (verts.shape != ref_verts.shape or faces.shape != ref_faces.shape
            or not np.array_equal(faces, ref_faces)):
        return MISMATCH_TOPOLOGY
    if len(verts) == 0:
        return 0.0
    d = np.abs(verts.astype(np.float64) - ref_verts.astype(np.float64))
    if not np.isfinite(d).all():
        return MISMATCH_TOPOLOGY
    return float(d.max() / pitch)


def gaps(config: dict, out: dict, ref: dict) -> dict:
    """The compared number of each output in ``out`` against ``ref``."""
    grid = config["grid"]
    pitch = float(np.float32(grid["bb_max"][0])
                  - np.float32(grid["bb_min"][0])) / grid["n"]
    got = {}
    if "sdf_images" in out:
        got["sdf_images"] = images_gap(out["sdf_images"], ref["sdf_images"])
    if "state" in out:
        got["state"] = state_gap(*out["state"], *ref["state"])
    if "mesh" in out:
        got["mesh"] = mesh_gap(*out["mesh"], *ref["mesh"], pitch)
    return {NUMBERS[k]: v for k, v in got.items()}


def verdict(readings: dict, limits: dict) -> bool:
    """Every number read, and each at or under its limit."""
    return all(k in readings and readings[k] <= limits[k] for k in limits)


def format_lines(readings: dict, limits: dict):
    """One line per compared number: its name, its reading, its limit."""
    return [f"check {k} {readings.get(k, float('nan'))!r} limit {limits[k]!r}"
            for k in limits]
