"""The system under test, ``vacancy_tpu_torch``, as the benchmark drives
it: the public facade ``VoxelCarver``, called by the steps a traffic mix
names, and the launch counters of its kernels. Nothing else of the
program is used."""

import numpy as np


def carver(config: dict, device):
    """A ``VoxelCarver`` with the configuration's options, on
    ``device``."""
    from vacancy_tpu_torch import VoxelCarver
    from vacancy_tpu_torch.config import (SdfInterpolation,
                                          UpdateOutsideImage, VoxelCarverOption,
                                          VoxelUpdate, VoxelUpdateOption)

    g, u = config["grid"], config["update"]
    option = VoxelCarverOption(
        bb_min=tuple(g["bb_min"]), bb_max=tuple(g["bb_max"]),
        resolution=g["resolution"],
        sdf_minmax_normalize=u["sdf_minmax_normalize"],
        update_option=VoxelUpdateOption(
            voxel_update=VoxelUpdate[u["rule"]],
            sdf_interp=SdfInterpolation[u["sdf_interp"]],
            update_outside=UpdateOutsideImage[u["update_outside"]],
            voxel_max_update_num=u["voxel_max_update_num"],
            voxel_update_weight=u["voxel_update_weight"],
            use_truncation=u["use_truncation"],
            truncation_band=u["truncation_band"]))
    return VoxelCarver(option, device=device)


def cameras(c2w, principal_point, focal_length, width, height, device):
    """The rig as one stacked ``PinholeCamera`` on ``device``."""
    from vacancy_tpu_torch.camera import PinholeCamera, stack_cameras

    return stack_cameras([
        PinholeCamera.create(width, height, c2w=c2w[i],
                             principal_point=np.asarray(principal_point[i]),
                             focal_length=np.asarray(focal_length[i]),
                             device=device)
        for i in range(len(c2w))])


def call(carver, step: dict, config: dict, inputs: dict):
    """One step of a request: the facade method ``step["call"]`` with the
    inputs it names (``"cameras"``, ``"masks"``) as positional arguments,
    the entries of the configuration's section ``step["config"]`` and
    then ``step["options"]`` as keyword arguments."""
    args = [inputs[name] for name in step.get("inputs", [])]
    kwargs = dict(config[step["config"]]) if "config" in step else {}
    kwargs.update(step.get("options", {}))
    return getattr(carver, step["call"])(*args, **kwargs)


def returned(kind: str, value):
    """What the check keeps of a step's return value: the SDF images as
    numpy, or the mesh as (vertices, faces) in numpy."""
    if kind == "sdf_images":
        return np.asarray(value)
    if kind == "mesh":
        return value.vertices, value.faces
    raise ValueError(f"no step returns {kind!r}")


def state(carver):
    """The fused state (sdf, update_num) the carver holds."""
    st = carver.state
    return st.sdf, st.update_num


def launches() -> dict:
    """The program's launch counters: kernel A, kernel C, kernel B's runs
    and passes, kernel E, kernel set S (three launches a call), and the
    meshes the mesh-assembly kernels build on the card."""
    from vacancy_tpu_torch.ops import (exact_fused, mc_fused, mesh_assembly,
                                       sdf2d_fused, warp_fused, warp_gather)

    return {
        "warp_fuse_planes": warp_fused.warp_fuse_planes.launches,
        "interp_rows": warp_gather.interp_rows.launches,
        "marching_cubes_fused": mc_fused.marching_cubes_fused.launches,
        "mc_tile_counts": mc_fused.mc_tile_counts.launches,
        "mc_scan": mc_fused.mc_scan.launches,
        "exact_fold": exact_fused.exact_fold.launches,
        "sdf2d_fused": sdf2d_fused.sdf2d_fused.launches,
        "assemble_on_card": mesh_assembly.assemble_on_card.meshes,
    }
