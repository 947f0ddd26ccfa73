"""End-to-end pipelines + CLI (``vacancy_tpu/pipeline.py``; the
reference's examples.cc).

    python -m vacancy_tpu_torch.pipeline turntable --n 512 --views 36 --out DIR
    python -m vacancy_tpu_torch.pipeline sweep --n 1024 --views 100 --out DIR
    python -m vacancy_tpu_torch.pipeline bunny --out DIR   # reads VACANCY_DATA
    python -m vacancy_tpu_torch.pipeline sweep --n 1024 --views 100 --mesh-shape 4

``turntable`` (BASELINE config 4) renders silhouettes of a sphere-union
blob from ``--views`` orbiting cameras, turns them into truncated 2D SDFs,
fuses them into an n^3 grid with weighted-average TSDF updates through the
fused warp kernel, extracts the iso-surface through the fused
marching-cubes kernel, and writes a binary PLY. ``sweep`` (BASELINE config
5) is the same scene at 1024^3 x 100 views on one card: the carve runs
z-chunked and in place (``carve_views_warp_blocked``), and cold and warm
times of carve and extract are reported. ``bunny`` is the examples.cc
sequence on the six views under ``VACANCY_DATA`` (by default the
checkout's ``data/``), with ``--checkpoint`` and ``--resume``. Each prints
one JSON line. The device defaults to ``cuda``; ``--device cpu`` runs the
kernels' plain versions instead.

``turntable --sharded`` and ``sweep`` (unless ``--no-sharded``) cut the
grid into blocks over a block mesh (``parallel/``): one block per card by
default, so a single card runs unsharded and says so; ``--mesh-shape
Z[,Y[,X]]`` places that many blocks round-robin over the visible cards
(all on the one card where there is one; with ``--device cpu``, CPU
blocks), ``auto`` picks the shape for one block per card. With
``--coordinator HOST:PORT --num-processes N --process-id R`` the same
``sweep`` command runs once per process and the mesh spans them:
extraction then goes through piece files under ``--piece-dir`` and
process 0 assembles.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .camera import PinholeCamera, stack_cameras
from .carver import VoxelCarver
from .checkpoint import load_state, save_state
from .config import (
    SdfInterpolation,
    VoxelCarverOption,
    VoxelUpdate,
    VoxelUpdateOption,
)
from .grid import GridSpec, VoxelGridState
from .io import load_mask, load_tum_poses, write_png
from .mesh import Mesh
from .metrics import bbox_diagonal, chamfer_distance, hausdorff_distance
from .ops.fusion_warp import carve_views_warp, carve_views_warp_blocked
from .ops.marching_cubes import extract_mesh
from .ops.sdf2d import make_signed_distance_field, signed_distance_to_color
from .parallel import (
    BlockMesh,
    carve_views_warp_sharded,
    extract_mesh_sharded,
    grid_sharding,
    initialize_distributed,
    make_device_mesh,
    pad_bbox_for_sharding,
    pick_mesh_shape,
    pick_transport,
)
from .parallel.mesh_utils import default_devices, rank_and_world
from .synthetic import blob_spheres, render_silhouettes, turntable_cameras
from .utils import LOGI, Timer, zfill
from .utils.timing import trace as profiler_trace

# exact mesh bounding box + 20mm pad (examples.cc:87-98)
BUNNY_BB_MIN = (-270.0, -364.586151, -149.982697)
BUNNY_BB_MAX = (270.0, 170.542343, 277.329224)
BUNNY_INTRINSICS = dict(
    width=320,
    height=240,
    principal_point=np.array([159.3, 127.65], np.float32),
    focal_length=np.array([258.65, 258.25], np.float32),
)


# where the bunny sequence is read from when VACANCY_DATA is unset
DEFAULT_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def default_data_dir() -> str:
    """The directory of the bunny sequence (``tumpose.txt``,
    ``mask_0000N.png``, ``GT.ply``): the ``VACANCY_DATA`` variable, read at
    each call, else ``DEFAULT_DATA_DIR``. A directory without the files
    fails where they are read, as the JAX package's ``DATA_DIR`` does."""
    return os.environ.get("VACANCY_DATA") or DEFAULT_DATA_DIR


def turntable_grid(n: int) -> GridSpec:
    """The n^3 grid over [-1.1, 1.1]^3 that ``vacancy_tpu.pipeline``'s
    turntable uses."""
    res = 2.2 / n
    grid = GridSpec(
        bb_min=(-1.1, -1.1, -1.1),
        bb_max=(-1.1 + (n + 0.4) * res,) * 3,
        resolution=res,
    )
    assert grid.shape_zyx == (n, n, n), grid.shape_zyx
    return grid


def turntable_option(tsdf: bool = True) -> VoxelUpdateOption:
    return VoxelUpdateOption(
        voxel_update=(
            VoxelUpdate.WEIGHTED_AVERAGE if tsdf else VoxelUpdate.MAX
        ),
        use_truncation=tsdf,
        truncation_band=0.05,
    )


def turntable_masks(n_views: int, device):
    """(stacked cameras, uint8 silhouettes [V, 240, 320]) on ``device``."""
    centers, radii = blob_spheres(seed=3)
    cams = turntable_cameras(n_views, radius=3.2, device=device)
    return stack_cameras(cams), render_silhouettes(cams, centers, radii)


def turntable_inputs(n: int, n_views: int, tsdf: bool, device):
    """(grid, option, stacked cameras, 2D SDF images [V, 240, 320]): what
    ``run_turntable`` fuses, on ``device``."""
    opt = turntable_option(tsdf)
    cams, masks = turntable_masks(n_views, device)
    sdf_images = make_signed_distance_field(
        masks, use_truncation=opt.use_truncation,
        truncation_band=opt.truncation_band,
    )
    return turntable_grid(n), opt, cams, sdf_images


def facade_inputs(n: int, n_views: int, width: int, height: int, device):
    """(VoxelCarverOption, cameras, uint8 silhouettes [V, height, width])
    for ``VoxelCarver``: the turntable's n^3 grid, WAVG + truncation band
    0.05, and ``n_views`` orbiting cameras of ``width`` x ``height`` that
    see the same blob."""
    grid = turntable_grid(n)
    opt = VoxelCarverOption(bb_min=grid.bb_min, bb_max=grid.bb_max,
                            resolution=grid.resolution,
                            update_option=turntable_option(tsdf=True))
    cams = turntable_cameras(n_views, 3.2, width=width, height=height,
                             device=device)
    return opt, cams, render_silhouettes(cams, *blob_spheres(seed=3))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


MeshShape = Union[None, str, Tuple[int, ...]]


def _local_devices(device: torch.device):
    """This process's block devices: the named one (``cpu``, ``cuda:1``),
    or for plain ``cuda`` every card the process may use."""
    if device.type == "cuda" and device.index is None:
        return default_devices(*rank_and_world())
    return [device]


def block_mesh(shape_zyx, sharded: bool, mesh_shape: MeshShape,
               device: torch.device) -> Optional[BlockMesh]:
    """The block mesh a ``--sharded`` run cuts its grid over, or None for
    an unsharded run. Without a shape: one block per block-holder (process
    x card) along z, and None where there is a single holder, as the JAX
    package runs unsharded on one device. ``"auto"``:
    ``pick_mesh_shape`` for that many blocks. An explicit shape: that
    many blocks, placed round-robin over this process's devices (all on
    the one card where there is one)."""
    if not sharded:
        return None
    _, world = rank_and_world()
    local = _local_devices(device)
    holders = world * len(local)
    if mesh_shape is None or mesh_shape == "auto":
        if holders == 1:
            return None
        mesh_shape = ((holders,) if mesh_shape is None
                      else pick_mesh_shape(shape_zyx, holders))
    total = int(np.prod(mesh_shape))
    if total % world:
        raise ValueError(f"mesh shape {mesh_shape}: {total} blocks do not "
                         f"divide over {world} processes")
    per_rank = total // world
    return make_device_mesh(
        shape=tuple(mesh_shape),
        devices=[local[i % len(local)] for i in range(per_rank)])


def _sync_all(device: torch.device, mesh: Optional[BlockMesh]) -> None:
    devices = {device} if mesh is None else {
        d for d in mesh.devices if d is not None}
    for d in devices:
        _sync(d)


def _mesh_report(mesh: Optional[BlockMesh], device: torch.device) -> dict:
    """The JAX lines' ``sharded`` and ``devices`` keys, plus the mesh's
    shape and how its halo slices travel."""
    _, world = rank_and_world()
    return {
        "sharded": mesh is not None,
        "devices": world * len(_local_devices(device)),
        "mesh_shape": None if mesh is None else list(mesh.axis_sizes),
        "transport": None if mesh is None else pick_transport(mesh).name,
    }


def run_turntable(
    n: int = 256,
    n_views: int = 36,
    tsdf: bool = True,
    out_dir: Optional[str] = None,
    device="cuda",
    sharded: bool = False,
    mesh_shape: MeshShape = None,
) -> dict:
    """Synthetic turntable blob at n^3. carve_s is the second (warm)
    fusion of every view; the first call builds the kernels. Both timings
    end in a device synchronize. ``sharded`` / ``mesh_shape``: over a
    block mesh of this process (``block_mesh``)."""
    device = torch.device(device)
    grid, opt, cams, sdf_images = turntable_inputs(n, n_views, tsdf, device)
    linear = opt.sdf_interp == SdfInterpolation.BILINEAR
    mesh_b = block_mesh(grid.shape_zyx, sharded, mesh_shape, device)
    views = (cams.w2c, cams.principal_point, cams.focal_length, sdf_images)
    if mesh_b is not None:
        # axes need not divide the grid extent (pick_mesh_shape's
        # contract): pad here, as run_sweep does
        grid = pad_bbox_for_sharding(grid, mesh_b)
        sharding = grid_sharding(mesh_b)

    def carve():
        if mesh_b is not None:
            st = carve_views_warp_sharded(
                VoxelGridState.create(grid, sharding=sharding), grid, *views,
                opt=opt, linear=linear, mesh=mesh_b)
        else:
            st = carve_views_warp(VoxelGridState.create(grid, device), grid,
                                  *views, opt=opt, linear=linear)
        _sync_all(device, mesh_b)
        return st

    carve()  # warm-up (first use builds the kernels)
    t0 = time.perf_counter()
    state = carve()
    carve_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    if mesh_b is not None:
        mesh = extract_mesh_sharded(state, grid, mesh_b)
    else:
        mesh = extract_mesh(state, grid)
    _sync_all(device, mesh_b)
    extract_s = time.perf_counter() - t0
    LOGI("turntable %d^3 x %d views: carve %.4f s, extract %.4f s",
         n, n_views, carve_s, extract_s)

    out = {
        "grid": list(grid.voxel_num),
        "views": n_views,
        "device": _device_name(device),
        "carve_s": carve_s,
        "fusions_per_s": grid.num_voxels * n_views / carve_s,
        "extract_s": extract_s,
        "mc_vertices": mesh.num_vertices,
        "mc_faces": mesh.num_faces,
        **_mesh_report(mesh_b, device),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        out["ply"] = os.path.join(out_dir, f"turntable_{n}.ply")
        mesh.write_ply(out["ply"], binary=True)
    return out


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def run_sweep(
    n: int = 1024,
    n_views: int = 100,
    sharded: bool = True,
    extract: bool = True,
    out_dir: Optional[str] = None,
    device="cuda",
    piece_dir: Optional[str] = None,
    mesh_shape: MeshShape = None,
) -> dict:
    """BASELINE config 5 as one command: N^3 (default 1024^3) TSDF sweep
    over 100+ synthetic turntable views, sharded over a block mesh
    (``block_mesh``: one block per card, or ``mesh_shape``), or on a
    single card z-chunked and in place (``carve_views_warp_blocked``; the
    per-view fields of the whole grid would exceed the card's memory),
    then extraction through the fused marching-cubes kernel, block by
    block with a one-voxel halo where sharded.

    Several processes: run the same command per process after
    ``initialize_distributed``; extraction then writes per-block pieces
    under ``piece_dir`` (a directory every process reaches) and process 0
    assembles.

    cold = the first call, which builds the kernels; warm = steady state
    (the headline fusions/s). Both are recorded, so the result shows the
    first-run cost and the throughput a long sweep sees. Every timing ends
    in a device synchronize. With ``out_dir`` the mesh is written to
    ``out_dir/sweep_{n}.ply`` (binary)."""
    device = torch.device(device)
    grid, opt, cams, sdf_images = turntable_inputs(n, n_views, True, device)
    linear = opt.sdf_interp == SdfInterpolation.BILINEAR
    mesh_b = block_mesh(grid.shape_zyx, sharded, mesh_shape, device)
    views = (cams.w2c, cams.principal_point, cams.focal_length, sdf_images)
    if mesh_b is not None:
        grid = pad_bbox_for_sharding(grid, mesh_b)
        sharding = grid_sharding(mesh_b)

    def do_carve():
        if mesh_b is not None:
            state = carve_views_warp_sharded(
                VoxelGridState.create(grid, sharding=sharding), grid, *views,
                opt=opt, linear=linear, mesh=mesh_b)
        else:
            state = carve_views_warp_blocked(
                VoxelGridState.create(grid, device), grid, *views, opt=opt,
                linear=linear)
        _sync_all(device, mesh_b)
        return state

    def do_extract(state):
        if mesh_b is not None:
            mesh = extract_mesh_sharded(state, grid, mesh_b,
                                        piece_dir=piece_dir)
        else:
            mesh = extract_mesh(state, grid)
        _sync_all(device, mesh_b)
        return mesh

    t0 = time.perf_counter()
    state = do_carve()
    carve_cold_s = time.perf_counter() - t0
    # free the cold state before the warm rerun: two 1024^3 states are
    # 17 GB that nothing needs (VoxelCarver.init likewise lets go of the
    # state it holds before it allocates the next, and its warp carve
    # writes over that one state)
    del state
    t0 = time.perf_counter()
    state = do_carve()
    carve_s = time.perf_counter() - t0

    out = {
        "config": "baseline-5-sweep",
        "grid": list(grid.voxel_num),
        "views": n_views,
        "device": _device_name(device),
        "carve_cold_s": carve_cold_s,
        "carve_s": carve_s,
        "fusions_per_s": grid.num_voxels * n_views / carve_s,
        **_mesh_report(mesh_b, device),
    }
    if extract:
        t0 = time.perf_counter()
        mesh = do_extract(state)
        extract_cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh = do_extract(state)
        out.update(extract_cold_s=extract_cold_s,
                   extract_s=time.perf_counter() - t0)
        if mesh is not None:  # None on every process but process 0
            out.update(mc_vertices=mesh.num_vertices,
                       mc_faces=mesh.num_faces)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                mesh.write_ply(os.path.join(out_dir, f"sweep_{n}.ply"),
                               binary=True)
    return out


def load_bunny(data_dir: Optional[str] = None, device="cuda"):
    """(six cameras on ``device``, uint8 masks [6, 240, 320]) of the
    bunny sequence under ``data_dir`` (default: ``default_data_dir()``)."""
    d = default_data_dir() if data_dir is None else data_dir
    poses = load_tum_poses(os.path.join(d, "tumpose.txt"))
    masks = np.stack(
        [load_mask(os.path.join(d, f"mask_{i:05d}.png")) for i in range(6)]
    )
    cams = [
        PinholeCamera.create(c2w=p, device=device, **BUNNY_INTRINSICS)
        for p in poses
    ]
    return cams, masks


def bunny_option(
    resolution: float = 10.0,
    tsdf: bool = False,
    truncation_band: float = 0.1,
    interp: str = "bilinear",
    sdf_scale: Optional[float] = None,
) -> VoxelCarverOption:
    """sdf_scale enables metric TSDF fusion (see
    config.VoxelCarverOption): pass the world-units-per-pixel factor
    (roughly camera_distance / fx) and a truncation_band in world units
    (e.g. 3 * resolution)."""
    return VoxelCarverOption(
        bb_min=BUNNY_BB_MIN,
        bb_max=BUNNY_BB_MAX,
        resolution=resolution,
        sdf_scale=sdf_scale,
        update_option=VoxelUpdateOption(
            voxel_update=(
                VoxelUpdate.WEIGHTED_AVERAGE if tsdf else VoxelUpdate.MAX
            ),
            sdf_interp=(
                SdfInterpolation.NN
                if interp == "nn"
                else SdfInterpolation.BILINEAR
            ),
            use_truncation=tsdf,
            truncation_band=truncation_band,
        ),
    )


def run_bunny(
    out_dir: Optional[str] = None,
    resolution: float = 10.0,
    tsdf: bool = False,
    write_artifacts: bool = True,
    chamfer_gt: bool = True,
    checkpoint: Optional[str] = None,
    resume: bool = False,
    sdf_scale: Optional[float] = None,
    engine: str = "exact",
    device="cuda",
) -> dict:
    """The examples.cc bunny pipeline (examples.cc:75-152), view by view
    through ``VoxelCarver.carve(engine=...)``: "exact" (the reference's
    sampling) or "warp" (the warp engine). With ``checkpoint`` the state
    is saved after every view; ``resume`` picks up after the last one."""
    device = torch.device(device)
    cams, masks = load_bunny(device=device)
    option = bunny_option(
        resolution=resolution,
        tsdf=tsdf,
        truncation_band=(3 * resolution if sdf_scale else 0.1),
        sdf_scale=sdf_scale,
    )
    carver = VoxelCarver(option, device)
    start_view = 0
    if not carver.init():
        raise ValueError("invalid bunny option")
    if resume and checkpoint and os.path.exists(
            checkpoint if checkpoint.endswith(".npz")
            else checkpoint + ".npz"):
        state, grid, start_view, _ = load_state(checkpoint, device=device)
        carver.restore(state, grid)
        LOGI("resumed from %s at view %d", checkpoint, start_view)
    LOGI("grid: %s (%d voxels)", carver.grid.voxel_num,
         carver.grid.num_voxels)

    results = {"grid": list(carver.grid.voxel_num), "views": []}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    timer = Timer()
    for i in range(start_view, 6):
        timer.start()
        sdf_img = carver.carve(cams[i], silhouette=masks[i], engine=engine)
        carve_ms = timer.end()
        num = zfill(i)
        view_rec = {"view": i, "carve_ms": carve_ms}
        if write_artifacts and out_dir:
            write_png(
                os.path.join(out_dir, f"sdf_{num}.png"),
                signed_distance_to_color(sdf_img, -1.0, 1.0),
            )
            timer.start()
            vm = carver.extract_voxel()
            vm.write_ply(os.path.join(out_dir, f"voxel_{num}.ply"))
            view_rec["voxel_ms"] = timer.end()
            timer.start()
            mc = carver.extract_iso_surface(0.0)
            mc.write_ply(os.path.join(out_dir, f"surface_{num}.ply"))
            view_rec["mc_ms"] = timer.end()
            mc_ni = carver.extract_iso_surface(0.0, linear_interp=False)
            mc_ni.write_ply(
                os.path.join(out_dir, f"surface_nointerp_{num}.ply")
            )
        if checkpoint:
            save_state(checkpoint, carver.state, carver.grid, next_view=i + 1)
        results["views"].append(view_rec)
        LOGI("view %d carved in %.1f ms", i, carve_ms)

    mesh = carver.extract_iso_surface(0.0)
    results["mc_vertices"] = mesh.num_vertices
    results["mc_faces"] = mesh.num_faces
    if out_dir:
        mesh.write_ply(os.path.join(out_dir, "final_surface.ply"))
    if chamfer_gt:
        gt = Mesh.load_ply(os.path.join(default_data_dir(), "GT.ply"))
        ch, a, b = chamfer_distance(mesh, gt)
        diag = bbox_diagonal(gt)
        results["chamfer"] = ch
        results["chamfer_over_diag"] = ch / diag
        results["hausdorff"] = hausdorff_distance(mesh, gt)
        LOGI("chamfer=%.3f (%.3f/%.3f) diag=%.1f ratio=%.5f",
             ch, a, b, diag, ch / diag)
    return results


def run_bunny_batched(resolution: float = 10.0, tsdf: bool = False,
                      device="cuda") -> dict:
    """All six views fused in one ``carve_batch`` call."""
    device = torch.device(device)
    cams, masks = load_bunny(device=device)
    carver = VoxelCarver(bunny_option(resolution=resolution, tsdf=tsdf),
                         device)
    if not carver.init():
        raise ValueError("invalid bunny option")
    t0 = time.perf_counter()
    carver.carve_batch(cams, masks)
    _sync(device)
    carve_s = time.perf_counter() - t0
    mesh = carver.extract_iso_surface(0.0)
    gt = Mesh.load_ply(os.path.join(default_data_dir(), "GT.ply"))
    ch, _, _ = chamfer_distance(mesh, gt)
    return {
        "grid": list(carver.grid.voxel_num),
        "carve_s": carve_s,
        "fusions_per_s": carver.grid.num_voxels * 6 / carve_s,
        "mc_vertices": mesh.num_vertices,
        "chamfer_over_diag": ch / bbox_diagonal(gt),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="vacancy_tpu_torch.pipeline")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bunny", help="bundled 6-view bunny (examples.cc); "
                       "reads the directory named by VACANCY_DATA (default: "
                       "the checkout's data/)")
    b.add_argument("--out", default=None)
    b.add_argument("--resolution", type=float, default=10.0)
    b.add_argument("--grid-n", type=int, default=None,
                   help="target ~N^3 grid (overrides --resolution)")
    b.add_argument("--tsdf", action="store_true",
                   help="weighted-average TSDF + truncation")
    b.add_argument("--sdf-scale", type=float, default=None,
                   help="metric TSDF: world units per pixel at the object "
                   "depth (~camera_distance/fx; band becomes 3*resolution)")
    b.add_argument("--no-artifacts", action="store_true")
    b.add_argument("--checkpoint", default=None)
    b.add_argument("--resume", action="store_true")
    b.add_argument("--engine", choices=("exact", "warp"), default="exact",
                   help="per-view fusion engine: exact = the reference's "
                   "sampling; warp = the warp engine")

    t = sub.add_parser("turntable", help="synthetic turntable at N^3")
    t.add_argument("--n", type=int, default=256)
    t.add_argument("--views", type=int, default=36)
    t.add_argument("--sharded", action="store_true",
                   help="cut the grid over a block mesh (parallel/)")
    t.add_argument("--out", default=None)

    s = sub.add_parser(
        "sweep", help="BASELINE config 5: 1024^3, 100+ views, one card")
    s.add_argument("--n", type=int, default=1024)
    s.add_argument("--views", type=int, default=100)
    s.add_argument("--no-sharded", action="store_true",
                   help="force the single-card z-chunked path (the default "
                   "is one block per card: a single card runs unsharded "
                   "unless --mesh-shape is given)")
    s.add_argument("--no-extract", action="store_true")
    s.add_argument("--out", default=None)
    for sp in (t, s):
        sp.add_argument(
            "--mesh-shape", default=None, metavar="Z[,Y[,X]]|auto",
            help="block mesh shape for sharded runs, e.g. 4 (z blocks), "
            "2,4 (z,y blocks), 2,2,2, or 'auto' (z first, then x, then "
            "y); blocks are placed round-robin over the visible cards. "
            "Default: one block per card along z")
    s.add_argument("--piece-dir", default=None,
                   help="directory every process reaches, for the per-block "
                   "mesh pieces of a multi-process run")
    s.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="process 0's address: run this command once per "
                   "process with its --process-id")
    s.add_argument("--num-processes", type=int, default=None)
    s.add_argument("--process-id", type=int, default=None)
    for sp in (b, t, s):
        sp.add_argument("--device", default="cuda", help="torch device; "
                        "cpu runs the kernels' plain versions")
        sp.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace to DIR/trace.json")

    args = p.parse_args(argv)
    mesh_shape = getattr(args, "mesh_shape", None)
    if mesh_shape and mesh_shape != "auto":
        mesh_shape = tuple(int(x) for x in mesh_shape.split(","))
    if getattr(args, "coordinator", None) is not None:
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)
    with profiler_trace(args.profile):
        if args.cmd == "bunny":
            res = args.resolution
            if args.grid_n:
                res = max(hi - lo for lo, hi in
                          zip(BUNNY_BB_MIN, BUNNY_BB_MAX)) / args.grid_n
            out = run_bunny(
                out_dir=args.out, resolution=res, tsdf=args.tsdf,
                write_artifacts=not args.no_artifacts,
                checkpoint=args.checkpoint, resume=args.resume,
                sdf_scale=args.sdf_scale, engine=args.engine,
                device=args.device,
            )
        elif args.cmd == "turntable":
            out = run_turntable(
                n=args.n, n_views=args.views, out_dir=args.out,
                device=args.device,
                sharded=args.sharded or bool(mesh_shape),
                mesh_shape=mesh_shape or None)
        else:
            out = run_sweep(n=args.n, n_views=args.views,
                            sharded=not args.no_sharded,
                            extract=not args.no_extract, out_dir=args.out,
                            device=args.device, piece_dir=args.piece_dir,
                            mesh_shape=mesh_shape or None)
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
