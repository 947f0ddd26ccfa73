"""Two processes over gloo, four CPU blocks each: an 8-block mesh that
spans processes (``tests/test_distributed.py`` and its worker, for the
port). This file is its own worker: the test starts it twice with

    python tests/test_torch_distributed.py RANK WORLD PORT DIR

Each rank runs ``initialize_distributed`` -> sharded fusion (exact and
warp engines) on a z mesh of 8 -> a per-process checkpoint round trip ->
sharded MC, with per-block pieces and assembly on process 0 -> the same
on a (2, 4) mesh (each process one z row of four y blocks), and process 0
writes the meshes.

Bar: every mesh equals the single-process dense extraction byte for byte,
each rank's blocks equal the dense state's slices bit for bit, and the
other rank gets None. The workers get 300 s together: a hang fails here
instead of eating the suite's clock."""

import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _scene():
    """The 16^3 grid and three views of ``tests/test_sharding.py``, from
    numpy alone (the workers import no JAX)."""
    import torch

    from vacancy_tpu_torch.camera import PinholeCamera, stack_cameras
    from vacancy_tpu_torch.config import VoxelUpdateOption
    from vacancy_tpu_torch.grid import GridSpec

    rng = np.random.default_rng(0)
    grid = GridSpec((-1.0, -1.0, -1.0), (1.01, 1.01, -1.0 + 16 * 0.125 + 0.01),
                    0.125)
    assert grid.shape_zyx == (16, 16, 16)
    h, w = 20, 28
    cams = []
    for i in range(3):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.2 * i - 0.2, 0.1, -4.0 - 0.3 * i]
        cams.append(PinholeCamera.create(
            w, h, c2w=c2w, principal_point=np.array([13.5, 9.5], np.float32),
            focal_length=np.array([25.0, 25.0], np.float32), device="cpu"))
    cam = stack_cameras(cams)
    imgs = torch.from_numpy(rng.normal(size=(3, h, w)).astype(np.float32))
    views = (cam.w2c, cam.principal_point, cam.focal_length, imgs)
    return grid, views, (0, 0, w - 1, h - 1), VoxelUpdateOption()


def _dense(grid, views, roi, opt):
    from vacancy_tpu_torch.grid import VoxelGridState
    from vacancy_tpu_torch.ops.fusion import carve_views
    from vacancy_tpu_torch.ops.fusion_warp import carve_views_warp

    new = lambda: VoxelGridState.create(grid, "cpu")  # noqa: E731
    return (carve_views(new(), grid, *views, roi, opt),
            carve_views_warp(new(), grid, *views, opt=opt))


def _assert_blocks(sh, dense):
    import torch

    assert len(sh.blocks) == 4
    for b, st in sh.blocks.items():
        sl = sh.sharding.slices(b, sh.shape)
        assert torch.equal(st.update_num, dense.update_num[sl])
        assert torch.equal(st.sdf.view(torch.int32),
                           dense.sdf[sl].contiguous().view(torch.int32))


def worker(rank: int, world: int, port: int, tmp: str) -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    import torch

    from vacancy_tpu_torch import parallel as par
    from vacancy_tpu_torch.checkpoint import load_state, save_state
    from vacancy_tpu_torch.grid import VoxelGridState

    torch.set_num_threads(2)
    par.initialize_distributed(f"localhost:{port}", world, rank)
    grid, views, roi, opt = _scene()
    dense, dense_w = _dense(grid, views, roi, opt)

    def save_mesh(name, mesh):
        if rank == 0:
            assert mesh is not None
            np.savez(os.path.join(tmp, f"{name}.npz"), vertices=mesh.vertices,
                     faces=mesh.faces)
        else:
            assert mesh is None

    for tag, shape in (("z8", (8,)), ("zy24", (2, 4))):
        mesh = par.make_device_mesh(shape=shape, devices=["cpu"] * 4)
        assert (mesh.rank, mesh.world_size, mesh.size) == (rank, world, 8)
        assert par.pick_transport(mesh).name == "gloo"
        sharding = par.grid_sharding(mesh)
        state = par.carve_views_sharded(
            VoxelGridState.create(grid, sharding=sharding), grid, *views, roi,
            opt, mesh=mesh)
        _assert_blocks(state, dense)
        state_w = par.carve_views_warp_sharded(
            VoxelGridState.create(grid, sharding=sharding), grid, *views,
            opt=opt, mesh=mesh)
        _assert_blocks(state_w, dense_w)

        # per-process checkpoint round trip: blocks keyed by (z, y, x)
        ckpt = os.path.join(tmp, f"ckpt_{tag}")
        save_state(ckpt, state_w, grid, next_view=3)
        assert os.path.exists(f"{ckpt}.proc{rank}.npz")
        back, grid2, next_view, _ = load_state(ckpt, sharding=sharding)
        assert next_view == 3 and grid2 == grid
        assert sorted(back.blocks) == sorted(state_w.blocks)
        _assert_blocks(back, dense_w)

        # sharded MC: per-block pieces, assembly on process 0
        save_mesh(f"fused_{tag}", par.extract_mesh_sharded(
            back, grid, mesh, engine="fused",
            piece_dir=os.path.join(tmp, f"pieces_fused_{tag}")))
        assert par.halo_exchange.last["transport"] == "gloo"
        assert par.halo_exchange.last["bytes"] > 0
        assert os.path.exists(os.path.join(
            tmp, f"pieces_fused_{tag}", f"mc_fused_pieces_proc{rank}.npz"))
        save_mesh(f"exact_{tag}", par.extract_mesh_sharded(
            state, grid, mesh, piece_dir=os.path.join(tmp, f"pieces_{tag}")))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(f"proc {rank}: OK", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed(tmp_path):
    from vacancy_tpu_torch.ops.marching_cubes import extract_mesh

    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE)] + env.get("PYTHONPATH", "").split(os.pathsep)
    ).rstrip(os.pathsep)
    logs = [tmp_path / f"worker{r}.log" for r in (0, 1)]
    files = [open(path, "w") for path in logs]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
             str(tmp_path)], env=env, stdout=f, stderr=subprocess.STDOUT)
        for r, f in zip((0, 1), files)
    ]
    deadline = time.monotonic() + 300
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p, f in zip(procs, files):
            if p.poll() is None:  # a hang: fail, do not wait for it
                p.kill()
                p.wait()
            f.close()
    for r, (p, path) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"proc {r} failed:\n{path.read_text()[-3000:]}"
        assert f"proc {r}: OK" in path.read_text()

    # reference: the identical workload, single process, dense
    grid, views, roi, opt = _scene()
    dense, dense_w = _dense(grid, views, roi, opt)
    want = {"exact": extract_mesh(dense, grid),
            "warp": extract_mesh(dense_w, grid)}
    assert want["exact"].num_faces > 0 and want["warp"].num_faces > 0
    for name, ref in (("exact_z8", "exact"), ("fused_z8", "warp"),
                      ("exact_zy24", "exact"), ("fused_zy24", "warp")):
        with np.load(tmp_path / f"{name}.npz") as z:
            np.testing.assert_array_equal(
                z["vertices"].view(np.int32),
                want[ref].vertices.view(np.int32), err_msg=name)
            np.testing.assert_array_equal(z["faces"], want[ref].faces,
                                          err_msg=name)


def test_initialize_distributed_needs_its_three_arguments():
    """Nothing on a machine tells a process of a cluster, so there is no
    auto-detection to fall back on."""
    import pytest

    from vacancy_tpu_torch import parallel as par

    with pytest.raises(ValueError, match="coordinator_address"):
        par.initialize_distributed()
    with pytest.raises(ValueError, match="coordinator_address"):
        par.initialize_distributed("localhost:1", 2)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
