"""The marching-cubes mesh assembled on the card (``ops/mesh_assembly.py``)
against the host's plain assembly of the same streams.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_mesh_assembly.py -m cuda

There the vertex and face arrays that ``extract_mesh`` builds on the card
must equal ``assemble_fused_streams(..., native=False)`` of kernel B's
streams array for array, bit for bit. On a machine without a card the
``cuda`` tests skip; the rest check that the tables are
``ops/mc_tables.py``'s, that the wrapper refuses a tensor off a CUDA
device, and that a CPU state keeps the host assembly.
"""

import numpy as np
import pytest
import torch

from vacancy_tpu_torch import VoxelCarver, VoxelCarverOption
from vacancy_tpu_torch.config import INVALID_SDF
from vacancy_tpu_torch.grid import GridSpec, VoxelGridState, state_from_numpy
from vacancy_tpu_torch.mesh import Mesh
from vacancy_tpu_torch.ops import mc_fused, mc_tables, mesh_assembly
from vacancy_tpu_torch.ops.marching_cubes import extract_mesh
from vacancy_tpu_torch.ops.mesh_assembly import assemble_on_card


def _random_state(shape, device, seed=5):
    """A random state with a border of 1.0, 5% invalid voxels and 10% not
    updated, and its unit grid."""
    nz, ny, nx = shape
    rng = np.random.default_rng(seed)
    sdf = rng.normal(size=shape).astype(np.float32)
    sdf[[0, -1], :, :] = 1.0
    sdf[:, [0, -1], :] = 1.0
    sdf[:, :, [0, -1]] = 1.0
    sdf[rng.random(shape) < 0.05] = INVALID_SDF
    un = (rng.random(shape) < 0.9).astype(np.int32)
    grid = GridSpec((0.0,) * 3, (nx + 0.4, ny + 0.4, nz + 0.4), 1.0)
    assert grid.shape_zyx == shape
    return state_from_numpy(sdf, un, device), grid


def _host_plain_mesh(state, grid, iso_level=0.0, linear=True) -> Mesh:
    """Kernel B's streams (the plain version's on a CPU state) copied to
    the host and assembled there by the numpy plain version."""
    dev = state.sdf.device
    st = mc_fused.marching_cubes_fused(
        state.sdf, state.update_num,
        *(grid.axis_centers_t(a, dev) for a in range(3)), iso_level, linear)
    host = [t.cpu().numpy() for t in st.as_tuple()[:8]]
    return mc_fused.assemble_fused_streams(
        host[0:6:2], [v.astype(np.int64) for v in host[1:6:2]], host[6],
        host[7], *state.sdf.shape[1:], grid, native=False)


def _assert_bytes_equal(got: Mesh, want: Mesh):
    assert got.vertices.dtype == want.vertices.dtype == np.float32
    assert got.faces.dtype == want.faces.dtype == np.int32
    assert got.vertices.shape == want.vertices.shape
    assert got.faces.shape == want.faces.shape
    assert np.array_equal(got.vertices.view(np.int32),
                          want.vertices.view(np.int32))
    assert np.array_equal(got.faces, want.faces)


def test_tables_are_mc_tables_arrays():
    tables = mesh_assembly.mesh_tables(torch.device("cpu"))
    assert tables.dtype == torch.int32 and tables.dim() == 1
    assert tables is mesh_assembly.mesh_tables(torch.device("cpu"))
    want = {
        "tri_table": mc_tables.TRI_TABLE,
        "tri_count": mc_tables.TRI_COUNT,
        "edge_axis": mc_tables.EDGE_AXIS,
        "edge_owner_xyz":
            mc_tables.CORNER_OFFSETS[mc_tables.EDGE_OWNER],
    }
    assert [name for name, _ in mesh_assembly.TABLE_PARTS] == list(want)
    assert tables.numel() == sum(a.size for a in want.values())
    parts, at = {}, 0
    for name, a in want.items():
        parts[name] = tables[at:at + a.size].reshape(a.shape).numpy()
        assert np.array_equal(parts[name], a), name
        at += a.size
    # each edge's owner offset, as a flat-id offset, is the host's
    xyz = parts["edge_owner_xyz"]
    assert np.array_equal(xyz[:, 2] * 7 * 9 + xyz[:, 1] * 9 + xyz[:, 0],
                          mc_fused._edge_off_lin(7, 9))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_assemble_on_card_refuses_tensors_off_the_card(device):
    state, grid = _random_state((6, 7, 8), "cpu")
    centers = [grid.axis_centers_t(a, "cpu") for a in range(3)]
    st = mc_fused.marching_cubes_fused(state.sdf, state.update_num, *centers)
    assert st.c_lin.numel() > 0
    st = mc_fused.McStreams(*(t.to(device) for t in st.as_tuple()))
    before = assemble_on_card.meshes
    with pytest.raises(ValueError, match="CUDA"):
        assemble_on_card(st, 7, 8, *(c.to(device) for c in centers))
    assert assemble_on_card.meshes == before


@pytest.mark.parametrize("iso", [0.0, 0.25])
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
def test_extract_mesh_on_a_cpu_state_takes_the_host_assembly(linear, iso):
    state, grid = _random_state((9, 21, 13), "cpu", seed=3)
    before = assemble_on_card.meshes
    mesh = extract_mesh(state, grid, iso_level=iso, linear_interp=linear)
    assert assemble_on_card.meshes == before
    assert mesh.num_faces > 0
    _assert_bytes_equal(mesh, _host_plain_mesh(state, grid, iso, linear))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("iso", [0.0, 0.25])
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
@pytest.mark.parametrize("shape", [(16, 12, 20), (9, 21, 13), (40, 64, 512)])
def test_on_card_mesh_equals_host_plain_assembly(cuda_device, shape, linear,
                                                 iso):
    """Random states; the largest has hundreds of thousands of cubes, so
    the face offsets' one CTA scans its sums in several rounds."""
    state, grid = _random_state(shape, cuda_device)
    before = assemble_on_card.meshes
    mesh = extract_mesh(state, grid, iso_level=iso, linear_interp=linear)
    assert assemble_on_card.meshes == before + 1
    want = _host_plain_mesh(state, grid, iso, linear)
    assert want.num_faces > 0
    _assert_bytes_equal(mesh, want)
    # and the plain streams of the same state on the CPU give that mesh
    cpu = VoxelGridState(state.sdf.cpu(), state.update_num.cpu())
    _assert_bytes_equal(mesh, _host_plain_mesh(cpu, grid, iso, linear))


@pytest.mark.cuda
def test_on_card_arrays_stay_on_the_card(cuda_device):
    state, grid = _random_state((16, 12, 20), cuda_device, seed=8)
    centers = [grid.axis_centers_t(a, cuda_device) for a in range(3)]
    st = mc_fused.marching_cubes_fused(state.sdf, state.update_num, *centers)
    verts, faces = assemble_on_card(st, 12, 20, *centers)
    assert verts.device.type == faces.device.type == "cuda"
    assert verts.dtype == torch.float32 and faces.dtype == torch.int32
    want = _host_plain_mesh(state, grid)
    _assert_bytes_equal(Mesh(vertices=verts.cpu().numpy(),
                             faces=faces.cpu().numpy()), want)
    assert int(faces.min()) >= 0 and int(faces.max()) < verts.shape[0]


@pytest.mark.cuda
def test_on_card_mesh_of_an_empty_grid(cuda_device):
    grid = GridSpec((0.0,) * 3, (9.4, 8.4, 7.4), 1.0)
    state = VoxelGridState.create(grid, cuda_device)
    before = assemble_on_card.meshes
    mesh = extract_mesh(state, grid)
    assert assemble_on_card.meshes == before + 1
    assert mesh.vertices.shape == (0, 3) and mesh.faces.shape == (0, 3)
    assert mesh.faces.dtype == np.int32


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [True, False], ids=["linear", "nointerp"])
def test_on_card_mesh_of_a_one_voxel_surface(cuda_device, linear):
    shape = (24, 40, 52)
    sdf = np.full(shape, 0.5, np.float32)
    sdf[10, 12, 45] = -0.5
    grid = GridSpec((0.0,) * 3, (52.4, 40.4, 24.4), 1.0)
    state = state_from_numpy(sdf, np.ones(shape, np.int32), cuda_device)
    mesh = extract_mesh(state, grid, linear_interp=linear)
    # the eight cubes around the voxel, one face each: a closed octahedron
    assert (mesh.num_vertices, mesh.num_faces) == (6, 8)
    _assert_bytes_equal(mesh, _host_plain_mesh(state, grid, 0.0, linear))


@pytest.mark.cuda
def test_counter_counts_each_cuda_extract(cuda_device):
    """The facade's ``extract_iso_surface`` on a CUDA state engages the
    on-card assembly once a call; a CPU carver never does."""
    for device, per_call in ((cuda_device, 1), (torch.device("cpu"), 0)):
        carver = VoxelCarver(VoxelCarverOption(), device=device)
        carver.restore(*_random_state((16, 12, 20), device, seed=11))
        before = assemble_on_card.meshes
        meshes = [carver.extract_iso_surface() for _ in range(3)]
        assert assemble_on_card.meshes == before + 3 * per_call
        assert meshes[0].num_faces > 0
        for m in meshes[1:]:
            _assert_bytes_equal(m, meshes[0])


@pytest.mark.cuda
def test_on_card_mesh_of_the_1024_sweep(cuda_device):
    """The sweep's 1024^3 state (100 views of the six-sphere blob, carved
    as ``pipeline sweep`` carves it): kernel B's whole mesh, 4,371,280
    faces, assembled on the card == the host's plain assembly."""
    from vacancy_tpu_torch import pipeline
    from vacancy_tpu_torch.config import SdfInterpolation
    from vacancy_tpu_torch.ops.fusion_warp import carve_views_warp_blocked

    grid, opt, cams, imgs = pipeline.turntable_inputs(1024, 100, True,
                                                      cuda_device)
    state = carve_views_warp_blocked(
        VoxelGridState.create(grid, cuda_device), grid, cams.w2c,
        cams.principal_point, cams.focal_length, imgs, opt=opt,
        linear=opt.sdf_interp == SdfInterpolation.BILINEAR)
    del imgs
    mesh = extract_mesh(state, grid)
    assert (mesh.num_vertices, mesh.num_faces) == (2_188_746, 4_371_280)
    _assert_bytes_equal(mesh, _host_plain_mesh(state, grid))
