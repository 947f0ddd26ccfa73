"""Marching-cubes extraction (``vacancy_tpu/ops/marching_cubes.py``).

Every vertex lies on a unique canonical grid edge ``(axis, owner voxel)``
(the edge from a voxel centre to its +axis neighbour), so vertices are
welded by construction and their order is structural: axis-major, then
flat (z, y, x) order of the owner voxel. Faces come cube-major, then by
table slot.

The port has one engine: the fused marching-cubes kernel B
(``ops/mc_fused.py``; its plain version on a CPU state), whose four
compacted streams become the mesh. On a CUDA state they stay on the card,
where the kernels of ``ops/mesh_assembly.py`` build the vertex and face
arrays, and only those two arrays are copied to the host. On a CPU state
the host assembles the streams (``assemble_fused_streams``, the plain
version the card is held against). The JAX package keeps a second engine
in XLA ops, for the CPU, where its Pallas kernel runs interpreted, and for
planes past its VMEM budget; the port needs neither, since the plain
version runs on CPU tensors and the CUDA kernel has no plane limit.
``ENGINES`` holds the JAX package's engine names, which all name that one
mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import GridSpec, VoxelGridState
from ..mesh import Mesh
from ..utils.timing import span
from .mc_fused import assemble_fused_streams, marching_cubes_fused
from .mesh_assembly import assemble_on_card

# the engine names callers may pass; every one is the fused engine
ENGINES = ("auto", "fused", "xla")


def check_engine(engine: str) -> None:
    """Raise ``ValueError`` unless ``engine`` is one of ``ENGINES``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")


def extract_mesh(
    state: VoxelGridState,
    grid: GridSpec,
    iso_level: float = 0.0,
    linear_interp: bool = True,
    engine: str = "auto",
) -> Mesh:
    """The iso-surface of ``state`` as a host ``Mesh``, from the fused
    marching-cubes kernel on a CUDA state (its plain version on a CPU
    state). On a CUDA state the mesh is assembled on the card
    (``assemble_on_card``) and its two arrays copied to the host; on a CPU
    state the four streams are assembled on the host. ``engine`` is any of
    ``ENGINES``; each gives this mesh."""
    check_engine(engine)
    _, ny, nx = state.sdf.shape
    dev = state.sdf.device
    with span("mc_b"):
        centers = [grid.axis_centers_t(a, dev) for a in range(3)]
        st = marching_cubes_fused(state.sdf, state.update_num, *centers,
                                  iso_level, linear_interp)
    if dev.type == "cuda":
        verts, faces = assemble_on_card(st, ny, nx, *centers)
        with span("stream_copy"):
            return Mesh(vertices=verts.cpu().numpy(),
                        faces=faces.cpu().numpy())
    with span("stream_copy"):
        host = [t.cpu().numpy() for t in st.as_tuple()[:8]]
        vpos_parts = host[0:6:2]
        vlin_parts = [v.astype(np.int64) for v in host[1:6:2]]
    return assemble_fused_streams(
        vpos_parts, vlin_parts, host[6], host[7], ny, nx, grid
    )


def marching_cubes_dense(
    state: VoxelGridState,
    grid: GridSpec,
    iso_level: float = 0.0,
    linear_interp: bool = True,
):
    """``extract_mesh``'s mesh in the JAX routine's form:
    ``((vx, vy, vz), n_vertices, (fa, fb, fc), n_faces)``, the vertex
    position components f32[n_vertices] and the per-face vertex ids
    i32[n_faces] on the state's device, sized by the counts."""
    mesh = extract_mesh(state, grid, iso_level, linear_interp)
    dev = state.sdf.device

    def columns(a: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a.T)).to(dev).unbind(0)

    return (columns(mesh.vertices), mesh.num_vertices, columns(mesh.faces),
            mesh.num_faces)
