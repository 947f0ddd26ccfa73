"""Marching-cubes extraction (``vacancy_tpu/ops/marching_cubes.py``).

Every vertex lies on a unique canonical grid edge ``(axis, owner voxel)``
(the edge from a voxel centre to its +axis neighbour), so vertices are
welded by construction and their order is structural: axis-major, then
flat (z, y, x) order of the owner voxel. Faces come cube-major, then by
table slot.

The port has one engine: the fused marching-cubes kernel
(``ops/mc_fused.py``; its plain version on a CPU state), whose four
compacted streams are copied to the host once and assembled there. The
JAX package keeps a second engine in XLA ops, for the CPU, where its
Pallas kernel runs interpreted, and for planes past its VMEM budget; the
port needs neither, since the plain version runs on CPU tensors and the
CUDA kernel has no plane limit. ``ENGINES`` holds the JAX package's
engine names, which all name that one mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import GridSpec, VoxelGridState
from ..mesh import Mesh
from ..utils.timing import span
from .mc_fused import assemble_fused_streams, marching_cubes_fused

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
    """The iso-surface of ``state`` as a host ``Mesh``: the fused
    marching-cubes kernel on a CUDA state (its plain version on a CPU
    state), the four streams copied to the host once and assembled there.
    ``engine`` is any of ``ENGINES``; each gives this mesh."""
    check_engine(engine)
    _, ny, nx = state.sdf.shape
    dev = state.sdf.device
    with span("mc_b"):
        st = marching_cubes_fused(
            state.sdf, state.update_num, grid.axis_centers_t(0, dev),
            grid.axis_centers_t(1, dev), grid.axis_centers_t(2, dev),
            iso_level, linear_interp,
        )
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
