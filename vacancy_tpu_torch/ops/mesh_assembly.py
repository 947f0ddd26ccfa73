"""The marching-cubes mesh assembled on the card from kernel B's streams.

The kernels (``csrc/mesh_assembly.cu``) have no TPU counterpart: the JAX
package, and the port on a CPU state, assemble the streams on the host
(``ops/mc_fused.assemble_fused_streams``). On a CUDA state
``ops/marching_cubes.extract_mesh`` leaves B's eight streams where they
are and calls ``assemble_on_card``: one elementwise pass builds the
vertices f32[V, 3] (the stream's position on the edge's axis, the grid's
axis centres on the other two); a pass over the cubes sums their triangle
counts per CTA and one CTA scans those sums into each CTA's offset and the
face count, which is read back once to size the faces; the face pass
expands every cube into its faces at its offset, each corner resolved to a
vertex id by binary search over the ascending lin streams. The bytes equal
``assemble_fused_streams(..., native=False)``'s, its plain version, which
the ``cuda`` tests hold it against.

The triangle table, the triangle counts, each edge's axis and each edge's
owner offset come from ``ops/mc_tables.py`` in one int32 array, copied to
each device once (``mesh_tables``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .. import _kernels
from ..utils.timing import span
from .mc_fused import McStreams
from .mc_tables import (CORNER_OFFSETS, EDGE_AXIS, EDGE_OWNER, TRI_COUNT,
                        TRI_TABLE)

# cubes per CTA of the face passes (csrc/mesh_assembly.cu's CUBES_PER_CTA)
CUBES_PER_CTA = 256

# the parts of the tables array, in csrc/mesh_assembly.cu's order (T_*)
TABLE_PARTS = (
    ("tri_table", TRI_TABLE),  # [256, 16] edge ids, -1 past the last face
    ("tri_count", TRI_COUNT),  # [256] faces per case
    ("edge_axis", EDGE_AXIS),  # [12] the axis of each cube edge
    ("edge_owner_xyz", CORNER_OFFSETS[EDGE_OWNER]),  # [12, 3] (dx, dy, dz)
)


@functools.lru_cache(maxsize=None)
def mesh_tables(device: torch.device) -> torch.Tensor:
    """The kernels' tables on ``device``: the ``TABLE_PARTS`` flattened
    and concatenated into one int32 tensor, made once per device."""
    flat = np.concatenate([np.asarray(a, np.int32).ravel()
                           for _, a in TABLE_PARTS])
    return torch.from_numpy(flat).to(device)


@functools.lru_cache(maxsize=None)
def _check_layout() -> None:
    """Once per process: the built kernels take CTAs of this module's
    size and read tables of its size."""
    lib = _kernels.load()
    got = (lib.vt_mesh_layout(0), lib.vt_mesh_layout(1))
    want = (CUBES_PER_CTA, sum(a.size for _, a in TABLE_PARTS))
    if got != want:
        raise RuntimeError(f"csrc/mesh_assembly.cu's layout {got} differs "
                           f"from ops/mesh_assembly.py's {want}")


def assemble_on_card(st: McStreams, ny: int, nx: int, cx: torch.Tensor,
                     cy: torch.Tensor, cz: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vertices f32[V, 3], faces i32[F, 3]) on the streams' CUDA device
    from kernel B's unsharded streams of a grid with planes of ``ny`` x
    ``nx`` and axis centres ``cx``, ``cy``, ``cz``: the mesh of
    ``assemble_fused_streams(..., native=False)``, byte for byte.

    Launches the vertex pass, then (span ``vt.expand_faces``) the face
    offsets, reads the face count back and launches the face pass, all
    inside span ``vt.assemble``; ``assemble_on_card.meshes`` counts the
    meshes built. Raises on a tensor that is not on a CUDA device (a CPU
    state takes the host assembly), on a build failure or on a non-zero
    cudaError_t."""
    nvs = [t.numel() for t in (st.vx_lin, st.vy_lin, st.vz_lin)]
    nc = st.c_lin.numel()
    dev = st.c_lin.device
    for name, t, dtype, n in (
            ("vx_pos", st.vx_pos, torch.float32, nvs[0]),
            ("vx_lin", st.vx_lin, torch.int32, nvs[0]),
            ("vy_pos", st.vy_pos, torch.float32, nvs[1]),
            ("vy_lin", st.vy_lin, torch.int32, nvs[1]),
            ("vz_pos", st.vz_pos, torch.float32, nvs[2]),
            ("vz_lin", st.vz_lin, torch.int32, nvs[2]),
            ("c_lin", st.c_lin, torch.int32, nc),
            ("c_case", st.c_case, torch.int32, nc),
            ("cx", cx, torch.float32, nx), ("cy", cy, torch.float32, ny),
            ("cz", cz, torch.float32, cz.numel())):
        _kernels.check_tensor(name, t, dtype, (n,))
    if sum(nvs) >= 2**31:
        raise ValueError(f"{sum(nvs)} vertices: face ids are int32")
    lib = _kernels.load()
    _check_layout()
    tables = mesh_tables(dev)
    stream = _kernels.stream_ptr(dev)
    with span("assemble"):
        verts = torch.empty((sum(nvs), 3), dtype=torch.float32, device=dev)
        _kernels.check(lib.vt_mesh_vertices(
            st.vx_pos.data_ptr(), st.vx_lin.data_ptr(), nvs[0],
            st.vy_pos.data_ptr(), st.vy_lin.data_ptr(), nvs[1],
            st.vz_pos.data_ptr(), st.vz_lin.data_ptr(), nvs[2],
            cx.data_ptr(), cy.data_ptr(), cz.data_ptr(), ny, nx,
            verts.data_ptr(), stream), "mesh_assembly vertex launch")
        with span("expand_faces"):
            offsets = torch.empty(-(-nc // CUBES_PER_CTA),
                                  dtype=torch.int64, device=dev)
            total = torch.empty(1, dtype=torch.int64, device=dev)
            _kernels.check(lib.vt_mesh_face_offsets(
                st.c_case.data_ptr(), nc, tables.data_ptr(),
                offsets.data_ptr(), total.data_ptr(), stream),
                "mesh_assembly face offsets launch")
            faces = torch.empty((int(total.item()), 3), dtype=torch.int32,
                                device=dev)
            _kernels.check(lib.vt_mesh_faces(
                st.c_lin.data_ptr(), st.c_case.data_ptr(), nc,
                offsets.data_ptr(), tables.data_ptr(),
                st.vx_lin.data_ptr(), nvs[0], st.vy_lin.data_ptr(), nvs[1],
                st.vz_lin.data_ptr(), nvs[2], ny, nx, faces.data_ptr(),
                stream), "mesh_assembly face launch")
    assemble_on_card.meshes += 1
    return verts, faces


assemble_on_card.meshes = 0
