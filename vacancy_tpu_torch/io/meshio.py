"""PLY mesh I/O in numpy (reference: src/vacancy/mesh.cc:475-610).

The header layout and record formats are those of
``vacancy_tpu/io/meshio.py``'s numpy path, so both packages write the same
bytes for the same mesh.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from ..mesh import Mesh

_FACE_REC = np.dtype([("n", "u1"), ("idx", "<i4", 3)])


def write_ply(path: str, mesh: "Mesh", binary: bool = False) -> None:
    v = np.ascontiguousarray(mesh.vertices, np.float32)
    f = np.ascontiguousarray(mesh.faces, np.int32)
    header = [
        "ply",
        "format binary_little_endian 1.0" if binary else "format ascii 1.0",
        f"element vertex {len(v)}",
        "property float x",
        "property float y",
        "property float z",
        f"element face {len(f)}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    if binary:
        with open(path, "wb") as fp:
            fp.write(("\n".join(header) + "\n").encode("ascii"))
            fp.write(v.astype("<f4").tobytes())
            frec = np.zeros(len(f), dtype=_FACE_REC)
            frec["n"] = 3
            frec["idx"] = f
            fp.write(frec.tobytes())
        return
    with open(path, "w") as fp:
        fp.write("\n".join(header) + "\n")
        rows = [f"{x:g} {y:g} {z:g} " for x, y, z in v.tolist()]
        fp.write("\n".join(rows))
        if rows:
            fp.write("\n")
        frows = [f"3 {a:d} {b:d} {c:d} " for a, b, c in f.tolist()]
        fp.write("\n".join(frows))
        if frows:
            fp.write("\n")


def load_ply(path: str) -> "Mesh":
    """Read an ascii or binary_little_endian PLY with float x/y/z vertices
    and triangle faces (the layout ``write_ply`` writes)."""
    from ..mesh import Mesh

    with open(path, "rb") as fp:
        if fp.readline().strip() != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = fp.readline().strip()
        if fmt not in (b"format ascii 1.0",
                       b"format binary_little_endian 1.0"):
            raise ValueError(f"unsupported ply format: {fmt!r}")
        binary = b"binary" in fmt
        counts = {}
        vert_props = []
        while True:
            tok = fp.readline().split()
            if not tok:
                raise ValueError("unexpected end of ply header")
            if tok[0] == b"element":
                counts[tok[1]] = int(tok[2])
            elif tok[0] == b"property" and len(counts) == 1:
                vert_props.append(tok[-1])
            elif tok[0] == b"end_header":
                break
        if vert_props != [b"x", b"y", b"z"]:
            raise ValueError(f"unsupported vertex properties {vert_props}")
        n_vert, n_face = counts.get(b"vertex", 0), counts.get(b"face", 0)
        if binary:
            verts = np.frombuffer(fp.read(12 * n_vert), "<f4").reshape(-1, 3)
            frec = np.frombuffer(fp.read(13 * n_face), dtype=_FACE_REC)
            if np.any(frec["n"] != 3):
                raise ValueError("only triangle ply faces are supported")
            faces = frec["idx"]
        else:
            lines = fp.read().split(b"\n")
            verts = np.array(
                [ln.split() for ln in lines[:n_vert]], np.float32
            ).reshape(-1, 3)
            fvals = np.array(
                [ln.split() for ln in lines[n_vert : n_vert + n_face]],
                np.int64,
            ).reshape(-1, 4)
            if np.any(fvals[:, 0] != 3):
                raise ValueError("only triangle ply faces are supported")
            faces = fvals[:, 1:]
    return Mesh(vertices=verts, faces=faces)
