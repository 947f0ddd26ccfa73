"""PLY / OBJ mesh I/O (reference: src/vacancy/mesh.cc:330-726), as
``vacancy_tpu/io/meshio.py``.

PLY files are written by the C++ library (``io/native.py``, built at first
use; a failed build raises) or, for a caller that passes ``native=False``,
by the numpy version, which writes the same bytes. ASCII PLY output keeps
the reference's header layout (mesh.cc:596-610); binary little-endian PLY
is supported besides, for speed at scale.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from ..mesh import Mesh


def write_ply(path: str, mesh: "Mesh", binary: bool = False,
              native: bool = True) -> None:
    if native:
        from .native import native_write_ply

        native_write_ply(path, mesh, binary=binary)
        return
    has_color = mesh.vertex_colors is not None
    v = np.ascontiguousarray(mesh.vertices, np.float32)
    f = np.ascontiguousarray(mesh.faces, np.int32)

    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header.append(f"element vertex {len(v)}")
    header += ["property float x", "property float y", "property float z"]
    if has_color:
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
            "property uchar alpha",
        ]
    header.append(f"element face {len(f)}")
    header.append("property list uchar int vertex_indices")
    header.append("end_header")

    if binary:
        with open(path, "wb") as fp:
            fp.write(("\n".join(header) + "\n").encode("ascii"))
            if has_color:
                c = np.clip(
                    np.round(mesh.vertex_colors), 0, 255
                ).astype(np.uint8)
                rec = np.zeros(
                    len(v),
                    dtype=[("xyz", "<f4", 3), ("rgba", "u1", 4)],
                )
                rec["xyz"] = v
                rec["rgba"][:, :3] = c
                rec["rgba"][:, 3] = 255
                fp.write(rec.tobytes())
            else:
                fp.write(v.astype("<f4").tobytes())
            frec = np.zeros(len(f), dtype=[("n", "u1"), ("idx", "<i4", 3)])
            frec["n"] = 3
            frec["idx"] = f
            fp.write(frec.tobytes())
        return

    # ASCII: vectorized row formatting (reference writes "%g"-style floats
    # via operator<<; np.format_float_positional differs slightly in digits
    # but parses identically).
    with open(path, "w") as fp:
        fp.write("\n".join(header) + "\n")
        if has_color:
            c = np.round(mesh.vertex_colors).astype(np.int32)
            rows = [
                f"{x:g} {y:g} {z:g} {r:d} {g:d} {b:d} 255 "
                for (x, y, z), (r, g, b) in zip(v.tolist(), c.tolist())
            ]
        else:
            rows = [f"{x:g} {y:g} {z:g} " for x, y, z in v.tolist()]
        fp.write("\n".join(rows))
        if rows:
            fp.write("\n")
        frows = [f"3 {a:d} {b:d} {c:d} " for a, b, c in f.tolist()]
        fp.write("\n".join(frows))
        if frows:
            fp.write("\n")


def load_ply(path: str) -> "Mesh":
    """Load ascii or binary_little_endian PLY (x/y/z + face list).

    Extends the reference loader (mesh.cc:475-581, ascii only) with binary
    support; extra vertex properties are skipped.
    """
    from ..mesh import Mesh
    from .native import native_parse_float3

    with open(path, "rb") as fp:
        if fp.readline().strip() != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = fp.readline().strip()
        if b"ascii" in fmt:
            binary = False
        elif b"binary_little_endian" in fmt:
            binary = True
        else:
            raise ValueError(f"unsupported ply format: {fmt!r}")

        n_vert = n_face = 0
        vert_props = []
        cur_element = None
        while True:
            line = fp.readline()
            if not line:
                raise ValueError("unexpected EOF in ply header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"element":
                cur_element = tok[1]
                if tok[1] == b"vertex":
                    n_vert = int(tok[2])
                elif tok[1] == b"face":
                    n_face = int(tok[2])
            elif tok[0] == b"property" and cur_element == b"vertex":
                vert_props.append((tok[1].decode(), tok[-1].decode()))
            elif tok[0] == b"end_header":
                break

        type_map = {
            "float": "<f4", "float32": "<f4", "double": "<f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
            "uint": "<u4", "uint32": "<u4",
        }
        if binary:
            dt = np.dtype([(n, type_map[t]) for t, n in vert_props])
            raw = np.frombuffer(fp.read(dt.itemsize * n_vert), dtype=dt)
            verts = np.stack(
                [raw["x"], raw["y"], raw["z"]], axis=-1
            ).astype(np.float32)
            frec = np.frombuffer(
                fp.read((1 + 12) * n_face),
                dtype=[("n", "u1"), ("idx", "<i4", 3)],
            )
            faces = frec["idx"].astype(np.int32)
        else:
            data = fp.read().split(b"\n")
            vrows = data[:n_vert]
            verts = native_parse_float3(b"\n".join(vrows), n_vert)
            if verts is None:
                vals = np.loadtxt(
                    [r for r in vrows], dtype=np.float32, ndmin=2
                )
                verts = vals[:, :3].astype(np.float32)
            frows = data[n_vert : n_vert + n_face]
            fvals = np.loadtxt([r for r in frows], dtype=np.int64, ndmin=2)
            if fvals.size and np.any(fvals[:, 0] != 3):
                raise ValueError("only triangle ply faces are supported")
            faces = fvals[:, 1:4].astype(np.int32)

    mesh = Mesh(vertices=verts, faces=faces)
    mesh.calc_normal()
    return mesh


def write_obj(path: str, mesh: "Mesh") -> None:
    """Write OBJ (reference mesh.cc:634-726, minus MTL/texture)."""
    v = mesh.vertices
    f = mesh.faces + 1  # OBJ is 1-indexed
    lines = [f"v {x:g} {y:g} {z:g}" for x, y, z in v.tolist()]
    if mesh.normals is not None:
        lines += [f"vn {x:g} {y:g} {z:g}" for x, y, z in mesh.normals.tolist()]
        lines += [
            f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in f.tolist()
        ]
    else:
        lines += [f"f {a} {b} {c}" for a, b, c in f.tolist()]
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")


def write_obj_textured(
    obj_dir: str,
    obj_basename: str,
    mesh: "Mesh",
    mtl_basename: str = "",
    tex_basename: str = "",
) -> None:
    """OBJ + MTL + diffuse-texture PNG (reference mesh.cc:634-726).

    Writes ``<obj_basename>.obj`` referencing ``<mtl>.mtl`` (defaults to
    the obj basename), the MTL's ``map_Kd`` pointing at ``<tex>.png``,
    and the texture image itself when the mesh carries one.
    """
    mtl_name = (mtl_basename or obj_basename) + ".mtl"
    tex_name = (tex_basename or obj_basename) + ".png"
    os.makedirs(obj_dir, exist_ok=True)

    v = mesh.vertices
    f = mesh.faces + 1
    lines = [f"mtllib ./{mtl_name}", ""]
    lines += [f"v {x:g} {y:g} {z:g} 1.0" for x, y, z in v.tolist()]
    has_uv = mesh.uv is not None and mesh.uv_indices is not None
    has_n = mesh.normals is not None
    if has_uv:
        lines += [f"vt {u:g} {w:g} 0" for u, w in mesh.uv.tolist()]
    if has_n:
        lines += [
            f"vn {x:g} {y:g} {z:g}" for x, y, z in mesh.normals.tolist()
        ]
    n_idx = (
        mesh.normal_indices + 1 if mesh.normal_indices is not None else f
    )
    uv_idx = mesh.uv_indices + 1 if has_uv else None
    for i in range(mesh.num_faces):
        parts = []
        for j in range(3):
            s = str(f[i, j])
            if has_uv or has_n:
                s += "/" + (str(uv_idx[i, j]) if has_uv else "")
                if has_n:
                    s += "/" + str(n_idx[i, j])
            parts.append(s)
        lines.append("f " + " ".join(parts))
    with open(os.path.join(obj_dir, obj_basename + ".obj"), "w") as fp:
        fp.write("\n".join(lines) + "\n")

    with open(os.path.join(obj_dir, mtl_name), "w") as fp:
        fp.write(
            "newmtl Textured\n"
            "Ka 1.000 1.000 1.000\n"
            "Kd 1.000 1.000 1.000\n"
            "Ks 0.000 0.000 0.000\n"
            "d 1.0\n"
            "illum 2\n"
            f"map_Kd {tex_name}\n"
        )

    if mesh.diffuse_texture is not None:
        from .image import write_png

        write_png(os.path.join(obj_dir, tex_name), mesh.diffuse_texture)


def load_obj(path: str) -> "Mesh":
    """OBJ reader: v / vt / vn / f records with slash-separated indices
    (the reference gates its reader behind tinyobjloader,
    mesh.cc:330-473); faces are fan-triangulated."""
    from ..mesh import Mesh

    verts, uvs, normals = [], [], []
    faces, uv_faces, n_faces = [], [], []
    with open(path) as fp:
        for line in fp:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                uvs.append([float(x) for x in tok[1:3]])
            elif tok[0] == "vn":
                normals.append([float(x) for x in tok[1:4]])
            elif tok[0] == "f":
                vi, ti, ni = [], [], []
                for t in tok[1:]:
                    comp = t.split("/")
                    vi.append(int(comp[0]) - 1)
                    ti.append(
                        int(comp[1]) - 1
                        if len(comp) > 1 and comp[1]
                        else -1
                    )
                    ni.append(
                        int(comp[2]) - 1
                        if len(comp) > 2 and comp[2]
                        else -1
                    )
                for i in range(1, len(vi) - 1):  # fan-triangulate
                    faces.append([vi[0], vi[i], vi[i + 1]])
                    uv_faces.append([ti[0], ti[i], ti[i + 1]])
                    n_faces.append([ni[0], ni[i], ni[i + 1]])
    mesh = Mesh(
        vertices=np.asarray(verts, np.float32).reshape(-1, 3),
        faces=np.asarray(faces, np.int32).reshape(-1, 3),
    )
    if uvs and all(t >= 0 for row in uv_faces for t in row):
        mesh.uv = np.asarray(uvs, np.float32).reshape(-1, 2)
        mesh.uv_indices = np.asarray(uv_faces, np.int32).reshape(-1, 3)
    if normals and all(n >= 0 for row in n_faces for n in row):
        per_face = np.asarray(n_faces, np.int32).reshape(-1, 3)
        src = np.asarray(normals, np.float32).reshape(-1, 3)
        if len(src) == mesh.num_vertices:
            # common case: one normal per vertex
            mesh.normals = src
            mesh.normal_indices = per_face
            return mesh
    mesh.calc_normal()
    return mesh
