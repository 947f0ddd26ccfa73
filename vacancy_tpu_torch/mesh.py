"""Triangle-mesh container with PLY/OBJ I/O (host-side numpy arrays), as
``vacancy_tpu/mesh.py``.

Stands for the reference ``Mesh`` class (``include/vacancy/mesh.h:23-92``,
``src/vacancy/mesh.cc``). Vertex dedup is the C++ library's O(n) hash weld
(``io/native.py``, built at first use), with an O(n log n) numpy weld as
its plain version, instead of the reference's O(n^2) scan
(``mesh.cc:115-146``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class MeshStats:
    bb_min: np.ndarray
    bb_max: np.ndarray
    center: np.ndarray


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.float32)
    )
    faces: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.int32)
    )
    vertex_colors: Optional[np.ndarray] = None  # f32[N, 3] in [0, 255]
    normals: Optional[np.ndarray] = None  # f32[N, 3] per-vertex
    face_normals: Optional[np.ndarray] = None  # f32[M, 3]
    uv: Optional[np.ndarray] = None  # f32[K, 2]
    uv_indices: Optional[np.ndarray] = None  # i32[M, 3]
    normal_indices: Optional[np.ndarray] = None  # i32[M, 3]
    diffuse_texture: Optional[np.ndarray] = None  # uint8[H, W, 3]

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, np.float32).reshape(
            -1, 3
        )
        self.faces = np.ascontiguousarray(self.faces, np.int32).reshape(-1, 3)

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_faces(self) -> int:
        return len(self.faces)

    def clear(self) -> None:
        self.vertices = np.zeros((0, 3), np.float32)
        self.faces = np.zeros((0, 3), np.int32)
        self.vertex_colors = None
        self.normals = None
        self.face_normals = None
        self.uv = None
        self.uv_indices = None
        self.normal_indices = None
        self.diffuse_texture = None

    # ------------------------------------------------------------------
    # geometry utilities (reference mesh.cc:83-239)
    # ------------------------------------------------------------------

    def calc_stats(self) -> MeshStats:
        if self.num_vertices == 0:
            big = np.float32(np.finfo(np.float32).max)
            return MeshStats(
                bb_min=np.full(3, big),
                bb_max=np.full(3, -big),
                center=np.zeros(3, np.float32),
            )
        return MeshStats(
            bb_min=self.vertices.min(axis=0),
            bb_max=self.vertices.max(axis=0),
            center=self.vertices.astype(np.float64).mean(axis=0).astype(
                np.float32
            ),
        )

    def calc_face_normal(self) -> np.ndarray:
        """Per-face unit normals (reference mesh.cc:229-239)."""
        v = self.vertices
        f = self.faces
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]

        def _unit(x):
            n = np.linalg.norm(x, axis=-1, keepdims=True)
            return np.divide(x, n, out=np.zeros_like(x), where=n > 0)

        self.face_normals = _unit(np.cross(_unit(e1), _unit(e2))).astype(
            np.float32
        )
        return self.face_normals

    def calc_normal(self) -> np.ndarray:
        """Per-vertex normals: average of incident face normals, normalized
        (reference mesh.cc:197-227)."""
        self.calc_face_normal()
        acc = np.zeros_like(self.vertices)
        np.add.at(acc, self.faces.ravel(), np.repeat(self.face_normals, 3, 0))
        n = np.linalg.norm(acc, axis=-1, keepdims=True)
        self.normals = np.divide(
            acc, n, out=np.zeros_like(acc), where=n > 0
        ).astype(np.float32)
        return self.normals

    def remove_duplicated_vertices(self, native: bool = True) -> None:
        """Weld exactly-equal vertices, first occurrence kept: the C++
        library's O(n) hash weld (raises if the library cannot be built;
        it drops vertex colors, as in the JAX package), or with
        ``native=False`` its plain version, an O(n log n) numpy unique
        (in place of the reference's O(n^2) scan, mesh.cc:115-146)."""
        if self.num_vertices == 0:
            return
        if native:
            from .io.native import native_weld

            self.vertices, self.faces = native_weld(self.vertices,
                                                    self.faces)
            self.vertex_colors = None
            self.normals = None
            self.face_normals = None
            return
        uniq, index, inverse = np.unique(
            self.vertices, axis=0, return_index=True, return_inverse=True
        )
        # keep first-occurrence order for stability
        order = np.argsort(index)
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        self.vertices = uniq[order]
        remap = rank[inverse.reshape(-1)].astype(np.int32)
        self.faces = remap[self.faces]
        if self.vertex_colors is not None:
            self.vertex_colors = self.vertex_colors[index[order]]
        self.normals = None
        self.face_normals = None

    def rotate(self, R: np.ndarray) -> None:
        R = np.asarray(R, np.float32)
        self.vertices = self.vertices @ R.T
        if self.normals is not None:
            self.normals = self.normals @ R.T
        if self.face_normals is not None:
            self.face_normals = self.face_normals @ R.T

    def translate(self, t: np.ndarray) -> None:
        self.vertices = self.vertices + np.asarray(t, np.float32)

    def transform(self, R: np.ndarray, t: np.ndarray) -> None:
        self.rotate(R)
        self.translate(t)

    def scale(self, sx: float, sy: Optional[float] = None, sz=None) -> None:
        if sy is None:
            sy = sz = sx
        self.vertices = self.vertices * np.asarray([sx, sy, sz], np.float32)

    def copy(self) -> "Mesh":
        return Mesh(
            vertices=self.vertices.copy(),
            faces=self.faces.copy(),
            vertex_colors=None
            if self.vertex_colors is None
            else self.vertex_colors.copy(),
        )

    # ------------------------------------------------------------------
    # I/O
    # ------------------------------------------------------------------

    def write_ply(self, path: str, binary: bool = False,
                  native: bool = True) -> None:
        from .io.meshio import write_ply

        write_ply(path, self, binary=binary, native=native)

    def write_obj(self, path: str) -> None:
        from .io.meshio import write_obj

        write_obj(path, self)

    def write_obj_textured(
        self,
        obj_dir: str,
        obj_basename: str,
        mtl_basename: str = "",
        tex_basename: str = "",
    ) -> None:
        """OBJ + MTL + diffuse-texture PNG (reference mesh.cc:634-726)."""
        from .io.meshio import write_obj_textured

        write_obj_textured(
            obj_dir, obj_basename, self, mtl_basename, tex_basename
        )

    @staticmethod
    def load_ply(path: str) -> "Mesh":
        from .io.meshio import load_ply

        return load_ply(path)

    @staticmethod
    def load_obj(path: str) -> "Mesh":
        from .io.meshio import load_obj

        return load_obj(path)


def make_cube(
    length,
    R: Optional[np.ndarray] = None,
    t: Optional[np.ndarray] = None,
) -> Mesh:
    """24-vertex axis-aligned cube with split per-face vertices and the
    reference's gradient vertex colors (mesh.cc:728-816). Vertices are
    split so per-face normals render correctly (mesh.h:94)."""
    if np.isscalar(length):
        length = (length, length, length)
    hx, hy, hz = (np.asarray(length, np.float32) / 2).tolist()

    # 6 faces x 4 corners, same layout as the reference
    top = [(-hx, hy, -hz), (hx, hy, -hz), (hx, hy, hz), (-hx, hy, hz)]
    bot = [(-hx, -hy, -hz), (hx, -hy, -hz), (hx, -hy, hz), (-hx, -hy, hz)]
    verts = np.array(
        top
        + bot
        + [top[1], top[2], bot[2], bot[1]]  # +x
        + [top[0], top[3], bot[3], bot[0]]  # -x
        + [top[0], top[1], bot[1], bot[0]]  # -z
        + [top[3], top[2], bot[2], bot[3]],  # +z
        np.float32,
    )
    faces = np.array(
        [
            [0, 2, 1], [0, 3, 2],
            [4, 5, 6], [4, 6, 7],
            [8, 9, 10], [8, 10, 11],
            [12, 14, 13], [12, 15, 14],
            [16, 17, 18], [16, 18, 19],
            [20, 22, 21], [20, 23, 22],
        ],
        np.int32,
    )
    half = np.array([hx, hy, hz], np.float32)
    full = 2 * half
    colors = (-verts + half) / full * 255.0

    mesh = Mesh(vertices=verts, faces=faces, vertex_colors=colors)
    if R is not None or t is not None:
        mesh.transform(
            np.eye(3, dtype=np.float32) if R is None else R,
            np.zeros(3, np.float32) if t is None else t,
        )
    mesh.calc_normal()
    return mesh


def set_random_vertex_color(mesh: Mesh, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    mesh.vertex_colors = rng.integers(
        0, 256, size=(mesh.num_vertices, 3)
    ).astype(np.float32)
