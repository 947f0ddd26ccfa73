"""Triangle mesh on the host: numpy vertices f32[N, 3] and faces i32[M, 3]."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.float32)
    )
    faces: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.int32)
    )

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(
            self.vertices, np.float32
        ).reshape(-1, 3)
        self.faces = np.ascontiguousarray(self.faces, np.int32).reshape(-1, 3)

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_faces(self) -> int:
        return len(self.faces)

    def write_ply(self, path: str, binary: bool = False) -> None:
        from .io.meshio import write_ply

        write_ply(path, self, binary=binary)

    @staticmethod
    def load_ply(path: str) -> "Mesh":
        from .io.meshio import load_ply

        return load_ply(path)


def make_cube(length) -> Mesh:
    """24-vertex axis-aligned cube centred at the origin, with split
    per-face vertices in the reference's layout (mesh.cc:728-816). The
    port's ``Mesh`` holds no colors or normals, so the cube carries
    neither."""
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
    return Mesh(vertices=verts, faces=faces)
