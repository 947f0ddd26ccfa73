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
