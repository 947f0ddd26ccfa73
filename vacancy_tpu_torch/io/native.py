"""ctypes bindings to the C++ host library (``native/vacancy_native.cc``).

The library holds the host-side hot paths at large scale: single-pass
marching-cubes face expansion, buffered PLY writing, ascii vertex parsing
and an O(n) vertex weld. The host compiler builds it at first use into
``build/vacancy_tpu_torch/native-<hash>/`` beside the package (keyed by a
hash of the source and the flags, never into ``native/``), as
``_kernels.py`` builds the CUDA sources. It is built without OpenMP, so it
links nothing beyond the C++ runtime; the face expansion shares its cubes
over Python threads instead. Nothing is built when this module is
imported.

A function here raises ``RuntimeError`` when the library cannot be built
or loaded; it never gives way to numpy by itself. The numpy versions live
beside their callers (``ops/mc_fused._expand_faces``, ``io/meshio``,
``Mesh.remove_duplicated_vertices``), which take ``native=False`` from a
caller that asks for them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from .._kernels import BUILD_ROOT

SOURCE = Path(__file__).resolve().parents[2] / "native" / "vacancy_native.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
# threads that share the cubes of one face expansion (fewer on fewer cores)
EXPAND_THREADS = 8

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64
_SIGNATURES = {
    "vacancy_write_ply": (ctypes.c_int, [
        ctypes.c_char_p, _F32P, _I64, _I32P, _I64, _U8P, ctypes.c_int]),
    "vacancy_weld_vertices": (_I64, [_F32P, _I64, _F32P, _I32P]),
    "vacancy_parse_float3_lines": (_I64, [ctypes.c_char_p, _I64, _I64,
                                          _F32P]),
    "vacancy_expand_faces": (_I64, [
        _I32P, _I32P, _I64,  # clin, ccase, n_cubes
        _I64P,  # starts [n_cubes + 1]
        _I32P,  # tri_table [256 * 16]
        _I32P,  # edge_axis [12]
        _I64P,  # edge_off [12]
        _I32P, _I64, _I32P, _I64, _I32P, _I64,  # the three vlin streams
        _I32P,  # faces_out [total * 3]
    ]),
}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"host compiler {cxx!r} not found: the native "
                           f"library cannot be built")
    return path


def build() -> Path:
    """Compile ``native/vacancy_native.cc`` if no cached library matches
    it; returns the library path. Raises RuntimeError with the compiler's
    output on failure."""
    if not SOURCE.exists():
        raise RuntimeError(f"native source not found: {SOURCE}")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / f"native-{h.hexdigest()[:16]}"
    lib = out_dir / "libvacancy_native.so"
    if lib.exists():
        return lib
    cxx = _compiler()
    out_dir.mkdir(parents=True, exist_ok=True)
    # built in a directory of this process's own and moved into place in
    # one rename, so two processes building at once never share a file
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        so = Path(tmp) / lib.name
        cmd = [cxx, *CXX_FLAGS, "-o", str(so), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(so, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every entry point's types declared."""
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    except (OSError, AttributeError) as e:
        raise RuntimeError(
            f"native library {path} failed to load: {e}") from e
    return lib


def available() -> bool:
    """Whether the library builds and loads here (what a report of the
    fast path should say; the entry points below raise instead)."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def native_write_ply(path: str, mesh, binary: bool = False) -> None:
    """Write ``mesh`` (vertices, faces, optional vertex colors) as PLY."""
    v = np.ascontiguousarray(mesh.vertices, np.float32)
    f = np.ascontiguousarray(mesh.faces, np.int32)
    c = None
    if mesh.vertex_colors is not None:
        c = np.ascontiguousarray(
            np.clip(np.round(mesh.vertex_colors), 0, 255), np.uint8)
    ret = load().vacancy_write_ply(
        os.fsencode(path), _ptr(v, _F32P), len(v), _ptr(f, _I32P), len(f),
        None if c is None else _ptr(c, _U8P), 1 if binary else 0,
    )
    if ret != 0:
        raise OSError(f"native PLY write to {path} failed ({ret})")


def native_parse_float3(buf: bytes, n_rows: int) -> Optional[np.ndarray]:
    """Parse N ascii "x y z ..." lines into an [N, 3] float32 array, or
    None if the buffer parsed short (a malformed body: the caller's numpy
    parse then names the fault)."""
    out = np.empty((n_rows, 3), np.float32)
    parsed = load().vacancy_parse_float3_lines(buf, len(buf), n_rows,
                                               _ptr(out, _F32P))
    return out if int(parsed) == n_rows else None


def native_expand_faces(
    clin: np.ndarray,  # i32[n_cubes]
    ccase: np.ndarray,  # i32[n_cubes]
    starts: np.ndarray,  # i64[n_cubes + 1] exclusive tri-count prefix
    tri_table: np.ndarray,  # i32[256, 16]
    edge_axis: np.ndarray,  # i32[12]
    edge_off: np.ndarray,  # i64[12] owner linear-id offset per edge
    vlins,  # three SORTED owner-id streams (int32 range)
) -> np.ndarray:
    """Marching-cubes face expansion in one pass (vacancy_native.cc):
    i32[total, 3] faces identical to ``ops/mc_fused._expand_faces``. Up to
    ``EXPAND_THREADS`` threads, one per core this process may run on, take
    equal ranges of the cubes."""
    if len(ccase) != len(clin) or len(starts) != len(clin) + 1:
        raise ValueError("clin, ccase and starts disagree in length")
    lib = load()
    n_cubes = len(clin)
    faces = np.empty((int(starts[-1]), 3), np.int32)
    clin, ccase, tri_table, edge_axis, *vlins = (
        np.ascontiguousarray(a, np.int32)
        for a in (clin, ccase, tri_table, edge_axis, *vlins))
    starts = np.ascontiguousarray(starts, np.int64)
    edge_off = np.ascontiguousarray(edge_off, np.int64)

    def expand(c0: int, c1: int) -> int:
        """Cubes [c0, c1) into their own rows of ``faces``."""
        sub = starts[c0:c1 + 1] - starts[c0]
        return int(lib.vacancy_expand_faces(
            _ptr(clin[c0:c1], _I32P), _ptr(ccase[c0:c1], _I32P), c1 - c0,
            _ptr(sub, _I64P), _ptr(tri_table, _I32P), _ptr(edge_axis, _I32P),
            _ptr(edge_off, _I64P),
            _ptr(vlins[0], _I32P), len(vlins[0]),
            _ptr(vlins[1], _I32P), len(vlins[1]),
            _ptr(vlins[2], _I32P), len(vlins[2]),
            _ptr(faces[starts[c0]:], _I32P),
        ))

    # one call walks its cubes on one core; ranges of cubes write disjoint
    # rows, and ctypes releases the interpreter lock during a call
    workers = max(1, min(EXPAND_THREADS, len(os.sched_getaffinity(0)),
                         n_cubes))
    cuts = np.linspace(0, n_cubes, workers + 1).astype(np.int64)
    with ThreadPoolExecutor(workers) as pool:
        rets = list(pool.map(expand, cuts[:-1].tolist(), cuts[1:].tolist()))
    if any(rets):
        raise RuntimeError(f"native face expansion failed ({rets})")
    return faces


def native_weld(vertices: np.ndarray, faces: np.ndarray):
    """Hash-weld exactly-equal vertices (first occurrence kept, O(n)).
    Returns (unique vertices, remapped faces)."""
    v = np.ascontiguousarray(vertices, np.float32)
    out = np.empty_like(v)
    remap = np.empty(len(v), np.int32)
    n_out = load().vacancy_weld_vertices(_ptr(v, _F32P), len(v),
                                         _ptr(out, _F32P),
                                         _ptr(remap, _I32P))
    if n_out < 0:
        raise RuntimeError("native vertex weld failed")
    return out[: int(n_out)].copy(), remap[np.asarray(faces, np.int32)]
