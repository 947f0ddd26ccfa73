"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source under ``csrc/``, one process
per source, all started together, and links the objects into one shared
library with a plain C interface, bound here with ``ctypes``. The
library is cached under ``build/vacancy_tpu_torch/<hash>/`` beside the
package, keyed by a hash of the sources and the flags, so a checkout
builds once. Nothing is built when this module is imported.

Flags: ``-fmad=false`` and no ``--use_fast_math`` (IEEE division), so
float expressions round exactly as the plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "vacancy_tpu_torch"
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"  # when nvcc is not on PATH
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)  # a host array of ints
_SIGNATURES = {
    "vt_warp_fuse_planes": [_P] * 10 + [_I] * 15 + [_F, _F, _I, _I, _P],
    "vt_warp_tiling": [_I],
    "vt_warp_ctas_per_sm": [_I],
    "vt_interp_rows": [_P] * 3 + [_I] * 11 + [_P],
    "vt_interp_tiling": [_I],
    "vt_mc_tiles": [_I, _I],
    "vt_mc_count": [_P] * 5 + [_I] * 3 + [_F, _I, _IP] + [_P] * 2,
    "vt_mc_scan_blocks": [_I],
    "vt_mc_scan": [_P] * 4 + [_I] * 3 + [_P, _P],
    "vt_mc_emit": ([_P] * 5 + [_I] * 3 + [_F, _I, _IP] + [_P, _IP]
                   + [_P] * 9),
    "vt_probe_scale": [_P, _P, _I, _P],
    "vt_exact_fold": [_P] * 9 + [_I] * 16 + [_F, _F, _P],
    "vt_exact_tiling": [_I],
    "vt_mesh_layout": [_I],
    "vt_mesh_vertices": [_P, _P, _I] * 3 + [_P] * 3 + [_I, _I, _P, _P],
    "vt_mesh_face_offsets": [_P, _I] + [_P] * 4,
    "vt_mesh_faces": ([_P, _P, _I, _P, _P] + [_P, _I] * 3
                      + [_I, _I, _P, _P]),
    "vt_sdf2d": [_P] * 4 + [_I] * 10 + [_F] * 3 + [_P],
}


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(CUDA_NVCC):
        nvcc = CUDA_NVCC
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if no cached library matches them; returns the
    library path. Raises RuntimeError with nvcc's output on failure."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libvacancy_kernels.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # objects and the library go to a directory of this process's own, so
    # two processes building at once never touch each other's files; the
    # finished library replaces `lib` in one rename
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        jobs = []
        for src, obj in zip(_sources(), objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"{' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {log[-1]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        so = Path(tmp) / lib.name
        cmd = [nvcc, "-shared", "-o", str(so), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        log.append(f"{' '.join(cmd)}\n"
                   f"seconds {time.perf_counter() - t0:.3f}\n")
        (Path(tmp) / "build.log").write_text("\n".join(log))
        os.replace(Path(tmp) / "build.log", out_dir / "build.log")
        os.replace(so, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every entry point's argtypes declared (each
    returns an int: a cudaError_t, or a count for ``vt_mc_tiles`` and the
    other entry points that size a launch or a table)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """nvcc's output for the cached build (register and shared-memory use
    per kernel from ``-Xptxas -v``), or '' if not built."""
    log = BUILD_ROOT / _digest() / "build.log"
    return log.read_text() if log.exists() else ""


def check_tensor(name: str, t, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (what every kernel entry point takes)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {t.shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {err}")


def smem_optin_bytes(device) -> int:
    """The shared memory a block on CUDA ``device`` may opt into, as the
    card reports it (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    import torch

    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as a raw pointer value."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
