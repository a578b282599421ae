"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` under ``repro_torch/kernels/csrc/`` is compiled by ONE
``nvcc`` call for ``sm_90a`` into a shared library with a plain C interface,
named by a hash of the sources, under ``build/kernels/`` at the repository
root, and loaded with ``ctypes``. Nothing happens at import time: the first
wrapper that launches a kernel on a CUDA tensor calls :func:`library`, so the
CPU tests (which have no ``nvcc``) can import every module.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points in csrc/ (pointers and the stream as void*)
SIGNATURES = {
    "repro_paged_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _P],
    "repro_paged_attention_verify": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "repro_moe_gmm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_LIB = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit (CUDA_HOME or PATH)")
    return cand


def library_path() -> Path:
    h = hashlib.sha1()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libreprokernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources (once per content hash) and return the library."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent process never sees half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
