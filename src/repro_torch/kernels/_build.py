"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` under ``repro_torch/kernels/csrc/`` is compiled for
``sm_90a`` by its own ``nvcc`` process, all started together, and the
objects are linked into one shared library with a plain C interface, named
by a hash of the sources, under ``build/kernels/`` at the repository root,
and loaded with ``ctypes``. Nothing happens at import time: the first
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# The head dims of the bf16 tensor-core bodies of paged_attention.cu and
# flash_attention.cu (csrc/tensor_core.cuh:mma_dim makes the same choice;
# at D = 112 each row's 14 chunks lie in a 16-chunk shared slot,
# tensor_core.cuh:slot_chunks)
MMA_HEAD_DIMS = (16, 32, 64, 112, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)   # an int the entry point writes back
# C signatures of the entry points in csrc/ (pointers and the stream as void*)
SIGNATURES = {
    "repro_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _P, _IP],
    "repro_paged_attention_verify": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _I, _I, _I, _I, _P, _IP],
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _P, _IP],
    "repro_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _I, _P, _IP],
    "repro_moe_gmm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _IP],
    "repro_grid_step": [_P, _P, _P, _I, _I, _I, _P, _IP],
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
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [(p.args[-1], p.communicate()[0], p.returncode) for p in procs]
        failed = [f"{src} ({rc}):\n{log}" for src, log, rc in logs if rc]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(tmpdir, out.name)
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        # atomic: a concurrent process never sees half a file
        os.replace(tmp, out)
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


def check_no_grad(name: str, *tensors) -> None:
    """Raise if autograd would record a call on ``tensors``. The serving
    wrappers (paged decode and verify, flash, the grouped matmul) have no
    backward (nor have the TPU kernels they replace): under grad mode an
    input that requires grad would get an output with no ``grad_fn``, and
    its gradient would be cut without a word. Training's attention goes
    through ``flash_attention.flash_attention_train`` instead, whose
    autograd Function has the backward kernels. The check is the same on
    CPU tensors, whose plain versions could differentiate, so a CPU run
    fails where the card would."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it "
                           f"under torch.no_grad() or on inputs that do not "
                           f"require grad")


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
