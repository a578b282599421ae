"""Grouped matmul for MoE expert compute: the wrapper around the CUDA kernel
``csrc/moe_gmm.cu`` (which replaces the Pallas kernel
``repro/kernels/moe_gmm/kernel.py:moe_gmm``).

The wrapper checks device, shape, dtype and contiguity against the kernel's
contract for every call; then on CPU tensors it runs the plain version
(``ref.py``) and on CUDA tensors it launches the kernel on the current stream
or raises — there is no fallback. ``moe_gmm.launches`` counts kernel
launches, and ``moe_gmm.launches_by_path`` counts them by the body the
kernel library reports it took (``kernel_path``). ``group_sizes`` stays on
the device: the kernel reads it itself, so a call costs no host sync.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import gmm_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bodies of csrc/moe_gmm.cu, by the code its entry point reports
PATHS = ("cuda_core", "mma")


def kernel_path(dtype: torch.dtype, d: int, f: int,
                aligned: bool = True) -> str:
    """The body a CUDA call with x (E, C, d), w (E, d, f) of ``dtype``
    takes: ``"mma"`` (bf16 on the tensor cores; its 16-byte copies need d
    and f to be multiples of 8 and aligned pointers) or ``"cuda_core"``
    (fp32 and every other shape). The C entry point makes the same
    choice."""
    return ("mma" if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
            and aligned else "cuda_core")


def moe_gmm(x, w, group_sizes):
    """x: (E, C, D); w: (E, D, F); group_sizes: (E,) int32 live rows per
    expert -> (E, C, F) in x's type, fp32 accumulation. Every row
    ``>= group_sizes[e]`` of the output is exactly zero, whatever ``x``
    holds there. Any C, D, F."""
    if w.device != x.device or group_sizes.device != x.device \
            or x.device.type not in ("cpu", "cuda"):
        raise ValueError("moe_gmm: x, w, group_sizes must be on one CUDA "
                         "device (or all on the CPU)")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2] \
            or tuple(group_sizes.shape) != (x.shape[0],):
        raise ValueError(f"moe_gmm: bad shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"moe_gmm: dtypes {x.dtype}/{w.dtype}; need one of "
                        f"float32, bfloat16 for both")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"moe_gmm: group_sizes must be int32, got "
                        f"{group_sizes.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()
            and group_sizes.is_contiguous()):
        raise ValueError("moe_gmm: inputs must be contiguous")
    _build.check_no_grad("moe_gmm", x, w)
    if x.device.type == "cpu":
        return gmm_ref(x, w, group_sizes)
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    path = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_moe_gmm(x.data_ptr(), w.data_ptr(),
                                group_sizes.data_ptr(), out.data_ptr(), e, c,
                                d, f, DTYPES[x.dtype], stream,
                                ctypes.byref(path))
    _build.check(err, "moe_gmm")
    moe_gmm.launches += 1
    moe_gmm.launches_by_path[PATHS[path.value]] += 1
    return out


moe_gmm.launches = 0
moe_gmm.launches_by_path = dict.fromkeys(PATHS, 0)
