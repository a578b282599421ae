"""Grouped matmul for MoE expert compute: the wrapper around the CUDA kernel
``csrc/moe_gmm.cu`` (which replaces the Pallas kernel
``repro/kernels/moe_gmm/kernel.py:moe_gmm``).

The wrapper checks device, shape, dtype and contiguity against the kernel's
contract for every call; then on CPU tensors it runs the plain version
(``ref.py``) and on CUDA tensors it launches the kernel on the current stream
or raises — there is no fallback. ``moe_gmm.launches`` counts kernel
launches. ``group_sizes`` stays on the device: the kernel reads it itself,
so a call costs no host sync.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import gmm_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    if x.device.type == "cpu":
        return gmm_ref(x, w, group_sizes)
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_moe_gmm(x.data_ptr(), w.data_ptr(),
                                group_sizes.data_ptr(), out.data_ptr(), e, c,
                                d, f, DTYPES[x.dtype], stream)
    _build.check(err, "moe_gmm")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
