"""Blackboard max-diffusion step: the wrapper around the CUDA kernel
``csrc/grid_step.cu`` (which replaces the Pallas kernel
``repro/kernels/grid_step/kernel.py:grid_step``).

The wrapper checks device, shape, dtype and contiguity against the kernel's
contract for every call; then on CPU tensors it runs the plain version
(``ref.py``) and on CUDA tensors it launches the kernel on the current stream
or raises — there is no fallback, and nothing is read back to the host.
``grid_step.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import grid_step_ref


def grid_step(labels, cond, *, band: int = 8):
    """labels, cond: (H, W) int32 -> (H, W) int32, one masked 4-neighbour
    max-diffusion step with zero-padded edges (``grid_step_ref``'s function,
    exactly, for any int32 input). ``band`` is the TPU kernel's row-band
    height, accepted so its callers run unchanged; it does not change the
    result."""
    del band
    if cond.device != labels.device \
            or labels.device.type not in ("cpu", "cuda"):
        raise ValueError("grid_step: labels and cond must be on one CUDA "
                         "device (or both on the CPU)")
    if labels.dim() != 2 or tuple(cond.shape) != tuple(labels.shape):
        raise ValueError(f"grid_step: bad shapes labels "
                         f"{tuple(labels.shape)}, cond {tuple(cond.shape)}; "
                         f"need two equal (H, W)")
    if labels.dtype != torch.int32 or cond.dtype != torch.int32:
        raise TypeError(f"grid_step: dtypes {labels.dtype}/{cond.dtype}; "
                        f"need int32 for both")
    if not (labels.is_contiguous() and cond.is_contiguous()):
        raise ValueError("grid_step: inputs must be contiguous")
    if labels.device.type == "cpu":
        return grid_step_ref(labels, cond)
    h, w = labels.shape
    out = torch.empty_like(labels)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream(labels.device).cuda_stream
        err = lib.repro_grid_step(labels.data_ptr(), cond.data_ptr(),
                                  out.data_ptr(), h, w, stream)
    _build.check(err, "grid_step")
    grid_step.launches += 1
    return out


grid_step.launches = 0
