"""Blackboard max-diffusion step: the wrappers around the CUDA kernel
``csrc/grid_step.cu`` (which replaces the Pallas kernel
``repro/kernels/grid_step/kernel.py:grid_step``).

``grid_step`` takes one (H, W) plane, ``grid_step_planes`` a stack of
(L, H, W) planes stepped each on its own in one launch; a ``grid_step`` call
is the L = 1 launch of the same kernel. Both check device, shape, dtype and
contiguity against the kernel's contract for every call; then on CPU tensors
they run the plain version (``ref.py``) and on CUDA tensors they launch the
kernel on the current stream or raise — there is no fallback, and nothing
is read back to the host. ``grid_step.launches`` counts the launches of
both, and ``grid_step.launches_by_path`` counts them by the body the kernel
library reports it took (``kernel_path``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import grid_step_planes_ref, grid_step_ref

# the bodies of csrc/grid_step.cu, by the code its entry point reports
PATHS = ("scalar", "vec4")


def kernel_path(w: int, aligned: bool = True) -> str:
    """The body a CUDA call on planes of width ``w`` takes: ``"vec4"`` (four
    columns a thread, 16-byte loads and stores: W a multiple of 4 and the
    inputs 16-byte aligned) or ``"scalar"`` (one column a thread). The C
    entry point makes the same choice."""
    return "vec4" if w % 4 == 0 and aligned else "scalar"


def _check(labels, cond, dims: int, name: str) -> None:
    if cond.device != labels.device \
            or labels.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: labels and cond must be on one CUDA "
                         f"device (or both on the CPU)")
    if labels.dim() != dims or tuple(cond.shape) != tuple(labels.shape):
        need = "(H, W)" if dims == 2 else "(L, H, W)"
        raise ValueError(f"{name}: bad shapes labels "
                         f"{tuple(labels.shape)}, cond {tuple(cond.shape)}; "
                         f"need two equal {need}")
    if labels.dtype != torch.int32 or cond.dtype != torch.int32:
        raise TypeError(f"{name}: dtypes {labels.dtype}/{cond.dtype}; "
                        f"need int32 for both")
    if not (labels.is_contiguous() and cond.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def _launch(labels, cond):
    """The kernel on contiguous (L, H, W) int32 CUDA tensors."""
    out = torch.empty_like(labels)
    if out.numel() == 0:
        return out
    planes, h, w = labels.shape
    lib = _build.library()
    path = ctypes.c_int(-1)
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream(labels.device).cuda_stream
        err = lib.repro_grid_step(labels.data_ptr(), cond.data_ptr(),
                                  out.data_ptr(), planes, h, w, stream,
                                  ctypes.byref(path))
    _build.check(err, "grid_step")
    grid_step.launches += 1
    grid_step.launches_by_path[PATHS[path.value]] += 1
    return out


def grid_step(labels, cond, *, band: int = 8):
    """labels, cond: (H, W) int32 -> (H, W) int32, one masked 4-neighbour
    max-diffusion step with zero-padded edges (``grid_step_ref``'s function,
    exactly, for any int32 input). ``band`` is the TPU kernel's row-band
    height, accepted so its callers run unchanged; it does not change the
    result."""
    del band
    _check(labels, cond, 2, "grid_step")
    if labels.device.type == "cpu":
        return grid_step_ref(labels, cond)
    return _launch(labels[None], cond[None])[0]


def grid_step_planes(labels, cond):
    """labels, cond: (L, H, W) int32 -> (L, H, W) int32: ``grid_step`` on
    every plane, independently (nothing diffuses across planes), in one
    launch (``grid_step_planes_ref``'s function, exactly). The launch
    counts on ``grid_step.launches``."""
    _check(labels, cond, 3, "grid_step_planes")
    if labels.device.type == "cpu":
        return grid_step_planes_ref(labels, cond)
    return _launch(labels, cond)


grid_step.launches = 0
grid_step.launches_by_path = dict.fromkeys(PATHS, 0)
