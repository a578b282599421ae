"""Flash attention (prefill): the wrapper around the CUDA kernel
``csrc/flash_attention.cu`` (which replaces the Pallas kernel
``repro/kernels/flash_attention/kernel.py:flash_attention``).

The wrapper checks device, shape, dtype and contiguity against the kernel's
contract for every call; then on CPU tensors it runs the plain version
(``ref.py``) and on CUDA tensors it launches the kernel on the current stream
or raises — there is no fallback. ``flash_attention.launches`` counts kernel
launches, and ``flash_attention.launches_by_path`` counts them by the body
the kernel library reports it took (``kernel_path``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
# the bodies of csrc/flash_attention.cu, by the code its entry point reports
PATHS = ("cuda_core", "mma")


def kernel_path(dtype: torch.dtype, head_dim: int,
                aligned: bool = True) -> str:
    """The body a CUDA call with inputs of ``dtype`` takes: ``"mma"`` (bf16
    on the tensor cores) at a head dim of ``_build.MMA_HEAD_DIMS``, or
    ``"cuda_core"`` (fp32, bf16 whose pointers are not 16-byte aligned,
    which cp.async needs, and bf16 at D = 112). The C entry point
    makes the same choice."""
    return "mma" if dtype == torch.bfloat16 and aligned \
        and head_dim in _build.MMA_HEAD_DIMS else "cuda_core"


def flash_attention(q, k, v, causal: bool = True):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) -> (B, H, S, D) in q's type.
    Any S (the ragged last block is masked)."""
    if k.device != q.device or v.device != q.device \
            or q.device.type not in ("cpu", "cuda"):
        raise ValueError("flash_attention: q, k, v must be on one CUDA "
                         "device (or all on the CPU)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, s, d = q.shape
    bk, hk, sk, dk = k.shape
    if bk != b or sk != s or dk != d or d not in HEAD_DIMS or h % hk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}; head dim must be in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; need one of float32, bfloat16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    _build.check_no_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    out = torch.empty_like(q)
    lib = _build.library()
    path = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hk,
            s, d, int(causal), DTYPES[q.dtype], stream, ctypes.byref(path))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_path[PATHS[path.value]] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_path = dict.fromkeys(PATHS, 0)
