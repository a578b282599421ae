"""Paged-decode attention: the wrapper around the CUDA kernel
``csrc/paged_attention.cu`` (which replaces the Pallas kernel
``repro/kernels/paged_attention/kernel.py:paged_attention``).

The wrapper checks device, shape, dtype and contiguity against the kernel's
contract for every call; then on CPU tensors it runs the plain version
(``ref.py``) and on CUDA tensors it launches the kernel on the current stream
or raises — there is no fallback. ``paged_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import paged_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_SMEM = 232_448          # bytes of shared memory one block may use (H100)


def _smem_bytes(g: int, d: int, page: int) -> int:
    ds = d + 1              # must match csrc/paged_attention.cu:smem_bytes
    return 4 * (g * ds + 2 * page * ds + g * page + g * d + 3 * g)


def paged_attention(q, k_pages, v_pages, table, lengths):
    """q: (B, H, D); k_pages, v_pages: (P, page, Hkv, D); table: (B, maxp)
    int32 physical page ids (0 = null page); lengths: (B,) int32 valid
    positions -> (B, H, D) in q's type."""
    tensors = (q, k_pages, v_pages, table, lengths)
    if any(t.device != q.device for t in tensors) \
            or q.device.type not in ("cpu", "cuda"):
        raise ValueError("paged_attention: all inputs must be on one CUDA "
                         "device (or all on the CPU)")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    b, h, d = q.shape
    _, page, hk, dk = k_pages.shape
    if dk != d or d not in HEAD_DIMS or h % hk:
        raise ValueError(f"paged_attention: head dim {d} (pages {dk}) must be "
                         f"in {HEAD_DIMS} and H={h} a multiple of Hkv={hk}")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: dtypes {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}; need one of float32, bfloat16")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or table.dim() != 2 or table.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError("paged_attention: table (B, maxp) and lengths (B,) "
                         "must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    g = h // hk
    if _smem_bytes(g, d, page) > MAX_SMEM:
        raise ValueError(f"paged_attention: G={g}, page={page}, D={d} need "
                         f"more shared memory than one block has")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, table, lengths)
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, hk, g, d,
            page, table.shape[1], DTYPES[q.dtype], stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
