"""Paged attention: the wrappers around the CUDA kernels of
``csrc/paged_attention.cu`` — decode (which replaces the Pallas kernel
``repro/kernels/paged_attention/kernel.py:paged_attention``) and the
self-speculative verify step (which replaces ``:paged_attention_verify``).

Each wrapper checks device, shape, dtype and contiguity against the kernel's
contract for every call; then on CPU tensors it runs the plain version
(``ref.py``) and on CUDA tensors it launches the kernel on the current stream
or raises — there is no fallback. ``paged_attention.launches`` and
``paged_attention_verify.launches`` count kernel launches.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import paged_attention_ref, paged_attention_verify_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_SMEM = 232_448          # bytes of shared memory one block may use (H100)


def _smem_bytes(rows: int, d: int, page: int) -> int:
    """Shared memory of one CTA holding ``rows`` query rows (G for decode,
    Sq*G for verify); must match csrc/paged_attention.cu:smem_bytes."""
    ds = d + 1
    return 4 * (rows * ds + 2 * page * ds + rows * page + rows * d + 3 * rows)


def _check(name: str, q, k_pages, v_pages, table, idx, sq: int) -> tuple:
    """The contract both kernels share; ``q``'s last two dims are (H, D),
    ``idx`` is the per-sequence lengths / positions vector and ``sq`` the
    query tokens per sequence. Returns ``(page, Hkv, G)``."""
    tensors = (q, k_pages, v_pages, table, idx)
    if any(t.device != q.device for t in tensors) \
            or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: all inputs must be on one CUDA device (or "
                         f"all on the CPU)")
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    b, (h, d) = q.shape[0], q.shape[-2:]
    _, page, hk, dk = k_pages.shape
    if dk != d or d not in HEAD_DIMS or h % hk:
        raise ValueError(f"{name}: head dim {d} (pages {dk}) must be in "
                         f"{HEAD_DIMS} and H={h} a multiple of Hkv={hk}")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"{name}: dtypes {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}; need one of float32, bfloat16")
    if table.dtype != torch.int32 or idx.dtype != torch.int32 \
            or table.dim() != 2 or table.shape[0] != b \
            or tuple(idx.shape) != (b,):
        raise ValueError(f"{name}: table (B, maxp) and lengths/pos (B,) must "
                         f"be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    g = h // hk
    if _smem_bytes(sq * g, d, page) > MAX_SMEM:
        raise ValueError(f"{name}: {sq * g} query rows, page={page}, D={d} "
                         f"need more shared memory than one block has")
    return page, hk, g


def _launch(name: str, q, *args) -> None:
    """Launch ``repro_<name>`` on q's device and current stream; raise on a
    refused launch."""
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"repro_{name}")(*args, stream)
    _build.check(err, name)


def paged_attention(q, k_pages, v_pages, table, lengths):
    """q: (B, H, D); k_pages, v_pages: (P, page, Hkv, D); table: (B, maxp)
    int32 physical page ids (0 = null page); lengths: (B,) int32 valid
    positions -> (B, H, D) in q's type."""
    if q.dim() != 3:
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)}")
    page, hk, g = _check("paged_attention", q, k_pages, v_pages, table,
                         lengths, 1)
    b, _, d = q.shape
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, table, lengths)
    out = torch.empty_like(q)
    _launch("paged_attention", q, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, hk, g, d, page, table.shape[1],
            DTYPES[q.dtype])
    paged_attention.launches += 1
    return out


def paged_attention_verify(q, k_pages, v_pages, table, pos):
    """Batched k-position verify step (self-speculative decoding).

    q: (B, Sq, H, D) — query row ``r`` sits at cache position ``pos + r`` and
    attends causally up to it; k_pages, v_pages: (P, page, Hkv, D); table:
    (B, maxp) int32; pos: (B,) int32 -> (B, Sq, H, D) in q's type. The
    kernel takes the rows of one kv head as (B, Hkv, Sq*G, D), (query,
    group) row-major, so row ``r`` is query ``r // G``."""
    if q.dim() != 4:
        raise ValueError(f"paged_attention_verify: bad shapes q "
                         f"{tuple(q.shape)}")
    b, sq, h, d = q.shape
    page, hk, g = _check("paged_attention_verify", q, k_pages, v_pages, table,
                         pos, sq)
    if q.device.type == "cpu":
        return paged_attention_verify_ref(q, k_pages, v_pages, table, pos)
    qk = q.reshape(b, sq, hk, g, d).transpose(1, 2).reshape(b, hk, sq * g, d) \
        .contiguous()
    out = torch.empty_like(qk)
    _launch("paged_attention_verify", q, qk.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), table.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, hk, g, sq, d, page, table.shape[1],
            DTYPES[q.dtype])
    paged_attention_verify.launches += 1
    return out.reshape(b, hk, sq, g, d).transpose(1, 2).reshape(b, sq, h, d)


paged_attention.launches = 0
paged_attention_verify.launches = 0
