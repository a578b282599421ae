"""Paged attention: the wrappers around the CUDA kernels of
``csrc/paged_attention.cu`` — decode (which replaces the Pallas kernel
``repro/kernels/paged_attention/kernel.py:paged_attention``) and the
self-speculative verify step (which replaces ``:paged_attention_verify``).

Each wrapper checks device, shape, dtype and contiguity against the kernel's
contract for every call; then on CPU tensors it runs the plain version
(``ref.py``) and on CUDA tensors it launches the kernel on the current stream
or raises — there is no fallback. A call splits each sequence's pages into
``split_rule``'s runs (one CUDA launch, plus a merge launch when there is
more than one split); the wrapper never reads the lengths or positions on
the host. ``paged_attention.launches`` and ``paged_attention_verify.launches``
count wrapper calls that launched, and ``launches_by_path`` counts them by
the body the kernel library reports it took (``kernel_path``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import paged_attention_ref, paged_attention_verify_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
# the bodies of csrc/paged_attention.cu, by the code its entry points report
PATHS = ("cuda_core", "mma")
TILE_TOKENS = 64          # tokens of one cp.async ring stage (csrc kTile)
TARGET_CTAS = 4 * 132     # about four CTAs for each of the H100's 132 SMs
MAX_SPLIT_PAGES = 512     # table entries one CTA stages in shared memory


def kernel_path(dtype: torch.dtype, head_dim: int,
                aligned: bool = True) -> str:
    """The body a CUDA call of either entry takes: ``"mma"`` (bf16 on the
    tensor cores) for bf16 with 16-byte-aligned pointers (what cp.async and
    ldmatrix need) at a head dim of ``_build.MMA_HEAD_DIMS``, else
    ``"cuda_core"`` (fp32, and bf16 views that are not aligned). Not a
    function of the rows: decode at G rows and verify
    at Sq * G rows take one body, so each verify row is bitwise the decode
    step at its position (the MoE spec run's bf16 agreement rests on it).
    The C entry points make the same choice."""
    return "mma" if dtype == torch.bfloat16 and aligned \
        and head_dim in _build.MMA_HEAD_DIMS else "cuda_core"


def split_rule(b: int, hkv: int, maxp: int, page: int) -> tuple[int, int]:
    """``(nsplit, pages_per_split)`` of a call over ``b`` sequences, ``hkv``
    kv heads and a ``maxp``-column block table of ``page``-token pages: a
    function of these shapes alone (never of the lengths, which live on the
    card). About ``TARGET_CTAS`` CTAs over ``b * hkv * nsplit``, each split
    a whole number of ``TILE_TOKENS`` tiles and at most ``MAX_SPLIT_PAGES``
    pages."""
    tile_pages = max(1, TILE_TOKENS // page)
    want = -(-TARGET_CTAS // max(1, b * hkv))
    pps = -(-max(1, maxp) // want)
    pps = min(-(-pps // tile_pages) * tile_pages, MAX_SPLIT_PAGES)
    return max(1, -(-maxp // pps)), pps


def _check(name: str, q, k_pages, v_pages, table, idx) -> tuple:
    """The contract both kernels share; ``q``'s last two dims are (H, D),
    ``idx`` is the per-sequence lengths / positions vector. Returns
    ``(Hkv, G)``."""
    tensors = (q, k_pages, v_pages, table, idx)
    if any(t.device != q.device for t in tensors) \
            or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: all inputs must be on one CUDA device (or "
                         f"all on the CPU)")
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    b, (h, d) = q.shape[0], q.shape[-2:]
    hk, dk = k_pages.shape[2:]
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
    _build.check_no_grad(name, q, k_pages, v_pages)
    return hk, h // hk


def _launch(wrapper, name: str, q, k_pages, v_pages, table, idx, hk: int,
            g: int, sq: tuple):
    """Launch ``repro_<name>`` on q's device and current stream with the
    split of ``split_rule``; count the call under the body it took. ``sq``
    is ``()`` for decode, ``(Sq,)`` for verify."""
    b, d = q.shape[0], q.shape[-1]
    page, maxp = k_pages.shape[1], table.shape[1]
    nsplit, pps = split_rule(b, hk, maxp, page)
    out = torch.empty_like(q)
    rows = g * (sq[0] if sq else 1)
    part = None
    if nsplit > 1:
        part = torch.empty(b * hk * nsplit * rows * (d + 2),
                           dtype=torch.float32, device=q.device)
    lib = _build.library()
    path = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"repro_{name}")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), idx.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), b, hk, g, *sq, d,
            page, maxp, nsplit, pps, DTYPES[q.dtype], stream,
            ctypes.byref(path))
    _build.check(err, name)
    wrapper.launches += 1
    wrapper.launches_by_path[PATHS[path.value]] += 1
    return out


def paged_attention(q, k_pages, v_pages, table, lengths):
    """q: (B, H, D); k_pages, v_pages: (P, page, Hkv, D); table: (B, maxp)
    int32 physical page ids (0 = null page); lengths: (B,) int32 valid
    positions -> (B, H, D) in q's type."""
    if q.dim() != 3:
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)}")
    hk, g = _check("paged_attention", q, k_pages, v_pages, table, lengths)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, table, lengths)
    return _launch(paged_attention, "paged_attention", q, k_pages, v_pages,
                   table, lengths, hk, g, ())


def paged_attention_verify(q, k_pages, v_pages, table, pos):
    """Batched k-position verify step (self-speculative decoding).

    q: (B, Sq, H, D) — query row ``r`` sits at cache position ``pos + r`` and
    attends causally up to it; k_pages, v_pages: (P, page, Hkv, D); table:
    (B, maxp) int32; pos: (B,) int32 -> (B, Sq, H, D) in q's type. The
    kernel reads q and writes the output in this layout, taking the Sq * G
    rows of a kv head as (query, group) row-major."""
    if q.dim() != 4:
        raise ValueError(f"paged_attention_verify: bad shapes q "
                         f"{tuple(q.shape)}")
    hk, g = _check("paged_attention_verify", q, k_pages, v_pages, table, pos)
    if q.device.type == "cpu":
        return paged_attention_verify_ref(q, k_pages, v_pages, table, pos)
    return _launch(paged_attention_verify, "paged_attention_verify", q,
                   k_pages, v_pages, table, pos, hk, g, (q.shape[1],))


for _fn in (paged_attention, paged_attention_verify):
    _fn.launches = 0
    _fn.launches_by_path = dict.fromkeys(PATHS, 0)
