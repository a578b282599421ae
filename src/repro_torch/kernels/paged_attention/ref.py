"""Plain PyTorch versions of the paged attention kernels: dense gather
(mirrors ``repro/kernels/paged_attention/ref.py``)."""
from __future__ import annotations

import torch


def _gather(k_pages, v_pages, table):
    """Each sequence's pages in logical order as fp32 (B, maxp*page, Hkv, D)."""
    b, maxp = table.shape
    _, page, hk, d = k_pages.shape
    idx = table.long()
    k = k_pages[idx].reshape(b, maxp * page, hk, d).float()
    v = v_pages[idx].reshape(b, maxp * page, hk, d).float()
    return k, v


def _masked_softmax(scores, keep):
    scores = torch.where(keep, scores,
                         torch.tensor(-1e30, device=scores.device))
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    return probs / probs.sum(-1, keepdim=True)


def paged_attention_ref(q, k_pages, v_pages, table, lengths):
    """q: (B, H, D); k_pages, v_pages: (P, page, Hkv, D); table: (B, maxp)
    int32; lengths: (B,) int32 -> (B, H, D), fp32 math, output in q's type.

    Gathers each sequence's pages into the dense (maxp*page, Hkv, D) logical
    layout, then runs masked single-query attention."""
    b, h, d = q.shape
    hk = k_pages.shape[2]
    k, v = _gather(k_pages, v_pages, table)
    qf = q.float().reshape(b, hk, h // hk, d)
    scores = torch.einsum("bkgd,btkd->bkgt", qf, k) / (d ** 0.5)
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    probs = _masked_softmax(scores, kpos < lengths.long()[:, None, None, None])
    out = torch.einsum("bkgt,btkd->bkgd", probs, v)
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_verify_ref(q, k_pages, v_pages, table, pos):
    """q: (B, Sq, H, D); k_pages, v_pages: (P, page, Hkv, D); table: (B, maxp)
    int32; pos: (B,) int32 -> (B, Sq, H, D), fp32 math, output in q's type.

    The k-position verify step: query row ``r`` sits at cache position
    ``pos + r`` and attends causally up to it (``kpos <= pos + r``); row 0 is
    ``paged_attention_ref`` at ``lengths = pos + 1``."""
    b, sq, h, d = q.shape
    hk = k_pages.shape[2]
    k, v = _gather(k_pages, v_pages, table)
    qf = q.float().reshape(b, sq, hk, h // hk, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k) / (d ** 0.5)
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, None, None, :]
    bound = (pos.long()[:, None]
             + torch.arange(sq, device=q.device)[None, :])[:, None, None, :,
                                                          None]
    probs = _masked_softmax(scores, kpos <= bound)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, h, d).to(q.dtype)
