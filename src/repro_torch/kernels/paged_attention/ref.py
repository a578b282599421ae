"""Plain PyTorch version of the paged-decode attention kernel: dense gather
(mirrors ``repro/kernels/paged_attention/ref.py::paged_attention_ref``)."""
from __future__ import annotations

import torch


def paged_attention_ref(q, k_pages, v_pages, table, lengths):
    """q: (B, H, D); k_pages, v_pages: (P, page, Hkv, D); table: (B, maxp)
    int32; lengths: (B,) int32 -> (B, H, D), fp32 math, output in q's type.

    Gathers each sequence's pages into the dense (maxp*page, Hkv, D) logical
    layout, then runs masked single-query attention."""
    b, h, d = q.shape
    page = k_pages.shape[1]
    maxp = table.shape[1]
    hk = k_pages.shape[2]
    g = h // hk
    idx = table.long()
    k = k_pages[idx].reshape(b, maxp * page, hk, d).float()
    v = v_pages[idx].reshape(b, maxp * page, hk, d).float()
    qf = q.float().reshape(b, hk, g, d)
    scores = torch.einsum("bkgd,btkd->bkgt", qf, k) / (d ** 0.5)
    kpos = torch.arange(maxp * page, device=q.device)[None, None, None, :]
    scores = torch.where(kpos < lengths.long()[:, None, None, None], scores,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v)
    return out.reshape(b, h, d).to(q.dtype)
