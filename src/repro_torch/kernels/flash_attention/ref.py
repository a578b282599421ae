"""Plain PyTorch version of the flash attention kernel (mirrors
``repro/kernels/flash_attention/ref.py::attention_ref``)."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, causal: bool = True):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) -> (B, H, S, D), fp32 math,
    output in q's type."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    g = h // hk
    qf = q.float().reshape(b, hk, g, s, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qf, k.float()) / (d ** 0.5)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    return out.reshape(b, h, s, d).to(q.dtype)
