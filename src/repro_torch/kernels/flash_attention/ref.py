"""Plain PyTorch versions of the flash attention kernels: the forward
(mirrors ``repro/kernels/flash_attention/ref.py::attention_ref``), the
forward with each row's log-sum-exp, and the backward's arithmetic."""
from __future__ import annotations

import torch


def _scores(q, k, causal: bool):
    """(B, Hkv, G, S, S) fp32 scores scaled by 1/sqrt(D), the future set to
    -1e30 when causal."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    qf = q.float().reshape(b, hk, h // hk, s, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qf, k.float()) / (d ** 0.5)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    return scores


def attention_ref(q, k, v, causal: bool = True):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) -> (B, H, S, D), fp32 math,
    output in q's type."""
    b, h, s, d = q.shape
    scores = _scores(q, k, causal)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    return out.reshape(b, h, s, d).to(q.dtype)


def attention_fwd_ref(q, k, v, causal: bool = True):
    """``attention_ref``'s output and each row's log-sum-exp of the scaled,
    masked scores, (B, H, S) fp32: what the forward kernel stores for the
    backward."""
    b, h, s, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal), dim=-1)
    return attention_ref(q, k, v, causal), lse.reshape(b, h, s)


def attention_bwd_ref(q, k, v, o, do, lse):
    """The backward kernels' arithmetic, causal: (dq, dk, dv) in the inputs'
    types from q, o, do (B, H, S, D), k, v (B, Hkv, S, D) and the forward's
    ``lse`` (B, H, S). P is recomputed from the fp32 scores and ``lse``;
    Delta = rowsum(do o o) in fp32; dS = P (dP - Delta) with dP = do v^T in
    fp32; P and dS are rounded to the inputs' type as the operands of dV =
    P^T do, dK = dS^T q and dQ = dS k (the last two times 1/sqrt(D)), which
    accumulate in fp32. The GQA group's q heads sum into their kv head."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    g = h // hk
    scale = 1.0 / d ** 0.5

    def rnd(x):
        return x.to(q.dtype).float()

    def grouped(x):
        return x.float().reshape(b, hk, g, s, d)

    p = torch.exp(_scores(q, k, True) - lse.float().reshape(b, hk, g, s, 1))
    dof = grouped(do)
    delta = (dof * grouped(o)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgsd,bktd->bkgst", dof, v.float())
    ds = rnd(p * (dp - delta))
    dv = torch.einsum("bkgst,bkgsd->bktd", rnd(p), dof)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, grouped(q)) * scale
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k.float()) * scale
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
