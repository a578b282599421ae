"""RecurrentGemma / Griffin recurrent block (arXiv:2402.19427): RG-LRU + conv
(PyTorch port of ``repro/models/rglru.py``).

Train/prefill evaluates the linear recurrence h_t = a_t h_{t-1} + b_t with a
log-depth scan over the sequence (``rglru_scan``: log2(S) steps of whole-
tensor ops, where a loop over positions would cost S launches a layer). The
JAX package uses ``jax.lax.associative_scan``; the two group the products
differently, so they agree within a tolerance, not bit for bit. Decode
carries a (B, lru_width) state — O(1) per token.

Caches are ``{"conv": (B, 3, W) pre-conv projections, "h": (B, W) fp32}``,
written in place (rows where ``active`` is False keep their values).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .layers import _normal, _param, dense_init, dtype_of, masked_copy_

_C = 8.0  # the paper's fixed recurrence sharpness


class RGLRU(nn.Module):
    """The recurrent block's parameters (the JAX package's ``init_rglru``
    keys)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device):
        super().__init__()
        dt = dtype_of(cfg)
        w = cfg.lru_width or cfg.d_model
        d = cfg.d_model
        self.w_in = _param(dense_init(gen, d, w, dt, device))
        self.w_gate_branch = _param(dense_init(gen, d, w, dt, device))
        self.conv_w = _param(_normal(gen, (4, w), 0.1, dt, device))
        self.conv_b = _param(torch.zeros(w, dtype=torch.float32,
                                         device=device))
        self.w_input_gate = _param(dense_init(gen, w, w, dt, device))
        self.w_rec_gate = _param(dense_init(gen, w, w, dt, device))
        # Lambda so that a = exp(-c * softplus(L) * r) lands in a useful
        # decay range: uniform(0.2, 0.9) through the inverse softplus
        if gen is None:
            lam = torch.empty(w, dtype=torch.float32, device=device)
        else:
            lam = (0.2 + 0.7 * torch.rand(w, generator=gen,
                                          dtype=torch.float32,
                                          device=gen.device)).to(device)
            lam = torch.log(torch.exp(lam) - 1.0)
        self.lambda_raw = _param(lam)
        self.w_out = _param(dense_init(gen, w, d, dt, device))


def init_rglru(cfg: ModelConfig, gen: torch.Generator, device) -> RGLRU:
    return RGLRU(cfg, gen, device)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")          # jax.nn.gelu's default


def _conv4(params: RGLRU, u: torch.Tensor) -> torch.Tensor:
    w = params.conv_w
    s = u.shape[1]
    out = u * w[-1]
    for i in range(1, w.shape[0]):
        out = out + F.pad(u, (0, 0, i, 0))[:, :s] * w[-1 - i]
    return out + params.conv_b.to(out.dtype)


def _gates(params: RGLRU, u: torch.Tensor):
    """a_t and the gated input b_t of the recurrence h = a h + b (fp32)."""
    uf = u.float()
    r = torch.sigmoid(uf @ params.w_rec_gate.float())
    i = torch.sigmoid(uf @ params.w_input_gate.float())
    log_a = -_C * F.softplus(params.lambda_raw) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) input normalization (the RG-LRU's variance preservation)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, b


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 (h_{-1} = 0), by a
    Hillis-Steele scan: at step k every position folds in the partial
    (A, B) of the position 2^k before it, ceil(log2 S) steps in all."""
    a, h = a.clone(), b.clone()
    s, k = a.shape[1], 1
    while k < s:
        # (a1, b1) then (a2, b2) composes to (a1 a2, a2 b1 + b2)
        h_prev, a_prev = h[:, :-k], a[:, :-k]
        h = torch.cat([h[:, :k], a[:, k:] * h_prev + h[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a_prev], dim=1)
        k *= 2
    return h


def rglru_block(params: RGLRU, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Griffin recurrent block. x: (B,S,D) -> (B,S,D)."""
    gate = _gelu(x @ params.w_gate_branch)
    u = _conv4(params, x @ params.w_in)
    a, b = _gates(params, u)
    h = rglru_scan(a, b).to(x.dtype)
    return (h * gate) @ params.w_out


def rglru_block_prefill(params: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                        cache: dict):
    """Full-sequence pass that also fills the decode cache (in place)."""
    gate = _gelu(x @ params.w_gate_branch)
    u_pre = x @ params.w_in
    u = _conv4(params, u_pre)
    a, b = _gates(params, u)
    h = rglru_scan(a, b)
    y = (h.to(x.dtype) * gate) @ params.w_out
    k = 3
    tail = u_pre[:, -k:] if u_pre.shape[1] >= k else \
        F.pad(u_pre, (0, 0, k - u_pre.shape[1], 0))
    masked_copy_(cache["conv"], tail, None)
    masked_copy_(cache["h"], h[:, -1], None)
    return y, cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, 3, w), dtype=dtype, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}


def rglru_block_decode(params: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                       cache: dict, active: Optional[torch.Tensor] = None):
    """One-token step. x: (B,1,D); the cache is advanced in place on the
    rows where ``active`` (all rows when None)."""
    gate = _gelu(x @ params.w_gate_branch)             # (B,1,W)
    u_new = x @ params.w_in                             # (B,1,W)
    window = torch.cat([cache["conv"].to(u_new.dtype), u_new], dim=1)
    u = torch.einsum("bkw,kw->bw", window, params.conv_w.to(window.dtype)) \
        + params.conv_b
    a, b = _gates(params, u[:, None, :])
    h = a[:, 0] * cache["h"] + b[:, 0]
    y = (h[:, None, :].to(x.dtype) * gate) @ params.w_out
    masked_copy_(cache["conv"], window[:, 1:], active)
    masked_copy_(cache["h"], h, active)
    return y, cache
