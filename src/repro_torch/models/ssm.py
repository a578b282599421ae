"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) in PyTorch (port of
``repro/models/ssm.py``).

Train/prefill uses the chunked dual form (intra-chunk quadratic + inter-chunk
recurrence); decode carries an explicit (B, H, N, P) state — O(1) per token.
ngroups = 1 (B/C shared across heads), as in the published 130m config. The
SSD arithmetic runs in fp32, as in the JAX package; its ``lax.scan`` over
chunks is a Python loop here.

Caches are ``{"conv": (B, ssm_conv - 1, conv_dim), "state": (B, H, N, P)
fp32}``; ``conv`` holds the last *pre-conv* projections. The block functions
that take a cache write the new one into it in place (rows where ``active``
is False keep their old values) and return it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .layers import (DP, RMSNorm, _normal, _param, constrain, dense_init,
                     dtype_of, guard_spec, is_dtensor, local_apply,
                     masked_copy_, reshard, rmsnorm, view)


def dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_state, cfg.ssm_head_dim


class SSM(nn.Module):
    """The mamba-2 mixer's parameters (the JAX package's ``init_ssm`` keys)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device):
        super().__init__()
        dt = dtype_of(cfg)
        d_inner, h, n, _ = dims(cfg)
        conv_dim = d_inner + 2 * n
        in_dim = 2 * d_inner + 2 * n + h    # [z, x, B, C, dt]
        f32 = torch.float32
        self.in_proj = _param(dense_init(gen, cfg.d_model, in_dim, dt, device))
        self.conv_w = _param(_normal(gen, (cfg.ssm_conv, conv_dim), 0.1, dt,
                                     device))
        self.conv_b = _param(torch.zeros(conv_dim, dtype=f32, device=device))
        self.A_log = _param(torch.zeros(h, dtype=f32, device=device))
        self.D = _param(torch.ones(h, dtype=f32, device=device))
        self.dt_bias = _param(torch.zeros(h, dtype=f32, device=device))
        self.norm = RMSNorm(d_inner, device)
        self.out_proj = _param(dense_init(gen, d_inner, cfg.d_model, dt,
                                          device))


def init_ssm(cfg: ModelConfig, gen: torch.Generator, device) -> SSM:
    return SSM(cfg, gen, device)


def _split(params: SSM, x: torch.Tensor, cfg: ModelConfig):
    """Project x into (z, xBC, dt), slicing the fused in_proj weight before
    the products, as the JAX package does."""
    d_inner, h, n, _ = dims(cfg)
    w = params.in_proj
    conv_dim = d_inner + 2 * n
    z = constrain(x @ w[:, :d_inner], DP, None, "model")
    xbc = constrain(x @ w[:, d_inner:d_inner + conv_dim], DP, None, "model")
    dt_raw = x @ w[:, -h:]                      # (B,S,H): tiny, replicated
    dt = F.softplus(dt_raw.float() + params.dt_bias)
    return z, xbc, dt


def _conv_train(params: SSM, xbc: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over the sequence (width cfg.ssm_conv)."""
    w = params.conv_w                                 # (K, C)
    k, s = w.shape[0], xbc.shape[1]
    out = xbc * w[-1]
    for i in range(1, k):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[-1 - i]
    return F.silu(out + params.conv_b.to(out.dtype))


def _segsum_decay(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L, H) per-step log-decay -> (..., H, L, L) lower-triangular
    decays: out[i, j] = exp(sum_{k=j+1..i} a_k) for j <= i, else 0."""
    acs = torch.cumsum(a, dim=-2)                      # inclusive
    diff = acs[..., :, None, :] - acs[..., None, :, :]  # (..., L, L, H)
    l = a.shape[-2]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    diff = torch.where(mask[..., None], diff,
                       torch.tensor(-torch.inf, device=a.device))
    return torch.exp(torch.movedim(diff, -1, -3))       # (..., H, L, L)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                return_state: bool = False,
                init_state: Optional[torch.Tensor] = None):
    """x: (B,S,H,P); dt: (B,S,H); a_log: (H,); b, c: (B,S,N). Returns
    (B,S,H,P) (and the final recurrence state (B,H,N,P) when
    ``return_state``). ``init_state`` resumes the inter-chunk recurrence
    mid-sequence (chunked prefill); splitting a sequence at chunk
    boundaries keeps the one-shot op order."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    l = min(chunk, s)
    pad = (-s) % l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = x.shape[1] // l
    xc = x.reshape(bsz, nc, l, h, p)
    dtc = dt.reshape(bsz, nc, l, h)
    bc = b.reshape(bsz, nc, l, n)
    cc = c.reshape(bsz, nc, l, n)

    a = dtc * (-torch.exp(a_log))                      # (B,NC,L,H), negative
    xdt = xc * dtc[..., None]
    decay = _segsum_decay(a)                           # (B,NC,H,L,L)

    # intra-chunk (the "attention-like" dual)
    att = torch.einsum("bcin,bcjn->bcij", cc, bc)
    y = torch.einsum("bchij,bcjhp->bcihp", att[:, :, None] * decay, xdt)

    # chunk-final states + inter-chunk recurrence
    acs = torch.cumsum(a, dim=2)
    tail = torch.exp(acs[:, :, -1:, :] - acs)          # decay to chunk end
    states = torch.einsum("bcln,bclhp->bchnp", bc, tail[..., None] * xdt)
    chunk_decay = torch.exp(acs[:, :, -1, :])          # (B,NC,H)

    carry = torch.zeros((bsz, h, n, p), dtype=x.dtype, device=x.device) \
        if init_state is None else init_state.to(x.dtype)
    entering = []
    for ci in range(nc):                               # the scan over chunks
        entering.append(carry)                         # state entering ci
        carry = carry * chunk_decay[:, ci][..., None, None] + states[:, ci]
    entering = torch.stack(entering, dim=1)            # (B,NC,H,N,P)

    y_off = torch.einsum("bcln,bchnp->bclhp", cc, entering) \
        * torch.exp(acs)[..., None]
    y = (y + y_off).reshape(bsz, nc * l, h, p)[:, :s]
    if return_state:
        return y, carry
    return y


def _mix(params: SSM, cfg: ModelConfig, x, z, xbc_c, dt, init_state=None,
         shard_p: bool = False):
    """The SSD over the conv'd projections, the skip, the gate and the
    output projection; returns (y (B,S,D), final state). ``shard_p`` (the
    training block) shards the state expansion on the head dim p over
    'model', so no SSD einsum contracts over a sharded dim."""
    d_inner, h, n, p = dims(cfg)
    xs = view(xbc_c[..., :d_inner], *x.shape[:2], h, p)
    if shard_p:
        xs = constrain(xs, DP, None, None, "model")
    b = xbc_c[..., d_inner:d_inner + n]
    c = xbc_c[..., d_inner + n:]
    args = (xs.float(), dt, params.A_log, b.float(), c.float(), init_state)

    def ssd(xs, dt, a_log, b, c, init_state):
        return ssd_chunked(xs, dt, a_log, b, c, cfg.ssm_chunk,
                           return_state=True, init_state=init_state)

    if is_dtensor(xs):
        # p is a pure batch dim of every SSD einsum: each shard runs its own
        bsz, s = x.shape[:2]
        xsp = guard_spec((bsz, s, h, p), DP, None, None, "model")
        st = guard_spec((bsz, h, n, p), DP, None, None, "model")
        rows = guard_spec((bsz, s, h), DP, None, None)
        y, state = local_apply(ssd, args, (xsp, rows, (None,), rows, rows, st),
                               (xsp, st))
    else:
        y, state = ssd(*args)
    y = _merge_ready(y + params.D[:, None] * xs.float())
    y = view(y, *x.shape[:2], d_inner).to(x.dtype)
    y = rmsnorm(params.norm, y * F.silu(z), cfg)
    return y @ params.out_proj, state


def ssm_block(params: SSM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence mamba-2 mixer. x: (B,S,D) -> (B,S,D)."""
    z, xbc, dt = _split(params, x, cfg)
    return _mix(params, cfg, x, z, _conv_train(params, xbc), dt,
                shard_p=True)[0]


def _conv_tail(xbc: torch.Tensor, k: int) -> torch.Tensor:
    """The last ``k`` pre-conv projections, zero-padded on the left."""
    if xbc.shape[1] >= k:
        return xbc[:, -k:]
    return F.pad(xbc, (0, 0, k - xbc.shape[1], 0))


def ssm_block_prefill(params: SSM, x: torch.Tensor, cfg: ModelConfig,
                      cache: dict):
    """Full-sequence pass that also fills the decode cache (in place)."""
    z, xbc, dt = _split(params, x, cfg)
    y, state = _mix(params, cfg, x, z, _conv_train(params, xbc), dt)
    masked_copy_(cache["conv"], _conv_tail(xbc, cfg.ssm_conv - 1), None)
    masked_copy_(cache["state"], state, None)
    return y, cache


def _conv_resume(params: SSM, xbc: torch.Tensor,
                 tail: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv resumed mid-sequence: ``tail`` is the previous
    chunk's last ``ssm_conv - 1`` *pre-conv* projections; the multiply-add
    order of ``_conv_train``."""
    w = params.conv_w
    k, s = w.shape[0], xbc.shape[1]
    ext = torch.cat([tail.to(xbc.dtype), xbc], dim=1)  # (B, k-1+S, C)
    out = xbc * w[-1]
    for i in range(1, k):
        out = out + ext[:, k - 1 - i:k - 1 - i + s] * w[-1 - i]
    return F.silu(out + params.conv_b.to(out.dtype))


def ssm_block_prefill_chunk(params: SSM, x: torch.Tensor, cfg: ModelConfig,
                            cache: dict):
    """Chunk-resume prefill: consumes the incoming cache (conv tail +
    recurrence state) and writes the next one in place — equal to one-shot
    ``ssm_block_prefill`` when the prompt and every chunk are multiples of
    ``cfg.ssm_chunk`` (the engine enforces this before chunking)."""
    z, xbc, dt = _split(params, x, cfg)
    y, state = _mix(params, cfg, x, z,
                    _conv_resume(params, xbc, cache["conv"]), dt,
                    init_state=cache["state"])
    k = cfg.ssm_conv - 1
    tail = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)[:, -k:]
    masked_copy_(cache["conv"], tail, None)
    masked_copy_(cache["state"], state.float(), None)
    return y, cache


# ---------------------------------------------------------------------------
# decode path: O(1) per token
# ---------------------------------------------------------------------------
def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d_inner, h, n, p = dims(cfg)
    conv_dim = d_inner + 2 * n
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, h, n, p), dtype=torch.float32,
                                 device=device)}


def _merge_ready(y: torch.Tensor) -> torch.Tensor:
    """y (..., H, P) ready to merge its heads into d_inner: on a mesh, p
    gives up 'model' and the heads take it where they divide it (a DTensor
    merges dims only when the first of them is the one sharded)."""
    if not is_dtensor(y):
        return y
    spec = guard_spec(y.shape, *((DP,) + (None,) * (y.dim() - 3)
                                 + ("model", None)))
    return reshard(y, spec)


def _ssd_step(state, xs, dt1, a_log, b, c, d):
    """One token of the recurrence: state (B,H,N,P), xs (B,H,P), dt1 (B,H),
    b and c (B,N). Returns (y (B,H,P) with the skip, the new state)."""
    decay = torch.exp(dt1 * (-torch.exp(a_log)))       # (B,H)
    xdt = xs * dt1[..., None]                           # (B,H,P)
    state = state * decay[..., None, None] \
        + torch.einsum("bn,bhp->bhnp", b, xdt)
    y = torch.einsum("bn,bhnp->bhp", c, state)
    return y + d[:, None] * xs, state


def ssm_block_decode(params: SSM, x: torch.Tensor, cfg: ModelConfig,
                     cache: dict, active: Optional[torch.Tensor] = None):
    """One-token step. x: (B,1,D) -> (B,1,D); the cache is advanced in place
    on the rows where ``active`` (all rows when None)."""
    d_inner, h, n, p = dims(cfg)
    z, xbc, dt = _split(params, x, cfg)                # (B,1,...)
    window = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)  # (B,K,C)
    conv = torch.einsum("bkc,kc->bc", window, params.conv_w.to(window.dtype))
    xbc1 = F.silu(conv + params.conv_b).to(x.dtype)

    xs = view(xbc1[..., :d_inner], -1, h, p).float()
    b = xbc1[..., d_inner:d_inner + n].float()
    c = xbc1[..., d_inner + n:].float()
    dt1 = dt[:, 0]                                     # (B,H)

    args = (cache["state"], xs, dt1, params.A_log, b, c, params.D)
    if is_dtensor(xs):
        bsz = xs.shape[0]
        st = guard_spec((bsz, h, n, p), DP, None, None, "model")
        row = guard_spec((bsz, h, p), DP, None, "model")
        rep = guard_spec((bsz, n), DP, None)
        y, state = local_apply(_ssd_step, args,
                               (st, row, rep, (None,), rep, rep, (None,)),
                               (row, st))
    else:
        y, state = _ssd_step(*args)
    y = view(_merge_ready(y), -1, 1, d_inner).to(x.dtype)
    y = rmsnorm(params.norm, y * F.silu(z), cfg)
    masked_copy_(cache["conv"], window[:, 1:], active)
    masked_copy_(cache["state"], state, active)
    return y @ params.out_proj, cache


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Naive sequential recurrence — oracle for ``ssd_chunked``."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    decay = torch.exp(dt * (-torch.exp(a_log)))        # (B,S,H)
    xdt = x * dt[..., None]
    state = torch.zeros((bsz, h, n, p), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(s):
        state = state * decay[:, t][..., None, None] \
            + torch.einsum("bn,bhp->bhnp", b[:, t], xdt[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t], state))
    return torch.stack(ys, dim=1)
