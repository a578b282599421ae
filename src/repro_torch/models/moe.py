"""Mixture-of-Experts FFN with capacity-based sort dispatch and immune load
balancing (PyTorch port of ``repro/models/moe.py``).

Tokens' (token, slot) assignments are sorted by expert (stably), ranked
within their expert in token-major order, dropped beyond capacity (the
router's capacity factor is the anergy threshold), gathered into an
(E, C, D) buffer, pushed through the three expert products and combined back
with gates from the unbiased router scores.

``backend`` picks the expert products: ``"kernel"`` runs the grouped matmul
``kernels.moe_gmm`` (the hand-written CUDA kernel on CUDA tensors, its plain
version on CPU tensors) with each expert's live row count as its group size;
``"torch"`` runs the JAX package's einsums in the model dtype.

Nothing on this path reads a device value back to the host: counts are a
scatter-add, the grid of the grouped matmul is fixed by the shapes and its
group sizes stay on the device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..core import router as irouter
from ..kernels.moe_gmm import moe_gmm
from . import layers


class MoE(nn.Module):
    """Router (always float32, whatever the model dtype) and the experts'
    gated-FFN weights: ``w_gate``, ``w_up`` (E, D, F), ``w_down`` (E, F, D)."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.w_router = layers._param(layers.dense_init(gen, d, e,
                                                        torch.float32, device))
        self.w_gate = layers._param(layers._normal(gen, (e, d, f),
                                                   1.0 / math.sqrt(d), dt,
                                                   device))
        self.w_up = layers._param(layers._normal(gen, (e, d, f),
                                                 1.0 / math.sqrt(d), dt,
                                                 device))
        self.w_down = layers._param(layers._normal(gen, (e, f, d),
                                                   1.0 / math.sqrt(f), dt,
                                                   device))


class MoEStats(NamedTuple):
    load_frac: torch.Tensor     # (E,) observed load fractions
    aux_loss: torch.Tensor      # () Switch aux loss (router_mode == 'aux')
    drop_frac: torch.Tensor     # () fraction of assignments dropped


def capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(cfg.capacity_factor * tokens * cfg.experts_per_token
            / cfg.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _dispatch(tok: torch.Tensor, idx: torch.Tensor, e: int, c: int):
    """Sort-based gather-only dispatch for one token group.

    tok: (T, D); idx: (T, k). Returns (expert_in (E, C, D), slot_loc (T*k,),
    keep (T*k,), sizes (E,) int32) with ``slot_loc`` in unsorted (token-major)
    order and ``sizes`` each expert's live buffer rows (``min(count, C)``) —
    the grouped matmul's group sizes."""
    t, d = tok.shape
    k = idx.shape[-1]
    dev = tok.device
    flat_e = idx.reshape(-1)                                     # (T*k,)
    n = t * k
    token_id = torch.arange(n, device=dev) // k

    # stable sort by expert; rank within expert = position - expert start
    order = torch.argsort(flat_e, stable=True)
    inv_order = torch.argsort(order, stable=True)
    sorted_e = flat_e[order]
    counts = irouter.expert_counts(flat_e, e)
    starts = torch.cumsum(counts, 0) - counts

    # buffer row (e_, c_) holds the c_-th assignment of expert e_, i.e.
    # sorted position starts[e_] + c_
    rows = torch.arange(e, device=dev)[:, None]
    cols = torch.arange(c, device=dev)[None, :]
    sorted_pos = starts[rows] + cols                             # (E, C)
    valid = cols < torch.clamp(counts[rows], max=c)
    src_tok = torch.where(valid,
                          token_id[order[sorted_pos.clamp(0, n - 1)]],
                          torch.full_like(sorted_pos, t))        # pad row
    tok_pad = torch.cat([tok, tok.new_zeros((1, d))], 0)
    expert_in = tok_pad[src_tok]                                 # (E, C, D)

    # per-slot buffer location in unsorted order (for the combine gather)
    rank_unsorted = (torch.arange(n, device=dev) - starts[sorted_e])[inv_order]
    keep = rank_unsorted < c
    slot_loc = torch.where(keep, flat_e * c + rank_unsorted,
                           torch.full_like(flat_e, e * c))
    sizes = torch.clamp(counts, max=c).to(torch.int32)
    return expert_in, slot_loc, keep, sizes


def _combine(out: torch.Tensor, slot_loc: torch.Tensor, gates: torch.Tensor,
             keep: torch.Tensor, t: int) -> torch.Tensor:
    """Gather-only combine: y[t] = sum_k gate * out[slot_loc[t, k]]; the
    weighting runs in the output's dtype."""
    e, c, d = out.shape
    k = gates.shape[-1]
    out_flat = torch.cat([out.reshape(e * c, d), out.new_zeros((1, d))], 0)
    slot_out = out_flat[slot_loc].reshape(t, k, d)
    w = (gates * keep.reshape(t, k)).to(out.dtype)
    return torch.einsum("tkd,tk->td", slot_out, w)


def _act(cfg: ModelConfig):
    if cfg.act == "silu":
        return F.silu
    return lambda h: F.gelu(h, approximate="tanh")


def _experts(params: MoE, expert_in: torch.Tensor, sizes: torch.Tensor,
             cfg: ModelConfig, backend: str) -> torch.Tensor:
    """The three expert products of one group's (E, C, D) buffer."""
    act = _act(cfg)
    if backend == "kernel":
        h = act(moe_gmm(expert_in, params.w_gate, sizes)) \
            * moe_gmm(expert_in, params.w_up, sizes)
        return moe_gmm(h, params.w_down, sizes)
    h = act(torch.einsum("ecd,edf->ecf", expert_in, params.w_gate)) \
        * torch.einsum("ecd,edf->ecf", expert_in, params.w_up)
    return torch.einsum("ecf,efd->ecd", h, params.w_down)


def moe_ffn(params: MoE, x: torch.Tensor, cfg: ModelConfig,
            bias: torch.Tensor, backend: str = "kernel"):
    """x: (B, S, D) -> (y, MoEStats). ``bias`` (E,) is the immune router's
    selection bias. Tokens are dispatched within ``cfg.dispatch_groups``
    independent groups (1 when the token count does not divide), each with
    its own capacity."""
    layers.check_backend(backend)
    if layers.is_dtensor(x):
        return _moe_ffn_mesh(params, x, cfg, bias, backend)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    g = cfg.dispatch_groups if t % cfg.dispatch_groups == 0 else 1
    tl = t // g
    tok = x.reshape(g, tl, d)

    logits = tok.float() @ params.w_router                       # (G, Tl, E)
    idx, gates, probs = irouter.route(logits, bias, k)
    c = capacity(cfg, tl)
    ys, keeps = [], []
    for gi in range(g):
        expert_in, slot_loc, keep, sizes = _dispatch(tok[gi], idx[gi], e, c)
        out = _experts(params, expert_in, sizes, cfg, backend)
        ys.append(_combine(out, slot_loc, gates[gi], keep, tl))
        keeps.append(keep)
    y = torch.stack(ys)

    stats = MoEStats(
        load_frac=irouter.load_fractions(idx, e),
        aux_loss=irouter.aux_loss(idx, probs, e),
        drop_frac=1.0 - torch.stack(keeps).float().mean())
    return y.reshape(b, s, d), stats


def _moe_ffn_mesh(params: MoE, x, cfg: ModelConfig, bias, backend: str):
    """``moe_ffn`` on DTensors. Routing, dispatch and combine run per token
    group on the group's DP shard (``local_map``: the argsort and the
    scatter stay local, as in the JAX package with ``dispatch_groups`` =
    the DP size); the expert buffer is resharded to E over 'model' for the
    expert products and back to its DP shard before the combine — the
    expert-parallel all-to-all, made explicit. The products are the torch
    route's einsums: the grouped-matmul kernel takes plain tensors."""
    if backend == "kernel":
        raise ValueError("the grouped-matmul kernel takes plain tensors; a "
                         "model on a mesh runs attn_backend='torch'")
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    g = cfg.dispatch_groups if t % cfg.dispatch_groups == 0 else 1
    tl = t // g
    mesh = x.device_mesh
    tok = layers.constrain(layers.view(x, g, tl, d), layers.DP, None, None)
    local = layers.placements(layers.guard_spec((g, tl, d), layers.DP, None,
                                                None), mesh)
    tok = layers.as_dtensor(tok, mesh, local)
    logits = layers.as_dtensor(tok.float() @ params.w_router, mesh, local)
    rep = (Replicate(),) * mesh.ndim
    c = capacity(cfg, tl)

    def route_dispatch(tok_l, logits_l, bias_l):
        idx, gates, probs = irouter.route(logits_l, bias_l, k)
        parts = [_dispatch(tok_l[gi], idx[gi], e, c)
                 for gi in range(tok_l.shape[0])]
        counts = torch.stack([irouter.expert_counts(idx[gi], e)
                              for gi in range(tok_l.shape[0])])
        expert_in, slot_loc, keep, _ = (torch.stack(z) for z in zip(*parts))
        return expert_in, slot_loc, keep, gates, probs, counts

    expert_in, slot_loc, keep, gates, probs, counts = local_map(
        route_dispatch, out_placements=(local,) * 6,
        in_placements=(local, local, rep), device_mesh=mesh)(
        tok, logits, layers.as_dtensor(bias, mesh, rep))

    # expert-parallel products: E over 'model', groups on their DP shards
    expert_in = layers.constrain(expert_in, layers.DP, "model", None, None)
    act = _act(cfg)
    h = act(torch.einsum("gecd,edf->gecf", expert_in, params.w_gate)) \
        * torch.einsum("gecd,edf->gecf", expert_in, params.w_up)
    h = layers.constrain(h, layers.DP, "model", None, None)
    out = torch.einsum("gecf,efd->gecd", h, params.w_down)
    # the return all-to-all: each group's buffer back to its DP shard before
    # the combine gather
    out = layers.as_dtensor(
        layers.constrain(out, layers.DP, None, None, None), mesh, local)

    def combine(out_l, slot_l, gates_l, keep_l):
        return torch.stack([_combine(out_l[gi], slot_l[gi], gates_l[gi],
                                     keep_l[gi], tl)
                            for gi in range(out_l.shape[0])])

    y = local_map(combine, out_placements=(local,),
                  in_placements=(local, local, local, local),
                  device_mesh=mesh)(out, slot_loc, gates, keep)
    y = layers.constrain(y, layers.DP, None, None)

    load = counts.sum(0).to(torch.float32) / (t * k)
    stats = MoEStats(
        load_frac=load,
        aux_loss=e * torch.sum(load.detach() * probs.mean(dim=(0, 1))),
        drop_frac=1.0 - keep.float().mean())
    return layers.view(y, b, s, d), stats


def moe_ffn_reference(params: MoE, x: torch.Tensor, cfg: ModelConfig,
                      bias: torch.Tensor) -> torch.Tensor:
    """Dense one-hot reference (O(T·E) memory) — the oracle for tests, small
    shapes only. No capacity limit: equals ``moe_ffn`` exactly when nothing
    is dropped."""
    b, s, d = x.shape
    k = cfg.experts_per_token
    tok = x.reshape(-1, d)
    logits = tok.float() @ params.w_router
    idx, gates, _ = irouter.route(logits, bias, k)
    act = _act(cfg)
    h = act(torch.einsum("td,edf->tef", tok, params.w_gate)) \
        * torch.einsum("td,edf->tef", tok, params.w_up)
    full = torch.einsum("tef,efd->ted", h, params.w_down)        # (T, E, D)
    sel = torch.gather(full, 1, idx[:, :, None].expand(-1, -1, d))
    y = torch.sum(sel * gates[:, :, None].to(sel.dtype), dim=1)
    return y.reshape(b, s, d)
