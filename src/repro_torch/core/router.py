"""Immune-regulated MoE expert load balancing (PyTorch port of
``repro/core/router.py``): the paper's technique at the ML layer.

Expert loads are agent *populations*. The router's selection bias ``b_e`` is
regulated state, not a trained parameter:

  * immunological memory  — EMA of observed per-expert load fractions
  * two-stage delayed suppression — a suppressor state ``s_e`` integrates the
    EMA overload and the bias is set from it, so overloaded experts are
    suppressed only after the suppressor population builds (T4 -> T8)
  * tolerance / anergy + IL-2 revival — starved experts (EMA below a floor)
    receive a revival boost so they are not permanently silenced
  * limit-cycle damping — suppressor leak + bias clipping bound the loop

The bias enters *selection only* (top-k); the combine weights use the raw
router scores. Baselines: ``aux`` (Switch-style auxiliary loss), ``sign``
(first-order bias update), ``none``.

Every state is a float32 tensor, as in the JAX package. Serving uses
``route`` and ``load_fractions``; training adds the aux loss and the
regulation step, one state per layer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32


class RouterConfig(NamedTuple):
    mode: str = "immune"        # immune | aux | sign | none
    mem_decay: float = 0.9      # immunological-memory EMA
    couple: float = 2.0         # suppressor build-up rate (per unit overload)
    leak: float = 0.05          # suppressor leak (limit-cycle damping)
    gain: float = 1.0           # bias contribution of the (delayed) suppressor
    prop: float = 10.0          # proportional damping on instantaneous overload
    revival: float = 0.05       # IL-2 boost for starved (anergic) experts
    starve_frac: float = 0.2    # starved = EMA load < starve_frac / E
    bias_clip: float = 4.0
    sign_gamma: float = 0.001   # the 'sign' baseline's step


class RouterState(NamedTuple):
    bias: torch.Tensor          # (E,) selection bias
    mem: torch.Tensor           # (E,) EMA of load fractions (memory)
    suppressor: torch.Tensor    # (E,) delayed negative-feedback population
    steps: torch.Tensor         # () int32 update count


def init_router_state(num_experts: int, device="cuda") -> RouterState:
    z = torch.zeros((num_experts,), dtype=F32, device=device)
    return RouterState(bias=z, mem=z + 1.0 / num_experts, suppressor=z,
                       steps=torch.zeros((), dtype=torch.int32, device=device))


def update_router_state(state: RouterState, load_frac: torch.Tensor,
                        cfg: RouterConfig) -> RouterState:
    """One regulation step given the observed per-expert load fractions
    (sum == 1). Every leaf may carry leading dims — (L, E), one state per
    layer, as training keeps them — regulated row by row."""
    load_frac = load_frac.to(F32)
    e = load_frac.shape[-1]
    target = 1.0 / e
    mem = cfg.mem_decay * state.mem + (1.0 - cfg.mem_decay) * load_frac
    overload = mem - target
    # the suppressor accumulates remembered overload (a leaky integrator: the
    # T8 build-up delay); the bias is set from it plus a proportional term
    suppressor = (1.0 - cfg.leak) * state.suppressor + cfg.couple * overload
    bias = -(cfg.gain * suppressor + cfg.prop * overload)
    starved = mem < cfg.starve_frac * target          # anergy revival (IL-2)
    bias = bias + cfg.revival * starved.to(F32)
    bias = torch.clamp(bias - bias.mean(dim=-1, keepdim=True),
                       -cfg.bias_clip, cfg.bias_clip)
    if cfg.mode == "sign":
        bias = torch.clamp(
            state.bias + cfg.sign_gamma * torch.sign(target - load_frac),
            -cfg.bias_clip, cfg.bias_clip)
        suppressor = state.suppressor
    elif cfg.mode in ("aux", "none"):
        bias = state.bias          # aux/none do not use a selection bias
        suppressor = state.suppressor
    return RouterState(bias=bias, mem=mem, suppressor=suppressor,
                       steps=state.steps + 1)


def route(logits: torch.Tensor, bias: torch.Tensor, k: int):
    """Top-k selection with a selection-only bias.

    logits: (..., E) raw router scores; bias: (E,). Returns (indices (..., k)
    int64, gates (..., k) f32, probs (..., E) f32). Gates come from the
    *unbiased* scores. Among equal biased scores the lower expert index wins,
    as in ``jax.lax.top_k`` (a stable descending sort; ``torch.topk`` makes
    no such promise)."""
    if bias is None:
        raise ValueError("MoE routing needs a router bias of shape (E,)")
    lf = logits.to(F32)
    probs = torch.softmax(lf, dim=-1)
    _, order = torch.sort(lf + bias.to(F32), dim=-1, descending=True,
                          stable=True)
    idx = order[..., :k]
    gates = torch.softmax(torch.gather(lf, -1, idx), dim=-1)
    return idx, gates, probs


def expert_counts(idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """(E,) int64 number of (token, slot) assignments per expert. A
    scatter-add of ones: ``torch.bincount`` on a CUDA tensor reads its
    maximum back to the host, a sync this must not cost on every layer."""
    flat = idx.reshape(-1)
    counts = torch.zeros((num_experts,), dtype=torch.int64, device=idx.device)
    return counts.scatter_add_(0, flat, torch.ones_like(flat))


def load_fractions(idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Fraction of (token, slot) assignments per expert; sums to 1."""
    return expert_counts(idx, num_experts).to(F32) / idx.numel()


def aux_loss(idx: torch.Tensor, probs: torch.Tensor,
             num_experts: int) -> torch.Tensor:
    """Switch-transformer auxiliary loss: E * sum_e f_e * p_e; ``probs`` is
    (..., E) with any leading dims."""
    f = load_fractions(idx, num_experts).detach()
    p = probs.reshape(-1, probs.shape[-1]).mean(dim=0)
    return num_experts * torch.sum(f * p)


def load_cv(load_frac: torch.Tensor) -> torch.Tensor:
    """Coefficient of variation of expert loads over the last dim (0 ==
    perfectly balanced)."""
    mean = load_frac.mean(dim=-1)
    return load_frac.std(dim=-1, correction=0) / torch.clamp(mean, min=1e-9)
