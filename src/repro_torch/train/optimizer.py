"""AdamW and the learning-rate schedules (PyTorch port of
``repro/train/optimizer.py``), on pytrees in the JAX package's layout.

Memory knobs, as in the JAX package:
  * ``state_dtype`` — dtype of the first / second moments (fp32 or bf16)
  * ``factored``    — Adafactor-style factored second moment for leaves of
                      two or more dimensions (row / col accumulators)

Schedules: ``cosine`` and ``wsd`` (warmup-stable-decay: linear warmup, a
stable plateau, then a 1-sqrt decay tail).

Every function takes trees of dicts and lists whose leaves are tensors (or,
for :func:`init_opt_state`, anything with ``shape`` and ``device``) in the
JAX package's parameter layout. Weight decay (``ndim >= 2``) and factoring
(:func:`_factorable`) are decided on those leaves, so a norm scale stacked
over its segment's R repeats, (R, D), is decayed — and factored when R > 1 —
as in the JAX package, while ``final_norm``'s (D,) is not. The moments keep
the same layout, so an ``AdamWState`` checkpoints in the JAX package's
format.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..configs.base import TrainConfig
from ..dist.checkpoint import flatten, unflatten


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor; the result stays on its
    device)."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "wsd":
        stable_end = cfg.stable_frac * cfg.decay_steps
        frac = torch.clamp((s - stable_end)
                           / max(cfg.decay_steps - stable_end, 1), 0.0, 1.0)
        decay = 1.0 - torch.sqrt(frac)           # MiniCPM's 1-sqrt tail
    else:
        frac = torch.clamp(s / max(cfg.decay_steps, 1), 0.0, 1.0)
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.learning_rate * warm * decay


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32
    mu: dict
    nu: dict              # full second moment, or {"row", "col"} when factored


def _factorable(x) -> bool:
    return len(x.shape) >= 2 and x.shape[-1] > 1 and x.shape[-2] > 1


def init_opt_state(params, state_dtype=torch.float32,
                   factored: bool = False) -> AdamWState:
    """Zero moments shaped like ``params``' leaves, on each leaf's
    device."""
    leaves, treedef = flatten(params)

    def zeros(shape, p):
        return torch.zeros(shape, dtype=state_dtype, device=p.device)

    def mk_nu(p):
        shape = tuple(p.shape)
        if factored and _factorable(p):
            return {"row": zeros(shape[:-1], p),
                    "col": zeros(shape[:-2] + shape[-1:], p)}
        return zeros(shape, p)

    device = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=unflatten(treedef, [zeros(tuple(p.shape), p) for p in leaves]),
        nu=unflatten(treedef, [mk_nu(p) for p in leaves]))


def _nu_update(nu, g2: torch.Tensor, b2: float):
    if isinstance(nu, dict):
        return {"row": b2 * nu["row"].float() + (1 - b2) * g2.mean(dim=-1),
                "col": b2 * nu["col"].float() + (1 - b2) * g2.mean(dim=-2)}
    return b2 * nu.float() + (1 - b2) * g2


def _nu_value(nu) -> torch.Tensor:
    if isinstance(nu, dict):
        row, col = nu["row"], nu["col"]
        denom = torch.clamp(row.mean(dim=-1, keepdim=True), min=1e-30)
        return row[..., None] * col[..., None, :] / denom[..., None]
    return nu


def global_norm(tree) -> torch.Tensor:
    leaves, _ = flatten(tree)
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in leaves]).sum())


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    leaves, treedef = flatten(grads)
    return unflatten(treedef, [(g.float() * scale).to(g.dtype)
                               for g in leaves]), norm


def _leaves_up_to(treedef, tree) -> list:
    """The subtrees of ``tree`` at the leaf positions of ``treedef`` (a
    factored second moment's {"row", "col"} dict is one of them)."""
    out: list = []

    def walk(d, node):
        kind = d[0]
        if kind == "leaf":
            out.append(node)
        elif kind == "dict":
            for k, c in zip(d[1], d[2]):
                walk(c, node[k])
        elif kind != "none":
            for c, v in zip(d[-1], node):
                walk(c, v)

    walk(treedef, tree)
    return out


def adamw_update(grads, state: AdamWState, params, cfg: TrainConfig,
                 lr: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state, grad_norm). Gradients are clipped by
    their global norm; weight decay is decoupled and skipped for 1-D
    leaves. The moments are updated in place, one leaf at a time: the new
    state holds ``state``'s moment tensors, so a step keeps one copy of
    them, not an old and a new one (with fp32 moments of 2.72 B parameters,
    21.8 GB less)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(cfg, step) if lr is None else lr
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, mu, nu):
        gf = g.float()
        mu_n = b1 * mu.float() + (1 - b1) * gf
        nu_n = _nu_update(nu, gf.square(), b2)
        u = (mu_n / c1) / (torch.sqrt(_nu_value(nu_n) / c2) + cfg.eps)
        if p.dim() >= 2:
            u = u + cfg.weight_decay * p.float()
        mu.copy_(mu_n)
        if isinstance(nu, dict):
            for k, v in nu_n.items():
                nu[k].copy_(v)
        else:
            nu.copy_(nu_n)
        return (p.float() - lr * u).to(p.dtype)

    flat_p, treedef = flatten(params)
    flat_g, _ = flatten(grads)
    flat_mu, _ = flatten(state.mu)
    flat_nu = _leaves_up_to(treedef, state.nu)
    new_p = [upd(p, g, m, n) for p, g, m, n in zip(flat_p, flat_g, flat_mu,
                                                   flat_nu, strict=True)]
    return (unflatten(treedef, new_p),
            AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm)
