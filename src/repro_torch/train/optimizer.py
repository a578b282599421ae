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

:func:`adamw_step` updates in place: each Parameter a leaf stacks (a
``models.model.ParamLeaf``) through views of the stacked moments, with no
stacked copy of the parameters or the gradients and no clipped copy of the
gradients. Its arithmetic is the functional :func:`adamw_update`'s (which
runs it on copies), op for op, in ``torch._foreach_*`` calls over groups
whose fp32 temporaries stay within ``GROUP_BYTES`` (1 GB) whatever the
leaf (a factored leaf whose row and column means span more is updated
whole).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..configs.base import TrainConfig
from ..dist.checkpoint import flatten, unflatten
from ..models import layers
from ..models.model import ParamLeaf

# bytes of the fp32 temporaries one group of the in-place update may hold:
# at most three temporaries of a group's size are alive at once (four with
# bf16 moments), so a group holds GROUP_BYTES / 12 elements (/ 16)
GROUP_BYTES = 1 << 30


def _group_elems(state_dtype: torch.dtype) -> int:
    return GROUP_BYTES // (4 * (3 if state_dtype == torch.float32 else 4))


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


def _unit_update(p, g, mu, nu, decayed: bool, scale, c1, c2, lr,
                 cfg: TrainConfig) -> None:
    """One tensor's AdamW step in place, whole: a factored leaf, whose row
    and column means span it."""
    b1, b2 = cfg.beta1, cfg.beta2
    gf = (g.float() * scale).to(g.dtype).float()
    mu_n = b1 * mu.float() + (1 - b1) * gf
    nu_n = _nu_update(nu, gf.square(), b2)
    u = (mu_n / c1) / (torch.sqrt(_nu_value(nu_n) / c2) + cfg.eps)
    if decayed:
        u = u + cfg.weight_decay * p.float()
    mu.copy_(mu_n)
    if isinstance(nu, dict):
        for k, v in nu_n.items():
            nu[k].copy_(v)
    else:
        nu.copy_(nu_n)
    p.copy_((p.float() - lr * u).to(p.dtype))


def _copy_(dst: list, src: list) -> None:
    """``dst[i].copy_(src[i])`` (cast to ``dst``'s dtype): one multi-tensor
    call, or one a tensor for DTensors, which have no sharding rule for
    it."""
    if layers.is_dtensor(dst[0]):
        for d, x in zip(dst, src):
            d.copy_(x)
    else:
        torch._foreach_copy_(dst, src)


def _f32(xs: list) -> list:
    """``xs`` as float32: the same list where it is float32 already, else
    new tensors."""
    if all(x.dtype == torch.float32 for x in xs):
        return xs
    out = [torch.empty_like(x, dtype=torch.float32) for x in xs]
    _copy_(out, xs)
    return out


def _group_update(ps, gs, mus, nus, decayed: list, scale, c1, c2, lr,
                  cfg: TrainConfig) -> None:
    """The AdamW step of a group of tensors in place, the arithmetic of
    :func:`_unit_update` (not factored) in multi-tensor calls. ``gs`` are
    consumed: they end as the clipped gradients."""
    b1, b2 = cfg.beta1, cfg.beta2
    gf = _f32(gs)
    torch._foreach_mul_(gf, scale)
    if gf is not gs:                       # rounded to the gradients' dtype
        _copy_(gs, gf)
        _copy_(gf, gs)
    mf = _f32(mus)
    torch._foreach_mul_(mf, b1)
    torch._foreach_add_(mf, torch._foreach_mul(gf, 1 - b1))
    if mf is not mus:
        _copy_(mus, mf)
    vf = _f32(nus)
    torch._foreach_mul_(vf, b2)
    g2 = torch._foreach_mul(gf, gf)
    del gf
    torch._foreach_mul_(g2, 1 - b2)
    torch._foreach_add_(vf, g2)
    del g2
    if vf is not nus:
        _copy_(nus, vf)
    u = torch._foreach_div(mf, c1)
    del mf
    den = torch._foreach_div(vf, c2)
    del vf
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(u, den)
    del den
    pf = _f32(ps)
    dec = [i for i, d in enumerate(decayed) if d]
    if dec:
        torch._foreach_add_([u[i] for i in dec], torch._foreach_mul(
            [pf[i] for i in dec], cfg.weight_decay))
    torch._foreach_mul_(u, lr)
    torch._foreach_sub_(pf, u)
    if pf is not ps:
        _copy_(ps, pf)


def _pieces(ts: tuple, limit: int) -> list:
    """Same-shaped tensors cut along their first dimension into views of at
    most ``limit`` elements (a DTensor, or one that fits, whole)."""
    t = ts[0]
    if t.numel() <= limit or t.dim() == 0 or layers.is_dtensor(t):
        return [ts]
    rows = max(1, limit * t.shape[0] // t.numel())
    return [tuple(x[a:a + rows] for x in ts)
            for a in range(0, t.shape[0], rows)]


def _batches(units: list, limit: int):
    """Consecutive units in groups of at most ``limit`` elements (a larger
    unit alone)."""
    batch, size = [], 0
    for unit in units:
        n = unit[0].numel()
        if batch and size + n > limit:
            yield batch
            batch, size = [], 0
        batch.append(unit)
        size += n
    if batch:
        yield batch


@torch.no_grad()
def adamw_step(layout, grads: list, state: AdamWState, cfg: TrainConfig,
               lr: Optional[torch.Tensor] = None):
    """AdamW in place. ``layout``: the parameter tree with a
    :class:`~repro_torch.models.model.ParamLeaf` at every leaf (the JAX
    leaf's shape decides decay; the moments' layout, factoring); ``grads``:
    the gradients of the leaves' Parameters in that order (consumed).
    Clips by the global norm, updates the moments through per-repeat views
    and each Parameter in place. Returns (new state, grad norm); the new
    state holds ``state``'s moment tensors."""
    leaves, treedef = flatten(layout)
    mus = flatten(state.mu)[0]
    nus = _leaves_up_to(treedef, state.nu)
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    norms = [n for gs in by_dtype.values()
             for n in torch._foreach_norm(gs, 2, dtype=torch.float32)]
    gnorm = torch.sqrt(torch.stack(norms).square().sum())
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step) if lr is None else lr
    c1 = 1.0 - cfg.beta1 ** step.float()
    c2 = 1.0 - cfg.beta2 ** step.float()

    groups: dict = {}          # (dtypes, device) -> units of the plain update
    g_it = iter(grads)
    for leaf, mu, nu in zip(leaves, mus, nus, strict=True):
        gs = [next(g_it) for _ in leaf.params]
        decayed = len(leaf.shape) >= 2
        if isinstance(nu, dict) and not (leaf.stacked
                                         and leaf.params[0].dim() >= 2):
            # factored, the row / column means over the whole leaf
            p = torch.stack(leaf.params) if leaf.stacked else leaf.params[0]
            g = torch.stack(gs) if leaf.stacked else gs[0]
            _unit_update(p, g, mu, nu, decayed, scale, c1, c2, lr, cfg)
            if leaf.stacked:
                for r, q in enumerate(leaf.params):
                    q.copy_(p[r])
            continue
        for r, (p, g) in enumerate(zip(leaf.params, gs)):
            m = mu[r] if leaf.stacked else mu
            v = nu if not leaf.stacked else (
                {k: x[r] for k, x in nu.items()} if isinstance(nu, dict)
                else nu[r])
            if isinstance(v, dict):
                _unit_update(p, g, m, v, decayed, scale, c1, c2, lr, cfg)
                continue
            key = (p.dtype, g.dtype, m.dtype, p.device)
            for unit in _pieces((p, g, m, v), _group_elems(m.dtype)):
                groups.setdefault(key, []).append(unit + (decayed,))
    for (_, _, state_dtype, _), units in groups.items():
        for batch in _batches(units, _group_elems(state_dtype)):
            _group_update(*(list(z) for z in zip(*batch)), scale, c1, c2, lr,
                          cfg)
    return AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm


def adamw_update(grads, state: AdamWState, params, cfg: TrainConfig,
                 lr: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state, grad_norm): :func:`adamw_step` on
    copies of ``params`` and ``grads`` (trees), each leaf one tensor.
    Gradients are clipped by their global norm; weight decay is decoupled
    and skipped for 1-D leaves. The moments are updated in place: the new
    state holds ``state``'s moment tensors."""
    flat_p, treedef = flatten(params)
    new = [p.detach().clone() for p in flat_p]
    leaves = []
    for p in new:
        leaf = ParamLeaf("", stacked=False)
        leaf.params.append(p)
        leaves.append(leaf)
    new_state, gnorm = adamw_step(
        unflatten(treedef, leaves),
        [g.detach().clone() for g in flatten(grads)[0]], state, cfg, lr)
    return unflatten(treedef, new), new_state, gnorm
