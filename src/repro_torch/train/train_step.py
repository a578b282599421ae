"""The training step: loss and gradients, microbatch accumulation, AdamW,
and the immune router's regulation outside the gradient path (PyTorch port
of ``repro/train/train_step.py``).

``TrainState`` holds the :class:`~repro_torch.models.model.Model` as its
``params``; the optimizer state and the router state are in the JAX
package's layout (see ``optimizer``), and :func:`state_tree` gives the whole
state as the JAX package's pytree, which is what a checkpoint stores.

A step consumes its input state, as the JAX package's jitted step donates
it: the model's parameters are updated in place, so the returned state
shares the model with the old one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs.base import ModelConfig, TrainConfig
from ..core import router as irouter
from ..dist.checkpoint import flatten, unflatten
from ..models import layers
from ..models import model as model_lib
from . import optimizer as opt


class TrainState(NamedTuple):
    params: model_lib.Model
    opt: opt.AdamWState
    router: Optional[irouter.RouterState]   # leaves (L, E); None if dense
    step: torch.Tensor                      # () int32


def init_router(cfg: ModelConfig,
                device="cuda") -> Optional[irouter.RouterState]:
    """Each layer's fresh router state, stacked: leaves (L, E), steps (L,)."""
    if not cfg.num_experts:
        return None
    one = irouter.init_router_state(cfg.num_experts, device)
    return irouter.RouterState(*[x.expand((cfg.num_layers,) + x.shape).clone()
                                 for x in one])


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     tcfg: TrainConfig, state_dtype=torch.float32,
                     factored: bool = False, device="cuda") -> TrainState:
    """Random weights from ``gen`` (on the generator's device), placed on
    ``device`` with gradients on; zero moments; fresh router states."""
    params = model_lib.init_params(cfg, gen, device).requires_grad_(True)
    return TrainState(
        params=params,
        opt=opt.init_opt_state(model_lib.param_layout(params, cfg),
                               state_dtype=state_dtype, factored=factored),
        router=init_router(cfg, device),
        step=torch.zeros((), dtype=torch.int32, device=device))


class Metrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor
    lr: torch.Tensor
    aux_loss: torch.Tensor
    drop_frac: torch.Tensor
    load_cv: torch.Tensor     # mean over layers of expert-load CV (0 if dense)


def _stats(out: model_lib.TrainOut) -> dict:
    load = out.load_frac if out.load_frac is not None \
        else torch.zeros((1, 1), device=out.loss.device)
    return {"load_frac": load, "aux": out.aux_loss.detach(),
            "drop": out.drop_frac.detach()}


def loss_and_grads(model: model_lib.Model, cfg: ModelConfig, batch: dict,
                   router_bias: Optional[torch.Tensor] = None):
    """(loss, stats, grads) of one (micro)batch: the detached loss, the
    ``load_frac`` / ``aux`` / ``drop`` stats, and the gradients as the
    leaves of the JAX-layout parameter tree (``param_layout``'s flatten
    order; stacked leaves stacked), each in its parameter's dtype."""
    leaves, _ = flatten(model_lib.param_layout(model, cfg))
    flat = [p for leaf in leaves for p in leaf.params]
    out = model_lib.train_loss(model, cfg, batch, router_bias=router_bias)
    with layers.under_mesh():       # the backward meets the same constants
        g = iter(torch.autograd.grad(out.loss, flat, allow_unused=True,
                                     materialize_grads=True))
    grads = []
    for leaf in leaves:
        gs = [next(g) for _ in leaf.params]
        grads.append(torch.stack(gs) if leaf.stacked else gs[0])
    return out.loss.detach(), _stats(out), grads


def train_step(state: TrainState, batch: dict, cfg: ModelConfig,
               tcfg: TrainConfig,
               rcfg: irouter.RouterConfig = irouter.RouterConfig()):
    """One optimizer step over ``tcfg.accum_steps`` microbatches (gradients
    accumulated in fp32). Returns (new state, ``Metrics``)."""
    model = state.params
    bias = state.router.bias if state.router is not None else None
    if tcfg.accum_steps > 1:
        n = tcfg.accum_steps
        size = batch["tokens"].shape[0] // n
        grads = loss = stats = None
        for i in range(n):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            l_i, s_i, g_i = loss_and_grads(model, cfg, mb, bias)
            if grads is None:
                grads = [g.float() for g in g_i]
                loss, stats = l_i, s_i
            else:
                grads = [a + g for a, g in zip(grads, g_i)]
                loss = loss + l_i
                stats = {k: stats[k] + s_i[k] for k in stats}
        inv = 1.0 / n
        grads = [g * inv for g in grads]
        loss = loss * inv
        stats = {k: v * inv for k, v in stats.items()}
    else:
        loss, stats, grads = loss_and_grads(model, cfg, batch, bias)

    leaves, treedef = flatten(model_lib.param_layout(model, cfg))
    with torch.no_grad():
        params = unflatten(treedef, [leaf.value() for leaf in leaves])
        new_params, new_opt, gnorm = opt.adamw_update(
            unflatten(treedef, grads), state.opt, params, tcfg)
        del params, grads
        for leaf, t in zip(leaves, flatten(new_params)[0]):
            leaf.assign(t)

        new_router = state.router
        load_cv = torch.zeros((), device=loss.device)
        if state.router is not None:
            load = stats["load_frac"]                       # (L, E)
            new_router = irouter.update_router_state(state.router, load, rcfg)
            load_cv = irouter.load_cv(load).mean()

    metrics = Metrics(loss=loss, grad_norm=gnorm,
                      lr=opt.schedule(tcfg, state.step + 1),
                      aux_loss=stats["aux"], drop_frac=stats["drop"],
                      load_cv=load_cv)
    return TrainState(params=model, opt=new_opt, router=new_router,
                      step=state.step + 1), metrics


# ---------------------------------------------------------------------------
# the state as the JAX package's pytree (checkpoints, parity tests)
# ---------------------------------------------------------------------------
def state_tree(state: TrainState, cfg: ModelConfig) -> TrainState:
    """``state`` with its params as the JAX-layout tree of tensors: the
    JAX package's ``TrainState`` leaf for leaf."""
    return state._replace(params=model_lib.params_tree(state.params, cfg))


def load_state_tree(state: TrainState, tree: TrainState,
                    cfg: ModelConfig) -> TrainState:
    """Copy a JAX-layout ``tree`` (as :func:`state_tree` gives, e.g.
    restored from a checkpoint) into ``state``'s model; the optimizer,
    router and step are ``tree``'s."""
    model_lib.load_params(state.params, cfg, tree.params)
    return TrainState(params=state.params, opt=tree.opt, router=tree.router,
                      step=tree.step)


def train_state_to_numpy(state: TrainState, cfg: ModelConfig) -> TrainState:
    """The state as the JAX package's pytree of numpy arrays."""
    leaves, treedef = flatten(state_tree(state, cfg))
    return unflatten(treedef, [model_lib.to_numpy(x) for x in leaves])


def train_state_from_numpy(tree, cfg: ModelConfig, device="cuda") -> TrainState:
    """A JAX package ``TrainState`` (any pytree with its fields, numpy or
    JAX arrays as leaves) as the port's, on ``device``, gradients on."""
    def t(a):
        return model_lib._tensor(a).to(device)

    def tmap(sub):
        leaves, treedef = flatten(sub)
        return unflatten(treedef, [t(x) for x in leaves])

    params = model_lib.params_from_numpy(tree.params, cfg, device)
    return TrainState(
        params=params.requires_grad_(True),
        opt=opt.AdamWState(step=t(tree.opt.step), mu=tmap(tree.opt.mu),
                           nu=tmap(tree.opt.nu)),
        router=None if tree.router is None
        else irouter.RouterState(*[t(x) for x in tree.router]),
        step=t(tree.step))
