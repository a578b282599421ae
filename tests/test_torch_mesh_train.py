"""The port's training pass on a mesh, on the CPU, under
``LocalTensorMode`` (see ``test_torch_mesh_parallel.py``): at (2, 2), fp32,
``train_loss`` and its gradients (through ``train_step.loss_and_grads``)
within 1e-5 of the unsharded port and of ``jax.value_and_grad`` — the loss
absolutely, each gradient leaf of its max-abs — for smollm-360m and
granite-moe-3b-a800m; the vocab-sharded target logit and the MoE's
per-group dispatch are on this path.
"""
import copy

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import DTensor

from _torch_mesh import (ARCHS, TOL, _close, _full, _place_batch, _rel,
                         _setup, local_world)
from repro.models import model as jmodel
from repro_torch.dist import sharding as shd
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

torch.set_num_threads(1)
jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_plain_and_jax(arch):
    jcfg, cfg, jp, tp, b, tb, bias = _setup(arch)
    jbias = None if bias is None else jnp.asarray(bias)
    tbias = None if bias is None else torch.from_numpy(bias)

    def loss_fn(p):
        out = jmodel.train_loss(p, jcfg, b, router_bias=jbias)
        return out.loss, out

    (jl, _), jg = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    jleaves = jax.tree.leaves(jg)
    plain = copy.deepcopy(tp).requires_grad_(True)
    ploss, pstats, pgrads = ts.loss_and_grads(plain, cfg, tb, tbias)

    with local_world((2, 2)) as mesh:
        m = copy.deepcopy(tp).requires_grad_(True)
        shd.place(m, shd.param_shardings(m, cfg, mesh), mesh, cfg)
        loss, stats, grads = ts.loss_and_grads(m, cfg, _place_batch(tb, mesh),
                                               tbias)
        assert isinstance(loss, DTensor)
        assert abs(float(_full(loss)) - float(ploss)) <= TOL
        assert abs(float(_full(loss)) - float(jl)) <= TOL
        assert len(grads) == len(pgrads) == len(jleaves)
        for g, p, j in zip(grads, pgrads, jleaves):
            assert tuple(g.shape) == tuple(p.shape) == tuple(j.shape)
            assert _rel(p, g) <= TOL
            assert _rel(j, g) <= TOL
        if cfg.num_experts:
            _close(stats["load_frac"], pstats["load_frac"])


def test_optimizer_tree_functions_accept_dtensors():
    """``opt.global_norm`` over DTensor leaves equals the plain norm (the
    all-reduce of the sharded sums)."""
    g = torch.Generator().manual_seed(3)
    leaves = {"a": torch.randn(8, 4, generator=g),
              "b": [torch.randn(4, generator=g)]}
    want = opt.global_norm(leaves)
    with local_world((2, 2)) as mesh:
        specs = {"a": shd.P("data", "model"), "b": [shd.P()]}
        got = opt.global_norm(shd.place(leaves, specs, mesh))
        _close(got, want, tol=1e-6)
