"""The port on a mesh, on the CPU: ``LocalTensorMode`` runs every rank of a
``fake`` process group in this process with real collective arithmetic, so
the DTensor model is held against the unsharded port and the JAX package.

* (2, 4): the smoke train state placed by ``train_state_shardings`` keeps
  every value, and some leaves are sharded.
* (2, 2), fp32: ``prefill`` and ``serve_step`` logits of smollm-360m and
  granite-moe-3b-a800m (dispatch groups = the DP size, as the dry-run sets
  them) within 1e-5 of the plain port and of JAX's.

The training cases are in ``test_torch_mesh_train.py``; the helpers both
share are in ``_torch_mesh.py``.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Shard

from _torch_mesh import (ARCHS, _close, _full, _place_batch, _setup,
                         local_world)
from repro.models import model as jmodel
from repro.serve import decode as jdecode
from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.dist import sharding as shd
from repro_torch.models import model as model_lib
from repro_torch.serve import decode
from repro_torch.train import train_step as ts

torch.set_num_threads(1)
jax.config.update("jax_platform_name", "cpu")


def test_train_state_places_on_2x4_mesh():
    """The counterpart of ``tests/test_sharding.py::
    test_train_state_places_on_8_device_mesh``: every leaf a DTensor whose
    global value is the plain leaf, and some of them sharded."""
    cfg = configs.get_config("smollm-360m").smoke()
    plain = ts.init_train_state(torch.Generator().manual_seed(0), cfg,
                                TrainConfig(), device="cpu")
    want = ts.state_tree(plain, cfg)
    with local_world((2, 4)) as mesh:
        state = copy.deepcopy(plain)
        state = shd.place(state, shd.train_state_shardings(state, cfg, mesh),
                          mesh, cfg)
        got = ts.state_tree(state, cfg)
        leaves, _ = ts.flatten(got)
        wleaves, _ = ts.flatten(want)
        assert len(leaves) == len(wleaves)
        for a, b in zip(leaves, wleaves):
            assert isinstance(a, DTensor)
            assert torch.equal(_full(a), b)
        params = list(state.params.parameters())
        assert all(isinstance(p, DTensor) for p in params)
        assert all(p.requires_grad for p in params)
        n_sharded = sum(any(isinstance(pl, Shard) for pl in x.placements)
                        for x in leaves + params)
    assert n_sharded > 0, "nothing sharded on the 2 x 4 mesh"


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_step_match_plain_and_jax(arch):
    jcfg, cfg, jp, tp, b, tb, bias = _setup(arch)
    bsz, s = tb["tokens"].shape
    jbias = None if bias is None else jnp.asarray(bias)
    tbias = None if bias is None else torch.from_numpy(bias)
    nxt = np.random.default_rng(1).integers(0, cfg.vocab_size, (bsz, 1)) \
        .astype(np.int32)

    jl, jc = jmodel.prefill(jp, jcfg, b, jmodel.init_cache(jcfg, bsz, s + 2),
                            router_bias=jbias)
    jd, _ = jdecode.serve_step(jp, jcfg, {"token": jnp.asarray(nxt)}, jc,
                               router_bias=jbias)
    pl, pc = model_lib.prefill(tp, cfg, tb, model_lib.init_cache(
        cfg, bsz, s + 2, "cpu"), attn_backend="torch", router_bias=tbias)
    pd, _ = decode.serve_step(tp, cfg, {"token": torch.from_numpy(nxt)}, pc,
                              router_bias=tbias)

    with local_world((2, 2)) as mesh:
        m = copy.deepcopy(tp)
        shd.place(m, shd.param_shardings(m, cfg, mesh), mesh, cfg)
        assert all(isinstance(p, DTensor) for p in m.parameters())
        cache = model_lib.init_cache(cfg, bsz, s + 2, "cpu")
        cache = shd.place(cache, shd.cache_shardings(cache, cfg, mesh), mesh)
        ml, cache = model_lib.prefill(m, cfg, _place_batch(tb, mesh), cache,
                                      attn_backend="torch",
                                      router_bias=tbias)
        md, _ = decode.serve_step(
            m, cfg, _place_batch({"token": torch.from_numpy(nxt)}, mesh),
            cache, router_bias=tbias)
        assert isinstance(ml, DTensor) and isinstance(md, DTensor)
        for got, plain, ref in ((ml, pl, jl), (md, pd, jd)):
            _close(got, plain)
            _close(got, ref)


def test_kernel_route_refuses_dtensors():
    """The hand-written kernels take plain tensors: a model on a mesh runs
    the torch route, and the MoE's kernel route says so."""
    jcfg, cfg, jp, tp, b, tb, bias = _setup("granite-moe-3b-a800m")
    with local_world((2, 2)) as mesh:
        m = copy.deepcopy(tp)
        shd.place(m, shd.param_shardings(m, cfg, mesh), mesh, cfg)
        cache = model_lib.init_cache(cfg, 4, 10, "cpu")
        cache = shd.place(cache, shd.cache_shardings(cache, cfg, mesh), mesh)
        with pytest.raises(ValueError, match="plain tensors"):
            model_lib.prefill(m, cfg, _place_batch(tb, mesh), cache,
                              attn_backend="kernel",
                              router_bias=torch.from_numpy(bias))
