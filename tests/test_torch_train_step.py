"""The port's train step (``repro_torch.train.train_step``) against the JAX
package's on the CPU: one step from a carried-over JAX ``TrainState`` with
``accum_steps`` 1 and 2, dense and MoE — new params, AdamW moments, router
state and ``Metrics``; the per-layer router regulation; the state's
round trip through the JAX package's pytree.

Tolerances: metrics within 1e-5; every state leaf within 5e-5 of its
max-abs after one step, with the optimizer's eps at 1e-4 — at the default
1e-8 a first Adam step is sign(g), and on gradient entries at the rounding
floor the two packages' sums flip that sign, whole lr-sized steps apart
(the gradients themselves agree within 1e-5: test_torch_train_loss.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import router as jrouter
from repro.data import pipeline as jpipe
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import router as irouter
from repro_torch.data import pipeline
from repro_torch.dist.checkpoint import flatten, unflatten
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

METRIC_TOL, STATE_TOL = 1e-5, 5e-5
PARITY_EPS = 1e-4


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = b.double().numpy()
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _carried(arch, accum, over=None, **train):
    over = over or {}
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(), **over)
    cfg = dataclasses.replace(configs.get_config(arch).smoke(), **over)
    kw = {**dict(learning_rate=1e-2, warmup_steps=0, decay_steps=100,
                 accum_steps=accum, eps=PARITY_EPS), **train}
    jt, tt = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    state = ts.train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                      "cpu")
    return jcfg, cfg, jt, tt, jstate, state


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(arch, accum):
    _step_matches_jax(*_carried(arch, accum))


def test_train_step_matches_jax_under_wsd():
    """minicpm-2b under its own schedule, WSD, from a step in the 1-sqrt
    decay tail (no plateau: stable_frac 0; lr x 1/2 at step 1)."""
    args = _carried("minicpm-2b", 1, schedule="wsd", decay_steps=4,
                    stable_frac=0.0)
    assert float(opt.schedule(args[3], torch.tensor(1))) == \
        pytest.approx(0.5e-2, rel=1e-6)
    _step_matches_jax(*args)


def _step_matches_jax(jcfg, cfg, jt, tt, jstate, state):
    batch, _ = jpipe.sample_batch(jcfg, 4, 16, jpipe.init_data_state())
    jnew, jm = jax.jit(lambda s, b: jts.train_step(s, b, jcfg, jt))(jstate,
                                                                   batch)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    new, m = ts.train_step(state, tb, cfg, tt)
    for name, a, b in zip(jm._fields, jm, m):
        assert abs(float(a) - float(b)) <= METRIC_TOL, name
    ja = jax.tree.leaves(jnew)
    tb_, _ = flatten(ts.state_tree(new, cfg))
    assert len(ja) == len(tb_)
    for a, b in zip(ja, tb_):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        assert _rel(a, b) <= STATE_TOL
    assert int(new.step) == int(new.opt.step) == 1
    if jcfg.num_experts:
        assert new.router.bias.abs().max() > 0
        assert (new.router.steps == 1).all()


def test_accumulation_sums_in_fp32():
    """With accum_steps 2 the gradients are the fp32 mean of the two
    microbatches' (bf16 parameters give bf16 microbatch gradients): the
    step equals AdamW applied to that mean by hand, in place on the
    Parameters as the step applies it (``adamw_step``)."""
    from repro_torch.models import model as model_lib
    from repro_torch.train import optimizer as opt
    cfg = dataclasses.replace(configs.get_config("smollm-360m").smoke(),
                              dtype="bfloat16")
    tt = TrainConfig(learning_rate=1e-2, warmup_steps=0, accum_steps=2)
    gen = torch.Generator().manual_seed(0)
    tree = ts.train_state_to_numpy(ts.init_train_state(
        gen, cfg, tt, device="cpu"), cfg)
    batch, _ = pipeline.sample_batch(cfg, 4, 16,
                                     pipeline.init_data_state("cpu"))
    new, _ = ts.train_step(ts.train_state_from_numpy(tree, cfg, "cpu"),
                           batch, cfg, tt)
    ref = ts.train_state_from_numpy(tree, cfg, "cpu")
    halves = [ts.loss_and_grads(ref.params, cfg,
                                {k: v[i * 2:(i + 1) * 2]
                                 for k, v in batch.items()})[2]
              for i in range(2)]
    leaves, treedef = flatten(model_lib.param_layout(ref.params, cfg))
    assert [g.dtype for g in halves[0]] == [leaf.dtype for leaf in leaves]
    assert torch.bfloat16 in {g.dtype for g in halves[0]}
    mean = [(a.float() + b) * 0.5 for a, b in zip(*halves)]
    per_param = [g for leaf, m in zip(leaves, mean)
                 for g in (m.unbind(0) if leaf.stacked else [m])]
    opt.adamw_step(unflatten(treedef, leaves), per_param, ref.opt, tt)
    for a, b in zip(flatten(model_lib.params_tree(ref.params, cfg))[0],
                    flatten(model_lib.params_tree(new.params, cfg))[0]):
        assert torch.equal(a, b)


def test_router_regulation_per_layer_matches_jax_vmap():
    """``update_router_state`` on (L, E) leaves regulates each layer as the
    JAX package's vmap does; ``load_cv`` per layer likewise."""
    over = {"num_layers": 4}
    jst = jts.init_router(dataclasses.replace(
        jconfigs.get_config("granite-moe-3b-a800m").smoke(), **over))
    st = ts.init_router(dataclasses.replace(
        configs.get_config("granite-moe-3b-a800m").smoke(), **over), "cpu")
    rng = np.random.default_rng(0)
    load = rng.dirichlet(np.ones(8), size=4).astype(np.float32)
    for a, b in zip(jst, st):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
    for mode in ("immune", "sign", "aux"):
        jcfg, cfg = jrouter.RouterConfig(mode=mode), \
            irouter.RouterConfig(mode=mode)
        ja, ta = jst, st
        for _ in range(3):
            ja = jax.vmap(lambda s, l: jrouter.update_router_state(
                s, l, jcfg))(ja, jnp.asarray(load))
            ta = irouter.update_router_state(ta, torch.from_numpy(load), cfg)
        for a, b in zip(ja, ta):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
    cv = jax.vmap(jrouter.load_cv)(jnp.asarray(load))
    np.testing.assert_allclose(irouter.load_cv(torch.from_numpy(load))
                               .numpy(), np.asarray(cv), rtol=1e-6)


@pytest.mark.parametrize("arch,factored,dtype", [
    ("smollm-360m", False, torch.float32),
    ("granite-moe-3b-a800m", True, torch.float32),
    ("recurrentgemma-9b", True, torch.bfloat16)])
def test_state_round_trips_through_the_jax_tree(arch, factored, dtype):
    cfg = configs.get_config(arch).smoke()
    state = ts.init_train_state(torch.Generator().manual_seed(0), cfg,
                                TrainConfig(), state_dtype=dtype,
                                factored=factored, device="cpu")
    tree = ts.train_state_to_numpy(state, cfg)
    back = ts.train_state_from_numpy(tree, cfg, "cpu")
    la, _ = flatten(ts.state_tree(state, cfg))
    lb, _ = flatten(ts.state_tree(back, cfg))
    assert len(la) == len(lb)
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(p.requires_grad for p in back.params.parameters())


class TestTrainStepMoE:
    """Port copy of ``tests/test_train.py::TestTrainStepMoE``."""

    def test_router_state_regulates_during_training(self):
        cfg = configs.get_config("granite-moe-3b-a800m").smoke()
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0,
                           decay_steps=1000)
        state = ts.init_train_state(torch.Generator().manual_seed(0), cfg,
                                    tcfg, device="cpu")
        data = pipeline.init_data_state("cpu")
        cvs = []
        for _ in range(8):
            batch, data = pipeline.sample_batch(cfg, 4, 32, data)
            state, metrics = ts.train_step(state, batch, cfg, tcfg)
            cvs.append(float(metrics.load_cv))
        assert np.isfinite(cvs).all()
        assert state.router.bias.abs().max() > 0, "router bias never updated"
