"""The port's immune MoE router against the JAX package's on the same inputs
(float32 on both sides; equal to 1e-6): routing with a selection bias, the
regulation step in every mode over 200 steps, load fractions, the aux loss
and the load CV. Inputs are drawn with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as jrouter
from repro_torch.core import router

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-6, atol=1e-6)


def _logits(seed, t, e):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(e)).astype(np.float32)
    return logits, bias


@pytest.mark.parametrize("t,e,k", [(64, 8, 2), (37, 40, 8), (5, 4, 4)])
def test_route_matches_jax(t, e, k):
    logits, bias = _logits(t * e + k, t, e)
    idx, gates, probs = router.route(torch.as_tensor(logits),
                                     torch.as_tensor(bias), k)
    jidx, jgates, jprobs = jrouter.route(jnp.asarray(logits),
                                         jnp.asarray(bias), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), **TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)


def test_route_ties_pick_the_lower_expert_like_jax():
    """Equal biased scores: ``jax.lax.top_k`` puts the lower index first,
    and so must the port (inactive decode lanes route all-equal rows)."""
    e, k = 8, 3
    logits = np.zeros((4, e), np.float32)
    logits[1] = [1, 2, 2, 2, 0, 2, 1, 1]
    logits[2, ::2] = 5.0
    logits[3] = [3, 3, 3, 3, 3, 3, 3, 3]
    bias = np.zeros(e, np.float32)
    bias[6] = 1.0                 # expert 6 first, then the lowest ties
    idx, _, _ = router.route(torch.as_tensor(logits), torch.as_tensor(bias),
                             k)
    jidx, _, _ = jrouter.route(jnp.asarray(logits), jnp.asarray(bias), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.tolist() == [[6, 0, 1], [1, 2, 3], [6, 0, 2], [6, 0, 1]]


def test_route_batched_leading_dims():
    logits, bias = _logits(3, 24, 8)
    idx, gates, _ = router.route(torch.as_tensor(logits).reshape(2, 12, 8),
                                 torch.as_tensor(bias), 2)
    flat, gflat, _ = router.route(torch.as_tensor(logits),
                                  torch.as_tensor(bias), 2)
    assert torch.equal(idx.reshape(24, 2), flat)
    assert torch.equal(gates.reshape(24, 2), gflat)


def test_route_needs_a_bias():
    with pytest.raises(ValueError, match="bias"):
        router.route(torch.zeros(3, 4), None, 2)


@pytest.mark.parametrize("mode", ["immune", "sign", "aux", "none"])
def test_update_router_state_200_steps_matches_jax(mode):
    """Open loop: both states see the same seeded sequence of skewed load
    fractions for 200 steps; every field stays within 1e-6."""
    e = 8
    rng = np.random.default_rng(7)
    cfg = router.RouterConfig(mode=mode)
    jcfg = jrouter.RouterConfig(mode=mode)
    st = router.init_router_state(e, device="cpu")
    jst = jrouter.init_router_state(e)
    skew = np.linspace(2.0, 0.2, e)
    for _ in range(200):
        load = (skew * rng.uniform(0.5, 1.5, e)).astype(np.float32)
        load = (load / load.sum()).astype(np.float32)
        st = router.update_router_state(st, torch.as_tensor(load), cfg)
        jst = jrouter.update_router_state(jst, jnp.asarray(load), jcfg)
    for name in ("bias", "mem", "suppressor"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)), **TOL,
                                   err_msg=name)
        assert getattr(st, name).dtype == torch.float32
    assert int(st.steps) == int(jst.steps) == 200
    if mode in ("aux", "none"):
        assert not st.bias.any()
    else:
        assert st.bias.abs().max() > 0


@pytest.mark.parametrize("t,e,k", [(64, 8, 2), (100, 40, 8)])
def test_load_fractions_aux_loss_and_cv_match_jax(t, e, k):
    logits, bias = _logits(t + e, t, e)
    idx, _, probs = router.route(torch.as_tensor(logits),
                                 torch.as_tensor(bias), k)
    jidx, _, jprobs = jrouter.route(jnp.asarray(logits), jnp.asarray(bias), k)
    load = router.load_fractions(idx, e)
    jload = jrouter.load_fractions(jidx, e)
    np.testing.assert_allclose(load.numpy(), np.asarray(jload), **TOL)
    assert abs(float(load.sum()) - 1.0) < 1e-6
    np.testing.assert_allclose(float(router.aux_loss(idx, probs, e)),
                               float(jrouter.aux_loss(jidx, jprobs, e)), **TOL)
    np.testing.assert_allclose(float(router.load_cv(load)),
                               float(jrouter.load_cv(jload)), **TOL)
    counts = router.expert_counts(idx, e)
    assert counts.tolist() == np.bincount(idx.numpy().ravel(),
                                          minlength=e).tolist()
