"""The port's MoE layer against the JAX package's on the CPU, on the same
weights and inputs (drawn with numpy from a seed), float32: ``moe_ffn``
within 1e-5 on both expert routes (the grouped-matmul kernel's plain version
and the einsums), at ``dispatch_groups`` 1 and 2, with a nonzero router
bias; where capacity drops assignments, the same ``idx``, ``keep`` and
``slot_loc`` (so the same drop fraction, whose mean is summed in another
order: within 1e-6); where nothing drops, equal to the dense
``moe_ffn_reference``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import router as jrouter
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.core import router
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.models import moe

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("w_router", "w_gate", "w_up", "w_down")


def _cfgs(**kw):
    jcfg = dataclasses.replace(
        jconfigs.get_config("granite-moe-3b-a800m").smoke(), **kw)
    cfg = dataclasses.replace(
        configs.get_config("granite-moe-3b-a800m").smoke(), **kw)
    return jcfg, cfg


def _layer(jcfg, cfg, seed=0):
    """The JAX package's MoE init and the same weights in the port's
    module."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = moe.MoE(cfg, None, "cpu")
    with torch.no_grad():
        for name in NAMES:
            getattr(tp, name).copy_(torch.as_tensor(np.array(jp[name])))
    return jp, tp


def _inputs(cfg, b, s, seed, skew=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(cfg.num_experts)).astype(np.float32)
    bias[0] += skew
    return x, bias


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_ffn_matches_jax(backend, groups):
    jcfg, cfg = _cfgs(dispatch_groups=groups)
    jp, tp = _layer(jcfg, cfg)
    x, bias = _inputs(cfg, 2, 12, seed=groups)
    y, stats = moe.moe_ffn(tp, torch.as_tensor(x), cfg, torch.as_tensor(bias),
                           backend=backend)
    jy, jstats = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, jnp.asarray(bias))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(stats.load_frac.numpy(),
                               np.asarray(jstats.load_frac), **TOL)
    np.testing.assert_allclose(float(stats.aux_loss), float(jstats.aux_loss),
                               **TOL)
    # the same assignments drop; the mean is summed in another order
    np.testing.assert_allclose(float(stats.drop_frac),
                               float(jstats.drop_frac), rtol=0, atol=1e-6)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_drops_at_capacity_match_jax_exactly(backend):
    """A skewed bias overloads expert 0 at cf 1.25: which assignments are
    dropped follows the reference's stable sort and token-major ranks."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer(jcfg, cfg, seed=1)
    x, bias = _inputs(cfg, 1, 32, seed=3, skew=3.0)
    tok = torch.as_tensor(x).reshape(32, -1)
    e, k = cfg.num_experts, cfg.experts_per_token
    c = moe.capacity(cfg, 32)
    assert c == jmoe.capacity(jcfg, 32) == 12
    logits = tok @ tp.w_router
    idx, _, _ = router.route(logits, torch.as_tensor(bias), k)
    jidx, _, _ = jrouter.route(jnp.asarray(tok.numpy()) @ jp["w_router"],
                               jnp.asarray(bias), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    expert_in, slot_loc, keep, sizes = moe._dispatch(tok, idx, e, c)
    jin, jloc, jkeep = jmoe._dispatch(jnp.asarray(tok.numpy()), jidx, e, c)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(slot_loc.numpy(), np.asarray(jloc))
    np.testing.assert_array_equal(expert_in.numpy(), np.asarray(jin))
    assert not keep.all(), "the skewed bias dropped nothing"
    assert sizes.tolist() == np.minimum(
        np.bincount(idx.numpy().ravel(), minlength=e), c).tolist()
    y, stats = moe.moe_ffn(tp, torch.as_tensor(x), cfg, torch.as_tensor(bias),
                           backend=backend)
    jy, jstats = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, jnp.asarray(bias))
    assert float(stats.drop_frac) > 0
    np.testing.assert_allclose(float(stats.drop_frac),
                               float(jstats.drop_frac), rtol=0, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_dropless_equals_dense_reference(backend):
    jcfg, cfg = _cfgs(capacity_factor=8.0)
    jp, tp = _layer(jcfg, cfg, seed=2)
    x, bias = _inputs(cfg, 2, 8, seed=4, skew=1.0)
    y, stats = moe.moe_ffn(tp, torch.as_tensor(x), cfg, torch.as_tensor(bias),
                           backend=backend)
    ref = moe.moe_ffn_reference(tp, torch.as_tensor(x), cfg,
                                torch.as_tensor(bias))
    jref = jmoe.moe_ffn_reference(jp, jnp.asarray(x), jcfg, jnp.asarray(bias))
    assert float(stats.drop_frac) == 0.0
    np.testing.assert_allclose(y.numpy(), ref.numpy(), **TOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **TOL)


def test_kernel_route_counts_no_launch_on_the_cpu_and_matches_einsum():
    """The ``"kernel"`` route reaches the grouped-matmul wrapper, which on
    CPU tensors runs its plain version and counts no launch; dead buffer
    rows come out zero either way, so both routes agree."""
    jcfg, cfg = _cfgs()
    _, tp = _layer(jcfg, cfg, seed=5)
    x, bias = _inputs(cfg, 3, 5, seed=6)
    before = moe_gmm.launches
    yk, _ = moe.moe_ffn(tp, torch.as_tensor(x), cfg, torch.as_tensor(bias),
                        backend="kernel")
    yt, _ = moe.moe_ffn(tp, torch.as_tensor(x), cfg, torch.as_tensor(bias),
                        backend="torch")
    assert moe_gmm.launches == before
    np.testing.assert_allclose(yk.numpy(), yt.numpy(), **TOL)
    with pytest.raises(ValueError, match="backend"):
        moe.moe_ffn(tp, torch.as_tensor(x), cfg, torch.as_tensor(bias),
                    backend="xla")


def test_bf16_layer_keeps_an_fp32_router():
    _, cfg = _cfgs(dtype="bfloat16")
    layer = moe.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    assert layer.w_router.dtype == torch.float32
    assert layer.w_gate.dtype == torch.bfloat16
    assert tuple(layer.w_gate.shape) == (cfg.num_experts, cfg.d_model,
                                         cfg.d_ff)
    assert tuple(layer.w_down.shape) == (cfg.num_experts, cfg.d_ff,
                                         cfg.d_model)
    x = torch.randn(1, 6, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    y, _ = moe.moe_ffn(layer, x, cfg, torch.zeros(cfg.num_experts))
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


@pytest.mark.parametrize("tokens", [1, 8, 40, 1000])
def test_capacity_matches_jax(tokens):
    jcfg, cfg = _cfgs()
    assert moe.capacity(cfg, tokens) == jmoe.capacity(jcfg, tokens)
    full = configs.get_config("granite-moe-3b-a800m")
    jfull = jconfigs.get_config("granite-moe-3b-a800m")
    assert moe.capacity(full, tokens) == jmoe.capacity(jfull, tokens)


@pytest.mark.parametrize("groups", [1, 2])
def test_counters_match_a_hand_worked_routing(groups):
    """Eight tokens, four experts, top-1, capacity C = 4 (1.25 x 8 / 4
    rounded up to 4): tokens 0-5 score highest on expert 0 and 6-7 on
    expert 1. In one group expert 0 overflows (6 > 4): 2 of 8 assignments
    dropped, 6 of the 16 buffer rows live, loads (6, 2, 0, 0) / 8. In two
    groups of four (C = 4 each) nothing overflows: 8 of 32 rows live."""
    _, cfg = _cfgs(num_experts=4, experts_per_token=1, capacity_factor=1.25,
                   dispatch_groups=groups)
    layer = moe.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        layer.w_router.zero_()
        layer.w_router[0, :2] = torch.tensor([1.0, -1.0])
    x = torch.zeros(1, 8, cfg.d_model)
    x[0, :, 0] = torch.tensor([1.0] * 6 + [-1.0] * 2)
    _, st = moe.moe_ffn(layer, x, cfg, torch.zeros(4), backend="torch")
    load = [0.75, 0.25, 0.0, 0.0]
    assert st.load_frac.tolist() == load
    if groups == 1:
        assert float(st.drop_frac) == 0.25
        assert float(st.fill) == 6 / 16
    else:
        assert float(st.drop_frac) == 0.0
        assert float(st.fill) == 8 / 32
    mean = sum(load) / 4
    cv = (sum((f - mean) ** 2 for f in load) / 4) ** 0.5 / mean
    assert float(router.load_cv(st.load_frac)) == pytest.approx(cv, rel=1e-6)
