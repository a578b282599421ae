"""The port's Griffin recurrent block (``repro_torch.models.rglru``) against
the JAX package's on the CPU, at ``recurrentgemma-9b`` smoke width (d_model
64, lru width 64), fp32.

``rglru_scan`` is a log-depth scan of whole-tensor steps; the JAX package's
``jax.lax.associative_scan`` groups the products another way, so the two are
held within 1e-5, not bit for bit. The same numpy draws go through both
packages, on the JAX ``init_rglru`` weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rglru as jrglru
from repro_torch import configs
from repro_torch.models import rglru

torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def block():
    jcfg = jconfigs.get_config("recurrentgemma-9b").smoke()
    cfg = configs.get_config("recurrentgemma-9b").smoke()
    jp = jax.tree.map(np.asarray, jrglru.init_rglru(jax.random.PRNGKey(5),
                                                    jcfg))
    jp["conv_b"] = (0.1 * np.random.default_rng(5).standard_normal(
        jp["conv_b"].shape)).astype(np.float32)
    tp = rglru.RGLRU(cfg, None, "cpu")
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(torch.as_tensor(np.array(jp[name])))
    return jcfg, cfg, jax.tree.map(jnp.asarray, jp), tp


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("s", [1, 2, 3, 7, 8, 33, 70])
def test_rglru_scan_matches_jax_and_the_recurrence(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.0, 1.0, (2, s, 16)).astype(np.float32)
    b = rng.standard_normal((2, s, 16)).astype(np.float32)
    h = rglru.rglru_scan(torch.as_tensor(a), torch.as_tensor(b))
    _close(h, jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(b)))
    ref, state = [], np.zeros((2, 16), np.float32)
    for t in range(s):
        state = a[:, t] * state + b[:, t]
        ref.append(state)
    _close(h, np.stack(ref, 1))


@pytest.mark.parametrize("s", [1, 5, 40])
def test_block_and_prefill_cache_match_jax(block, s):
    """The full-sequence block and the prefill's output and cache (the last
    three pre-conv projections, zero-padded when S < 3, and the last
    hidden state) against the JAX package's."""
    jcfg, cfg, jp, tp = block
    x = _x(s, 2, s, cfg.d_model)
    _close(rglru.rglru_block(tp, torch.as_tensor(x), cfg),
           jrglru.rglru_block(jp, jnp.asarray(x), jcfg))
    cache = rglru.init_rglru_cache(cfg, 2, torch.float32, "cpu")
    y, cache = rglru.rglru_block_prefill(tp, torch.as_tensor(x), cfg, cache)
    jy, jcache = jrglru.rglru_block_prefill(
        jp, jnp.asarray(x), jcfg, jrglru.init_rglru_cache(jcfg, 2,
                                                          jnp.float32))
    _close(y, jy)
    _close(cache["conv"], jcache["conv"])
    _close(cache["h"], jcache["h"])


def test_prefill_then_decode_matches_full_forward_and_jax(block):
    """Prefill of 12, then six decode steps: each step equals the
    full-sequence block at that position and JAX's decode step, and the
    caches stay equal to JAX's."""
    jcfg, cfg, jp, tp = block
    x = _x(9, 2, 18, cfg.d_model)
    full = rglru.rglru_block(tp, torch.as_tensor(x), cfg)
    cache = rglru.init_rglru_cache(cfg, 2, torch.float32, "cpu")
    _, cache = rglru.rglru_block_prefill(tp, torch.as_tensor(x[:, :12]), cfg,
                                         cache)
    _, jcache = jrglru.rglru_block_prefill(
        jp, jnp.asarray(x[:, :12]), jcfg,
        jrglru.init_rglru_cache(jcfg, 2, jnp.float32))
    for t in range(12, 18):
        y, cache = rglru.rglru_block_decode(
            tp, torch.as_tensor(x[:, t:t + 1]), cfg, cache)
        jy, jcache = jrglru.rglru_block_decode(
            jp, jnp.asarray(x[:, t:t + 1]), jcfg, jcache)
        _close(y, full[:, t:t + 1])
        _close(y, jy)
        _close(cache["h"], jcache["h"])
        _close(cache["conv"], jcache["conv"])


def test_decode_freezes_inactive_rows(block):
    jcfg, cfg, jp, tp = block
    cache = rglru.init_rglru_cache(cfg, 3, torch.float32, "cpu")
    cache["conv"].normal_(generator=torch.Generator().manual_seed(0))
    cache["h"].normal_(generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in cache.items()}
    rglru.rglru_block_decode(tp, torch.as_tensor(_x(3, 3, 1, cfg.d_model)),
                             cfg, cache, torch.tensor([False, True, True]))
    for k in cache:
        assert torch.equal(cache[k][0], before[k][0])
        assert not torch.equal(cache[k][1], before[k][1])


def test_gate_branch_is_tanh_gelu(block):
    """``jax.nn.gelu`` defaults to the tanh form; so does the port."""
    x = torch.linspace(-4, 4, 81)
    _close(rglru._gelu(x), jax.nn.gelu(jnp.asarray(x.numpy())))
