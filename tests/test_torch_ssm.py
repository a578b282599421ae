"""The port's mamba-2 mixer (``repro_torch.models.ssm``) against the JAX
package's on the CPU, at ``mamba2-130m`` smoke width (d_model 64, 8 heads of
16, state 16, chunk 8), fp32.

The same numpy draws go through both packages; the mixer's parameters are
the JAX ``init_ssm`` tree with ``A_log`` and ``dt_bias`` redrawn (both zero
at init). Tolerance 1e-5 (the two packages sum in different orders); the
port's own chunk-resumed prefill against its one-shot prefill within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.models import ssm

torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def mixer():
    """(jcfg, cfg, JAX params, port SSM module) on the same weights."""
    jcfg = jconfigs.get_config("mamba2-130m").smoke()
    cfg = configs.get_config("mamba2-130m").smoke()
    jp = jax.tree.map(np.asarray, jssm.init_ssm(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)
    h = jp["A_log"].shape[0]
    jp["A_log"] = rng.uniform(-1.0, 1.0, h).astype(np.float32)
    jp["dt_bias"] = rng.uniform(-2.0, 0.5, h).astype(np.float32)
    jp["conv_b"] = (0.1 * rng.standard_normal(jp["conv_b"].shape)
                    ).astype(np.float32)
    tp = ssm.SSM(cfg, None, "cpu")
    with torch.no_grad():
        for name, p in tp.named_parameters():
            node = jp
            for k in name.split("."):
                node = node[k]
            p.copy_(torch.as_tensor(np.array(node)))
    return jcfg, cfg, jax.tree.map(jnp.asarray, jp), tp


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, (b, s, h)).astype(np.float32)
    a_log = rng.uniform(-1.0, 1.0, h).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a_log, bb, cc


@pytest.mark.parametrize("s,chunk", [(16, 8), (13, 4), (8, 8), (5, 8),
                                     (24, 8)])
def test_ssd_chunked_matches_jax_and_reference(s, chunk):
    """Outputs and final states against JAX's ``ssd_chunked``, and both
    against the sequential oracles (the port's ``ssd_reference`` and
    JAX's)."""
    arrs = _ssd_inputs(s, 2, s, 3, 4, 5)
    y, st = ssm.ssd_chunked(*(torch.as_tensor(a) for a in arrs), chunk,
                            return_state=True)
    jy, jst = jssm.ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk,
                               return_state=True)
    _close(y, jy)
    if s % chunk == 0:        # padded steps decay the state (both packages)
        _close(st, jst)
    ref = ssm.ssd_reference(*(torch.as_tensor(a) for a in arrs))
    _close(y, ref, 1e-4)
    _close(ref, jssm.ssd_reference(*(jnp.asarray(a) for a in arrs)))


def test_chunk_resumed_init_state_equals_oneshot():
    """A sequence split at chunk boundaries and resumed through
    ``init_state`` gives the one-shot outputs and final state."""
    x, dt, a_log, b, c = (torch.as_tensor(a)
                          for a in _ssd_inputs(7, 2, 24, 3, 4, 5))
    y, st = ssm.ssd_chunked(x, dt, a_log, b, c, 8, return_state=True)
    ys, states, state = [], [], None
    for lo, hi in ((0, 8), (8, 16), (16, 24)):
        yi, state = ssm.ssd_chunked(x[:, lo:hi], dt[:, lo:hi], a_log,
                                    b[:, lo:hi], c[:, lo:hi], 8,
                                    return_state=True, init_state=state)
        ys.append(yi)
        states.append(state)
    _close(torch.cat(ys, 1), y, 1e-6)
    _close(state, st, 1e-6)
    # the JAX package resumed from the port's state after the first chunk
    jy, jst = jssm.ssd_chunked(
        *(jnp.asarray(a.numpy()) for a in (x[:, 8:16], dt[:, 8:16], a_log,
                                           b[:, 8:16], c[:, 8:16])),
        8, return_state=True, init_state=jnp.asarray(states[0].numpy()))
    _close(ys[1], jy)
    _close(states[1], jst)


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("s", [1, 3, 16, 21])
def test_block_and_prefill_cache_match_jax(mixer, s):
    """``ssm_block`` and ``ssm_block_prefill`` outputs, and the cache's conv
    tail (the last three pre-conv projections, zero-padded when S < 3) and
    state, against the JAX package's."""
    jcfg, cfg, jp, tp = mixer
    x = _x(s, 2, s, cfg.d_model)
    _close(ssm.ssm_block(tp, torch.as_tensor(x), cfg),
           jssm.ssm_block(jp, jnp.asarray(x), jcfg))
    if s % cfg.ssm_chunk and s > cfg.ssm_chunk:
        return                # padded steps decay the state: not a prefill
    cache = ssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    y, cache = ssm.ssm_block_prefill(tp, torch.as_tensor(x), cfg, cache)
    jy, jcache = jssm.ssm_block_prefill(
        jp, jnp.asarray(x), jcfg, jssm.init_ssm_cache(jcfg, 2, jnp.float32))
    _close(y, jy)
    _close(cache["conv"], jcache["conv"])
    _close(cache["state"], jcache["state"])
    # the tail is the pre-conv projections themselves
    _, xbc, _ = ssm._split(tp, torch.as_tensor(x), cfg)
    k = cfg.ssm_conv - 1
    want = xbc[:, -k:] if s >= k else torch.nn.functional.pad(
        xbc, (0, 0, k - s, 0))
    _close(cache["conv"], want, 0.0)


def test_conv_resume_with_zero_tail_is_the_sequence_start(mixer):
    jcfg, cfg, jp, tp = mixer
    _, xbc, _ = ssm._split(tp, torch.as_tensor(_x(2, 2, 9, cfg.d_model)),
                           cfg)
    zero = torch.zeros(2, cfg.ssm_conv - 1, xbc.shape[-1])
    assert torch.equal(ssm._conv_resume(tp, xbc, zero),
                       ssm._conv_train(tp, xbc))


def test_prefill_chunk_threads_the_cache_like_jax(mixer):
    """Three chunk-resumed prefill calls of 8 against one-shot prefill of
    24 (port: within 1e-6, the same ops in the same order), and each chunk
    against JAX's ``ssm_block_prefill_chunk``."""
    jcfg, cfg, jp, tp = mixer
    x = _x(5, 2, 24, cfg.d_model)
    one = ssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    y1, one = ssm.ssm_block_prefill(tp, torch.as_tensor(x), cfg, one)
    cache = ssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    jcache = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    ys = []
    for lo in range(0, 24, 8):
        part = x[:, lo:lo + 8]
        y, cache = ssm.ssm_block_prefill_chunk(tp, torch.as_tensor(part),
                                               cfg, cache)
        jy, jcache = jssm.ssm_block_prefill_chunk(jp, jnp.asarray(part),
                                                  jcfg, jcache)
        _close(y, jy)
        _close(cache["conv"], jcache["conv"])
        _close(cache["state"], jcache["state"])
        ys.append(y)
    _close(torch.cat(ys, 1), y1, 1e-6)
    _close(cache["state"], one["state"], 1e-6)
    _close(cache["conv"], one["conv"], 0.0)


def test_decode_steps_match_the_full_forward_and_jax(mixer):
    """Prefill of 16 then five one-token decode steps: each step's output
    equals the full-sequence mixer's at that position and JAX's decode
    step; the caches stay equal to JAX's."""
    jcfg, cfg, jp, tp = mixer
    x = _x(11, 2, 21, cfg.d_model)
    full = ssm.ssm_block(tp, torch.as_tensor(x), cfg)
    cache = ssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    _, cache = ssm.ssm_block_prefill(tp, torch.as_tensor(x[:, :16]), cfg,
                                     cache)
    _, jcache = jssm.ssm_block_prefill(
        jp, jnp.asarray(x[:, :16]), jcfg,
        jssm.init_ssm_cache(jcfg, 2, jnp.float32))
    for t in range(16, 21):
        y, cache = ssm.ssm_block_decode(tp, torch.as_tensor(x[:, t:t + 1]),
                                        cfg, cache)
        jy, jcache = jssm.ssm_block_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                           jcfg, jcache)
        _close(y, full[:, t:t + 1])
        _close(y, jy)
        _close(cache["state"], jcache["state"])
        _close(cache["conv"], jcache["conv"])


def test_decode_freezes_inactive_rows(mixer):
    """``active`` False leaves a row's conv tail and state untouched."""
    jcfg, cfg, jp, tp = mixer
    cache = ssm.init_ssm_cache(cfg, 3, torch.float32, "cpu")
    cache["conv"].normal_(generator=torch.Generator().manual_seed(0))
    cache["state"].normal_(generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in cache.items()}
    active = torch.tensor([True, False, True])
    ssm.ssm_block_decode(tp, torch.as_tensor(_x(4, 3, 1, cfg.d_model)), cfg,
                         cache, active)
    for k in cache:
        assert torch.equal(cache[k][1], before[k][1])
        assert not torch.equal(cache[k][0], before[k][0])
