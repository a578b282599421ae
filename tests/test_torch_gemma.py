"""gemma-7b at head dim 256 against the JAX package on the CPU.

``ModelConfig.smoke()`` sets head_dim to 16, which would hide the head dim
the D = 256 kernel bodies serve, so the config here is gemma-7b's own (GeGLU,
tied and scaled embeddings, the plus-one norm, MHA) cut to 2 layers, d_model
512, 2 / 2 heads at head_dim 256, d_ff 1,024 and vocab 512, in fp32. Both
packages get the same weights (the JAX tree converted by
``params_from_numpy``) and the same numpy tokens.

Tolerance: logits within 1e-5 (both sides run the same fp32 operations, in
another summation order). On the CPU the port's kernel backend runs each
kernel's plain version; the card tests (``tests/test_torch_cuda.py``) hold
the kernels to those at this head dim.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as flash_pkg
from repro_torch.kernels import paged_attention as paged_pkg
from repro_torch.models import model
from repro_torch.serve import api, engine, traces

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
BACKENDS = ("kernel", "torch")
SHAPE = dict(num_layers=2, d_model=512, num_heads=2, num_kv_heads=2,
             head_dim=256, d_ff=1024, vocab_size=512, dtype="float32")


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jconfigs.get_config("gemma-7b"), **SHAPE)
    cfg = dataclasses.replace(configs.get_config("gemma-7b"), **SHAPE)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


def test_config_is_gemma_at_head_dim_256(pair):
    jcfg, cfg, _, tp = pair
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.head_dim, cfg.act, cfg.tie_embeddings, cfg.scale_embeddings,
            cfg.num_heads == cfg.num_kv_heads) == (256, "gelu", True, True,
                                                   True)
    assert tp.blocks[0].mixer.wq.shape[-1] == 2 * 256


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,s", [(2, 37), (1, 70)])
def test_prefill_matches_jax(pair, backend, b, s):
    """Prefill logits and the dense cache it fills, both backends."""
    jcfg, cfg, jp, tp = pair
    toks = _tokens(s, (b, s), cfg.vocab_size)
    jl, jc = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                            jmodel.init_cache(jcfg, b, 80))
    tl, tc = model.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                           model.init_cache(cfg, b, 80, "cpu"),
                           attn_backend=backend)
    assert tl.shape == (b, 1, cfg.vocab_size)
    _close(tl, jl)
    for tseg, jseg in zip(tc["layers"], jc["layers"]):
        for tpos, jpos in zip(tseg, jseg):
            for name in ("k", "v"):
                _close(tpos[name], jpos[name])


def test_decode_step_paged_matches_jax(pair):
    """Three paged decode steps on the kernel backend (the plain versions on
    the CPU): two slots at different depths over scattered pages, one
    inactive lane whose write lands on the null page."""
    jcfg, cfg, jp, tp = pair
    page, maxp, num_pages = 8, 6, 16
    table = np.zeros((3, maxp), np.int32)
    table[0, :4] = [5, 2, 9, 14]
    table[1, :2] = [7, 3]
    jpool = jmodel.init_slot_cache_paged(jcfg, 3, page * maxp, num_pages,
                                         page)
    tpool = model.init_slot_cache_paged(cfg, 3, page * maxp, num_pages, page,
                                        "cpu")
    for slot, plen in ((0, 29), (1, 9)):
        toks = _tokens(slot, (1, plen), cfg.vocab_size)
        _, jone = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                 jmodel.init_cache(jcfg, 1, page * maxp))
        _, tone = model.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                                model.init_cache(cfg, 1, page * maxp, "cpu"),
                                attn_backend="kernel")
        jpool = jmodel.insert_slot_cache_paged(jpool, jone, jcfg, slot,
                                               jnp.asarray(table[slot]))
        tpool = model.insert_slot_cache_paged(tpool, tone, cfg, slot,
                                              torch.as_tensor(table[slot]))
    active = np.asarray([True, True, False])
    for step in range(3):
        nxt = _tokens(50 + step, (3, 1), cfg.vocab_size)
        jl, jpool = jmodel.decode_step(
            jp, jcfg, {"token": jnp.asarray(nxt)}, jpool,
            table=jnp.asarray(table), active=jnp.asarray(active))
        tl, tpool = model.decode_step(
            tp, cfg, {"token": torch.as_tensor(nxt)}, tpool,
            table=torch.as_tensor(table), active=torch.as_tensor(active),
            attn_backend="kernel")
        _close(tl[:2], jl[:2])
    np.testing.assert_array_equal(_np(tpool["pos"]), _np(jpool["pos"]))
    for tseg, jseg in zip(tpool["layers"], jpool["layers"]):
        for tpos, jpos in zip(tseg, jseg):
            for name in ("k", "v"):
                _close(tpos[name][:, 1:], np.asarray(jpos[name])[:, 1:])


def test_engine_matches_oneshot_generate(pair):
    """A 4-request trace (one lane sampled) served by the engine on the
    kernel backend, token-equal to the port's own one-shot ``generate``."""
    _, cfg, _, tp = pair
    trace = traces.synthetic_trace(cfg, num_requests=4, seed=0,
                                   prompt_lens=(9, 20), light_tokens=6,
                                   heavy_tokens=10, heavy_prompt=33)
    trace[1].params = dataclasses.replace(trace[1].params, temperature=0.8)
    eng = engine.Engine(tp, cfg, engine.EngineConfig(
        num_slots=2, max_cache=48, page_size=8, num_classes=3), device="cpu")
    stats = eng.run(trace, max_ticks=200)
    assert stats["completed"] == 4
    for req in eng.completed:
        probe = api.ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params)
        assert api.generate(tp, cfg, probe, max_cache=48).tokens == \
            req.out_tokens, f"request {req.rid}: engine != one-shot"


def test_mma_dim_is_the_build_gate():
    """``csrc/tensor_core.cuh:mma_dim``, which the C entry points read, and
    ``_build.MMA_HEAD_DIMS``, which the wrappers' ``kernel_path`` read, name
    the same head dims; 256 and 112 are both among them."""
    src = (_build.CSRC / "tensor_core.cuh").read_text()
    body = re.search(r"constexpr bool mma_dim\(int d\) \{(.*?)\}", src,
                     re.S).group(1)
    dims = {int(x) for x in re.findall(r"d == (\d+)", body)}
    assert dims == set(_build.MMA_HEAD_DIMS)
    assert {112, 256} <= dims
    for pkg in (paged_pkg, flash_pkg):
        for d in (112, 256):
            assert pkg.kernel_path(torch.bfloat16, d) == "mma"
            assert pkg.kernel_path(torch.float32, d) == "cuda_core"
