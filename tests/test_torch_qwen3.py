"""qwen3-4b at head dim 128 with qk-norm and GQA 4 against the JAX package
on the CPU, and a CPU rehearsal of ``chip_smoke.py``'s phase 14.

``ModelConfig.smoke()`` sets head_dim 16 and 4 / 2 heads, which would hide
the head dim the D = 128 kernel bodies serve, so the config here is
qwen3-4b's own (qk-norm, rope theta 1e6, tied embeddings, SiLU) cut to 2
layers, d_model 512, 8 / 2 heads at head_dim 128 (GQA 4, as published),
d_ff 1,024 and vocab 512, in fp32. Both packages get the same weights: the
JAX tree, with every RMSNorm scale (qk-norm's included) drawn away from its
zero init so that the ``(1 + g)`` scale is held, converted by
``params_from_numpy``; and the same numpy tokens.

Tolerances: prefill and decode logits within 1e-5 (both sides run the same
fp32 operations, in another summation order); engine tokens exactly equal;
the plain paged / verify / flash versions at 8 / 2 heads and D = 128 within
1e-5 / 1e-5 / 5e-5 of the interpret-mode Pallas kernels in fp32 (the
tolerances of tests/test_kernels.py), flash in bf16 within 5e-2 of the JAX
oracle. On the CPU the port's kernel backend runs each kernel's plain
version; the card tests (``tests/test_torch_cuda.py``) hold the kernels to
those at qwen3-4b's full 32 / 8 heads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_attention import \
    paged_attention_verify as jax_verify
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro.serve import traces as jtraces
from repro_torch import configs
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.paged_attention import (paged_attention_ref,
                                                 paged_attention_verify_ref)
from repro_torch.models import layers, model
from repro_torch.serve import api, engine, spec, traces

from _torch_rehearsal import (KERNEL_PATHS, StandIn, chip_smoke_on_cpu,
                              counting_wrappers)

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

ARCH = "qwen3-4b"
TOL = 1e-5
SHAPE = dict(num_layers=2, d_model=512, num_heads=8, num_kv_heads=2,
             head_dim=128, d_ff=1024, vocab_size=512, dtype="float32")


def _with_scales(tree, seed=7):
    """``tree`` with every RMSNorm scale drawn from N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        if getattr(path[-1], "key", None) != "scale":
            return x
        return (0.5 * rng.standard_normal(x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH), **SHAPE)
    cfg = dataclasses.replace(configs.get_config(ARCH), **SHAPE)
    tree = _with_scales(jax.tree.map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg)))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = model.params_from_numpy(tree, cfg, "cpu")
    return jcfg, cfg, jp, tp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


def test_config_is_qwen3_at_head_dim_128(pair):
    """The cut config equals JAX's; qk-norm on, GQA 4 at D = 128, and the
    drawn qk-norm scales reach the port's parameters."""
    jcfg, cfg, jp, tp = pair
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.qk_norm, cfg.head_dim, cfg.num_heads // cfg.num_kv_heads,
            cfg.rope_theta, cfg.tie_embeddings) == (True, 128, 4, 1e6, True)
    mixer = tp.blocks[0].mixer
    assert mixer.wq.shape[-1] == 8 * 128 and mixer.wk.shape[-1] == 2 * 128
    for name in ("q_norm", "k_norm"):
        scale = getattr(mixer, name).scale
        assert scale.shape == (128,) and scale.abs().min() > 0
    assert model.param_count(tp) == jmodel.param_count(jp)


@pytest.mark.parametrize("starts", [(0, 61), (991, 1000), (1491, 1500)])
def test_qkv_applies_qk_norm_then_rope_as_jax(pair, starts):
    """``layers._qkv`` (projection, qk-norm with its ``(1 + g)`` scale in
    fp32, then rope at theta 1e6) against the JAX package's, layer 0, on
    two rows of 9 positions from ``starts``: the prefill tests' and the
    long prompts phase 14 serves. v within 1e-5; q and k within 1e-5, or
    3e-8 x the largest position where that is more: the two packages'
    fp32 ``pow`` rounds a few rope frequencies to neighbouring floats (both
    within 6e-8 of exact), and the angle's gap grows with the position
    (measured: 1.5e-6 below 70, 2.2e-5 at 991-1008, 4.3e-5 at 1491-1508,
    |q| up to 5.8; the rule holds them at ~0.5 of it), so a drift beyond
    that rounding shows."""
    jcfg, cfg, jp, tp = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.stack([np.arange(s, s + 9) for s in starts]).astype(np.int32)
    jmix = jax.tree.map(lambda a: a[0], jp["stack"][0][0]["mixer"])
    jq, jk, jv = jlayers._qkv(jmix, jnp.asarray(x), jcfg,
                              jnp.asarray(pos))
    tq, tk, tv = layers._qkv(tp.blocks[0].mixer, torch.as_tensor(x), cfg,
                             torch.as_tensor(pos))
    _close(tv, jv)
    for a, b in ((tq, jq), (tk, jk)):
        _close(a, b, tol=max(TOL, 3e-8 * int(pos.max())))


@pytest.mark.parametrize("backend", ["kernel", "torch"])
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


def test_engine_matches_jax_engine(pair):
    """A 5-request ``synthetic_trace`` (a heavy 33-token prompt, one lane
    sampled) on 2 slots: the port's engine on the kernel backend emits the
    JAX engine's tokens exactly, and its own one-shot ``generate``'s."""
    jcfg, cfg, jp, tp = pair

    def trace(mod, c):
        reqs = mod.synthetic_trace(c, num_requests=5, seed=0,
                                   prompt_lens=(9, 20), light_tokens=6,
                                   heavy_tokens=10, heavy_prompt=33)
        reqs[1].params = dataclasses.replace(reqs[1].params,
                                             temperature=0.8)
        return reqs

    ekw = dict(num_slots=2, max_cache=48, page_size=8, num_classes=3)
    jeng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**ekw))
    jeng.run(trace(jtraces, jcfg), max_ticks=300)
    teng = engine.Engine(tp, cfg, engine.EngineConfig(**ekw), device="cpu")
    stats = teng.run(trace(traces, cfg), max_ticks=300)
    assert stats["completed"] == 5
    ours = {r.rid: r.out_tokens for r in teng.completed}
    assert ours == {r.rid: r.out_tokens for r in jeng.completed}
    for req in teng.completed:
        probe = api.ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params)
        assert api.generate(tp, cfg, probe, max_cache=48).tokens == \
            req.out_tokens, f"request {req.rid}: engine != one-shot"


def _pools(rng, b, h, hk, d, page, maxp, rows_of):
    """q (B, *rows_of, H, D) and K/V pools of B * maxp pages beside a
    +-1e4 null page (page 0, never read live)."""
    num_pages = b * maxp + 1
    q = rng.standard_normal((b, *rows_of, h, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, page, hk, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page, hk, d)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    return q, kp, vp


@pytest.mark.parametrize("page,maxp", [(8, 6), (16, 4)])
def test_paged_plain_at_qwen3_grouping_matches_jax(page, maxp):
    """Decode at 8 / 2 heads (G = 4, qwen3-4b's 32 / 8) and D = 128, ragged
    lengths incl. a full table: the plain version against the
    interpret-mode Pallas kernel, fp32, 1e-5."""
    rng = np.random.default_rng(page + maxp + 128)
    b = 3
    q, kp, vp = _pools(rng, b, 8, 2, 128, page, maxp, ())
    lengths = np.asarray([1, page + 3, maxp * page], np.int32)
    table = np.arange(1, b * maxp + 1, dtype=np.int32).reshape(b, maxp)
    for i, n in enumerate(lengths):
        table[i, -(-int(n) // page):] = 0
    arrs = (q, kp, vp, table, lengths)
    out = paged_attention_ref(*(torch.as_tensor(a) for a in arrs))
    ref = jax_paged(*(jnp.asarray(a) for a in arrs), interpret=True)
    _close(out, ref)


@pytest.mark.parametrize("sq", [2, 5])
def test_verify_plain_at_qwen3_grouping_matches_jax(sq):
    """The verify step at 8 / 2 heads and D = 128 (Sq rows of 4 q heads a
    kv head, one lane at the table's end): fp32, 1e-5 of the
    interpret-mode Pallas verify kernel."""
    rng = np.random.default_rng(sq + 128)
    b, page, maxp = 2, 8, 4
    q, kp, vp = _pools(rng, b, 8, 2, 128, page, maxp, (sq,))
    pos = np.asarray([page, maxp * page - sq], np.int32)
    table = np.arange(1, b * maxp + 1, dtype=np.int32).reshape(b, maxp)
    arrs = (q, kp, vp, table, pos)
    out = paged_attention_verify_ref(*(torch.as_tensor(a) for a in arrs))
    ref = jax_verify(*(jnp.asarray(a) for a in arrs), interpret=True)
    _close(out, ref)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_at_qwen3_grouping_matches_jax(causal):
    """Flash at 8 / 2 heads (G = 4) and D = 128 over two 128-blocks: fp32
    within 5e-5 of the interpret-mode Pallas kernel, and bf16 at a ragged
    S = 100 within 5e-2 of the JAX oracle."""
    rng = np.random.default_rng(128)
    q, k, v = (rng.standard_normal((1, h, 256, 128)).astype(np.float32)
               for h in (8, 2, 2))
    out = attention_ref(*(torch.as_tensor(a) for a in (q, k, v)),
                        causal=causal)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, bq=64, bkv=128, interpret=True)
    _close(out, ref, 5e-5)
    q, k, v = (a[:, :, :100] for a in (q, k, v))
    out = attention_ref(*(torch.as_tensor(a).bfloat16() for a in (q, k, v)),
                        causal=causal).float()
    ref = jax_attention_ref(*(jnp.asarray(a).astype(jnp.bfloat16)
                              for a in (q, k, v)), causal=causal)
    _close(out, np.asarray(ref.astype(jnp.float32)), 5e-2)


# ---------------------------------------------------------------------------
# phase 14 of chip_smoke.py, rehearsed on the CPU
# ---------------------------------------------------------------------------
def test_phase14_preemption_plan_fires_at_its_sizes(monkeypatch):
    """Phase 14 (c)'s trace, engine and pool as the card runs them, on a
    1-layer fp32 qwen3 (which request a page shortage preempts depends only
    on the lengths: every lane is greedy, none stops early): every request
    completes with its budget under both modes, preemption fires and
    replays, preempt admits deeper than reserve, and the schedule is
    ``PREEMPT_PLAN``, the one the card's bf16 runs are held to (reserve 329
    ticks at concurrency 4; preempt 330 at 8, 22 preemptions over 10
    requests, 30 replayed tokens)."""
    cs = chip_smoke_on_cpu(monkeypatch)
    cfg = dataclasses.replace(configs.get_config(ARCH).smoke(), num_layers=1)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    stats = {}
    for mode in ("reserve", "preempt"):
        eng = engine.Engine(params, cfg, cs["preempt_config"](
            engine, mode, cs["PREEMPT_PAGES"], capture_logits=False),
            device="cpu")
        trace = traces.contention_trace(cfg, seed=0, **cs["PREEMPT_TRACE"])
        stats[mode] = eng.run(trace, max_ticks=2000)
        assert stats[mode]["completed"] == 16 and not stats[mode]["shed"]
        assert all(len(r.out_tokens) == r.max_new_tokens
                   for r in eng.completed)
    assert stats["reserve"]["preemptions"] == 0
    assert stats["preempt"]["preemptions"] >= 1
    assert stats["preempt"]["replayed_tokens"] >= 1
    assert stats["preempt"]["concurrency_hw"] > \
        stats["reserve"]["concurrency_hw"]
    plan = cs["PREEMPT_PLAN"]
    assert plan["preempt"] == {"ticks": 330, "concurrency_hw": 8,
                               "preemptions": 22, "preempted_requests": 10,
                               "replayed_tokens": 30}
    assert plan["reserve"]["ticks"] == 329
    for mode in ("reserve", "preempt"):
        assert {k: stats[mode][k] for k in plan[mode]} == plan[mode]


def test_phase14_rehearsal_on_cpu(monkeypatch):
    """``chip_smoke.qwen_phase`` with every ``"cuda"`` read as ``"cpu"``,
    the ``torch.cuda`` sync and memory calls and the profiler stubbed, the
    kernel wrappers counted as on the card, a bf16 qwen3-shaped smoke config
    at head_dim 128 (8 / 2 heads), a draft depth of 1 and the contention
    trace scaled down: both backends serve their 8 requests with flash
    once a layer a prefill and paged decode once a layer a tick on
    ``mma``; the spec run verifies; preemption fires in bf16 on the scaled
    trace's schedule, the fp32 run stops once a request that replayed
    tokens completes, and every preempted stream holds to its
    uninterrupted run."""
    cs = chip_smoke_on_cpu(monkeypatch)
    counters = counting_wrappers(monkeypatch)
    cs["SPEC_DEPTH"] = 1
    cs["PREEMPT_TRACE"] = dict(num_requests=8, prompt_lens=(10, 38),
                               hog_prompt=100, light_tokens=4, hog_tokens=8,
                               hog_every=4)
    cs["PREEMPT_PAGES"], cs["PREEMPT_CHUNK"] = 12, 32
    cs["PREEMPT_PLAN"] = {
        "reserve": {"ticks": 30, "concurrency_hw": 4, "preemptions": 0},
        "preempt": {"ticks": 26, "concurrency_hw": 5, "preemptions": 2,
                    "replayed_tokens": 3}}
    cfg = dataclasses.replace(configs.get_config(ARCH).smoke(),
                              dtype="bfloat16", head_dim=128, num_heads=8,
                              num_kv_heads=2)
    rep = cs["qwen_phase"](torch, StandIn({ARCH: cfg}), engine, traces,
                           model, api, spec, 0, counters, KERNEL_PATHS)
    k = rep["kernel"]
    assert k["requests"] == 8 and k["prefills"] == 8
    assert k["launches"] == {
        "paged_attention": 2 * k["decode_ticks"], "paged_attention_verify": 0,
        "flash_attention": 2 * k["prefills"], "moe_gmm": 0}
    assert all(p["cuda_core"] == 0 for p in k["paths"].values())
    assert rep["torch"]["launches"] == dict.fromkeys(counters, 0)
    sp = rep["spec"]["spec"]
    assert sp["spec_ticks"] > 0 and sp["launches"][
        "paged_attention_verify"] == 2 * sp["spec_ticks"]
    bf16, fp32 = rep["preemption_bf16"], rep["preemption_fp32"]
    assert bf16["preempt"]["preemptions"] == 2
    assert fp32["preemptions"] >= 1 and fp32["ticks"] < 26
    for pre in (bf16, fp32):
        assert pre["preempted"]["agreement"]["violations"] == 0
    assert fp32["preempted"]["rids"] == [4]
    assert fp32["preempted"]["replayed_tokens"] == {4: 3}
    assert fp32["paths"]["paged_attention"]["mma"] == 0
    assert rep["preemption_bf16"]["reserve"]["concurrency_hw"] < \
        rep["preemption_bf16"]["preempt"]["concurrency_hw"]
