"""kimi-k2 at head dim 112 against the JAX package on the CPU, and a CPU
rehearsal of ``chip_smoke.py``'s phase 13.

``ModelConfig.smoke()`` sets head_dim 16 and 4 / 2 heads, which would hide
the head dim and the grouping the D = 112 kernel bodies serve, so the config
here is kimi-k2's smoke variant (2 layers, d_model 64, 8 experts top-2,
expert d_ff 128, vocab 256, capacity factor 1.25, immune router, tied
embeddings) at head_dim 112 with 8 / 1 heads (kimi-k2's 8:1 grouping), in
fp32. Both packages get the same weights (the JAX tree converted by
``params_from_numpy``), the same numpy tokens and the same seeded router
bias.

Tolerances: prefill and decode logits within 1e-5 (both sides run the same
fp32 operations, in another summation order); engine tokens exactly equal
on a trace whose concurrent-duplicate prefix fault (ROADMAP queue 3) cannot
fire (the MoE engine prefills one-shot at capacity factor 1.25 and shares no
prefix); the plain flash / paged / verify versions at D = 112 within 5e-5 /
1e-5 / 1e-5 of the interpret-mode Pallas kernels in fp32 (the tolerances of
tests/test_kernels.py), flash in bf16 within 5e-2 of the JAX oracle. On the
CPU the port's kernel backend runs each kernel's plain version; the card
tests (``tests/test_torch_cuda.py``) hold the kernels to those.
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
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro.serve import traces as jtraces
from repro_torch import configs
from repro_torch.core import router
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.paged_attention import (paged_attention_ref,
                                                 paged_attention_verify_ref)
from repro_torch.models import model, moe
from repro_torch.serve import api, engine, traces

from _torch_rehearsal import (KERNEL_PATHS, StandIn, chip_smoke_on_cpu,
                              counting_wrappers)

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

ARCH = "kimi-k2-1t-a32b"
TOL = 1e-5
KIMI_HEADS = dict(head_dim=112, num_heads=8, num_kv_heads=1)


def _shape(mod, dtype="float32"):
    return dataclasses.replace(mod.get_config(ARCH).smoke(), dtype=dtype,
                               **KIMI_HEADS)


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = _shape(jconfigs), _shape(configs)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    bias = (0.5 * np.random.default_rng(3).standard_normal(
        (cfg.num_layers, cfg.num_experts))).astype(np.float32)
    return jcfg, cfg, jp, tp, bias


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


def test_params_from_numpy_takes_the_kimi_tree(pair):
    """The kimi-shaped JAX tree (D = 112, GQA 8:1, MoE leaves) converts leaf
    for leaf and back, bit for bit, with the same parameter counts."""
    jcfg, cfg, jp, tp, _ = pair
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.family, cfg.router_mode, cfg.tie_embeddings) == \
        ("moe", "immune", True)
    mixer = tp.blocks[0].mixer
    assert mixer.wq.shape[-1] == 8 * 112 and mixer.wk.shape[-1] == 112
    assert tp.blocks[0].moe.w_gate.shape == (8, 64, 128)
    back = model.params_to_numpy(tp, cfg)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(got, ref)
    assert model.param_count(tp) == jmodel.param_count(jp)
    assert model.active_param_count(tp, cfg) == \
        jmodel.active_param_count(jp, jcfg)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_prefill_matches_jax(pair, backend):
    """Prefill logits and the dense cache it fills, with the router bias,
    on both backends (two sequences, a ragged 37 tokens)."""
    jcfg, cfg, jp, tp, bias = pair
    toks = _tokens(37, (2, 37), cfg.vocab_size)
    jl, jc = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                            jmodel.init_cache(jcfg, 2, 48),
                            router_bias=jnp.asarray(bias))
    tl, tc = model.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                           model.init_cache(cfg, 2, 48, "cpu"),
                           attn_backend=backend,
                           router_bias=torch.as_tensor(bias))
    assert tl.shape == (2, 1, cfg.vocab_size)
    _close(tl, jl)
    for tseg, jseg in zip(tc["layers"], jc["layers"]):
        for tpos, jpos in zip(tseg, jseg):
            for name in ("k", "v"):
                _close(tpos[name], jpos[name])


def test_decode_step_paged_matches_jax(pair):
    """Three paged decode steps on the kernel backend (the plain versions on
    the CPU) with the router bias: two slots at different depths over
    scattered pages, one inactive lane whose write lands on the null
    page."""
    jcfg, cfg, jp, tp, bias = pair
    page, maxp, num_pages = 8, 6, 16
    table = np.zeros((3, maxp), np.int32)
    table[0, :4] = [5, 2, 9, 14]
    table[1, :2] = [7, 3]
    jpool = jmodel.init_slot_cache_paged(jcfg, 3, page * maxp, num_pages,
                                         page)
    tpool = model.init_slot_cache_paged(cfg, 3, page * maxp, num_pages, page,
                                        "cpu")
    jb, tb = jnp.asarray(bias), torch.as_tensor(bias)
    for slot, plen in ((0, 29), (1, 9)):
        toks = _tokens(slot, (1, plen), cfg.vocab_size)
        _, jone = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                 jmodel.init_cache(jcfg, 1, page * maxp),
                                 router_bias=jb)
        _, tone = model.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                                model.init_cache(cfg, 1, page * maxp, "cpu"),
                                attn_backend="kernel", router_bias=tb)
        jpool = jmodel.insert_slot_cache_paged(jpool, jone, jcfg, slot,
                                               jnp.asarray(table[slot]))
        tpool = model.insert_slot_cache_paged(tpool, tone, cfg, slot,
                                              torch.as_tensor(table[slot]))
    active = np.asarray([True, True, False])
    for step in range(3):
        nxt = _tokens(50 + step, (3, 1), cfg.vocab_size)
        jl, jpool = jmodel.decode_step(
            jp, jcfg, {"token": jnp.asarray(nxt)}, jpool, router_bias=jb,
            table=jnp.asarray(table), active=jnp.asarray(active))
        tl, tpool = model.decode_step(
            tp, cfg, {"token": torch.as_tensor(nxt)}, tpool,
            table=torch.as_tensor(table), active=torch.as_tensor(active),
            attn_backend="kernel", router_bias=tb)
        _close(tl[:2], jl[:2])


def test_engine_matches_jax_engine(pair):
    """A 5-request ``synthetic_trace`` (a heavy 33-token prompt, one lane
    sampled) on 2 slots: the port's engine on the kernel backend emits the
    JAX engine's tokens exactly, and its own one-shot ``generate``'s."""
    jcfg, cfg, jp, tp, bias = pair

    def trace(mod, c):
        reqs = mod.synthetic_trace(c, num_requests=5, seed=0,
                                   prompt_lens=(9, 20), light_tokens=6,
                                   heavy_tokens=10, heavy_prompt=33)
        reqs[1].params = dataclasses.replace(reqs[1].params,
                                             temperature=0.8)
        return reqs

    ekw = dict(num_slots=2, max_cache=48, page_size=8, num_classes=3)
    jeng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**ekw),
                          router_bias=jnp.asarray(bias))
    jeng.run(trace(jtraces, jcfg), max_ticks=300)
    teng = engine.Engine(tp, cfg, engine.EngineConfig(**ekw), device="cpu",
                         router_bias=torch.as_tensor(bias))
    stats = teng.run(trace(traces, cfg), max_ticks=300)
    assert stats["completed"] == 5 and stats["chunked_prefill_chunks"] == 0
    assert stats["shared_pages_adopted"] == 0
    ours = {r.rid: r.out_tokens for r in teng.completed}
    assert ours == {r.rid: r.out_tokens for r in jeng.completed}
    for req in teng.completed:
        probe = api.ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params)
        assert api.generate(tp, cfg, probe, max_cache=48,
                            router_bias=torch.as_tensor(bias)).tokens == \
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
def test_paged_plain_at_kimi_grouping_matches_jax(page, maxp):
    """Decode at G = 8 (kimi-k2's 64 / 8 heads, cut to 8 / 1) and D = 112,
    ragged lengths incl. a full table: the plain version against the
    interpret-mode Pallas kernel, fp32, 1e-5."""
    rng = np.random.default_rng(page + maxp)
    b = 3
    q, kp, vp = _pools(rng, b, 8, 1, 112, page, maxp, ())
    lengths = np.asarray([1, page + 3, maxp * page], np.int32)
    table = np.arange(1, b * maxp + 1, dtype=np.int32).reshape(b, maxp)
    for i, n in enumerate(lengths):
        table[i, -(-int(n) // page):] = 0
    arrs = (q, kp, vp, table, lengths)
    out = paged_attention_ref(*(torch.as_tensor(a) for a in arrs))
    ref = jax_paged(*(jnp.asarray(a) for a in arrs), interpret=True)
    _close(out, ref)


@pytest.mark.parametrize("sq", [2, 5])
def test_verify_plain_at_kimi_grouping_matches_jax(sq):
    """The verify step at G = 8 and D = 112 (Sq rows of 8 q heads a kv
    head, one lane at the table's end): fp32, 1e-5 of the interpret-mode
    Pallas verify kernel."""
    rng = np.random.default_rng(sq)
    b, page, maxp = 2, 8, 4
    q, kp, vp = _pools(rng, b, 8, 1, 112, page, maxp, (sq,))
    pos = np.asarray([page, maxp * page - sq], np.int32)
    table = np.arange(1, b * maxp + 1, dtype=np.int32).reshape(b, maxp)
    arrs = (q, kp, vp, table, pos)
    out = paged_attention_verify_ref(*(torch.as_tensor(a) for a in arrs))
    ref = jax_verify(*(jnp.asarray(a) for a in arrs), interpret=True)
    _close(out, ref)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_at_kimi_grouping_matches_jax(causal):
    """Flash at 16 / 2 heads (G = 8) and D = 112 over two 128-blocks: fp32
    within 5e-5 of the interpret-mode Pallas kernel, and bf16 at a ragged
    S = 100 within 5e-2 of the JAX oracle."""
    rng = np.random.default_rng(112)
    q, k, v = (rng.standard_normal((1, h, 256, 112)).astype(np.float32)
               for h in (16, 2, 2))
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
# phase 13 of chip_smoke.py, rehearsed on the CPU
# ---------------------------------------------------------------------------
def test_phase13_rehearsal_on_cpu(monkeypatch):
    """``chip_smoke.kimi_phase`` with every ``"cuda"`` read as ``"cpu"``,
    the ``torch.cuda`` sync and memory calls and the profiler stubbed, the
    kernel wrappers counted as on the card, and a bf16 kimi-shaped smoke
    config: it serves its 8 requests on both backends, counts flash once a
    prefill, paged decode once a tick and the grouped matmul 3 x (ticks +
    prefills) on ``mma`` (the CUDA-core bodies in fp32), and passes phase
    6's MoE rule."""
    cs = chip_smoke_on_cpu(monkeypatch)
    counters = counting_wrappers(monkeypatch)
    rep = cs["kimi_phase"](torch, StandIn({ARCH: _shape(configs, "bfloat16")}),
                           engine, traces, model, api, moe, router, 0,
                           counters, KERNEL_PATHS)
    ticks, prefills = rep["kernel"]["decode_ticks"], rep["kernel"]["prefills"]
    assert rep["kernel"]["requests"] == 8 and prefills == 8 and ticks > 30
    assert rep["kernel"]["launches"] == {
        "paged_attention": ticks, "paged_attention_verify": 0,
        "flash_attention": prefills, "moe_gmm": 3 * (ticks + prefills)}
    assert all(p["cuda_core"] == 0 for p in rep["kernel"]["paths"].values())
    assert rep["torch"]["launches"] == dict.fromkeys(counters, 0)
    assert rep["fp32_kernel"]["launches"]["moe_gmm"] > 0
    assert rep["agreement_fp32"]["violations"] == 0
    assert rep["layers"] == 1 and rep["head_dim"] == 112
