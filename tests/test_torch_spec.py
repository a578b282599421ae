"""Self-speculative decoding in the port against the JAX package's on the CPU:
the paged verify layer and ``verify_step`` (written pages and logits),
``spec_tick`` (drafts and argmaxes), and the engine — spec equal to non-spec
equal to the JAX spec engine, spec ticks gated off by sampled, logprob and
penalized residents, preemption replay, stop and budget inside an accepted
run, and positions past a slot's capacity; on the MoE family, with a nonzero
router bias riding into draft and verify.

Tolerances (fp32 smoke weights, the JAX tree converted with
``params_from_numpy``): logits within 1e-5, tokens exactly equal. The JAX
package holds a verify row bitwise equal to the sequential decode row; across
frameworks that is a tolerance, and so is it inside the port (a (k+1)-row and
a 1-row projection sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serve import api as japi
from repro.serve import engine as jengine
from repro.serve import spec as jspec
from repro.serve import traces as jtraces
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers, model, transformer
from repro_torch.serve import api, decode, engine, spec, traces
from repro_torch.serve.api import SamplingParams, ServeRequest

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
DEPTH = 1                 # draft depth for the 2-layer smoke stack
BACKENDS = ("kernel", "torch")
PAGE, MAXP = 8, 4


@pytest.fixture(scope="module")
def pair():
    """The JAX smoke weights made draft-friendly on the JAX side, then
    converted (so ``make_draft_friendly`` itself is checked separately)."""
    jcfg = jconfigs.get_config("smollm-360m").smoke()
    cfg = configs.get_config("smollm-360m").smoke()
    jp = jspec.make_draft_friendly(
        jmodel.init_params(jax.random.PRNGKey(0), jcfg), jcfg, DEPTH)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


def _pages_close(tpool, jpool):
    """Every page but the null page (trash on both sides), and positions."""
    for tseg, jseg in zip(tpool["layers"], jpool["layers"]):
        for tpos, jpos in zip(tseg, jseg):
            for name in ("k", "v"):
                _close(tpos[name][:, 1:], np.asarray(jpos[name])[:, 1:])
    np.testing.assert_array_equal(_np(tpool["pos"]), _np(jpool["pos"]))


def _pools(pair, prompts: dict):
    """Both packages' paged pools with ``prompts`` ({slot: length}) prefilled
    into scattered pages; slot 2 stays inactive. Returns (table, active,
    jpool, tpool); pool positions are the prompt lengths."""
    jcfg, cfg, jp, tp = pair
    table = np.zeros((3, MAXP), np.int32)
    table[0] = [5, 2, 9, 11]
    table[1] = [7, 3, 10, 1]
    jpool = jmodel.init_slot_cache_paged(jcfg, 3, PAGE * MAXP, 12, PAGE)
    tpool = model.init_slot_cache_paged(cfg, 3, PAGE * MAXP, 12, PAGE, "cpu")
    for slot, plen in prompts.items():
        toks = _tokens(slot, (1, plen), cfg.vocab_size)
        _, jone = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                 jmodel.init_cache(jcfg, 1, PAGE * MAXP))
        _, tone = model.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                                model.init_cache(cfg, 1, PAGE * MAXP, "cpu"))
        jpool = jmodel.insert_slot_cache_paged(jpool, jone, jcfg, slot,
                                               jnp.asarray(table[slot]))
        tpool = model.insert_slot_cache_paged(tpool, tone, cfg, slot,
                                              torch.as_tensor(table[slot]))
    return table, np.asarray([True, True, False]), jpool, tpool


# ---------------------------------------------------------------------------
# the verify layer and verify_step against JAX
# ---------------------------------------------------------------------------
class TestVerify:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_attention_verify_paged_matches_jax(self, pair, backend):
        """Block 0's attention: outputs and every written page."""
        jcfg, cfg, jp, tp = pair
        table, active, _, _ = _pools(pair, {})
        rng = np.random.default_rng(1)
        shape = (12, PAGE, cfg.num_kv_heads, cfg.head_dim)
        kv = {n: rng.standard_normal(shape).astype(np.float32)
              for n in ("k", "v")}
        x = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
        pos = np.asarray([7, 29, 0], np.int32)      # lane 1 runs past 32
        jmix = jax.tree.map(lambda a: a[0], jp["stack"][0][0]["mixer"])
        jout, jc = jlayers.attention_verify_paged(
            jmix, jnp.asarray(x), jcfg, {n: jnp.asarray(a) for n, a in
                                         kv.items()},
            jnp.asarray(pos), jnp.asarray(table), jnp.asarray(active))
        tc = {n: torch.as_tensor(a.copy()) for n, a in kv.items()}
        tout, tc = layers.attention_verify_paged(
            tp.blocks[0].mixer, torch.as_tensor(x), cfg, tc,
            torch.as_tensor(pos), torch.as_tensor(table),
            torch.as_tensor(active), backend=backend)
        _close(tout[:2], jout[:2])
        for n in ("k", "v"):
            _close(tc[n][1:], np.asarray(jc[n])[1:])

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("pos0", [19, 30])
    def test_verify_step_matches_jax(self, pair, backend, pos0):
        """Two slots at different depths, one inactive lane; ``pos0 = 30``
        puts lane 0 at ``max_cache - 2`` with k = 4, so its last rows fall
        past the table (written to the null page, attending everything)."""
        jcfg, cfg, jp, tp = pair
        table, active, jpool, tpool = _pools(pair, {0: pos0, 1: 9})
        seq = _tokens(40 + pos0, (3, 5), cfg.vocab_size)
        jl, jpool = jmodel.verify_step(jp, jcfg, {"tokens": jnp.asarray(seq)},
                                       jpool, jnp.asarray(table),
                                       active=jnp.asarray(active))
        tl, tpool = model.verify_step(tp, cfg, {"tokens": torch.as_tensor(seq)},
                                      tpool, torch.as_tensor(table),
                                      active=torch.as_tensor(active),
                                      attn_backend=backend)
        assert tl.shape == (3, 5, cfg.vocab_size)
        _close(tl[:2], jl[:2])
        _pages_close(tpool, jpool)

    def test_verify_rows_match_sequential_decode(self, pair):
        """Row ``j`` of verify is the decode step at ``pos + j`` (the port's
        own accept oracle), logits within 1e-5, pages alike."""
        _, cfg, _, tp = pair
        table, active, _, vpool = _pools(pair, {0: 11, 1: 6})
        _, _, _, dpool = _pools(pair, {0: 11, 1: 6})
        seq = _tokens(3, (3, 4), cfg.vocab_size)
        tt, ta = torch.as_tensor(table), torch.as_tensor(active)
        vl, vpool = model.verify_step(tp, cfg, {"tokens": torch.as_tensor(seq)},
                                      vpool, tt, active=ta)
        for j in range(4):
            dl, dpool = model.decode_step(
                tp, cfg, {"token": torch.as_tensor(seq[:, j:j + 1])}, dpool,
                table=tt, active=ta)
            _close(vl[:2, j], dl[:2, 0])
        for vseg, dseg in zip(vpool["layers"], dpool["layers"]):
            for n in ("k", "v"):
                _close(vseg[0][n][:, 1:], dseg[0][n][:, 1:])


# ---------------------------------------------------------------------------
# spec_tick, accept rule, draft-friendly weights
# ---------------------------------------------------------------------------
class TestSpecTick:
    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("pos0", [13, 30])
    def test_drafts_and_argmax_match_jax(self, pair, backend, pos0):
        jcfg, cfg, jp, tp = pair
        table, active, jpool, tpool = _pools(pair, {0: pos0, 1: 9})
        last = _tokens(pos0, (3, 1), cfg.vocab_size)
        jd, jam, jok, jlg, jpool = jspec.spec_tick(
            jp, jcfg, jpool, jnp.asarray(last), jnp.asarray(active),
            jnp.asarray(table), k=4, depth=DEPTH, return_logits=True)
        td, tam, tok, tlg, tpool = spec.spec_tick(
            tp, cfg, tpool, torch.as_tensor(last), torch.as_tensor(active),
            torch.as_tensor(table), k=4, depth=DEPTH, attn_backend=backend,
            return_logits=True)
        np.testing.assert_array_equal(td[:2].numpy(), np.asarray(jd)[:2])
        np.testing.assert_array_equal(tam[:2].numpy(), np.asarray(jam)[:2])
        assert tok.all() and np.asarray(jok).all()
        _close(tlg[:2], jlg[:2])
        _pages_close(tpool, jpool)

    def test_pool_after_spec_tick_is_pool_after_verify(self, pair):
        """The draft writes in place; verify rewrites every position it
        touched before reading, so the drafts leave no trace."""
        _, cfg, _, tp = pair
        table, active, _, spool = _pools(pair, {0: 30, 1: 9})
        _, _, _, vpool = _pools(pair, {0: 30, 1: 9})
        last = _tokens(2, (3, 1), cfg.vocab_size)
        tt, ta = torch.as_tensor(table), torch.as_tensor(active)
        drafts, _, _, _, spool = spec.spec_tick(
            tp, cfg, spool, torch.as_tensor(last), ta, tt, k=4, depth=DEPTH)
        seq = torch.cat([torch.as_tensor(last), drafts], dim=1)
        _, vpool = model.verify_step(tp, cfg, {"tokens": seq}, vpool, tt,
                                     active=ta)
        for sseg, vseg in zip(spool["layers"], vpool["layers"]):
            for n in ("k", "v"):
                assert torch.equal(sseg[0][n][:, 1:], vseg[0][n][:, 1:])

    def test_accept_length_is_longest_matching_prefix(self):
        assert spec.accept_length([3, 5, 7], [3, 5, 9, 1], 3) == 2
        assert spec.accept_length([3, 5, 7], [3, 5, 7, 1], 3) == 3
        assert spec.accept_length([4, 5, 7], [3, 5, 7, 1], 3) == 0
        assert spec.accept_length([], [9], 0) == 0

    def test_draft_friendly_copies_and_matches_jax(self, pair):
        jcfg, cfg, _, _ = pair
        jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
        tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
        before = {n: p.clone() for n, p in tp.named_parameters()}
        out = spec.make_draft_friendly(tp, cfg, DEPTH)
        for n, p in tp.named_parameters():
            assert torch.equal(p, before[n]), f"{n} modified in place"
        ref = model.params_from_numpy(jax.tree.map(
            np.asarray, jspec.make_draft_friendly(jp, jcfg, DEPTH)), cfg, "cpu")
        for (n, a), (_, b) in zip(out.named_parameters(),
                                  ref.named_parameters()):
            assert torch.equal(a, b), n
        assert not torch.equal(out.blocks[1].mlp.w_down, tp.blocks[1].mlp.w_down)
        assert torch.equal(out.blocks[0].mixer.wo, tp.blocks[0].mixer.wo)

    def test_truncate_stack_is_the_leading_layers(self, pair):
        _, cfg, _, tp = pair
        pool = model.init_slot_cache_paged(cfg, 2, 32, 5, 8, "cpu")
        pairs = transformer.truncate_stack(tp.blocks, cfg, pool["layers"], 1)
        assert len(pairs) == 1 and pairs[0][0] is tp.blocks[0]
        assert pairs[0][1]["k"].data_ptr() == pool["layers"][0][0]["k"] \
            .data_ptr()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _ecfg(**kw):
    base = dict(num_slots=2, max_cache=64, page_size=16, prefill_chunk=8,
                policy="fifo", spec_decode=4, spec_draft_layers=DEPTH)
    base.update(kw)
    return base


def _reqs(cfg, n, seed=0, plens=(6, 10), steps=(8, 12), stagger=1, **pkw):
    rng = np.random.default_rng(seed)
    return [ServeRequest(
        rid=rid, tokens=rng.integers(0, cfg.vocab_size,
                                     size=plens[rid % len(plens)])
        .astype(np.int32),
        params=SamplingParams(max_new_tokens=steps[rid % len(steps)],
                              seed=100 + rid, **pkw),
        rclass=rid % 2, arrival=rid * stagger) for rid in range(n)]


def _oneshot_tokens(tp, cfg, req, max_cache):
    probe = ServeRequest(rid=req.rid, tokens=req.tokens, params=req.params)
    return api.generate(tp, cfg, probe, max_cache=max_cache).tokens


def _tokens_by_rid(eng) -> dict:
    return {r.rid: list(r.out_tokens) for r in eng.completed}


SPEC_COUNTERS = ("completed", "ticks", "spec_ticks", "spec_drafted",
                 "spec_accepted", "spec_emitted", "shared_pages_adopted",
                 "cow_forks", "prefill_tokens", "preemptions",
                 "replayed_tokens")


class TestSpecEngine:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_agentic_spec_equals_nonspec_equals_jax(self, pair, backend):
        """Grown-prompt agentic turns over shared pages: the port's spec
        engine emits the port's non-spec tokens and the JAX spec engine's,
        with equal spec and paging counters; every stream is also the
        port's one-shot oracle's."""
        jcfg, cfg, jp, tp = pair

        def trace(m, c):
            return m.agentic_trace(c, sessions=2, turns=3, base_prompt=16,
                                   grow_lens=(4, 6), decode_lens=(6, 8),
                                   turn_gap=2)

        ekw = _ecfg(max_cache=96, pin_pages=4)
        jeng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**ekw))
        jstats = jeng.run(trace(jtraces, jcfg), max_ticks=400)
        runs = {}
        for k in (0, 4):
            eng = engine.Engine(tp, cfg, engine.EngineConfig(
                **{**ekw, "spec_decode": k,
                   "spec_draft_layers": DEPTH if k else 0},
                attn_backend=backend), device="cpu")
            runs[k] = (eng, eng.run(trace(traces, cfg), max_ticks=400))
        eng, stats = runs[4]
        assert stats["completed"] == 6 and stats["spec_ticks"] > 0
        assert stats["spec_accepted"] > 0
        assert stats["spec_emitted"] > stats["spec_ticks"]
        assert stats["ticks"] < runs[0][1]["ticks"]
        assert stats["shared_pages_adopted"] \
            + stats["pinned_pages_adopted"] > 0
        assert _tokens_by_rid(eng) == _tokens_by_rid(runs[0][0]) \
            == _tokens_by_rid(jeng)
        for key in SPEC_COUNTERS:
            assert stats[key] == jstats[key], (key, stats[key], jstats[key])
        for req in eng.completed:
            assert req.out_tokens == _oneshot_tokens(tp, cfg, req, 96)

    def test_spec_logits_match_oneshot(self, pair):
        """Captured logits rows of spec-emitted tokens are the one-shot
        oracle's within 1e-5."""
        _, cfg, _, tp = pair
        eng = engine.Engine(tp, cfg, engine.EngineConfig(
            **_ecfg(capture_logits=True)), device="cpu")
        stats = eng.run(_reqs(cfg, 3), max_ticks=300)
        assert stats["completed"] == 3 and stats["spec_emitted"] > 0
        for req in eng.completed:
            probe = ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params)
            out = api.generate(tp, cfg, probe, max_cache=64,
                               capture_logits=True)
            assert out.tokens == req.out_tokens
            _close(np.stack(req.out_logits), np.stack(probe.out_logits))

    @pytest.mark.parametrize("pkw", [dict(temperature=0.9, top_p=0.9),
                                     dict(logprobs=1),
                                     dict(repetition_penalty=1.3)],
                             ids=["sampled", "logprobs", "penalized"])
    def test_residents_that_cannot_ride_a_spec_tick_gate_it_off(self, pair,
                                                                pkw):
        _, cfg, _, tp = pair
        eng = engine.Engine(tp, cfg, engine.EngineConfig(**_ecfg()),
                            device="cpu")
        stats = eng.run(_reqs(cfg, 3, **pkw), max_ticks=300)
        assert stats["completed"] == 3
        assert stats["spec_ticks"] == 0
        for req in eng.completed:
            assert req.out_tokens == _oneshot_tokens(tp, cfg, req, 64)

    def test_gate_reopens_when_the_sampled_resident_leaves(self, pair):
        _, cfg, _, tp = pair
        reqs = _reqs(cfg, 2, steps=(4, 20), stagger=0)
        reqs[0].params = dataclasses.replace(reqs[0].params, temperature=0.8)
        eng = engine.Engine(tp, cfg, engine.EngineConfig(**_ecfg()),
                            device="cpu")
        stats = eng.run(reqs, max_ticks=300)
        assert stats["completed"] == 2 and stats["spec_ticks"] > 0
        assert stats["decode_ticks"] > 0
        for req in eng.completed:
            assert req.out_tokens == _oneshot_tokens(tp, cfg, req, 64)

    def test_preempted_then_replayed_spec_is_exact(self, pair):
        """Page pressure preempts a spec-decoding resident; its replay runs
        through spec ticks and the stream is still the one-shot oracle's and
        the JAX engine's."""
        jcfg, cfg, jp, tp = pair
        ekw = _ecfg(num_slots=2, max_cache=96, page_size=8, num_pages=10,
                    admission_mode="preempt", prefill_chunk=8)

        def trace(m):
            hog = m.ServeRequest(rid=0, tokens=np.arange(16, dtype=np.int32),
                                 params=m.SamplingParams(max_new_tokens=40))
            rng = np.random.default_rng(3)
            late = [m.ServeRequest(
                rid=i + 1, tokens=rng.integers(0, cfg.vocab_size, size=24)
                .astype(np.int32),
                params=m.SamplingParams(max_new_tokens=10, seed=100 + i),
                rclass=i % 2, arrival=2 + i) for i in range(2)]
            return [hog] + late

        from repro.serve import api as japi
        jeng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**ekw))
        jeng.run(trace(japi), max_ticks=500)
        eng = engine.Engine(tp, cfg, engine.EngineConfig(**ekw), device="cpu")
        stats = eng.run(trace(api), max_ticks=500)
        assert stats["completed"] == 3 and stats["spec_ticks"] > 0
        assert stats["preemptions"] > 0 and stats["replayed_tokens"] > 0
        assert _tokens_by_rid(eng) == _tokens_by_rid(jeng)
        for req in eng.completed:
            toks, _ = decode.generate(tp, cfg, req.prompts("cpu"),
                                      max_cache=96, steps=req.max_new_tokens)
            assert req.out_tokens == toks[0].tolist()

    def test_stop_and_budget_inside_an_accepted_run(self, pair):
        """A stop token (at its first occurrence in the free stream) and a
        budget that both land inside one spec tick's accepted run: the lane
        emits exactly up to them."""
        _, cfg, _, tp = pair
        [probe] = _reqs(cfg, 1, steps=(16,))
        free_eng = engine.Engine(tp, cfg, engine.EngineConfig(**_ecfg()),
                                 device="cpu")
        free_stats = free_eng.run([probe], max_ticks=100)
        free = probe.out_tokens
        assert free_stats["spec_emitted"] > free_stats["spec_ticks"]
        idx = next(i for i in range(2, len(free)) if free.index(free[i]) == i)
        [stop] = _reqs(cfg, 1, steps=(16,))
        stop.params = dataclasses.replace(stop.params, stop=(free[idx],))
        [short] = _reqs(cfg, 1, steps=(idx + 1,))
        for req, reason in ((stop, "stop"), (short, "length")):
            eng = engine.Engine(tp, cfg, engine.EngineConfig(**_ecfg()),
                                device="cpu")
            stats = eng.run([req], max_ticks=100)
            assert req.out_tokens == free[:idx + 1]
            assert req.finish_reason == reason
            assert stats["spec_ticks"] > 0 and stats["pages_in_use"] == 0
        assert stats["spec_emitted"] == idx      # the seed came from prefill

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_capacity_edge(self, pair, backend):
        """Prompt + budget = max_cache: the last spec ticks draft and verify
        positions past the slot's capacity (pos = max_cache - 2, k = 4).
        They go to the null page, and the stream is still exact."""
        jcfg, cfg, jp, tp = pair
        from repro.serve import api as japi

        def req(m):
            return m.ServeRequest(rid=0, tokens=_tokens(9, (20,),
                                                        cfg.vocab_size),
                                  params=m.SamplingParams(max_new_tokens=12))

        ekw = _ecfg(num_slots=2, max_cache=32, page_size=8)
        jeng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**ekw))
        jeng.run([req(japi)], max_ticks=100)
        eng = engine.Engine(tp, cfg, engine.EngineConfig(
            **ekw, attn_backend=backend), device="cpu")
        stats = eng.run([req(api)], max_ticks=100)
        assert stats["completed"] == 1 and stats["spec_ticks"] > 0
        [r] = eng.completed
        assert len(r.out_tokens) == 12
        assert r.out_tokens == _oneshot_tokens(tp, cfg, r, 32)
        assert _tokens_by_rid(eng) == _tokens_by_rid(jeng)

    def test_spec_config_validation(self, pair):
        _, cfg, _, tp = pair
        for depth in (0, cfg.num_layers):
            with pytest.raises(ValueError, match="spec_draft_layers"):
                engine.Engine(tp, cfg, engine.EngineConfig(
                    **_ecfg(spec_draft_layers=depth)), device="cpu")
        with pytest.raises(ValueError, match="spec_decode"):
            engine.Engine(tp, cfg, engine.EngineConfig(
                **_ecfg(spec_decode=-1)), device="cpu")


def test_cli_serves_agentic_with_spec_on_cpu(capsys):
    stats = launch_serve.main(["--arch", "smollm-360m", "--smoke", "--stream",
                               "--device", "cpu", "--requests", "8",
                               "--slots", "3", "--trace", "agentic",
                               "--steps", "8", "--spec-decode", "4",
                               "--spec-draft-layers", "1"])
    assert stats["completed"] + stats["shed"] + stats["rejected"] == 8
    assert stats["spec_decode"] == 4
    assert "spec decode: k=4" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the MoE family (granite-moe-3b-a800m smoke) with a nonzero router bias
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_pair():
    jcfg = jconfigs.get_config("granite-moe-3b-a800m").smoke()
    cfg = configs.get_config("granite-moe-3b-a800m").smoke()
    jp = jspec.make_draft_friendly(
        jmodel.init_params(jax.random.PRNGKey(0), jcfg), jcfg, DEPTH)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    bias = (0.5 * np.random.default_rng(2).standard_normal(
        (cfg.num_layers, cfg.num_experts))).astype(np.float32)
    return jcfg, cfg, jp, tp, bias


class TestMoESpec:
    def test_draft_friendly_scales_the_experts_like_jax(self):
        jcfg = jconfigs.get_config("granite-moe-3b-a800m").smoke()
        cfg = configs.get_config("granite-moe-3b-a800m").smoke()
        jp = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
        tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
        out = spec.make_draft_friendly(tp, cfg, DEPTH)
        ref = model.params_from_numpy(jax.tree.map(
            np.asarray, jspec.make_draft_friendly(jp, jcfg, DEPTH)), cfg,
            "cpu")
        for (n, a), (_, b) in zip(out.named_parameters(),
                                  ref.named_parameters()):
            assert torch.equal(a, b), n
        assert not torch.equal(out.blocks[1].moe.w_down,
                               tp.blocks[1].moe.w_down)
        assert torch.equal(out.blocks[0].moe.w_down, tp.blocks[0].moe.w_down)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_moe_spec_equals_nonspec_equals_jax(self, moe_pair, backend):
        """The verify pass routes with the plain tick's bias at dropless
        capacity, the draft with its leading layers' rows: spec decode
        emits the non-spec tokens, and the JAX spec engine's."""
        jcfg, cfg, jp, tp, bias = moe_pair
        runs = {}
        for k in (0, 3):
            eng = engine.Engine(tp, cfg, engine.EngineConfig(**_ecfg(
                spec_decode=k, spec_draft_layers=DEPTH if k else 0,
                attn_backend=backend)), device="cpu",
                router_bias=torch.as_tensor(bias))
            stats = eng.run(_reqs(cfg, 3, steps=(6, 8)), max_ticks=300)
            assert stats["completed"] == 3
            runs[k] = (eng, stats)
        assert runs[3][1]["spec_ticks"] > 0
        assert runs[3][1]["spec_accepted"] > 0
        jeng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**_ecfg(
            spec_decode=3)), router_bias=jnp.asarray(bias))
        jeng.run([japi.ServeRequest(
            rid=r.rid, tokens=r.tokens, rclass=r.rclass, arrival=r.arrival,
            params=japi.SamplingParams(max_new_tokens=r.params.max_new_tokens,
                                       seed=r.params.seed))
            for r in _reqs(cfg, 3, steps=(6, 8))], max_ticks=300)
        assert _tokens_by_rid(runs[3][0]) == _tokens_by_rid(runs[0][0]) \
            == _tokens_by_rid(jeng)
        for key in SPEC_COUNTERS:
            assert runs[3][1][key] == jeng.stats()[key], key

    def test_spec_tick_drafts_and_argmax_match_jax(self, moe_pair):
        """One spec tick on pools prefilled through both packages: the same
        drafts and verify argmaxes, logits within 1e-5."""
        jcfg, cfg, jp, tp, bias = moe_pair
        table = np.zeros((3, MAXP), np.int32)
        table[0] = [5, 2, 9, 11]
        table[1] = [7, 3, 10, 1]
        jpool = jmodel.init_slot_cache_paged(jcfg, 3, PAGE * MAXP, 12, PAGE)
        tpool = model.init_slot_cache_paged(cfg, 3, PAGE * MAXP, 12, PAGE,
                                            "cpu")
        last = np.zeros((3, 1), np.int32)
        for slot, plen in {0: 9, 1: 14}.items():
            toks = _tokens(slot, (1, plen), cfg.vocab_size)
            jlg, jone = jmodel.prefill(
                jp, jcfg, {"tokens": jnp.asarray(toks)},
                jmodel.init_cache(jcfg, 1, PAGE * MAXP),
                router_bias=jnp.asarray(bias))
            _, tone = model.prefill(
                tp, cfg, {"tokens": torch.as_tensor(toks)},
                model.init_cache(cfg, 1, PAGE * MAXP, "cpu"),
                router_bias=torch.as_tensor(bias))
            jpool = jmodel.insert_slot_cache_paged(jpool, jone, jcfg, slot,
                                                   jnp.asarray(table[slot]))
            tpool = model.insert_slot_cache_paged(
                tpool, tone, cfg, slot, torch.as_tensor(table[slot]))
            last[slot, 0] = int(np.argmax(np.asarray(jlg)[0, -1]))
        active = np.asarray([True, True, False])
        dcfg = dataclasses.replace(cfg, capacity_factor=float(
            cfg.num_experts))
        jdcfg = dataclasses.replace(jcfg, capacity_factor=float(
            jcfg.num_experts))
        jd, jam, _, jlg, _ = jspec.spec_tick(
            jp, jdcfg, jpool, jnp.asarray(last), jnp.asarray(active),
            jnp.asarray(table), k=3, depth=DEPTH, return_logits=True,
            router_bias=jnp.asarray(bias))
        td, tam, _, tlg, _ = spec.spec_tick(
            tp, dcfg, tpool, torch.as_tensor(last), torch.as_tensor(active),
            torch.as_tensor(table), k=3, depth=DEPTH, return_logits=True,
            router_bias=torch.as_tensor(bias))
        np.testing.assert_array_equal(td.numpy()[:2], np.asarray(jd)[:2])
        np.testing.assert_array_equal(tam.numpy()[:2], np.asarray(jam)[:2])
        _close(tlg[:2], np.asarray(jlg)[:2])
