"""Mechanics of the port's serving engine on the CPU, against its own
one-shot oracle (``api.generate`` / ``decode.generate``): retirement, stop
tokens, rejection and backpressure, the immune admission controller, the
NaN/Inf guard, ``stream()`` deltas, and preemption with replay.

The cases mirror tests/test_serve_engine.py and tests/test_sampling.py with
the known reference faults avoided: a stop token is chosen at its first
occurrence in the stream, and engine-vs-one-shot logits are compared within
1e-5 (fp32) rather than bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import model, transformer
from repro_torch.serve import api, decode, engine, traces
from repro_torch.serve.api import SamplingParams, ServeRequest

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dense():
    cfg = configs.get_config("smollm-360m").smoke()
    return cfg, model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _reqs(cfg, n, seed=0, prompt_lens=(6, 10), steps=(5, 8), stagger=1):
    rng = np.random.default_rng(seed)
    return [ServeRequest(
        rid=rid, tokens=rng.integers(0, cfg.vocab_size,
                                     size=prompt_lens[rid % len(prompt_lens)])
        .astype(np.int32),
        params=SamplingParams(max_new_tokens=steps[rid % len(steps)]),
        rclass=rid % 2, arrival=rid * stagger) for rid in range(n)]


def _oneshot(params, cfg, req, max_cache):
    probe = ServeRequest(rid=req.rid, tokens=req.tokens, params=req.params)
    return api.generate(params, cfg, probe, max_cache=max_cache)


class TestRetirement:
    def test_stop_token_at_first_occurrence(self, dense):
        cfg, params = dense
        ecfg = engine.EngineConfig(num_slots=2, max_cache=48, policy="fifo")
        [probe] = _reqs(cfg, 1, steps=(8,))
        engine.Engine(params, cfg, ecfg, device="cpu").run([probe])
        free = probe.out_tokens
        idx = next(i for i in range(1, len(free)) if free.index(free[i]) == i)
        [again] = _reqs(cfg, 1, steps=(8,))
        again.params = SamplingParams(max_new_tokens=8, stop=(free[idx],))
        eng = engine.Engine(params, cfg, ecfg, device="cpu")
        stats = eng.run([again])
        assert again.out_tokens == free[:idx + 1]
        assert again.finish_reason == "stop" and probe.finish_reason == "length"
        assert stats["pages_in_use"] == 0, "stop retirement left pages held"

    def test_single_token_request_retires_at_admission_tick(self, dense):
        cfg, params = dense
        [req] = _reqs(cfg, 1, steps=(1,))
        eng = engine.Engine(params, cfg, engine.EngineConfig(
            num_slots=2, max_cache=48, policy="fifo"), device="cpu")
        assert eng.run([req])["completed"] == 1
        assert len(req.out_tokens) == 1 and req.finish_tick == req.admit_tick

    def test_submit_rejects_oversized_request(self, dense):
        cfg, params = dense
        eng = engine.Engine(params, cfg, engine.EngineConfig(
            num_slots=2, max_cache=16), device="cpu")
        big, ok = _reqs(cfg, 2, prompt_lens=(12, 6), steps=(8, 4))
        eng.submit(big)
        eng.submit(ok)
        assert eng.rejected == [big] and list(eng.queue) == [ok]
        stats = eng.run([])
        assert stats["completed"] == 1 and stats["rejected"] == 1
        assert stats["goodput"] <= 0.5

    def test_reserve_backpressure_defers_then_serves(self, dense):
        cfg, params = dense
        ecfg = engine.EngineConfig(num_slots=2, max_cache=32, page_size=16,
                                   num_pages=3, policy="fifo",
                                   admission_mode="reserve")
        eng = engine.Engine(params, cfg, ecfg, device="cpu")
        stats = eng.run(_reqs(cfg, 2, prompt_lens=(10,), steps=(8,)))
        assert stats["completed"] == 2 and stats["concurrency_hw"] == 1
        r0, r1 = sorted(eng.completed, key=lambda r: r.rid)
        assert r1.admit_tick >= r0.finish_tick


class TestOracle:
    @pytest.mark.parametrize("prefill_chunk", [0, 8])
    def test_logits_match_oneshot_within_tolerance(self, dense,
                                                   prefill_chunk):
        cfg, params = dense
        ecfg = engine.EngineConfig(num_slots=3, max_cache=48,
                                   prefill_chunk=prefill_chunk,
                                   capture_logits=True)
        reqs = _reqs(cfg, 6, prompt_lens=(6, 19))
        reqs[2].params = dataclasses.replace(reqs[2].params, temperature=0.9,
                                             seed=4, logprobs=2)
        eng = engine.Engine(params, cfg, ecfg, device="cpu")
        eng.run(reqs)
        assert len(eng.completed) == 6
        for req in eng.completed:
            probe = ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params)
            out = api.generate(params, cfg, probe, max_cache=48,
                               capture_logits=True)
            assert out.tokens == req.out_tokens
            np.testing.assert_allclose(np.stack(req.out_logits),
                                       np.stack(probe.out_logits),
                                       rtol=1e-5, atol=1e-5)
            if req.params.logprobs:
                np.testing.assert_allclose(req.out_logprobs,
                                           probe.out_logprobs, atol=1e-5)
                assert [i for i, _ in req.out_topk] == \
                    [i for i, _ in probe.out_topk]

    def test_penalized_lanes_match_oneshot(self, dense):
        cfg, params = dense
        reqs = _reqs(cfg, 4)
        for r in reqs[:2]:
            r.params = dataclasses.replace(
                r.params, temperature=0.7, seed=r.rid, repetition_penalty=1.3,
                frequency_penalty=0.2, max_new_tokens=8)
        eng = engine.Engine(params, cfg, engine.EngineConfig(
            num_slots=2, max_cache=48), device="cpu")
        eng.run(reqs)
        for req in eng.completed:
            assert _oneshot(params, cfg, req, 48).tokens == req.out_tokens

    def test_stream_deltas_concatenate_to_the_output(self, dense):
        cfg, params = dense
        reqs = traces.synthetic_trace(cfg, num_requests=6, temperature=0.8)
        eng = engine.Engine(params, cfg, engine.EngineConfig(
            num_slots=2, max_cache=64, num_classes=3), device="cpu")
        seen, finished = {}, {}
        for out in eng.stream(reqs):
            seen.setdefault(out.rid, []).extend(out.new_tokens)
            assert out.tokens == seen[out.rid]
            if out.finished:
                finished[out.rid] = out
        for req in eng.completed:
            assert seen[req.rid] == req.out_tokens
            assert finished[req.rid].finish_reason == "length"
            assert finished[req.rid].latency_ticks == req.latency


class TestNanGuard:
    def test_poisoned_page_retires_only_its_lane(self, dense):
        cfg, params = dense
        eng = engine.Engine(params, cfg, engine.EngineConfig(
            num_slots=2, max_cache=48, policy="fifo"), device="cpu")
        # both fit one page; the corrupted lane's page is scrubbed before it
        # is freed (see test_recycled_page_of_a_corrupted_lane_is_scrubbed)
        a, b = _reqs(cfg, 2, prompt_lens=(6,), steps=(8, 8), stagger=0)
        eng.submit(a)
        eng.submit(b)
        eng.step()
        page = int(eng.alloc.table()[a.slot, 0])

        def poison(kind, d):         # K only, as the reference's guard test
            d["k"][:, page] = float("nan")
            return d

        transformer.map_block_caches(cfg, poison, eng.pool["layers"])
        stats = eng.run([])
        assert a.finish_reason == "corrupted" and stats["corrupted"] == 1
        assert b.finish_reason == "length"
        assert b.out_tokens == _oneshot(params, cfg, b, 48).tokens

    @pytest.mark.parametrize("backend", ["kernel", "torch"])
    def test_recycled_page_of_a_corrupted_lane_is_scrubbed(self, dense,
                                                           backend):
        """K and V of the corrupted lane's page are NaN. The healthy request
        grows onto that recycled page past its first page and reads its
        stale positions masked: without the scrub in ``_retire_corrupted``,
        0 * NaN in the PV product poisons it too (the reference keeps this
        fault)."""
        cfg, params = dense
        eng = engine.Engine(params, cfg, engine.EngineConfig(
            num_slots=2, max_cache=48, policy="fifo", attn_backend=backend),
            device="cpu")
        a, b = _reqs(cfg, 2, prompt_lens=(6, 10), steps=(8, 30), stagger=0)
        eng.submit(a)
        eng.submit(b)
        eng.step()
        page = int(eng.alloc.table()[a.slot, 0])

        def poison(kind, d):
            d["k"][:, page] = float("nan")
            d["v"][:, page] = float("nan")
            return d

        transformer.map_block_caches(cfg, poison, eng.pool["layers"])
        later_pages = set()
        while b.finish_reason is None:
            eng.step()
            if eng.slots[b.slot] is b:
                later_pages.update(eng.alloc.owned(b.slot)[1:])
        assert a.finish_reason == "corrupted" and len(eng.corrupted) == 1
        assert page in later_pages, "the recycled page never reached b"
        assert b.finish_reason == "length"
        assert b.out_tokens == _oneshot(params, cfg, b, 48).tokens


class TestPreemption:
    def test_stall_preempts_and_replays_exactly(self, dense):
        cfg, params = dense
        ecfg = engine.EngineConfig(num_slots=2, max_cache=32, page_size=16,
                                   num_pages=3, policy="fifo")
        reqs = _reqs(cfg, 2, prompt_lens=(10,), steps=(8,))
        for r in reqs:
            r.params = dataclasses.replace(r.params, logprobs=1)
        eng = engine.Engine(params, cfg, ecfg, device="cpu")
        stats = eng.run(reqs)
        assert stats["completed"] == 2 and stats["preemptions"] >= 1
        assert stats["replayed_tokens"] >= 1
        r0, r1 = sorted(eng.completed, key=lambda r: r.rid)
        assert r0.preemptions == 0 and r1.preemptions >= 1
        for req in eng.completed:
            toks, _, lp = decode.generate(
                params, cfg, ServeRequest(rid=0, tokens=req.tokens)
                .prompts("cpu"), max_cache=32, steps=req.max_new_tokens,
                return_logprobs=True)
            assert req.out_tokens == toks[0].tolist()
            np.testing.assert_allclose(req.out_logprobs, lp[0].numpy(),
                                       atol=1e-5)

    def test_preempt_admits_deeper_than_reserve(self, dense):
        cfg, params = dense
        hw = {}
        for mode in ("reserve", "preempt"):
            eng = engine.Engine(params, cfg, engine.EngineConfig(
                num_slots=2, max_cache=32, page_size=16, num_pages=3,
                policy="fifo", admission_mode=mode), device="cpu")
            stats = eng.run(_reqs(cfg, 2, prompt_lens=(10,), steps=(8,)))
            assert stats["completed"] == 2
            hw[mode] = stats["concurrency_hw"]
        assert hw["preempt"] > hw["reserve"]


class TestImmuneAdmission:
    def _adm(self):
        return engine.ImmuneAdmission(engine.EngineConfig(
            num_slots=4, max_cache=64, num_classes=3, latency_budget=10.0))

    def test_burst_throttles_then_recovers(self):
        adm, none = self._adm(), np.zeros(3)
        assert not adm.throttled()
        for _ in range(4):
            adm.end_tick(4, 10, none, none)
        assert adm.throttled()
        for _ in range(60):
            adm.end_tick(0, 0, none, none)
        assert not adm.throttled()

    def test_blown_budget_sheds_then_pressure_drop_revives(self):
        adm = self._adm()
        demand, cost = np.asarray([1.0, 0.0, 1.0]), np.asarray([2.0, 2.0, 50.0])
        for _ in range(6):
            adm.observe_completion(0, cost=2.0, latency=3.0)
            adm.end_tick(1, 20, demand, cost)
        assert not adm.admissible(2)
        assert adm.admissible(0) and adm.admissible(1)
        for _ in range(20):
            adm.end_tick(0, 0, np.zeros(3), cost)
        assert adm.admissible(2)

    def test_memory_tracks_per_class_cost(self):
        adm = self._adm()
        for _ in range(30):
            adm.observe_completion(0, cost=4.0, latency=5.0)
            adm.observe_completion(1, cost=40.0, latency=45.0)
        assert abs(adm.remembered_cost(0) - 4.0) < 0.5
        assert abs(adm.remembered_cost(1) - 40.0) < 5.0
        assert adm.remembered_cost(2) == 0.0

    def test_immune_tail_no_worse_than_fifo(self, dense):
        cfg, params = dense
        stats = {}
        for policy in ("fifo", "immune"):
            eng = engine.Engine(params, cfg, engine.EngineConfig(
                num_slots=4, max_cache=64, policy=policy, num_classes=3,
                latency_budget=24.0), device="cpu")
            stats[policy] = eng.run(traces.synthetic_trace(cfg,
                                                           num_requests=24))
        assert stats["fifo"]["completed"] == 24
        assert stats["immune"]["p99_latency"] <= stats["fifo"]["p99_latency"]
        assert stats["immune"]["goodput"] >= stats["fifo"]["goodput"]


# ---------------------------------------------------------------------------
# fleet hooks, against the JAX package's engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_pair():
    import jax
    from repro import configs as jconfigs
    from repro.models import model as jmodel
    jax.config.update("jax_platform_name", "cpu")
    jcfg = jconfigs.get_config("smollm-360m").smoke()
    cfg = configs.get_config("smollm-360m").smoke()
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


FLEET_ECFG = dict(num_slots=2, max_cache=96, page_size=16, prefill_chunk=16,
                  policy="immune", num_classes=2, latency_budget=12.0,
                  pin_pages=8, num_pages=2 * 6 + 1 + 8)


def _engines(jax_pair, **kw):
    from repro.serve import engine as jengine
    jcfg, cfg, jp, tp = jax_pair
    ekw = dict(FLEET_ECFG, **kw)
    return (jengine.Engine(jp, jcfg, jengine.EngineConfig(**ekw)),
            engine.Engine(tp, cfg, engine.EngineConfig(**ekw), device="cpu"))


def _tenant_trace(m, cfg, **kw):
    base = dict(tenants=2, prefix_len=48, suffix_lens=(4,), burst_size=2,
                bursts=2, gap=30, decode_lens=(6,))
    base.update(kw)
    return m.returning_tenant_trace(cfg, **base)


class TestFleetHooks:
    def test_admission_degrade_export_import_like_jax(self):
        from repro.serve import engine as jengine
        ecfg = dict(num_slots=4, max_cache=64, num_classes=3,
                    latency_budget=10.0)
        ours = engine.ImmuneAdmission(engine.EngineConfig(**ecfg))
        ref = jengine.ImmuneAdmission(jengine.EngineConfig(**ecfg))
        demand, cost = np.asarray([1.0, 0.0, 1.0]), np.asarray([2.0, 2.0, 50.0])
        for a in (ours, ref):
            for t in range(5):
                a.observe_completion(t % 3, cost=3.0 + t, latency=4.0 * t)
                a.end_tick(2, 6, demand, cost)
                a.degrade((1, 7), 0.6)
        assert ours.export_state() == ref.export_state()
        assert not ours.admissible(1) and ours.admissible(0)
        back = engine.ImmuneAdmission(engine.EngineConfig(**ecfg))
        back.import_state(ref.export_state())
        assert back.export_state() == ours.export_state()
        for a in (back, ref):
            a.end_tick(0, 0, np.zeros(3), cost)
        assert back.export_state() == ref.export_state()

    def test_telemetry_equals_jax_and_is_host_side(self, jax_pair):
        from repro.serve import traces as jtraces
        jcfg, cfg, _, _ = jax_pair
        jeng, teng = _engines(jax_pair)
        jeng.run(_tenant_trace(jtraces, jcfg, bursts=1), max_ticks=300)
        teng.run(_tenant_trace(traces, cfg, bursts=1), max_ticks=300)
        for name in ("class_costs", "anergy_levels"):
            ours, ref = getattr(teng, name)(), getattr(jeng, name)()
            assert isinstance(ours, np.ndarray) and ours.dtype == np.float64
            np.testing.assert_array_equal(ours, ref)
        assert teng.pinned_chain_keys() == jeng.pinned_chain_keys()
        for req, jreq in zip(_tenant_trace(traces, cfg, bursts=2)[4:],
                             _tenant_trace(jtraces, jcfg, bursts=2)[4:]):
            assert teng.prefix_affinity(req) == jeng.prefix_affinity(jreq) \
                == 48
            teng.submit(req)
            jeng.submit(jreq)
            assert teng.occupancy() == jeng.occupancy()

    def test_evacuate_like_jax_and_consistent_on_device(self, jax_pair):
        from repro.serve import traces as jtraces
        jcfg, cfg, _, _ = jax_pair
        jeng, teng = _engines(jax_pair)
        for eng, m, c in ((jeng, jtraces, jcfg), (teng, traces, cfg)):
            for r in _tenant_trace(m, c, gap=2):
                eng.submit(r)
            for _ in range(5):
                eng.step()
        lost = teng.evacuate()
        assert [(r.rid, r.out_tokens, r.slot) for r in lost] == \
            [(r.rid, r.out_tokens, r.slot) for r in jeng.evacuate()]
        assert lost and any(r.out_tokens for r in lost)
        assert teng.occupancy() == 0 and not teng.jobs
        assert teng.alloc.pages_in_use == teng.alloc.pages_pinned \
            == jeng.alloc.pages_pinned
        assert not teng.active.any() and not teng.pool["pos"].any()
        assert not teng.active_host.any() and not teng.emitted.any()
        teng.drop_device_state()
        assert teng.pool is None and teng.stats()["unserved"] == 0

    def test_warm_state_round_trip_and_across_packages(self, jax_pair):
        """Export a warm engine's forest and memories; a fresh port engine
        importing the port's or the JAX package's export holds the same K/V
        in its pinned pages and serves the returning tenants as the JAX
        engine that imported it does."""
        from repro.serve import traces as jtraces
        jcfg, cfg, _, _ = jax_pair
        jeng, teng = _engines(jax_pair)
        jeng.run(_tenant_trace(jtraces, jcfg, bursts=1), max_ticks=300)
        teng.run(_tenant_trace(traces, cfg, bursts=1), max_ticks=300)
        meta, kv = teng.export_warm_state()
        jmeta, jkv = jeng.export_warm_state()
        assert meta == jmeta and meta["kv_per_page"] == 2
        assert len(kv) == len(jkv) == 2 * len(meta["forest"]) == 12
        for a, b in zip(kv, jkv):
            assert a.shape == b.shape == (cfg.num_layers, 16,
                                          cfg.num_kv_heads, cfg.head_dim)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        outs = []
        for src_meta, src_kv in ((meta, kv), (jmeta, [torch.tensor(
                np.asarray(x)) for x in jkv])):
            je2, te2 = _engines(jax_pair)
            assert te2.import_warm_state(dict(src_meta), src_kv) == 6
            assert je2.import_warm_state(dict(jmeta), jkv) == 6
            assert te2.pinned_chain_keys() == teng.pinned_chain_keys()
            np.testing.assert_array_equal(te2.class_costs(),
                                          teng.class_costs())
            pages = [p for p in range(te2.alloc.num_pages)
                     if te2.alloc.is_pinned(p)]
            got = te2.pool["layers"][0][0]["k"][:, pages]
            want = torch.stack(src_kv[0::2], dim=1)
            assert torch.equal(got, want)
            back = _tenant_trace(traces, cfg, bursts=2)[4:]
            jback = _tenant_trace(jtraces, jcfg, bursts=2)[4:]
            for r in back:
                r.arrival = 0
            for r in jback:
                r.arrival = 0
            s = te2.run(back, max_ticks=300)
            je2.run(jback, max_ticks=300)
            assert s["pinned_pages_adopted"] == 6     # 3 pages a tenant
            assert {r.rid: r.out_tokens for r in te2.completed} == \
                {r.rid: r.out_tokens for r in je2.completed}
            outs.append({r.rid: r.out_tokens for r in te2.completed})
        assert outs[0] == outs[1]
