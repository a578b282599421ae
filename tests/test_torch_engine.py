"""The port's serving engine against the JAX package's engine on the CPU.

Both engines serve the same trace (the port's ``serve.traces`` draws exactly
the JAX package's prompts) over the same smoke-size fp32 weights. Required:
per request, the port's tokens equal the JAX engine's AND the port's own
one-shot ``api.generate`` tokens; the admission, sharing, preemption and
paging counters are equal. The traces cover mid-stream one-shot prefill,
seeded sampling, chunked prefill with prefix sharing and copy-on-write forks,
batched prefill streams with a pinned prefix cache, and page contention with
preemption and replay; on ``granite-moe-3b-a800m`` smoke weights with a
router bias, one-shot prefill at capacity factor 1.25 (which drops
assignments) and dropless chunked prefill.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.serve import api as japi
from repro.serve import engine as jengine
from repro.serve import traces as jtraces
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model, moe
from repro_torch.serve import api, engine, traces

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")

COUNTERS = ("completed", "shed", "rejected", "corrupted", "ticks",
            "mid_stream_admissions", "concurrency_hw", "pages_hw",
            "chunked_prefill_chunks", "prefill_batch_calls",
            "shared_pages_adopted", "cow_forks", "nowrite_adoptions",
            "prefill_positions_skipped", "prefill_tokens", "pins",
            "pinned_pages_adopted", "pin_evictions", "preemptions",
            "preempted_requests", "replayed_tokens", "p50_latency",
            "p99_latency", "goodput")


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get_config("smollm-360m").smoke()
    cfg = configs.get_config("smollm-360m").smoke()
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def serve_both(pair, make_trace, bias=None, **ekw):
    """Run ``make_trace(traces_module, cfg)`` through both engines (an MoE
    pair with the router ``bias``, a numpy array); check token and counter
    equality and the port's one-shot oracle. Returns the port engine and its
    stats."""
    jcfg, cfg, jp, tp = pair
    jbias, tbias = (None, None) if bias is None else \
        (jnp.asarray(bias), torch.as_tensor(bias))
    jeng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**ekw),
                          router_bias=jbias)
    jstats = jeng.run(make_trace(jtraces, jcfg), max_ticks=600)
    teng = engine.Engine(tp, cfg, engine.EngineConfig(**ekw), device="cpu",
                         router_bias=tbias)
    tstats = teng.run(make_trace(traces, cfg), max_ticks=600)
    ours = {r.rid: r.out_tokens for r in teng.completed}
    ref = {r.rid: r.out_tokens for r in jeng.completed}
    assert ours == ref, "port engine tokens differ from the JAX engine's"
    assert {r.rid: r.finish_reason for r in teng.completed} == \
        {r.rid: r.finish_reason for r in jeng.completed}
    for key in COUNTERS:
        assert tstats[key] == jstats[key], (key, tstats[key], jstats[key])
    for req in teng.completed:
        probe = api.ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params)
        assert api.generate(tp, cfg, probe, max_cache=ekw["max_cache"],
                            router_bias=tbias).tokens == req.out_tokens, \
            f"request {req.rid}: engine != port one-shot"
    assert tstats["pages_in_use"] == tstats["pages_pinned"]
    return teng, tstats


class TestSyntheticTrace:
    @pytest.mark.parametrize("policy", ["immune", "fifo"])
    def test_greedy(self, pair, policy):
        _, stats = serve_both(
            pair, lambda m, c: m.synthetic_trace(c, num_requests=12, seed=0),
            num_slots=3, max_cache=64, policy=policy, num_classes=3)
        assert stats["completed"] == 12 and stats["mid_stream_admissions"] > 0

    def test_seeded_sampling(self, pair):
        _, stats = serve_both(
            pair, lambda m, c: m.synthetic_trace(
                c, num_requests=12, seed=1, temperature=0.8, top_k=20,
                top_p=0.9, sample_seed=5),
            num_slots=3, max_cache=64, num_classes=3)
        assert stats["sampled_requests"] == 12

    def test_latency_budget_sheds_like_reference(self, pair):
        """A tight tick budget drives the anergy gate; who is shed and when
        follows the reference exactly (float32 immune states)."""
        serve_both(pair, lambda m, c: m.synthetic_trace(
            c, num_requests=16, seed=2, heavy_frac=0.4),
            num_slots=2, max_cache=80, latency_budget=6.0, num_classes=3)


class TestSharedPrefixTrace:
    def test_chunked_sharing_with_cow_fork(self, pair):
        _, stats = serve_both(
            pair, lambda m, c: m.shared_prefix_trace(
                c, num_requests=10, prefix_len=44, suffix_lens=(4, 12),
                arrival_every=3),
            num_slots=3, max_cache=64, prefill_chunk=8, policy="fifo")
        assert stats["cow_forks"] >= 1 and stats["shared_pages_adopted"] >= 4

    def test_concurrent_duplicate_prefix_stays_exact(self, pair):
        """Two requests with one prefix prefilled side by side (neither could
        adopt the other's pages): the later one must not index its pages
        under the earlier one's chain. The JAX allocator does, and frees a
        live page when the earlier chain is dropped (request 5 then decodes
        over a page another slot overwrites); the port matches its one-shot
        oracle here, which is what this trace checks."""
        _, cfg, _, tp = pair
        ecfg = engine.EngineConfig(num_slots=3, max_cache=64, prefill_chunk=8,
                                   policy="fifo")
        eng = engine.Engine(tp, cfg, ecfg, device="cpu")
        stats = eng.run(traces.shared_prefix_trace(
            cfg, num_requests=10, prefix_len=44, suffix_lens=(4, 8),
            arrival_every=2), max_ticks=600)
        assert stats["completed"] == 10 and stats["cow_forks"] >= 1
        for req in eng.completed:
            probe = api.ServeRequest(rid=req.rid, tokens=req.tokens,
                                     params=req.params)
            assert api.generate(tp, cfg, probe, max_cache=64).tokens == \
                req.out_tokens, f"request {req.rid}: engine != one-shot"
        assert eng.alloc.live_refs() == 0

    def test_prefill_streams_and_pinned_cache(self, pair):
        _, stats = serve_both(
            pair, lambda m, c: m.shared_prefix_trace(
                c, num_requests=10, prefix_len=32, arrival_every=3),
            num_slots=4, max_cache=64, prefill_chunk=8, prefill_streams=2,
            pin_pages=4)
        assert stats["prefill_batch_calls"] > 0 and stats["pins"] > 0

    def test_crafted_family_forks_and_nowrite(self, pair):
        """A donor, a strict-prefix follower (partial-page hit: CoW fork),
        an identical twin, and a page-boundary prompt (no-write adoption)."""
        def family(m, c):
            rng = np.random.default_rng(0)
            donor = rng.integers(0, c.vocab_size, size=48).astype(np.int32)
            lens = [(48, 12, 0), (40, 6, 8), (48, 5, 10), (33, 5, 14)]
            return [m.ServeRequest(rid=i, tokens=donor[:n].copy(),
                                   arrival=a,
                                   params=m.SamplingParams(max_new_tokens=k))
                    for i, (n, k, a) in enumerate(lens)]

        class Both:
            ServeRequest, SamplingParams = None, None

        def make(mod, c):
            ns = japi if mod is jtraces else api
            Both.ServeRequest, Both.SamplingParams = ns.ServeRequest, \
                ns.SamplingParams
            return family(Both, c)

        _, stats = serve_both(pair, make, num_slots=3, max_cache=64,
                              prefill_chunk=8, page_size=16, policy="fifo")
        assert stats["cow_forks"] >= 1


class TestContentionTrace:
    def test_preemption_and_replay(self, pair):
        _, stats = serve_both(
            pair, lambda m, c: m.contention_trace(c, num_requests=10),
            num_slots=3, max_cache=64, num_pages=7, num_classes=3)
        assert stats["preemptions"] >= 1 and stats["replayed_tokens"] >= 1

    def test_preemption_chunked_sampled(self, pair):
        _, stats = serve_both(
            pair, lambda m, c: m.contention_trace(
                c, num_requests=10, temperature=0.7, sample_seed=3),
            num_slots=3, max_cache=64, num_pages=7, prefill_chunk=16,
            num_classes=3)
        assert stats["preemptions"] >= 1

    def test_reserve_mode(self, pair):
        _, stats = serve_both(
            pair, lambda m, c: m.contention_trace(c, num_requests=8),
            num_slots=3, max_cache=64, num_pages=7, num_classes=3,
            admission_mode="reserve")
        assert stats["preemptions"] == 0


# ---------------------------------------------------------------------------
# the MoE family: granite-moe-3b-a800m smoke (8 experts, top-2, cf 1.25)
# ---------------------------------------------------------------------------
def _moe_pair(**kw):
    jcfg = dataclasses.replace(
        jconfigs.get_config("granite-moe-3b-a800m").smoke(), **kw)
    cfg = dataclasses.replace(
        configs.get_config("granite-moe-3b-a800m").smoke(), **kw)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _moe_bias(cfg, seeded: bool):
    if not seeded:
        return np.zeros((cfg.num_layers, cfg.num_experts), np.float32)
    rng = np.random.default_rng(3)
    return (0.5 * rng.standard_normal((cfg.num_layers, cfg.num_experts))
            ).astype(np.float32)


def _moe_trace(mod, cfg, n=4, seed=1, prompt_lens=(6, 10), steps=(4, 6)):
    """The staggered requests of tests/test_serve_engine.py's MoE parity
    case, in either package's request type."""
    ns = japi if mod is jtraces else api
    rng = np.random.default_rng(seed)
    return [ns.ServeRequest(
        rid=rid, tokens=rng.integers(0, cfg.vocab_size,
                                     size=prompt_lens[rid % 2]).astype(
                                         np.int32),
        params=ns.SamplingParams(max_new_tokens=steps[rid % 2]),
        rclass=rid % 2, arrival=rid) for rid in range(n)]


class TestMoE:
    @pytest.mark.parametrize("seeded", [False, True])
    def test_oneshot_prefill_drops_like_jax(self, seeded, monkeypatch):
        """cf 1.25: every prompt takes one-shot prefill at its own capacity,
        which drops assignments; decode runs dropless. Tokens and counters
        equal the JAX engine's, and every stream its one-shot oracle's."""
        pair = _moe_pair()
        drops = []
        ffn = moe.moe_ffn

        def recording(*a, **kw):
            y, stats = ffn(*a, **kw)
            drops.append((a[1].shape[1], float(stats.drop_frac)))
            return y, stats

        monkeypatch.setattr(moe, "moe_ffn", recording)
        eng, stats = serve_both(pair, _moe_trace,
                                bias=_moe_bias(pair[1], seeded),
                                num_slots=2, max_cache=48, policy="fifo")
        assert stats["completed"] == 4 and stats["mid_stream_admissions"] >= 1
        assert stats["chunked_prefill_chunks"] == 0
        assert any(d > 0 for s, d in drops if s > 1), "no prefill dropped"
        assert all(d == 0 for s, d in drops if s == 1), "decode dropped"

    def test_dropless_chunked_prefill_equals_jax(self):
        """cf 8 (dropless: cf * k >= E): chunked prefill and prefix sharing
        switch on, and both engines agree."""
        pair = _moe_pair(capacity_factor=8.0)
        eng, stats = serve_both(
            pair, lambda m, c: _moe_trace(m, c, n=6, prompt_lens=(12, 20)),
            bias=_moe_bias(pair[1], True), num_slots=3, max_cache=48,
            prefill_chunk=8, policy="fifo")
        assert stats["completed"] == 6 and stats["chunked_prefill_chunks"] > 0
        assert eng.stats()["prefills"] == 0

    def test_moe_engine_refuses_to_chunk_at_finite_capacity(self):
        _, cfg, _, tp = _moe_pair()
        eng = engine.Engine(tp, cfg, engine.EngineConfig(prefill_chunk=8),
                            device="cpu",
                            router_bias=_moe_bias(cfg, False))
        probe = api.ServeRequest(rid=0, tokens=np.zeros(16, np.int32))
        assert not eng._chunkable(probe) and not eng._sharable(probe)
        assert eng.cfg_decode.capacity_factor == cfg.num_experts
        assert eng.router_bias.dtype == torch.float32

    def test_params_from_numpy_round_trips_moe_leaves(self):
        """Every ``moe`` leaf lands in its block; in a bf16 model the router
        stays float32 (as the JAX package keeps it) and the experts bf16."""
        for dtype in ("float32", "bfloat16"):
            jcfg, cfg, jp, tp = _moe_pair(dtype=dtype)
            tree = jax.tree.map(np.asarray, jp)
            leaves = tree["stack"][0][0]["moe"]
            for li, blk in enumerate(tp.blocks):
                assert not hasattr(blk, "mlp")
                for name in ("w_router", "w_gate", "w_up", "w_down"):
                    got = getattr(blk.moe, name)
                    want = leaves[name][li]
                    assert got.dtype == (torch.float32 if name == "w_router"
                                         else getattr(torch, dtype)), name
                    np.testing.assert_array_equal(
                        got.float().numpy(),
                        np.asarray(want, np.float32))
            assert model.active_param_count(tp, cfg) == \
                jmodel.active_param_count(jp, jcfg)
            assert model.param_count(tp) == jmodel.param_count(jp)


def test_cli_serves_granite_moe_on_cpu(capsys):
    stats = launch_serve.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                               "--stream", "--device", "cpu", "--requests",
                               "6", "--slots", "3", "--steps", "8"])
    assert stats["completed"] + stats["shed"] + stats["rejected"] == 6
    assert stats["completed"] >= 1 and stats["prefills"] >= 1
    assert "completed" in capsys.readouterr().out
