"""Slot groups in the port (``serve.groups`` and the engine's group paths)
against the JAX package's on the CPU: the group maths function by function,
joint admission with the prompt charged once, ``n`` and ``best_of``
assembly against the one-shot facade and the JAX engine, whole-group
rejection, joint preemption with replay, and joint cancellation.

Tokens must be equal; smoke-size fp32 weights converted from the JAX tree.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.serve import api as japi
from repro.serve import engine as jengine
from repro.serve import groups as jgroups
from repro_torch import configs
from repro_torch.models import model, transformer
from repro_torch.serve import api, engine, groups
from repro_torch.serve.api import SamplingParams, ServeRequest

# smoke-size ops: one intra-op thread per test worker (the suite runs
# several workers; torch's default of one thread per core oversubscribes)
torch.set_num_threads(1)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get_config("smollm-360m").smoke()
    cfg = configs.get_config("smollm-360m").smoke()
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _ecfg(**kw):
    base = dict(num_slots=3, max_cache=64, page_size=16, prefill_chunk=8,
                policy="fifo")
    base.update(kw)
    return base


def _parent(m, vocab, rid=0, plen=32, steps=6, seed=0, arrival=0, **pkw):
    """A parent request in package ``m`` (the port's ``api`` or JAX's)."""
    rng = np.random.default_rng(1000 + rid)
    return m.ServeRequest(
        rid=rid, tokens=rng.integers(0, vocab, size=plen).astype(np.int32),
        params=m.SamplingParams(seed=seed + 10 * rid, max_new_tokens=steps,
                                **pkw),
        rclass=rid % 2, arrival=arrival)


def _finals(eng, reqs, max_ticks=400):
    return {out.rid: out for out in eng.stream(reqs, max_ticks=max_ticks)
            if out.finished}


def _lanes(out):
    return [o.tokens for o in out.group_outputs]


# ---------------------------------------------------------------------------
# group maths (model-free) against the JAX package's functions
# ---------------------------------------------------------------------------
class TestGroupMath:
    def test_rid_maths_match_jax(self):
        assert groups.GROUP_RID_BASE == jgroups.GROUP_RID_BASE
        assert groups.LANE_STRIDE == jgroups.LANE_STRIDE
        for parent, lane in ((0, 0), (37, 5), (10 ** 6, 255)):
            rid = groups.member_rid(parent, lane)
            assert rid == jgroups.member_rid(parent, lane)
            assert groups.is_member_rid(rid) and jgroups.is_member_rid(rid)
            assert groups.parent_rid_of(rid) == jgroups.parent_rid_of(rid) \
                == parent
            assert groups.lane_of(rid) == jgroups.lane_of(rid) == lane
        assert not groups.is_member_rid(37)
        with pytest.raises(ValueError):
            groups.member_rid(0, groups.LANE_STRIDE)

    @pytest.mark.parametrize("pkw", [dict(n=1, best_of=3, temperature=0.7),
                                     dict(n=2, temperature=1.0),
                                     dict(n=3, best_of=4, logprobs=2)])
    def test_expand_matches_jax(self, pkw):
        toks = np.arange(8, dtype=np.int32)
        ours = groups.expand(ServeRequest(
            rid=3, tokens=toks, params=SamplingParams(seed=50, **pkw)))
        ref = jgroups.expand(japi.ServeRequest(
            rid=3, tokens=toks, params=japi.SamplingParams(seed=50, **pkw)))
        assert len(ours) == len(ref) == max(pkw.get("n", 1),
                                            pkw.get("best_of", 0))
        for a, b in zip(ours, ref):
            assert (a.rid, a.group, a.lane, a.group_size) == \
                (b.rid, b.group, b.lane, b.group_size)
            assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)
            assert a.tokens is toks
        assert groups.expand(ours[1]) == [ours[1]]
        lone = ServeRequest(rid=9, tokens=toks)
        assert groups.expand(lone) == [lone]

    def test_rank_matches_jax(self):
        rng = np.random.default_rng(0)
        for _ in range(5):
            lps = [list(rng.standard_normal(3)) for _ in range(4)]
            lps[2] = list(lps[0])                 # a tie broken by lane
            ours, ref = [], []
            for lane, lp in enumerate(lps):
                for m, out in ((api, ours), (japi, ref)):
                    r = m.ServeRequest(rid=groups.member_rid(0, lane),
                                       tokens=np.arange(2, dtype=np.int32),
                                       group=0, lane=lane)
                    r.out_logprobs = lp
                    out.append(r)
            assert groups.rank(ours) == jgroups.rank(ref)
        bare = [ServeRequest(rid=i, tokens=np.arange(2), lane=ln)
                for i, ln in enumerate((2, 0, 1))]
        assert [bare[i].lane for i in groups.rank(bare)] == [0, 1, 2]

    def test_assemble_abnormal_reason_wins(self):
        parent = ServeRequest(rid=0, tokens=np.arange(4, dtype=np.int32),
                              params=SamplingParams(n=2, temperature=1.0))
        members = groups.expand(parent)
        outs = []
        for i, m in enumerate(members):
            m.out_tokens = [i, i + 1]
            m.finish_reason = "length" if i == 0 else "shed"
            m.finish_tick = 5 + i
            outs.append(api.RequestOutput(
                rid=m.rid, new_tokens=m.out_tokens, tokens=m.out_tokens,
                finished=True, finish_reason=m.finish_reason, tick=5 + i))
        done = groups.assemble(parent, members, outs)
        assert done.finish_reason == "shed" and done.finished
        assert done.rid == 0 and done.finish_tick == 6
        assert done.tokens == [0, 1] and len(done.group_outputs) == 2

    def test_group_book_assembles_on_the_last_lane(self):
        parent = ServeRequest(rid=4, tokens=np.arange(4, dtype=np.int32),
                              params=SamplingParams(n=2))
        book = groups.GroupBook()
        book.register(parent)
        members = groups.expand(parent)
        outs = []
        for m in members:
            m.finish_reason, m.finish_tick = "length", 3
            outs.append(api.RequestOutput(rid=m.rid, new_tokens=[], tokens=[],
                                          finished=True,
                                          finish_reason="length", tick=3))
        assert book.has(4) and book.pending() == [4]
        assert book.offer(members[1], outs[1]) is None
        done = book.offer(members[0], outs[0])
        assert done.rid == 4 and not book.has(4) and book.pending() == []
        lone = ServeRequest(rid=1, tokens=np.arange(2))
        assert book.offer(lone, outs[0]) is None

    def test_group_size_and_validation(self):
        assert SamplingParams().group_size == 1
        assert SamplingParams(n=2).group_size == 2
        assert SamplingParams(n=2, best_of=3).group_size == 3
        with pytest.raises(ValueError):
            SamplingParams(n=0)
        with pytest.raises(ValueError):
            SamplingParams(n=3, best_of=2)


# ---------------------------------------------------------------------------
# the engine: joint admission, shared prompt pages, assembly
# ---------------------------------------------------------------------------
def _serve_both(pair, parents_of, **ekw):
    """Serve ``parents_of(m)`` through the port's and the JAX engine; the
    finished outputs (members and parents) must agree token for token."""
    jcfg, cfg, jp, tp = pair
    eng = engine.Engine(tp, cfg, engine.EngineConfig(**_ecfg(**ekw)),
                        device="cpu")
    ours = _finals(eng, parents_of(api, cfg.vocab_size), max_ticks=600)
    jeng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**_ecfg(**ekw)))
    ref = _finals(jeng, parents_of(japi, jcfg.vocab_size), max_ticks=600)
    assert set(ours) == set(ref)
    for rid, out in ours.items():
        assert out.tokens == ref[rid].tokens, rid
        assert out.finish_reason == ref[rid].finish_reason
        if out.group_outputs is not None:
            assert _lanes(out) == _lanes(ref[rid])
    stats, jstats = eng.stats(), jeng.stats()
    for key in ("groups_submitted", "group_members_completed", "ticks",
                "shared_pages_adopted", "prefill_tokens", "preemptions",
                "replayed_tokens", "spec_ticks"):
        assert stats[key] == jstats[key], (key, stats[key], jstats[key])
    return eng, ours, stats


class TestEngineGroups:
    def test_n2_group_assembles_and_matches_oneshot(self, pair):
        """One parent, two sampled lanes: one assembled parent output whose
        lanes are the one-shot facade's, with the prompt prefilled once and
        adopted by the sibling (32 + 1 prefilled positions, not 64)."""
        _, cfg, _, tp = pair

        def parents(m, vocab):
            return [_parent(m, vocab, plen=32, steps=6, n=2, temperature=0.8,
                            top_p=0.9)]

        eng, finals, stats = _serve_both(pair, parents)
        oracle = api.generate(tp, cfg, parents(api, cfg.vocab_size)[0],
                              max_cache=64)
        assert set(finals) == {0, groups.member_rid(0, 0),
                               groups.member_rid(0, 1)}
        done = finals[0]
        assert done.finish_reason == "length" and len(done.group_outputs) == 2
        assert done.tokens == oracle.tokens
        assert _lanes(done) == _lanes(oracle)
        assert stats["groups_submitted"] == 1
        assert stats["group_members_completed"] == 2
        members = [r for r in eng.completed if r.group >= 0]
        assert sum(m.prefill_tokens for m in members) == 33
        assert stats["shared_pages_adopted"] >= 2

    def test_best_of_ranks_by_cum_logprob(self, pair):
        _, cfg, _, tp = pair

        def parents(m, vocab):
            return [_parent(m, vocab, plen=16, steps=5, n=1, best_of=3,
                            temperature=1.0, top_p=0.9)]

        eng, finals, _ = _serve_both(pair, parents)
        oracle = api.generate(tp, cfg, parents(api, cfg.vocab_size)[0],
                              max_cache=64)
        done = finals[0]
        assert len(done.group_outputs) == 1           # best_of keeps n lanes
        assert done.tokens == oracle.tokens
        members = sorted((r for r in eng.completed if r.group >= 0),
                         key=lambda r: r.lane)
        assert len(members) == 3
        cums = [sum(m.out_logprobs) for m in members]
        assert done.tokens == members[int(np.argmax(cums))].out_tokens
        assert done.logprobs == members[int(np.argmax(cums))].out_logprobs

    def test_groups_beside_standalone_requests(self, pair):
        """Two parents and a standalone request interleaved under the immune
        policy: every output agrees with the JAX engine's."""
        def parents(m, vocab):
            out = [_parent(m, vocab, rid=rid, plen=20, steps=5, n=2,
                           temperature=0.9, arrival=2 * rid)
                   for rid in range(2)]
            out.append(_parent(m, vocab, rid=7, plen=12, steps=7, arrival=1))
            return out

        _, finals, stats = _serve_both(pair, parents, policy="immune",
                                       num_classes=3, max_cache=80)
        assert stats["groups_submitted"] == 2 and 7 in finals
        assert finals[0].group_outputs and finals[1].group_outputs

    def test_oversized_group_rejected_whole(self, pair):
        """One probe decides the whole group: never half-scheduled."""
        _, cfg, _, tp = pair
        parent = _parent(api, cfg.vocab_size, plen=60, steps=20, n=2,
                         temperature=1.0)
        eng = engine.Engine(tp, cfg, engine.EngineConfig(**_ecfg()),
                            device="cpu")
        finals = _finals(eng, [parent], max_ticks=30)
        assert set(finals) == {parent.rid}
        assert finals[parent.rid].finish_reason == "rejected"
        assert eng.stats()["groups_submitted"] == 0 and not eng.queue


class TestGroupLifecycle:
    def test_member_preempted_mid_draft_cascades_and_replays(self, pair):
        """Page pressure evicts one lane of a spec-decoding group: its
        resident sibling goes too, and the re-admitted group assembles the
        one-shot facade's lanes and the JAX engine's outputs."""
        _, cfg, _, tp = pair

        def parents(m, vocab):
            hog = m.ServeRequest(rid=0, tokens=np.arange(16, dtype=np.int32),
                                 params=m.SamplingParams(max_new_tokens=40))
            return [hog, _parent(m, vocab, rid=1, plen=32, steps=8, n=2,
                                 arrival=2)]

        eng, finals, stats = _serve_both(
            pair, parents, num_slots=3, max_cache=96, page_size=8,
            num_pages=11, admission_mode="preempt", spec_decode=3,
            spec_draft_layers=1)
        assert stats["spec_ticks"] > 0 and stats["preemptions"] > 0
        lanes = {groups.member_rid(1, ln) for ln in (0, 1)}
        assert lanes <= eng.preempted_rids
        oracle = api.generate(tp, cfg, parents(api, cfg.vocab_size)[1],
                              max_cache=96)
        assert finals[1].finish_reason == "length"
        assert _lanes(finals[1]) == _lanes(oracle)
        assert finals[0].finish_reason == "length"

    def test_corrupted_member_cancels_its_group(self, pair):
        """A poisoned lane retires "corrupted" and takes its sibling with it;
        the parent assembles once, with the abnormal reason."""
        _, cfg, _, tp = pair
        parent = _parent(api, cfg.vocab_size, plen=16, steps=8, n=2,
                         temperature=0.7)
        eng = engine.Engine(tp, cfg, engine.EngineConfig(
            **_ecfg(prefill_chunk=0)), device="cpu")
        outs = []
        stream = eng.stream([parent])
        while not any(r is not None and r.lane == 1 and r.out_tokens
                      for r in eng.slots):
            outs.append(next(stream))
        victim = next(r for r in eng.slots if r is not None and r.lane == 1)
        page = int(eng.alloc.table()[victim.slot, -1 + len(
            eng.alloc.owned(victim.slot))])

        def poison(kind, d):
            d["v"][:, page] = float("nan")
            return d

        transformer.map_block_caches(cfg, poison, eng.pool["layers"])
        outs.extend(stream)
        finals = {o.rid: o for o in outs if o.finished}
        assert finals[parent.rid].finish_reason == "corrupted"
        assert [finals[groups.member_rid(0, ln)].finish_reason
                for ln in (0, 1)] == ["corrupted", "corrupted"]
        assert sum(1 for o in outs if o.rid == parent.rid) == 1
        assert eng.stats()["corrupted"] == 2 and not eng.queue
        assert all(r is None for r in eng.slots)
