"""The port's fault injection (``repro_torch.serve.faults``) and the router's
failover against the JAX package's, on the CPU.

Plan grammar and injector semantics are model-free: the port's parse must
give the JAX package's events, refuse what it refuses, and the injector must
hold, heal, slow, seize and rejoin on the same ticks. The fleet tests run
the same trace under the same plan through both packages' routers over the
same smoke-size fp32 weights and require, per rid, equal tokens, finish
reasons and finish ticks, and equal router counters; and the port's own
oracle: every completed rid of a faulted run equals a single uninterrupted
engine run.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro.serve import faults as jfaults
from repro.serve import router as jrouter
from repro.serve import traces as jtraces
from repro_torch import configs
from repro_torch.models import model
from repro_torch.serve import api, engine, router, traces
from repro_torch.serve.faults import (FaultEvent, FaultInjector, FaultPlan,
                                      PowerLoss)
from repro_torch.serve.paging import PageAllocator

torch.set_num_threads(1)
jax.config.update("jax_platform_name", "cpu")

COUNTERS = ("ticks", "placements", "affinity_checks", "affinity_hits",
            "affinity_tokens", "drain_skips", "drain_overflow", "deaths",
            "rejoins", "replaced_requests", "retries", "recovery_ticks",
            "completed", "shed", "rejected", "failed", "unserved", "tokens",
            "p50_latency", "p99_latency", "goodput", "health", "faults",
            "prefill_tokens", "preemptions", "replayed_tokens",
            "pinned_pages_adopted")


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get_config("smollm-360m").smoke()
    cfg = configs.get_config("smollm-360m").smoke()
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _ekw(**kw):
    base = dict(num_slots=2, max_cache=64, page_size=16, prefill_chunk=16,
                policy="immune", num_classes=3, latency_budget=64.0,
                pin_pages=4)
    base.update(kw)
    return base


def _fleet(m, cfg, **kw):
    base = dict(tenants=3, num_requests=12, prefix_len=32, suffix_lens=(4,),
                decode_lens=(6,), hot_frac=0.5, burst_every=4, burst_size=3,
                seed=0)
    base.update(kw)
    return m.fleet_trace(cfg, **base)


def _books(r) -> dict:
    """rid -> (finish reason, finish tick, tokens) of every terminal request
    (completions from fallen replicas and failures included)."""
    return {q.rid: (q.finish_reason, q.finish_tick, list(q.out_tokens))
            for q in r._terminal_requests()}


def run_both(pair, spec=None, n=3, policy="immune", ekw=None, rkw=None,
             trace_kw=None):
    """The same trace and plan through both routers; returns (JAX router,
    its stats, port router, its stats) after checking they agree."""
    jcfg, cfg, jp, tp = pair
    ekw = _ekw(**(ekw or {}))
    rkw = dict(policy=policy, **(rkw or {}))
    trace_kw = trace_kw or {}

    def jeng():
        return jengine.Engine(jp, jcfg, jengine.EngineConfig(**ekw))

    def teng():
        return engine.Engine(tp, cfg, engine.EngineConfig(**ekw), device="cpu")

    jinj = jfaults.FaultInjector(jfaults.FaultPlan.parse(spec),
                                 engine_factory=jeng) if spec else None
    tinj = FaultInjector(FaultPlan.parse(spec), engine_factory=teng) \
        if spec else None
    jr = jrouter.Router([jeng() for _ in range(n)],
                        jrouter.RouterConfig(**rkw), injector=jinj)
    js = jr.run(_fleet(jtraces, jcfg, **trace_kw), max_ticks=600)
    tr = router.Router([teng() for _ in range(n)], router.RouterConfig(**rkw),
                       injector=tinj)
    ts = tr.run(_fleet(traces, cfg, **trace_kw), max_ticks=600)
    assert _books(tr) == _books(jr)
    for key in COUNTERS:
        assert ts[key] == js[key], (key, ts[key], js[key])
    return jr, js, tr, ts


def single_engine_oracle(pair, trace_kw=None, ekw=None) -> dict:
    """rid -> tokens of one uninterrupted port engine serving the trace."""
    _, cfg, _, tp = pair
    eng = engine.Engine(tp, cfg, engine.EngineConfig(
        **_ekw(**dict(ekw or {}, num_slots=4))), device="cpu")
    eng.run(_fleet(traces, cfg, **(trace_kw or {})), max_ticks=600)
    assert not eng.shed and not eng.rejected
    return {r.rid: list(r.out_tokens) for r in eng.completed}


# ---------------------------------------------------------------------------
# plan + injector semantics (model-free)
# ---------------------------------------------------------------------------
SPECS = ["crash@40:r1 rejoin@90:r1 slow@10+30:r0:x3 stall@15+4:r2",
         "pressure@20+10:r0:p4, crash@3:r0 rejoin@9:r0 crash@15:r0",
         "poweroff@30 restart@34", "slow@1+2:r5:x2 poweroff@7"]
BAD_SPECS = ["crash@1", "boom@1:r0", "crash@1:r0 crash@2:r0", "rejoin@1:r0",
             "slow@1:r0", "slow@1+2:r0:x1", "pressure@1+2:r0",
             "stall@1+2:r0:q3", "poweroff@1:r0", "restart@5",
             "poweroff@1 poweroff@2", "crash@x:r0"]


class TestFaultPlan:
    @pytest.mark.parametrize("spec", SPECS)
    def test_parse_equals_jax(self, spec):
        ours = [(e.tick, e.kind, e.replica, e.duration, e.factor, e.pages)
                for e in FaultPlan.parse(spec)]
        ref = [(e.tick, e.kind, e.replica, e.duration, e.factor, e.pages)
               for e in jfaults.FaultPlan.parse(spec)]
        assert ours == ref and len(ours) == len(spec.replace(",", " ").split())

    @pytest.mark.parametrize("spec", BAD_SPECS)
    def test_invalid_specs_raise_like_jax(self, spec):
        with pytest.raises(ValueError):
            jfaults.FaultPlan.parse(spec)
        with pytest.raises(ValueError):
            FaultPlan.parse(spec)

    def test_helpers_and_queries(self):
        plan = FaultPlan.crash_of_one(2, at=5, rejoin_at=12)
        assert [(e.tick, e.kind, e.replica) for e in plan] == \
            [(5, "crash", 2), (12, "rejoin", 2)]
        assert plan.max_replica() == 2 and plan.events_at(12)[0].kind \
            == "rejoin"
        off = FaultPlan.poweroff_at(7, restart_at=11)
        assert off.restart_after(7) == 11 and off.restart_after(11) is None
        assert FaultEvent(tick=3, kind="poweroff").replica == -1


class _StubEngine:
    def __init__(self):
        self.alloc = PageAllocator(9, 4, 2, 4, pin_pages=2,
                                   require_reservation=False)
        self.tick = 0


class _StubRouter:
    def __init__(self, n=3):
        self.tick = 0
        self.engines = [_StubEngine() for _ in range(n)]
        self.rejoined = []

    def rejoin(self, i, eng):
        self.rejoined.append(i)
        self.engines[i] = eng


def _held(inj, rt, ticks):
    held = {i: [] for i in range(len(rt.engines))}
    for t in range(ticks):
        rt.tick = t
        inj.begin_tick(rt)
        for i in range(len(rt.engines)):
            if not inj.can_step(i, t):
                held[i].append(t)
    return held


class TestFaultInjector:
    @pytest.mark.parametrize("spec,ticks,want", [
        ("crash@2:r1 rejoin@5:r1", 8, {0: [], 1: [2, 3, 4], 2: []}),
        ("stall@2+3:r0", 8, {0: [2, 3, 4], 1: [], 2: []}),
        ("slow@2+6:r0:x3", 10, {0: [3, 4, 6, 7], 1: [], 2: []}),
        ("slow@1+4:r2:x2 stall@3+2:r1", 8, {0: [], 1: [3, 4], 2: [2, 4]})])
    def test_holds_like_jax(self, spec, ticks, want):
        ours = _held(FaultInjector(FaultPlan.parse(spec),
                                   engine_factory=_StubEngine),
                     _StubRouter(), ticks)
        ref = _held(jfaults.FaultInjector(jfaults.FaultPlan.parse(spec),
                                          engine_factory=_StubEngine),
                    _StubRouter(), ticks)
        assert ours == ref == want

    def test_pressure_seizes_then_restores(self):
        inj = FaultInjector(FaultPlan.parse("pressure@1+3:r0:p4"))
        rt = _StubRouter()
        alloc = rt.engines[0].alloc
        nominal = alloc.usable_pages
        for t in range(6):
            rt.tick = t
            inj.begin_tick(rt)
            if 1 <= t < 4:
                assert alloc.pages_seized == 4
                assert alloc.usable_pages == nominal - 4
        assert alloc.pages_seized == 0 and alloc.usable_pages == nominal
        assert inj.stats()["pages_seized"] == 4

    def test_rejoin_requires_factory_and_fleet_bounds(self):
        with pytest.raises(ValueError, match="engine_factory"):
            FaultInjector(FaultPlan.parse("crash@1:r0 rejoin@5:r0"))
        with pytest.raises(ValueError, match="r7"):
            FaultInjector(FaultPlan.parse("crash@0:r7")).begin_tick(
                _StubRouter(n=3))

    def test_poweroff_raises_with_restart_tick(self):
        inj = FaultInjector(FaultPlan.parse("poweroff@2 restart@6"))
        rt = _StubRouter()
        rt.tick = 1
        inj.begin_tick(rt)
        rt.tick = 2
        with pytest.raises(PowerLoss) as err:
            inj.begin_tick(rt)
        assert (err.value.tick, err.value.restart_tick) == (2, 6)
        assert inj.stats()["poweroffs"] == 1


# ---------------------------------------------------------------------------
# failover on real replicas, against the JAX package
# ---------------------------------------------------------------------------
class TestFleetFailover:
    @pytest.mark.parametrize("policy", ["rr", "jsq", "immune"])
    def test_crash_and_rejoin_equal_jax_and_the_oracle(self, pair, policy):
        _, _, tr, ts = run_both(pair, "crash@5:r1 rejoin@15:r1",
                                policy=policy)
        assert ts["deaths"] == 1 and ts["rejoins"] == 1
        assert ts["replaced_requests"] > 0 and ts["unserved"] == 0
        assert ts["completed"] + ts["shed"] + ts["rejected"] \
            + ts["failed"] == 12
        oracle = single_engine_oracle(pair)
        for r in tr.completed:
            assert list(r.out_tokens) == oracle[r.rid], r.rid
        assert len(tr.fallen) == 1 and tr.fallen[0].pool is None

    def test_pressure_shock_conserves_pages(self, pair):
        _, _, tr, ts = run_both(pair, "pressure@3+6:r0:p3")
        assert ts["faults"]["pressure_shocks"] == 1
        for eng in tr.engines:
            a = eng.alloc
            live = {p for sl in range(a.num_slots) for p in a.owned(sl)}
            assert len(a._free) + len(live) + a.pages_pinned \
                == a.usable_pages and a.pages_seized == 0

    def test_slow_and_stall_survive_without_failover(self, pair):
        _, _, tr, ts = run_both(pair, "slow@2+8:r0:x3 stall@4+3:r2")
        assert ts["deaths"] == 0 and ts["health"] == ["healthy"] * 3

    def test_retry_budget_exhaustion_fails_like_jax(self, pair):
        _, _, tr, ts = run_both(pair, "crash@5:r0", policy="rr",
                                rkw=dict(max_retries=0))
        assert ts["failed"] > 0 and ts["goodput"] < 1.0
        assert all(r.finish_reason == "failed" for r in tr.failed)

    def test_backoff_then_second_crash_like_jax(self, pair):
        """A request evacuated twice spends its backoff before its second
        re-placement, in both packages."""
        _, _, tr, ts = run_both(pair, "crash@4:r0 crash@9:r1", policy="rr")
        assert ts["deaths"] == 2 and ts["retries"] >= ts["replaced_requests"]

    def test_graceful_degradation_like_jax(self, pair):
        _, _, tr, ts = run_both(
            pair, "crash@4:r1", rkw=dict(degrade_classes=(2,)),
            trace_kw=dict(num_requests=18, hot_frac=0.34, burst_every=3))
        shed = [r for e in tr.engines + tr.fallen for r in e.shed]
        assert shed and all(r.rclass == 2 for r in shed)

    @pytest.mark.parametrize("replicas,spec", [
        (1, None), (2, "crash@6:r0 rejoin@12:r0"), (2, "crash@9:r1")])
    def test_oracle_where_the_reference_frees_live_pages(self, pair,
                                                         replicas, spec):
        """Port only: on the trace where the reference's concurrent-duplicate
        prefix registration frees a live page (its single-replica fleet
        leaves the oracle at rid 5), the port's routed and failed-over runs
        equal one uninterrupted engine per rid, and its one-shot oracle."""
        _, cfg, _, tp = pair
        ecfg = engine.EngineConfig(num_slots=3, max_cache=64, prefill_chunk=8,
                                   policy="fifo")

        def teng():
            return engine.Engine(tp, cfg, ecfg, device="cpu")

        def trace():
            return traces.shared_prefix_trace(
                cfg, num_requests=10, prefix_len=44, suffix_lens=(4, 8),
                arrival_every=2)

        inj = FaultInjector(FaultPlan.parse(spec), engine_factory=teng) \
            if spec else None
        tr = router.Router([teng() for _ in range(replicas)],
                           router.RouterConfig(policy="rr"), injector=inj)
        ts = tr.run(trace(), max_ticks=600)
        assert ts["completed"] == 10 and ts["deaths"] == (1 if spec else 0)
        one = teng()
        one.run(trace(), max_ticks=600)
        oracle = {r.rid: list(r.out_tokens) for r in one.completed}
        assert {r.rid: list(r.out_tokens) for r in tr.completed} == oracle
        for r in tr.completed:
            probe = api.ServeRequest(rid=r.rid, tokens=r.tokens,
                                     params=r.params)
            assert api.generate(tp, cfg, probe, max_cache=64).tokens \
                == oracle[r.rid]
