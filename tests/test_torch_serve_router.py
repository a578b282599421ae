"""The port's placement router (``repro_torch.serve.router``) against the JAX
package's, on the CPU.

Placement decisions are compared call by call: the same engines' state in
both packages (rr cycling, join-shortest-queue, prefix affinity and its
anti-convoy forfeit, anergy draining and its overflow, least remembered
cost) must pick the same replica and count the same telemetry. Whole runs
of the fleet trace under every policy and replica count must give, per rid,
the JAX package's tokens, finish reasons and finish ticks, its router
counters, and the port's one-shot ``generate`` tokens: placement decides
where a request runs, never what it computes. The health machine walks the
same states on the same ticks, and a replaced replica frees its device
state while its books stay in ``stats()``.
"""
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.serve import api as japi
from repro.serve import engine as jengine
from repro.serve import faults as jfaults
from repro.serve import router as jrouter
from repro.serve import traces as jtraces
from repro_torch import configs
from repro_torch.models import model
from repro_torch.serve import api, engine, router, traces
from repro_torch.serve.faults import FaultInjector, FaultPlan

torch.set_num_threads(1)
jax.config.update("jax_platform_name", "cpu")

COUNTERS = ("ticks", "placements", "placement_imbalance", "affinity_checks",
            "affinity_hits", "affinity_tokens", "drain_skips",
            "drain_overflow", "completed", "shed", "rejected", "unserved",
            "tokens", "p50_latency", "p99_latency", "goodput",
            "prefill_tokens", "preemptions", "replayed_tokens",
            "pinned_pages_adopted", "groups")


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get_config("smollm-360m").smoke()
    cfg = configs.get_config("smollm-360m").smoke()
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _ekw(**kw):
    base = dict(num_slots=2, max_cache=64, page_size=16, prefill_chunk=8,
                policy="immune", num_classes=3, latency_budget=64.0,
                pin_pages=4)
    base.update(kw)
    return base


class Both:
    """``n`` replicas in each package over the same weights and config."""

    def __init__(self, pair, n, **kw):
        self.jcfg, self.cfg, jp, tp = pair
        ekw = _ekw(**kw)
        self.j = [jengine.Engine(jp, self.jcfg, jengine.EngineConfig(**ekw))
                  for _ in range(n)]
        self.t = [engine.Engine(tp, self.cfg, engine.EngineConfig(**ekw),
                                device="cpu") for _ in range(n)]

    def routers(self, **rkw):
        return (jrouter.Router(self.j, jrouter.RouterConfig(**rkw)),
                router.Router(self.t, router.RouterConfig(**rkw)))


def _req(m, rid, rclass=0, plen=8, steps=4, tokens=None):
    if tokens is None:
        tokens = np.arange(plen, dtype=np.int32) + rid
    return m.ServeRequest(rid=rid, tokens=np.asarray(tokens, np.int32),
                          params=m.SamplingParams(max_new_tokens=steps),
                          rclass=rclass)


def _place_both(jr, tr, rid, **kw):
    j = jr._place(_req(japi, rid, **kw))
    t = tr._place(_req(api, rid, **kw))
    assert t == j, (rid, t, j)
    return t


def _fleet(m, cfg, **kw):
    base = dict(tenants=3, num_requests=9, prefix_len=32, suffix_lens=(4,),
                decode_lens=(6,), hot_frac=0.5, burst_every=4, burst_size=3,
                seed=0)
    base.update(kw)
    return m.fleet_trace(cfg, **base)


def _books(r) -> dict:
    return {q.rid: (q.finish_reason, q.finish_tick, list(q.out_tokens))
            for q in r._terminal_requests()}


def run_both(pair, n, trace_kw=None, rkw=None, **ekw):
    both = Both(pair, n, **ekw)
    jr, tr = both.routers(**(rkw or {}))
    js = jr.run(_fleet(jtraces, both.jcfg, **(trace_kw or {})), max_ticks=500)
    ts = tr.run(_fleet(traces, both.cfg, **(trace_kw or {})), max_ticks=500)
    assert _books(tr) == _books(jr)
    for key in COUNTERS:
        assert ts[key] == js[key], (key, ts[key], js[key])
    assert [p["completed"] for p in ts["per_replica"]] == \
        [p["completed"] for p in js["per_replica"]]
    return tr, ts


class TestPlacementPolicies:
    def test_round_robin_cycles(self, pair):
        jr, tr = Both(pair, 3).routers(policy="rr")
        assert [_place_both(jr, tr, i) for i in range(5)] == [0, 1, 2, 0, 1]

    def test_jsq_picks_least_occupied(self, pair):
        both = Both(pair, 2)
        for m, engs in ((japi, both.j), (api, both.t)):
            engs[0].submit(_req(m, 0))
            engs[0].submit(_req(m, 1))
        jr, tr = both.routers(policy="jsq")
        assert _place_both(jr, tr, 2) == 1
        for m, engs in ((japi, both.j), (api, both.t)):
            engs[1].submit(_req(m, 3))
            engs[1].submit(_req(m, 4))
        assert _place_both(jr, tr, 5) == 0       # ties: lowest index

    @pytest.mark.parametrize("backlog", [0, 5])
    def test_affinity_and_its_forfeit(self, pair, backlog):
        """A replica holding a prompt's chains (pinned after its donor
        drained) wins placement; backlogged past 2 x slots it forfeits."""
        both = Both(pair, 2)
        prefix = np.arange(32, dtype=np.int32)
        for m, engs in ((japi, both.j), (api, both.t)):
            engs[1].run([_req(m, 0, tokens=np.concatenate(
                [prefix, np.full(4, 7, np.int32)]))], max_ticks=100)
            for i in range(backlog):
                engs[1].submit(_req(m, 10 + i, rclass=1))
        assert both.t[1].alloc.pages_pinned == both.j[1].alloc.pages_pinned > 0
        assert both.t[1].pinned_chain_keys() == both.j[1].pinned_chain_keys()
        jr, tr = both.routers(policy="immune")
        follower = np.concatenate([prefix, np.full(4, 9, np.int32)])
        assert _place_both(jr, tr, 1, tokens=follower) == \
            (1 if not backlog else 0)
        assert (tr.affinity_hits, tr.affinity_tokens) == \
            (jr.affinity_hits, jr.affinity_tokens)
        assert tr.affinity_tokens == (0 if backlog else 32)

    def test_drains_anergic_replica(self, pair):
        both = Both(pair, 2)
        lvl = np.zeros(3, np.float32)
        lvl[0] = 0.9

        def set_level(i, v):
            a = both.j[i].admission
            a.anergy = a.anergy._replace(level=jnp.asarray(v))
            b = both.t[i].admission
            b.anergy = b.anergy._replace(level=torch.as_tensor(v))

        set_level(0, lvl)
        jr, tr = both.routers(policy="immune")
        assert _place_both(jr, tr, 0, rclass=0) == 1
        assert _place_both(jr, tr, 1, rclass=1) == 0
        set_level(1, lvl * 0.8)
        assert _place_both(jr, tr, 2, rclass=0) == 1
        assert (tr.drain_skips, tr.drain_overflow) == \
            (jr.drain_skips, jr.drain_overflow) == (1, 1)

    def test_least_remembered_cost_placement(self, pair):
        both = Both(pair, 2)
        for m, engs in ((japi, both.j), (api, both.t)):
            for _ in range(10):
                engs[0].admission.observe_completion(0, cost=40.0,
                                                     latency=5.0)
            engs[0].submit(_req(m, 0, rclass=0))
            engs[1].submit(_req(m, 1, rclass=1))
        costs = both.t[0].class_costs()
        assert isinstance(costs, np.ndarray) and costs.dtype == np.float64
        np.testing.assert_array_equal(costs, both.j[0].class_costs())
        jr, tr = both.routers(policy="immune")
        assert _place_both(jr, tr, 2, rclass=2) == 1
        assert tr._load(both.t[0]) == jr._load(both.j[0])
        jr, tr = both.routers(policy="jsq")
        assert _place_both(jr, tr, 3, rclass=2) == 0


class TestPlacementInvariance:
    @pytest.mark.parametrize("policy", ["rr", "jsq", "immune"])
    @pytest.mark.parametrize("n", [1, 2, 3])
    def test_runs_equal_jax_and_the_oracle(self, pair, policy, n):
        _, cfg, _, tp = pair
        tr, ts = run_both(pair, n, rkw=dict(policy=policy))
        assert ts["completed"] == 9 and ts["shed"] == 0
        if policy == "immune":
            assert ts["affinity_hits"] > 0
        for r in tr.completed:
            probe = api.ServeRequest(rid=r.rid, tokens=r.tokens,
                                     params=r.params)
            assert api.generate(tp, cfg, probe, max_cache=64).tokens == \
                r.out_tokens, (policy, n, r.rid)

    @pytest.mark.parametrize("n", [1, 2])
    def test_invariant_across_preemption(self, pair, n):
        """Tiny page pools preempt at one replica: the replayed requests
        still equal the JAX fleet's and the one-shot oracle."""
        _, cfg, _, tp = pair
        kw = dict(tenants=2, num_requests=4, prefix_len=8, suffix_lens=(2,),
                  decode_lens=(8,), burst_every=2, burst_size=4)
        tr, ts = run_both(pair, n, trace_kw=kw, max_cache=32, num_pages=3,
                          prefill_chunk=0, pin_pages=0, num_classes=2)
        assert ts["completed"] == 4 and (n > 1 or ts["preemptions"] >= 1)
        for r in tr.completed:
            probe = api.ServeRequest(rid=r.rid, tokens=r.tokens,
                                     params=r.params)
            assert api.generate(tp, cfg, probe, max_cache=32).tokens == \
                r.out_tokens

    def test_slot_groups_co_place_and_assemble_like_jax(self, pair):
        """A parent with n = 2 expands at the router, its lanes land on one
        replica and assemble into one output, as in the JAX package."""
        both = Both(pair, 2)
        jr, tr = both.routers(policy="immune")
        outs = []
        for m, r, cfg in ((japi, jr, both.jcfg), (api, tr, both.cfg)):
            reqs = _fleet({"japi": jtraces, "api": traces}[
                m.__name__.split(".")[-1]], cfg, num_requests=4)
            reqs.append(m.ServeRequest(
                rid=50, tokens=np.arange(20, dtype=np.int32),
                params=m.SamplingParams(max_new_tokens=5, n=2,
                                        temperature=0.8, seed=3),
                arrival=1))
            s = r.run(reqs, max_ticks=300)
            assert s["groups"]["assembled"] == 1 and s["completed"] == 6
            outs.append([(o.rid, [(g.rid, g.tokens) for g in o.group_outputs])
                         for o in r.group_outputs])
        assert outs[0] == outs[1]
        assert tr.group_coplacements == jr.group_coplacements == 1


class TestRouterHarness:
    def test_rejects_bad_policy_and_empty_fleet(self, pair):
        both = Both(pair, 1)
        with pytest.raises(ValueError, match="policy"):
            router.Router(both.t, router.RouterConfig(policy="maxflow"))
        with pytest.raises(ValueError, match="at least one"):
            router.Router([], router.RouterConfig())

    def test_stats_on_fresh_and_idle_fleets(self, pair):
        s = router.Router(Both(pair, 2).t).stats()
        assert s["completed"] == 0 and s["goodput"] == 0.0
        assert s["p50_latency"] == float("inf")
        assert s["placement_imbalance"] == 0.0 and s["recovery_ticks"] == 0
        tr, s = run_both(pair, 3, trace_kw=dict(num_requests=2),
                         rkw=dict(policy="rr"))
        assert s["placements"][2] == 0 and s["completed"] == 2
        assert s["per_replica"][2]["completed"] == 0

    def test_fenced_replica_frees_its_device_state(self, pair):
        """A rejoin replaces the dead replica: its pool is released (no
        reference to it survives) while its completions stay counted."""
        _, cfg, _, tp = pair
        ecfg = engine.EngineConfig(**_ekw())

        def teng():
            return engine.Engine(tp, cfg, ecfg, device="cpu")

        tr = router.Router(
            [teng() for _ in range(3)], router.RouterConfig(policy="rr"),
            injector=FaultInjector(FaultPlan.parse("crash@5:r1 rejoin@14:r1"),
                                   engine_factory=teng))
        pool = weakref.ref(tr.engines[1].pool["layers"][0][0]["k"])
        s = tr.run(_fleet(traces, cfg, num_requests=9), max_ticks=500)
        assert s["rejoins"] == 1 and pool() is None
        old = tr.fallen[0]
        assert old.pool is None and old.active is None
        assert old.stats()["completed"] == len(old.completed)
        assert s["completed"] == sum(len(e.completed)
                                     for e in tr.engines + tr.fallen) == 9


class TestHealthMachine:
    def _pair_routers(self, pair, n, spec, **rkw):
        both = Both(pair, n)
        jr = jrouter.Router(both.j, jrouter.RouterConfig(**rkw),
                            injector=jfaults.FaultInjector(
                                jfaults.FaultPlan.parse(spec)))
        tr = router.Router(both.t, router.RouterConfig(**rkw),
                           injector=FaultInjector(FaultPlan.parse(spec)))
        return both, jr, tr

    @pytest.mark.parametrize("spec", ["stall@1+3:r0", "stall@1+4:r0",
                                      "crash@1:r0", "slow@0+12:r1:x4"])
    def test_health_walk_equals_jax(self, pair, spec):
        _, jr, tr = self._pair_routers(pair, 2, spec, policy="rr")
        for _ in range(9):
            jr.step()
            tr.step()
            assert tr.health == jr.health
        assert tr.death_ticks == jr.death_ticks
        if spec.startswith("crash"):
            assert tr.death_ticks == [6]

    def test_suspect_replica_takes_no_new_placements(self, pair):
        both, jr, tr = self._pair_routers(pair, 2, "stall@1+4:r0",
                                          policy="rr")
        for _ in range(3):
            jr.step()
            tr.step()
        assert tr.health[0] == router.SUSPECT and tr._eligible() == [1]
        for rid in range(4):
            jr.submit(_req(japi, rid))
            tr.submit(_req(api, rid))
        jr.step()
        tr.step()
        assert list(tr.placements) == list(jr.placements) == [0, 4]

    def test_queue_holds_when_no_replica_is_healthy(self, pair):
        _, cfg, _, tp = pair
        tr = router.Router(
            Both(pair, 1).t, router.RouterConfig(policy="rr"),
            injector=FaultInjector(FaultPlan.parse("crash@1:r0")))
        reqs = _fleet(traces, cfg, num_requests=4)
        s = tr.run(reqs, max_ticks=40)
        assert tr.health == [router.DEAD] and s["unserved"] > 0
        assert s["completed"] + s["shed"] + s["rejected"] + s["failed"] \
            + s["unserved"] == len(reqs)

    def test_replaced_request_keeps_arrival_and_submit_time(self, pair):
        _, cfg, _, tp = pair
        both = Both(pair, 3)
        reqs = _fleet(traces, cfg)
        arrivals = {r.rid: r.arrival for r in reqs}
        tr = router.Router(both.t, router.RouterConfig(policy="rr"),
                           injector=FaultInjector(FaultPlan.parse(
                               "crash@4:r0")))
        tr.run(reqs)
        assert tr.replaced_rids
        assert all(r.arrival == arrivals[r.rid] for r in reqs)
        e0, e1 = Both(pair, 2).t
        req = _req(api, 0)
        e0.submit(req)
        t0 = req.submit_time
        e1.submit(req)
        assert t0 >= 0 and req.submit_time == t0

    def test_retry_backoff_delays_second_replacement(self, pair):
        tr = router.Router(Both(pair, 2).t, router.RouterConfig(
            policy="rr", max_retries=3, retry_backoff=2))
        req = _req(api, 0, steps=4)
        req.retries = 1
        tr.engines[0].submit(req)
        tr.tick = 5
        tr._declare_dead(0)
        assert not tr.queue and tr._retry[0][0] == 5 + 1 + 2
        for _ in range(4):
            tr.step()
        assert not tr._retry


class TestLauncher:
    """``launch/serve.py`` drives the fleet on the CPU and prints the JAX
    CLI's summary lines; without ``--stream`` it serves the one-shot batch."""

    FLEET_LINES = ("  throughput ", "  placements ", "  fleet: ",
                   "  replica 0: ")

    def test_fleet_faults(self, capsys):
        from repro_torch.launch import serve as launch_serve
        s = launch_serve.main([
            "--arch", "smollm-360m", "--smoke", "--device", "cpu", "--stream",
            "--trace", "fleet-faults", "--replicas", "3", "--router",
            "immune", "--faults", "crash@8:r1 rejoin@24:r1", "--requests",
            "12", "--steps", "8"])
        out = capsys.readouterr().out
        assert s["deaths"] == 1 and s["rejoins"] == 1 and s["unserved"] == 0
        assert "fault plan: crash@8:r1 rejoin@24:r1" in out
        assert out.count("[immune x 3 on cpu] ") == 1
        for line in self.FLEET_LINES + ("  failover: 1 deaths / 1 rejoins",):
            assert line in out, line

    def test_fleet_poweroff_with_journal(self, tmp_path, capsys):
        from repro_torch.launch import serve as launch_serve
        wal = str(tmp_path / "serve.wal")
        s = launch_serve.main([
            "--arch", "smollm-360m", "--smoke", "--device", "cpu", "--stream",
            "--trace", "fleet-poweroff", "--replicas", "2", "--journal", wal,
            "--snapshot-dir", str(tmp_path / "snap"), "--snapshot-every", "4",
            "--pin-pages", "4", "--requests", "12", "--steps", "8"])
        out = capsys.readouterr().out
        assert s["restarts"] == 1 and s["unserved"] == 0
        assert s["durability"]["snapshots"] > 0 and os.path.getsize(wal) > 0
        assert "fault plan: poweroff@" in out
        for line in self.FLEET_LINES + ("  durability: 1 restarts | journal ",):
            assert line in out, line

    def test_one_shot_batch_draws_the_jax_prompts(self, capsys):
        from repro_torch import prng
        from repro_torch.launch import serve as launch_serve
        toks = launch_serve.main(["--arch", "smollm-360m", "--smoke",
                                  "--device", "cpu", "--batch", "2",
                                  "--steps", "5"])
        assert tuple(toks.shape) == (2, 5)
        assert "2 x 5 tokens in" in capsys.readouterr().out
        key = torch.as_tensor(prng.PRNGKey(1).astype("int64"))
        assert np.array_equal(
            prng.randint(key, (2, 16), 0, 256).numpy(),
            np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                          256)))
