"""The port's durability plane (``repro_torch.serve.durability``): the
write-ahead journal, warm snapshots and the crash-restart driver, against
the JAX package's ``repro.serve.durability`` on the CPU.

The journal and snapshot formats are shared. The same records make the same
journal bytes in both packages; a JAX journal is read by the port with the
same folded state and the same truncation of a torn tail at every byte
offset; snapshots are read across the two packages both ways, bf16 K/V
included. Whole power-loss runs (warm and cold) through both packages'
``run_durable`` give, per rid, equal tokens, finish reasons and finish
ticks and equal counters; a fleet that crashed in one package recovers from
its journal and snapshot in the other. The port's oracle: a power-cycled
run equals the uninterrupted fleet and a single uninterrupted engine, also
on the trace where the reference frees live pages.
"""
import os
import tempfile
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.serve import api as japi
from repro.serve import durability as jdur
from repro.serve import engine as jengine
from repro.serve import faults as jfaults
from repro.serve import router as jrouter
from repro.serve import traces as jtraces
from repro_torch import configs
from repro_torch.models import model
from repro_torch.serve import api, durability, engine, router, traces
from repro_torch.serve.faults import FaultInjector, FaultPlan, PowerLoss

torch.set_num_threads(1)
jax.config.update("jax_platform_name", "cpu")

COUNTERS = ("ticks", "completed", "shed", "rejected", "failed", "unserved",
            "tokens", "p50_latency", "p99_latency", "placements",
            "affinity_hits", "deaths", "rejoins", "replaced_requests",
            "retries", "restarts", "durability", "prefill_tokens",
            "replayed_tokens", "pinned_pages_adopted")


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get_config("smollm-360m").smoke()
    cfg = configs.get_config("smollm-360m").smoke()
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


# the JAX benchmark's durability replica (benchmarks/serve_engine.py
# run_durability) at 12 requests: prefix-dominated, bursty, one hot tenant
N = 12


def _ekw(**kw):
    base = dict(num_slots=2, max_cache=96, page_size=16, prefill_chunk=16,
                policy="immune", num_classes=2, latency_budget=50.0 * N,
                pin_pages=8, num_pages=2 * 6 + 1 + 8)
    base.update(kw)
    return base


def _trace(m, cfg, **kw):
    base = dict(tenants=2, num_requests=N, prefix_len=64, suffix_lens=(4,),
                decode_lens=(8,), hot_frac=0.9, burst_every=2, burst_size=4,
                seed=0)
    base.update(kw)
    return m.fleet_trace(cfg, **base)


def _books(r) -> dict:
    done = {q.rid: (q.finish_reason, q.finish_tick, list(q.out_tokens))
            for q in r._terminal_requests()}
    done.update({q.rid: (q.finish_reason, q.finish_tick, list(q.out_tokens))
                 for q in r.recovered})
    return done


def _jax_factory(pair, spec, n=2):
    jcfg, _, jp, _ = pair

    def make():
        return jrouter.Router(
            [jengine.Engine(jp, jcfg, jengine.EngineConfig(**_ekw()))
             for _ in range(n)], jrouter.RouterConfig(policy="immune"),
            injector=jfaults.FaultInjector(jfaults.FaultPlan.parse(spec))
            if spec else None)
    return make


def _port_factory(pair, spec, n=2, made=None):
    _, cfg, _, tp = pair

    def make():
        rt = router.Router(
            [engine.Engine(tp, cfg, engine.EngineConfig(**_ekw()),
                           device="cpu") for _ in range(n)],
            router.RouterConfig(policy="immune"),
            injector=FaultInjector(FaultPlan.parse(spec)) if spec else None)
        if made is not None:
            made.append(rt)
        return rt
    return make


@pytest.fixture(scope="module")
def reference(pair):
    """The uninterrupted fleet (port) and the sized power-loss plan."""
    _, cfg, _, _ = pair
    rt = _port_factory(pair, None)()
    s = rt.run(_trace(traces, cfg), max_ticks=600)
    horizon = max(r.arrival for r in _trace(traces, cfg))
    off = max(horizon + 2, (3 * s["ticks"]) // 5)
    return {r.rid: list(r.out_tokens) for r in rt.completed}, \
        f"poweroff@{off} restart@{off + 4}", off


def _req(m, rid, plen=5, deadline=None, **kw):
    base = dict(max_new_tokens=4, seed=rid)
    base.update(kw)
    return m.ServeRequest(rid=rid, tokens=np.arange(plen, dtype=np.int32),
                          params=m.SamplingParams(**base), rclass=rid % 2,
                          arrival=rid, deadline=deadline)


def _write_records(jmod, amod, path):
    """The same record sequence through a journal of either package; returns
    the file size after each synced record."""
    j = jmod.RequestJournal(path)
    ends = []
    for kind, args in (("log_submit", (_req(amod, 0, deadline=1.5),)),
                       ("log_emit", (0, 10)),
                       ("log_submit", (_req(amod, 1, plen=3,
                                            temperature=0.7),)),
                       ("log_emit", (0, 11)), ("log_emit", (1, 20)),
                       ("log_finish", (0, "stop", 4)), ("log_emit", (1, 21)),
                       ("log_finish", (1, "length", 6))):
        getattr(j, kind)(*args)
        j.sync()
        ends.append(os.path.getsize(path))
    j.close()
    return ends


# ---------------------------------------------------------------------------
# journal semantics and format
# ---------------------------------------------------------------------------
class TestJournal:
    def test_same_records_make_the_same_bytes(self, tmp_path):
        a, b = str(tmp_path / "port.wal"), str(tmp_path / "jax.wal")
        assert _write_records(durability, api, a) == \
            _write_records(jdur, japi, b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        s = durability.RequestJournal(a).state
        assert s[0]["out"] == [10, 11] and s[0]["fin"] == "stop"
        assert s[0]["deadline"] == 1.5 and s[1]["fin_tick"] == 6
        assert api.SamplingParams(**s[1]["params"]).temperature == 0.7

    def test_jax_journal_torn_at_every_byte(self, tmp_path):
        """Cut a JAX-written journal at every byte offset: the port folds the
        same state as the JAX package, truncates the same torn tail, and the
        state is exactly the records wholly before the cut."""
        src = str(tmp_path / "jax.wal")
        ends = _write_records(jdur, japi, src)
        with open(src, "rb") as f:
            data = f.read()
        for cut in range(len(data) + 1):
            for who in ("port", "jax"):
                with open(str(tmp_path / who), "wb") as f:
                    f.write(data[:cut])
            ours = durability.RequestJournal(str(tmp_path / "port"))
            ref = jdur.RequestJournal(str(tmp_path / "jax"))
            assert ours.state == ref.state, cut
            assert (ours.records, ours.truncated_bytes) == \
                (ref.records, ref.truncated_bytes) == \
                (sum(e <= cut for e in ends),
                 cut - max([0] + [e for e in ends if e <= cut])), cut
            assert os.path.getsize(str(tmp_path / "port")) == \
                cut - ours.truncated_bytes
            ours._f.close()
            ref._f.close()

    def test_group_commit_and_power_loss(self, tmp_path):
        j = durability.RequestJournal(str(tmp_path / "wal"), sync_every=3)
        j.log_submit(_req(api, 0))               # submits always fsync
        base = j.syncs
        j.log_emit(0, 1)
        assert j.commit(0) is True
        j.log_emit(0, 2)
        assert j.commit(1) is False and j.commit(2) is False
        assert j.commit(3) is True and j.syncs == base + 2
        assert j.commit(4) is False
        j.log_emit(0, 3)
        j.log_finish(0, "stop", 5)               # buffered, never fsync'd
        j.simulate_power_loss()
        with pytest.raises(ValueError):
            j.log_emit(0, 9)
        back = durability.RequestJournal(str(tmp_path / "wal"))
        assert back.state[0]["out"] == [1, 2] and back.state[0]["fin"] is None

    @pytest.mark.parametrize("seed", range(6))
    def test_churn_any_crash_point_recovers_consistent_prefix(self, seed):
        """A seeded random cut of a journal of random records recovers to
        the fold of exactly the records wholly before it."""
        rng = np.random.default_rng(seed)
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "wal")
            j = durability.RequestJournal(p)
            want_at, want = [], {}
            for _ in range(int(rng.integers(5, 20))):
                rid = int(rng.integers(0, 4))
                if rid not in want:
                    j.log_submit(_req(api, rid))
                    want[rid] = ([], None)
                elif want[rid][1] is None and rng.random() < 0.2:
                    j.log_finish(rid, "stop", 1)
                    want[rid] = (want[rid][0], "stop")
                else:
                    tok = int(rng.integers(0, 100))
                    j.log_emit(rid, tok)
                    want[rid] = (want[rid][0] + [tok], want[rid][1])
                j.sync()
                want_at.append((os.path.getsize(p),
                                {k: (list(v[0]), v[1])
                                 for k, v in want.items()}))
            j.close()
            cut = int(rng.integers(0, os.path.getsize(p) + 1))
            with open(p, "r+b") as f:
                f.truncate(cut)
            got = durability.RequestJournal(p).state
            exp = max(((e, w) for e, w in want_at if e <= cut),
                      default=(0, {}))[1]
            assert {k: (v["out"], v["fin"]) for k, v in got.items()} == exp


# ---------------------------------------------------------------------------
# snapshots across packages
# ---------------------------------------------------------------------------
class TestSnapshot:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_snapshots_read_across_packages(self, tmp_path, dtype):
        meta = {"tick": 9, "replicas": [{"forest": [], "kv_per_page": 2}]}
        vals = [np.random.default_rng(i).standard_normal((2, 4, 2, 3))
                .astype(np.float32) for i in range(2)]
        tdt = getattr(torch, dtype)
        jdt = getattr(jnp, dtype)
        durability.save_snapshot(str(tmp_path / "p"), 9, meta,
                                 [torch.as_tensor(v).to(tdt) for v in vals])
        jdur.save_snapshot(str(tmp_path / "j"), 9, meta,
                           [np.asarray(jnp.asarray(v).astype(jdt))
                            for v in vals])
        for src in ("p", "j"):
            tm, tkv, ts = durability.load_snapshot(str(tmp_path / src))
            jm, jkv, js = jdur.load_snapshot(str(tmp_path / src))
            assert tm == jm == meta and ts == js == 9
            for a, b in zip(tkv, jkv):
                assert a.dtype == tdt
                assert np.array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
        assert durability.load_snapshot(str(tmp_path / "none")) == \
            (None, [], 0)


# ---------------------------------------------------------------------------
# power-loss recovery
# ---------------------------------------------------------------------------
class TestPowerLossRecovery:
    @pytest.mark.parametrize("warm", [True, False])
    def test_run_durable_equals_jax_and_the_oracle(self, pair, reference,
                                                   tmp_path, warm):
        jcfg, cfg, _, _ = pair
        ref, spec, _ = reference
        runs = {}
        for who, run, fac, tr in (
                ("port", durability.run_durable, _port_factory(pair, spec),
                 _trace(traces, cfg)),
                ("jax", jdur.run_durable, _jax_factory(pair, spec),
                 _trace(jtraces, jcfg))):
            d = tmp_path / who
            runs[who] = run(fac, tr, str(d / "wal"),
                            snapshot_dir=str(d / "snap") if warm else None,
                            snapshot_every=2, max_ticks=600)
            with open(d / "wal", "rb") as f:
                runs[who] += (f.read(),)
        (rt, s, wal), (jrt, js, jwal) = runs["port"], runs["jax"]
        assert _books(rt) == _books(jrt) and wal == jwal
        for key in COUNTERS:
            assert s[key] == js[key], (key, s[key], js[key])
        assert s["restarts"] == 1 and s["unserved"] == 0
        rids = [r.rid for r in rt.completed]
        assert len(rids) == len(set(rids)) == N
        assert {r.rid: list(r.out_tokens) for r in rt.completed} == ref
        d = s["durability"]
        assert d["recovered_finished"] + d["recovered_open"] > 0
        assert (d["recovered_pinned_pages"] > 0) == warm

    @pytest.mark.parametrize("crashed_in", ["jax", "port"])
    def test_recovery_from_the_other_package(self, pair, reference, tmp_path,
                                             crashed_in):
        """A fleet loses power in one package; a fresh fleet of the other
        recovers from its journal and warm snapshot and finishes the trace
        with the uninterrupted run's tokens."""
        jcfg, cfg, _, _ = pair
        ref, spec, off = reference
        wal, snap = str(tmp_path / "wal"), str(tmp_path / "snap")
        if crashed_in == "jax":
            run, fac, tr = jdur.run_durable, _jax_factory(pair, spec), \
                _trace(jtraces, jcfg)
        else:
            run, fac, tr = durability.run_durable, \
                _port_factory(pair, spec), _trace(traces, cfg)
        with pytest.raises(Exception) as err:
            run(fac, tr, wal, snapshot_dir=snap, snapshot_every=2,
                max_ticks=600, max_restarts=0)
        assert type(err.value).__name__ == "PowerLoss"
        mod, make, trace = (durability, _port_factory(pair, None),
                            _trace(traces, cfg)) if crashed_in == "jax" \
            else (jdur, _jax_factory(pair, None), _trace(jtraces, jcfg))
        journal = mod.RequestJournal(wal)
        rt = make()
        rt.attach_durability(journal, snapshot_dir=snap, snapshot_every=2)
        rec = rt.recover(journal, snap)
        assert rec["recovered_pages"] > 0 and rec["recovered_open"] > 0
        rt.tick = max(rt.tick, off + 4)
        s = rt.run([r for r in trace if r.rid not in journal.state],
                   max_ticks=600)
        journal.close()
        assert s["unserved"] == 0 and s["completed"] == N
        assert {r.rid: list(r.out_tokens) for r in rt.completed} == ref

    def test_resubmission_after_finish_is_deduped(self, pair, tmp_path):
        _, cfg, _, _ = pair
        trace = _trace(traces, cfg, num_requests=6)
        rt, _ = durability.run_durable(
            _port_factory(pair, "poweroff@4 restart@6"), trace,
            str(tmp_path / "wal"), max_ticks=600)
        journal = durability.RequestJournal(str(tmp_path / "wal"))
        rt2 = _port_factory(pair, None)()
        rt2.recover(journal, None)
        done_before = len(rt2.completed)
        out = rt2.run(_trace(traces, cfg, num_requests=6), max_ticks=600)
        assert rt2.dedup_drops == done_before == 6 and out["completed"] == 6
        assert {r.rid: r.out_tokens for r in rt2.completed} == \
            {r.rid: r.out_tokens for r in rt.completed}

    def test_warm_restart_halves_the_cold_reprefill(self, pair, reference,
                                                    tmp_path):
        """The JAX benchmark's bar: the warm restart re-prefills at most
        0.5x the cold restart's tokens, with the same streams."""
        _, cfg, _, _ = pair
        ref, spec, _ = reference
        pf = {}
        for warm in (True, False):
            d = tmp_path / str(warm)
            rt, s = durability.run_durable(
                _port_factory(pair, spec), _trace(traces, cfg),
                str(d / "wal"), snapshot_dir=str(d / "snap") if warm
                else None, snapshot_every=2, max_ticks=600)
            assert {r.rid: list(r.out_tokens) for r in rt.completed} == ref
            pf[warm] = sum(e.prefill_tokens for e in rt.engines)
        assert pf[True] <= 0.5 * pf[False]

    def test_lost_fleet_is_freed_before_the_next_is_built(self, pair,
                                                          reference,
                                                          tmp_path):
        _, cfg, _, _ = pair
        _, spec, _ = reference
        made, dead = [], []
        inner = _port_factory(pair, spec, made=made)

        def make():
            dead.append([r() is None for r in refs])
            rt = inner()
            refs.append(weakref.ref(rt))
            refs.append(weakref.ref(rt.engines[0].pool["layers"][0][0]["k"]))
            made.clear()
            return rt

        refs = []
        durability.run_durable(make, _trace(traces, cfg),
                               str(tmp_path / "wal"), max_ticks=600)
        assert dead == [[], [True, True]]

    def test_oracle_where_the_reference_frees_live_pages(self, pair,
                                                         tmp_path):
        """Port only: power-cycled on the trace where the reference's
        concurrent-duplicate prefix registration frees a live page, the
        fleet equals one uninterrupted engine per rid."""
        _, cfg, _, tp = pair
        ecfg = engine.EngineConfig(num_slots=3, max_cache=64, prefill_chunk=8,
                                   policy="fifo")

        def trace():
            return traces.shared_prefix_trace(
                cfg, num_requests=10, prefix_len=44, suffix_lens=(4, 8),
                arrival_every=2)

        def make():
            return router.Router(
                [engine.Engine(tp, cfg, ecfg, device="cpu")],
                router.RouterConfig(policy="rr"),
                injector=FaultInjector(FaultPlan.parse("poweroff@9 "
                                                       "restart@12")))

        rt, s = durability.run_durable(make, trace(), str(tmp_path / "wal"),
                                       max_ticks=600)
        one = engine.Engine(tp, cfg, ecfg, device="cpu")
        one.run(trace(), max_ticks=600)
        assert s["restarts"] == 1 and s["completed"] == 10
        assert {r.rid: list(r.out_tokens) for r in rt.completed} == \
            {r.rid: list(r.out_tokens) for r in one.completed}

    def test_power_loss_is_the_ports_own_exception(self):
        assert PowerLoss.__module__ == "repro_torch.serve.faults"
