"""The port's tracer (``repro_torch.telemetry``) on the CPU: the switch (off
records nothing and changes no token; ``recording()`` and the profiler's
active step turn it on, each time in a new session), the spans of
``Engine.step`` and ``train_step`` and how they nest, the session's bound,
and the benchmark's eight readers of the spans (``portbench/metrics``) on
hand-placed spans and device activity. No JAX: the engine is held to its
own run with recording off."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.core import spec as bench_spec  # noqa: E402
from portbench.core.trace import Trace  # noqa: E402
from repro_torch import configs, telemetry  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import model, moe  # noqa: E402
from repro_torch.serve import engine, traces  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

torch.set_num_threads(1)

STEP_CHILDREN = ("admit", "prefill", "decode", "retire")


@pytest.fixture(scope="module")
def dense():
    cfg = configs.get_config("smollm-360m").smoke()
    return cfg, model.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")


def _serve(dense, chunk=0, n=6):
    cfg, params = dense
    eng = engine.Engine(params, cfg, engine.EngineConfig(
        num_slots=3, max_cache=64, page_size=8, prefill_chunk=chunk),
        device="cpu")
    stats = eng.run(traces.synthetic_trace(cfg, num_requests=n, seed=1))
    return eng, stats


def _tokens(eng):
    return {r.rid: list(r.out_tokens) for r in eng.completed}


# -- the switch ---------------------------------------------------------------
def test_off_records_nothing_and_changes_no_token(dense):
    before = telemetry.last()
    kept = len(before.spans) if before is not None else 0
    off, _ = _serve(dense)
    assert telemetry.last() is before
    assert (len(before.spans) if before is not None else 0) == kept
    with telemetry.recording() as s:
        on, _ = _serve(dense)
    assert s.named("step") and telemetry.last() is s
    assert _tokens(on) == _tokens(off)


def test_each_recording_is_a_new_session_and_nests():
    with telemetry.recording() as a:
        with telemetry.recording() as inner:
            assert inner is a
        assert telemetry.session() is a
    assert telemetry.session() is None
    with telemetry.recording() as b:
        assert b is not a and telemetry.last() is b
    assert telemetry.last() is b


def test_profiler_turns_recording_on_from_its_active_step(dense):
    """The harness's schedule: one warm-up step, then the active one."""
    cfg, params = dense
    eng = engine.Engine(params, cfg, engine.EngineConfig(
        num_slots=2, max_cache=64, page_size=8), device="cpu")
    for req in traces.synthetic_trace(cfg, num_requests=2, seed=3):
        eng.submit(req)
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        eng.step()                                  # warm-up: not recording
        assert telemetry.session() is None
        prof.step()
        eng.step()
        eng.step()
        s = telemetry.last()
        prof.step()
    eng.step()                                      # after: off again
    assert telemetry.session() is None and telemetry.last() is s
    assert [x.attrs["tick"] for x in s.named("step")] == [1, 2]


def test_session_keeps_its_bound_and_counts_what_it_dropped():
    s = telemetry.Session(capacity=3)
    s.begin("step", root=True, t=0.0)
    s.add("queue", 0.0, 1.0, rid=7, root=True)
    s.begin("admit", t=0.5)
    s.add("prefill", 0.5, 0.6)              # the fourth: dropped
    s.end(t=0.7)
    s.end(t=1.0)
    assert [x.name for x in s.spans] == ["step", "queue", "admit"]
    assert s.dropped == 1 and s.spans[2].t1 == 0.7 and s.spans[0].t1 == 1.0
    s.begin("step", root=True, t=2.0)       # also dropped; closes cleanly
    s.end(t=3.0)
    assert s.dropped == 2


def test_a_root_span_closes_what_an_exception_left_open():
    s = telemetry.Session()
    s.begin("step", root=True, t=0.0)
    s.begin("admit", t=0.1)                 # never closed
    s.begin("step", root=True, t=1.0)
    s.end(t=2.0)
    assert s.spans[2].parent == -1 and s.named("step") == [s.spans[2]]


# -- serving spans ------------------------------------------------------------
@pytest.mark.parametrize("chunk", [0, 8], ids=["one_shot", "chunked"])
def test_every_step_has_one_step_span_and_its_children_nest_in_order(
        dense, chunk):
    with telemetry.recording() as s:
        eng, stats = _serve(dense, chunk)
    steps = s.named("step")
    assert [x.attrs["tick"] for x in steps] == list(range(stats["ticks"]))
    assert all(set(x.attrs) == {"tick", "residents", "queue_len",
                                "pages_in_use"} for x in steps)
    for step in steps:
        kids = s.children(step)
        names = [k.name for k in kids]
        assert names[0] == "admit" and names[-1] == "retire"
        assert [STEP_CHILDREN.index(n) for n in names] == \
            sorted(STEP_CHILDREN.index(n) for n in names)
        prev = step.t0
        for k in kids:
            assert prev <= k.t0 <= k.t1 <= step.t1
            prev = k.t1
            for d in s.descendants(k):
                assert k.t0 <= d.t0 <= d.t1 <= k.t1
    for tick in s.named("decode"):
        parts = s.children(tick)
        assert [p.name for p in parts] == ["decode.launch", "decode.wait",
                                           "decode.emit"]
        assert parts[0].t0 == tick.t0 and parts[-1].t1 == tick.t1
        assert parts[0].t1 == parts[1].t0 and parts[1].t1 == parts[2].t0
    for pf in s.named("prefill"):
        parts = [p.name for p in s.children(pf)]
        assert parts[0] == "prefill.launch"
        assert set(parts) <= {"prefill.launch", "prefill.wait"}


@pytest.mark.parametrize("chunk", [0, 8], ids=["one_shot", "chunked"])
def test_each_admitted_request_has_one_queue_span_and_a_prefill(dense,
                                                                chunk):
    with telemetry.recording() as s:
        eng, _ = _serve(dense, chunk)
    admitted = sorted(r.rid for r in eng.completed)
    queued = [x.rid for x in s.named("queue")]
    assert sorted(queued) == admitted
    by_rid = {r.rid: r for r in eng.completed}
    for q in s.named("queue"):
        assert q.parent == -1 and q.t0 == by_rid[q.rid].submit_time
    prefilled = {x.rid for x in s.named("prefill")}
    assert prefilled == set(admitted)
    waits = s.named("prefill.wait")
    assert len(waits) == len(admitted)     # one seed token read per request
    tokens = sum(x.attrs["tokens"] for x in s.named("prefill"))
    assert tokens == sum(r.prefill_tokens for r in eng.completed)


def test_decode_seconds_are_the_decode_spans(dense):
    """One pair of clock readings a tick: the counter is the spans' sum."""
    with telemetry.recording() as s:
        eng, stats = _serve(dense)
    ticks = s.named("decode")
    assert len(ticks) == stats["decode_ticks"]
    total = 0.0
    for x in ticks:
        total += x.t1 - x.t0
    assert total == eng.decode_seconds


# -- training spans -----------------------------------------------------------
@pytest.mark.parametrize("arch,accum", [("smollm-360m", 1),
                                        ("smollm-360m", 2),
                                        ("granite-moe-3b-a800m", 1)])
def test_train_step_records_its_phases_with_host_times_only_on_cpu(arch,
                                                                   accum):
    cfg = configs.get_config(arch).smoke()
    tcfg = TrainConfig(accum_steps=accum)
    state = ts.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                                device="cpu")
    batch, _ = pipeline.sample_batch(cfg, 2, 16,
                                     pipeline.init_data_state("cpu"), seed=3)
    before = telemetry.last()
    state, _ = ts.train_step(state, batch, cfg, tcfg)     # off
    assert telemetry.last() is before
    with telemetry.recording() as s:
        ts.train_step(state, batch, cfg, tcfg)
    (step,) = s.named("train_step")
    phases = s.children(step)
    want = ["forward", "backward"] * accum + ["optimizer"]
    if cfg.num_experts:
        want.append("router")
    assert [p.name for p in phases] == want
    for a, b in zip(phases, phases[1:]):
        assert a.t1 == b.t0                  # one clock reading an edge
    assert step.t0 <= phases[0].t0 and phases[-1].t1 <= step.t1
    assert all(p.t1 > p.t0 and s.device_ms(p) is None for p in phases)


MOE_STAGES = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]


def _moe_step(accum, remat="full"):
    cfg = dataclasses.replace(
        configs.get_config("granite-moe-3b-a800m").smoke(), remat=remat)
    tcfg = TrainConfig(accum_steps=accum)
    state = ts.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                                device="cpu")
    batch, _ = pipeline.sample_batch(cfg, 2, 16,
                                     pipeline.init_data_state("cpu"), seed=3)
    return cfg, tcfg, state, batch


@pytest.mark.parametrize("accum,remat", [(1, "full"), (2, "full"),
                                         (1, "none")])
def test_moe_spans_nest_under_forward_once_per_layer(accum, remat):
    """One ``moe`` span a layer under each microbatch's ``forward`` (none
    from remat's recompute under ``backward``), its four stages as phases
    edge to edge; the step's span holds the step's counters."""
    cfg, tcfg, state, batch = _moe_step(accum, remat)
    with telemetry.recording() as s:
        _, met = ts.train_step(state, batch, cfg, tcfg)
    (step,) = s.named("train_step")
    forwards = [c for c in s.children(step) if c.name == "forward"]
    assert len(forwards) == accum
    assert len(s.named("moe")) == cfg.num_layers * accum
    for f in forwards:
        layers_ = s.children(f)
        assert [x.name for x in layers_] == ["moe"] * cfg.num_layers
        assert [x.attrs["layer"] for x in layers_] == \
            list(range(cfg.num_layers))
        for m in layers_:
            parts = s.children(m)
            assert [x.name for x in parts] == MOE_STAGES
            assert f.t0 <= m.t0 <= parts[0].t0 and parts[-1].t1 == m.t1
            for a, b in zip(parts, parts[1:]):
                assert a.t1 == b.t0
    for name in ("fill", "drop", "load_cv"):
        field = {"drop": "drop_frac"}.get(name, name)
        assert torch.equal(step.attrs[name], getattr(met, field))
    live = sum(int(x.attrs["live"]) for x in s.named("moe.experts"))
    rows = cfg.num_experts * moe.capacity(cfg, 2 * 16 // accum)
    assert live / (cfg.num_layers * accum * rows) == \
        pytest.approx(float(met.fill), rel=1e-6)
    assert 0 < float(met.fill) <= 1 / cfg.capacity_factor


def test_moe_layer_records_no_span_and_no_event_with_recording_off(
        monkeypatch):
    """Off: no session, no span, no event asked for. On: one event at each
    edge, shared by the phases on either side (the step's five, six a
    layer)."""
    cfg, tcfg, state, batch = _moe_step(1)
    edges = []
    monkeypatch.setattr(telemetry, "_event", lambda device: edges.append(1))
    before = telemetry.last()
    state, _ = ts.train_step(state, batch, cfg, tcfg)
    assert telemetry.last() is before and edges == []
    with telemetry.recording() as s:
        ts.train_step(state, batch, cfg, tcfg)
    assert len(edges) == 5 + 6 * cfg.num_layers
    assert len(s.named("moe")) == cfg.num_layers


# -- the benchmark's readers --------------------------------------------------
READERS = {                     # metric -> its value on the spans below
    "admit_wait_p50_ms.serve": 2.0,
    "prefill_ms_p50.serve": 30.0,
    "decode_tick_ms_p50.serve": 25.0,
    "step_host_ms_p50.serve": 40.0,
    "idle_in_launch_share.serve": 100.0 * 56 / 350,
    "forward_ms_p50.train": 250.0,
    "backward_ms_p50.train": 600.0,
    "optimizer_ms_p50.train": 200.0,
}
PC0, NS0 = 1000.0, 7_000_000_000       # the window's start on both clocks


class _Event:
    """A stand-in for a CUDA event, stamped in device milliseconds."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _at(ms):
    return PC0 + ms / 1e3


def _window(busy_ms=((0, 120), (145, 155), (300, 305), (420, 435),
                     (500, 1000))):
    """A traced window of one second with device activity at ``busy_ms``
    (ms from its start; idle 350 ms in all)."""
    tr = Trace(torch, False)
    tr.pc0, tr.ns0 = PC0, NS0
    tr.pc1, tr.ns1 = PC0 + 1.0, NS0 + 1_000_000_000
    tr.merged = [[NS0 + a * 1_000_000, NS0 + b * 1_000_000]
                 for a, b in busy_ms]
    tr.window_s = 1.0
    tr.busy_s = sum(b - a for a, b in busy_ms) / 1e3
    return tr


def _run(tr):
    cell = bench_spec.Cell("minicpm-2b.docqa", ROOT)
    from portbench.core.report import Run
    return Run(cell, "cuda", tr)


def _place_serving(s):
    """Three steps (ms from the window's start) and four queue waits, one
    ended before the window."""
    for rid, a, b in ((0, -500, -100), (1, 10, 12), (2, 20, 26),
                      (3, 30, 31)):
        s.add("queue", _at(a), _at(b), rid=rid, root=True)
    steps = [  # (t0, t1, [(t0, t1, rid, launch end, wait end)],
        #        (decode t0, launch end, wait end, t1))
        (100, 200, [(101, 149, 1, 140)], (150, 160, 185, 190)),
        (300, 330, [], (301, 311, 321, 325)),
        (400, 460, [(400, 430, 2, 420)], (430, 440, 450, 455)),
    ]
    for i, (t0, t1, prefills, (d0, dl, dw, d1)) in enumerate(steps):
        s.begin("step", root=True, t=_at(t0), tick=t0, residents=i,
                queue_len=3 - i, pages_in_use=10 * i)
        s.begin("admit", t=_at(t0))
        for p0, p1, rid, pl in prefills:
            s.begin("prefill", rid=rid, t=_at(p0), tokens=8 * rid)
            s.add("prefill.launch", _at(p0), _at(pl))
            s.add("prefill.wait", _at(pl), _at(p1))
            s.end(t=_at(p1))
        s.end(t=_at(d0))
        s.begin("decode", t=_at(d0))
        s.add("decode.launch", _at(d0), _at(dl))
        s.add("decode.wait", _at(dl), _at(dw))
        s.add("decode.emit", _at(dw), _at(d1))
        s.end(t=_at(d1))
        s.begin("retire", t=_at(d1))
        s.end(t=_at(t1))
        s.end(t=_at(t1))


def _place_training(s):
    """Three steps, the last of two microbatches; device ms by event."""
    steps = [[("forward", 0, 300), ("backward", 300, 900),
              ("optimizer", 900, 1100)],
             [("forward", 1200, 1450), ("backward", 1450, 2100),
              ("optimizer", 2100, 2350)],
             [("forward", 2400, 2500), ("backward", 2500, 2800),
              ("forward", 2800, 2900), ("backward", 2900, 3200),
              ("optimizer", 3200, 3400)]]
    for i, phases in enumerate(steps):
        s.begin("train_step", root=True, t=_at(100 + 200 * i))
        for j, (name, a, b) in enumerate(phases):
            s.begin(name, t=_at(101 + 200 * i + 10 * j), ev=_Event(a))
            s.end(t=_at(110 + 200 * i + 10 * j), ev=_Event(b))
        s.end(t=_at(190 + 200 * i))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_hand_placed_spans(metric):
    with telemetry.recording() as s:
        _place_serving(s)
        _place_training(s)
    run = _run(_window())
    read = run.cell.reader(metric)
    # the harness maps a perf_counter reading to whole nanoseconds, so a
    # mapped edge may fall 1 ns short (a few parts in 1e8 of 350 ms idle)
    assert read(run) == pytest.approx(READERS[metric], rel=1e-6)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_nothing_without_spans(metric):
    with telemetry.recording():
        pass
    run = _run(_window())
    assert run.cell.reader(metric)(run) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_nothing_from_a_program_without_the_tracer(
        metric, monkeypatch):
    """The parent of the tracer's change runs the same readers."""
    import repro_torch
    with telemetry.recording() as s:
        _place_serving(s)
        _place_training(s)
    monkeypatch.delattr(repro_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    run = _run(_window())
    assert run.cell.reader(metric)(run) is None


def test_train_readers_need_device_times():
    """Spans recorded on the CPU carry no events: nothing is read."""
    with telemetry.recording() as s:
        s.begin("train_step", root=True, t=_at(10))
        for i, name in enumerate(("forward", "backward", "optimizer")):
            s.begin(name, t=_at(11 + i))
            s.end(t=_at(12 + i))
        s.end(t=_at(20))
    run = _run(_window())
    for metric in READERS:
        if metric.endswith(".train"):
            assert run.cell.reader(metric)(run) is None


# the expert layer's readers: three steps of two MoE layers; each moe span's
# stages in device ms, its experts' live rows, the router phase, counters
MOE_STEPS = [dict(moe=[(0, 10), (10, 22)], router=(30, 32), live=50_000,
                  fill=0.5, drop=0.1, load_cv=0.3),
             dict(moe=[(100, 114), (114, 130)], router=(140, 143),
                  live=40_000, fill=0.6, drop=0.2, load_cv=0.4),
             dict(moe=[(200, 220), (220, 240)], router=(250, 254),
                  live=30_000, fill=0.7, drop=0.3, load_cv=0.5)]
# experts_roofline: each experts stage lasts 1 ms; at granite's D 1,536 and
# F 512 a live row costs 6 D F operations, the bound at 989 TFLOP/s (the
# bytes, 2 bytes x (2 D a row + 3 x 40 D F), bind less)
_OPS = 6 * 1536 * 512 * (50_000 + 40_000 + 30_000) * 2
MOE_READERS = {
    "moe_fwd_ms_p50.train": 30.0,
    "router_ms_p50.train": 3.0,
    "expert_fill.train": 60.0,
    "drop_share.train": 20.0,
    "load_cv.train": 40.0,
    "experts_roofline.train": 100.0 * _OPS / 989e12 / 6e-3,
}


def _place_moe_training(s):
    for i, st in enumerate(MOE_STEPS):
        s.begin("train_step", root=True, t=_at(100 + 200 * i))
        s.begin("forward", t=_at(101 + 200 * i), ev=_Event(st["moe"][0][0]))
        for li, (a, b) in enumerate(st["moe"]):
            s.begin("moe", t=_at(102 + 200 * i + li), ev=_Event(a), layer=li)
            edges = [a, a + 1, a + 2, a + 3, b]      # experts: 1 ms
            for j, stage in enumerate(MOE_STAGES):
                attrs = {"live": torch.tensor(st["live"])} \
                    if stage == "moe.experts" else {}
                s.begin(stage, t=_at(102.1 + 200 * i + li + 0.1 * j),
                        ev=_Event(edges[j]), **attrs)
                s.end(t=_at(102.15 + 200 * i + li + 0.1 * j),
                      ev=_Event(edges[j + 1]))
            s.end(t=_at(102.9 + 200 * i + li), ev=_Event(b))
        s.end(t=_at(110 + 200 * i), ev=_Event(st["moe"][-1][1]))
        s.begin("router", t=_at(120 + 200 * i), ev=_Event(st["router"][0]))
        s.end(t=_at(121 + 200 * i), ev=_Event(st["router"][1]))
        s.note(**{k: torch.tensor(st[k]) for k in ("fill", "drop",
                                                    "load_cv")})
        s.end(t=_at(190 + 200 * i))


def _moe_run(tr):
    from portbench.core import peaks
    from portbench.core.report import Run
    run = Run(bench_spec.Cell("granite-moe-3b.train", ROOT), "cuda", tr)
    run.peaks = peaks.peak("NVIDIA H100 80GB HBM3")
    return run


@pytest.mark.parametrize("metric", sorted(MOE_READERS))
def test_moe_reader_reads_hand_placed_spans(metric):
    with telemetry.recording() as s:
        _place_moe_training(s)
    run = _moe_run(_window())
    experts = s.named("moe.experts")
    assert [s.device_ms(x) for x in experts] == [1.0] * 6
    assert run.cell.reader(metric)(run) == pytest.approx(MOE_READERS[metric],
                                                         rel=1e-6)


@pytest.mark.parametrize("metric", sorted(MOE_READERS))
def test_moe_reader_reads_nothing_from_dense_spans_or_without_the_tracer(
        metric, monkeypatch):
    """The minicpm cell's spans hold no expert layer; the parent of the
    tracer's change runs the same readers."""
    with telemetry.recording() as s:
        _place_training(s)
    assert _moe_run(_window()).cell.reader(metric)(_moe_run(_window())) \
        is None
    import repro_torch
    with telemetry.recording() as s:
        _place_moe_training(s)
    monkeypatch.delattr(repro_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    run = _moe_run(_window())
    assert run.cell.reader(metric)(run) is None


# -- tools/span_report.py -----------------------------------------------------
def _span_report():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "span_report", ROOT / "tools" / "span_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_span_report_names_gaps_by_span_and_step_and_lists_requests():
    """Idle gaps (ms from the window's start) inside the first step's
    prefill launch and decode launch, the second's decode launch and the
    third's decode read-back."""
    with telemetry.recording() as s:
        _place_serving(s)
    tr = _window(busy_ms=((0, 105), (110, 155), (160, 305), (312, 440),
                          (445, 1000)))
    ns = tr.ns
    tr.events = [("flash_mma_kernel", ns(_at(102)), ns(_at(103))),
                 ("paged_decode_mma_kernel", ns(_at(152)), ns(_at(153))),
                 ("flash_mma_kernel", ns(_at(405)), ns(_at(406)))]
    out = _span_report().report(_run(tr), s)

    def step(i):
        return {"tick": (100, 300, 400)[i], "residents": i,
                "queue_len": 3 - i, "pages_in_use": 10 * i}
    assert [[n.split("@")[0], round(sec * 1e3, 3), st]
            for n, sec, st in out["idle_gaps"]] == [
        ["decode.launch", 7.0, step(1)],
        ["prefill.launch", 5.0, step(0)],
        ["decode.launch", 5.0, step(0)],
        ["decode.wait", 5.0, step(2)]]
    assert [(p["rid"], p["tokens"], p["tick"]) for p in
            out["slow_prefills"]] == [(1, 8, 100), (2, 16, 400)]
    assert [p["ms"] for p in out["slow_prefills"]] == \
        pytest.approx([48.0, 30.0])
    assert [q["rid"] for q in out["slow_queue"]] == [2, 1, 3]
    assert [q["ms"] for q in out["slow_queue"]] == \
        pytest.approx([6.0, 2.0, 1.0])
    # launches: prefill 39 + 20 ms, decode 3 x 10 ms, of a 1 s window
    assert out["launch_share"] == pytest.approx(0.089)
    assert out["flash_in_prefill"] == {"share": 1.0, "flash_ops": 2}
    assert out["counts"]["step"] == 3 and out["counts"]["queue"] == 3
    assert "phases_ms" not in out


def test_span_report_sums_the_training_phases_device_time():
    with telemetry.recording() as s:
        _place_training(s)
    out = _span_report().report(_run(_window()), s)
    assert out["steps"] == 3
    assert out["phases_ms"] == pytest.approx(
        {"forward": 750.0, "backward": 1850.0, "optimizer": 650.0})
    assert out["phases_share"] == pytest.approx(3.25)
    assert "launch_share" not in out and "slow_prefills" not in out
