"""Median wall milliseconds of the window's decode ticks (the program's
``decode`` spans inside ``Engine.step``: the launches, the read-backs and
the host loop that emits the tokens). Nothing is read from a program without
the tracer, or a run that recorded no spans. Read in the profiled window
(``--trace 1``): the profiler slows the host, so these spans read longer
than untraced ones (PERF.md §5 keeps both)."""


def read(run):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    from portbench.core.stats import percentile
    s, tr = telemetry.last(), run.trace
    ms = s.host_ms("decode", tr.pc0, tr.pc1) if s else []
    return percentile(ms, 50) if ms else None
