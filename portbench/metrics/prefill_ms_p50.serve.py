"""Median wall milliseconds of the window's prefills, one-shot or a chunk
(the program's ``prefill`` spans inside ``Engine.step``: the launches and
the seed token's read-back). Nothing is read from a program without the
tracer, or a run that recorded no spans. Read in the profiled window
(``--trace 1``): the profiler slows the host, so these spans read longer
than untraced ones (PERF.md §5 keeps both)."""


def read(run):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    from portbench.core.stats import percentile
    s, tr = telemetry.last(), run.trace
    ms = s.host_ms("prefill", tr.pc0, tr.pc1) if s else []
    return percentile(ms, 50) if ms else None
