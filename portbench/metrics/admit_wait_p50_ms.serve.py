"""Median wall milliseconds a request waited in the engine's queue: from
``Engine.submit`` to its first admission (the program's ``queue`` spans of
the requests admitted inside the traced window). Nothing is read from a
program without the tracer, or a run that recorded no spans. Read in the
profiled window (``--trace 1``): the profiler slows the host, so these spans
read longer than untraced ones (PERF.md §5 keeps both)."""


def read(run):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    from portbench.core.stats import percentile
    s, tr = telemetry.last(), run.trace
    ms = s.host_ms("queue", tr.pc0, tr.pc1) if s else []
    return percentile(ms, 50) if ms else None
