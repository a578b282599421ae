"""Median host milliseconds of the window's ``Engine.step`` calls less their
waits on the card: each program ``step`` span less the ``*.wait`` spans
inside it (the seed tokens' and the decode tick's read-backs), so what is
left is host work and launches. Nothing is read from a program without the
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
    ms = s.host_ms("step", tr.pc0, tr.pc1, less=".wait") if s else []
    return percentile(ms, 50) if ms else None
