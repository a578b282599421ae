"""Median device milliseconds per training step of its ``router`` phase
(the immune regulation of every layer's bias from the step's loads), from
the CUDA events the program records at the phase's edges while it traces.
Nothing is read from a dense model, a program without the tracer, a run
that recorded no spans, or spans without device times (the CPU)."""


def read(run):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    from portbench.core.stats import percentile
    s, tr = telemetry.last(), run.trace
    ms = s.phase_ms("router", tr.pc0, tr.pc1) if s else None
    return percentile(ms, 50) if ms else None
