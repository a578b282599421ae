"""Median device milliseconds per training step of its ``backward`` phase
(the gradients, ``autograd.grad``, and their stacking), from the CUDA
events the program records at the phase's edges while it traces, summed
over a step's microbatches. Nothing is read from a program without the
tracer, a run that recorded no spans, or spans without device times (the
CPU)."""


def read(run):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    from portbench.core.stats import percentile
    s, tr = telemetry.last(), run.trace
    ms = s.phase_ms("backward", tr.pc0, tr.pc1) if s else None
    return percentile(ms, 50) if ms else None
