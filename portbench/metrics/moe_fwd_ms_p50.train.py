"""Median device milliseconds per training step spent in the expert layers
of its forward pass: the ``moe`` spans (route, dispatch, expert products,
combine) under each ``forward`` phase, summed over the layers and the
step's microbatches, from the CUDA events the program records at their
edges while it traces. Nothing is read from a program without these spans
or from spans without device times (the CPU)."""


def read(run):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    from portbench.core.stats import percentile
    s, tr = telemetry.last(), run.trace
    if s is None:
        return None
    per_step = []
    for step in s.named("train_step", tr.pc0, tr.pc1):
        ms = [s.device_ms(m) for f in s.children(step) if f.name == "forward"
              for m in s.children(f) if m.name == "moe"]
        if not ms or None in ms:
            return None
        per_step.append(sum(ms))
    return percentile(per_step, 50) if per_step else None
