"""Median wall milliseconds of the host's ``Engine.step`` calls in the
window (a harness span around each)."""


def read(run):
    from portbench.core.stats import percentile
    s = run.samples["step_s"]
    return percentile(s, 50) * 1e3 if s else None
