"""90th percentile of time to first token over every request due in the
window, from when it was due to the return of the step that emitted its
first token. A request refused, shed or never answered counts as missing:
it sorts last. Where more than a tenth are missing the percentile is
missing too, and reads as the longest a request could have waited (the
window and the drain after it)."""
import math


def read(run):
    from portbench.core.stats import percentile
    v = percentile(run.samples["ttft_s"], 90)
    if not math.isfinite(v):
        v = run.window_s + run.cell.traffic["drain_s"]
    return v * 1e3
