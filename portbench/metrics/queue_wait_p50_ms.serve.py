"""Median wall time from a request's due time to the end of the step whose
admission took it (its first admission; immune admission and paging), over
the requests admitted inside the window."""


def read(run):
    from portbench.core.stats import percentile
    w = run.samples["queue_wait_s"]
    return percentile(w, 50) * 1e3 if w else None
