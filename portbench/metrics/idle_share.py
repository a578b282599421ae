"""Share of the traced window in which no operation ran on the card."""


def read(run):
    tr = run.trace
    if tr.busy_s is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
