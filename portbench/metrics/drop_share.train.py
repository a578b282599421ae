"""The share of (token, choice) assignments dropped past their expert's
capacity, averaged over the MoE layers and the window's steps, in %. Read
from the counter the program notes on each traced ``train_step`` span."""


def read(run):
    from portbench.core.counters import step_mean
    v = step_mean(run, "drop")
    return None if v is None else 100.0 * v
