"""The experts' load imbalance: the coefficient of variation of the
per-expert share of assignments (0 when balanced), averaged over the MoE
layers and the window's steps, in %. What the immune bias regulates. Read
from the counter the program notes on each traced ``train_step`` span."""


def read(run):
    from portbench.core.counters import step_mean
    v = step_mean(run, "load_cv")
    return None if v is None else 100.0 * v
