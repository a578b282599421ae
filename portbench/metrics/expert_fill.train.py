"""The share of the expert buffer's rows (G x E x C a layer) that hold an
assignment, averaged over the MoE layers and the window's steps, in %: what
the padded einsums compute for nothing is the rest. Read from the counter
the program notes on each traced ``train_step`` span."""


def read(run):
    from portbench.core.counters import step_mean
    v = step_mean(run, "fill")
    return None if v is None else 100.0 * v
