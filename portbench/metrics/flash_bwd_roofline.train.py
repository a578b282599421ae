"""Training's flash backward against its roofline, in the traced run: the
least time of the window's backwards (each layer's of each step, its
operations and bytes at the published peaks, ``counts/flash_attention_bwd.py``)
over the profiler's device time of every ``flash_bwd*`` call (the Delta,
dK / dV and dQ launches). Every layer of a step makes one backward, one
``flash_bwd_dkdv`` call; where the trace holds another number of them (a
program that trains through another route, or launches the profiler lost),
nothing is read."""


def read(run):
    tr = run.trace
    if not run.peaks or tr.busy_s is None:
        return None
    from portbench.core.peaks import bound_s
    m, c = run.model, run.counters
    backwards = m["num_layers"] * c.get("steps", 0)
    if not backwards or len(tr.calls("flash_bwd_dkdv")) != backwards:
        return None
    fb = run.cell.count("flash_attention_bwd")
    t, _ = bound_s(fb.nbytes(c["batch"], m["num_heads"], m["num_kv_heads"],
                             c["seq"], m["head_dim"]),
                   fb.flops(c["batch"], m["num_heads"], c["seq"],
                            m["head_dim"]),
                   run.peaks["flops"][m["dtype"]],
                   run.peaks["hbm_bytes_per_s"])
    spent = sum(b - a for a, b in tr.calls("flash_bwd")) / 1e9
    return 100.0 * backwards * t / spent
