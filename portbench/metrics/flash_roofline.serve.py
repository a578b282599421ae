"""The prefills' flash attention against its roofline, in the traced run:
the least time of the window's flash calls (each call's operations and
bytes at the published peaks, ``counts/flash_attention.py``) over the
profiler's device time of those calls. Every layer of a one-shot prefill
makes one call. Where the trace holds another number of flash calls than
the prefills made (the profiler lost launches), nothing is read."""


def read(run):
    tr = run.trace
    if not run.peaks or tr.busy_s is None:
        return None
    from portbench.core.peaks import bound_s
    fa = run.cell.count("flash_attention")
    m = run.model
    lens = run.samples["prefill_lens"]
    calls = tr.calls("flash")
    if not lens or len(calls) != m["num_layers"] * len(lens):
        return None
    least = 0.0
    for s in lens:
        t, _ = bound_s(fa.nbytes(1, m["num_heads"], m["num_kv_heads"], s,
                                 m["head_dim"]),
                       fa.flops(1, m["num_heads"], s, m["head_dim"]),
                       run.peaks["flops"][m["dtype"]],
                       run.peaks["hbm_bytes_per_s"])
        least += m["num_layers"] * t
    spent = sum(b - a for a, b in calls) / 1e9
    return 100.0 * least / spent
