"""Model operations of every prefill and decode token the window processed
(counted from shapes by ``counts/model_flops.py``), over the window's
seconds times the card's published bf16 peak."""


def read(run):
    if not run.peaks:
        return None
    mf = run.cell.count("model_flops")
    m = run.model
    ops = sum(mf.prefill(m, s) for s in run.samples["prefill_lens"])
    n, ctx = run.counters["decode_tokens"], run.counters["decode_ctx"]
    ops += mf.forward(m, n, ctx, n)
    return 100.0 * ops / (run.window_s * run.peaks["flops"][m["dtype"]])
