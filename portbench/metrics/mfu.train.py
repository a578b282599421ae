"""Model operations of the window's training steps (forward and backward,
3x the forward; recomputation not counted; ``counts/model_flops.py``), over
the window's seconds times the card's published bf16 peak."""


def read(run):
    if not run.peaks:
        return None
    mf = run.cell.count("model_flops")
    m = run.model
    c = run.counters
    ops = c["steps"] * mf.train_step(m, c["batch"], c["seq"])
    return 100.0 * ops / (run.window_s * run.peaks["flops"][m["dtype"]])
