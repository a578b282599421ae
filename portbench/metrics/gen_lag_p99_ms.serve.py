"""How late the harness submitted requests after they were due, 99th
percentile (the load generator's own lag, which the latencies include)."""


def read(run):
    from portbench.core.stats import percentile
    return percentile(run.samples["gen_lag_s"], 99) * 1e3
