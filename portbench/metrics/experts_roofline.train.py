"""The forward's expert products against their roofline, in the traced run:
the least time of every ``moe.experts`` span in the window (its live rows'
operations, 6 D F a row, and bytes at the published peaks,
``counts/moe_experts.py``) over those spans' device time, from the CUDA
events the program records at their edges. Rows the buffer pads count for
nothing, so the share says what the padding and the route cost. Nothing is
read from a program without these spans or their ``live`` counts, or from
spans without device times (the CPU)."""


def read(run):
    if not run.peaks:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    s, tr = telemetry.last(), run.trace
    spans = s.named("moe.experts", tr.pc0, tr.pc1) if s else []
    if not spans:
        return None
    ms = [s.device_ms(x) for x in spans]
    live = [(x.attrs or {}).get("live") for x in spans]
    if None in ms or any(v is None for v in live):
        return None
    import torch
    from portbench.core.peaks import bound_s
    m = run.model
    me = run.cell.count("moe_experts")
    least = 0.0
    for rows in torch.stack(live).tolist():        # one read-back
        t, _ = bound_s(me.nbytes(m["d_model"], m["d_ff"], m["num_experts"],
                                 rows),
                       me.flops(m["d_model"], m["d_ff"], rows),
                       run.peaks["flops"][m["dtype"]],
                       run.peaks["hbm_bytes_per_s"])
        least += t
    return 100.0 * least / (sum(ms) / 1e3)
