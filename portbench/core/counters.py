"""What the program's training step notes on its spans, for the readers of
per-layer metrics: each ``train_step`` span of an MoE model carries its
counters (``fill``, ``drop``, ``load_cv``; device tensors, read back here
once, after the window)."""
from __future__ import annotations


def step_mean(run, name: str):
    """The mean over the window's training steps of the counter ``name``;
    None where the program has no tracer, recorded no step in the window,
    or a step lacks the counter."""
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    s, tr = telemetry.last(), run.trace
    if s is None:
        return None
    values = [(x.attrs or {}).get(name)
              for x in s.named("train_step", tr.pc0, tr.pc1)]
    if not values or any(v is None for v in values):
        return None
    import torch
    return float(torch.stack([v.float() for v in values]).mean())
