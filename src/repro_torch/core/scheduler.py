"""Immune straggler / shard scheduler — the paper's regulation at the cluster
level (port of ``repro/core/scheduler.py``).

The data-parallel step time is the max over workers; a single straggler
drags the fleet. The paper's loop maps directly:

  * immunological memory   — per-worker EMA of observed throughput
  * two-stage regulation   — shard-fraction targets track *memory*, not
                             instantaneous speed (the delay), so transient
                             hiccups don't trigger rebalancing storms
  * hysteresis             — asymmetric up/down tracking damps limit cycles
  * anergy / clonal deletion — workers whose memory falls below a floor are
                             marked anergic (excluded: presumed failed) and
                             revived when throughput returns

Pure tensor state -> state, float32 as in the reference, on the device of
the state (``init_scheduler`` puts it on ``cuda`` unless asked otherwise).
Nothing here reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .immune import hysteresis

F32 = torch.float32


class SchedulerConfig(NamedTuple):
    mem_decay: float = 0.9        # throughput EMA decay
    up_rate: float = 0.3          # hysteresis: fast to give work back
    down_rate: float = 0.1        # slow to take work away (damps cycles)
    anergy_floor: float = 0.05    # fraction of median speed below which a
                                  # worker is considered failed (anergic)
    revival_steps: int = 3        # consecutive healthy observations to revive
    min_frac: float = 0.0         # floor on a live worker's share


class SchedulerState(NamedTuple):
    mem: torch.Tensor            # (W,) throughput EMA
    frac: torch.Tensor           # (W,) shard fractions (sum 1 over live)
    anergic: torch.Tensor        # (W,) bool — excluded workers
    healthy_count: torch.Tensor  # (W,) int32 healthy runs while anergic


def init_scheduler(num_workers: int, device="cuda") -> SchedulerState:
    w = num_workers
    return SchedulerState(
        mem=torch.ones((w,), dtype=F32, device=device),
        frac=torch.full((w,), 1.0 / w, dtype=F32, device=device),
        anergic=torch.zeros((w,), dtype=torch.bool, device=device),
        healthy_count=torch.zeros((w,), dtype=torch.int32, device=device),
    )


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D tensor: the mean of the two middle values
    of an even count (``torch.nanmedian`` returns the lower one), NaN when
    every value is NaN."""
    s = torch.sort(x).values                   # NaN sorts last
    count = (~torch.isnan(x)).sum()
    lo = torch.clamp((count - 1) // 2, min=0)
    hi = torch.clamp(torch.minimum(count // 2, count - 1), min=0)
    return (torch.take(s, lo) + torch.take(s, hi)) * 0.5


def _nanmax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmax`` of a 1-D tensor: NaN when every value is NaN."""
    m = torch.nan_to_num(x, nan=float("-inf")).amax()
    return torch.where(torch.isnan(x).all(), float("nan"), m)


def observe(state: SchedulerState, throughput,
            cfg: SchedulerConfig = SchedulerConfig()) -> SchedulerState:
    """Update with one step's observed per-worker throughput (0 = no
    heartbeat)."""
    throughput = torch.as_tensor(throughput, dtype=F32,
                                 device=state.mem.device)
    mem = cfg.mem_decay * state.mem + (1.0 - cfg.mem_decay) * throughput
    live_mem = torch.where(state.anergic, float("nan"), mem)
    median = torch.nan_to_num(_nanmedian(live_mem), nan=1.0)
    # the median alone fails when a *majority* dies — anchor the health
    # reference to the fastest live worker too
    median = torch.maximum(median,
                           0.5 * torch.nan_to_num(_nanmax(live_mem), nan=1.0))

    # anergy (failure detection) and revival
    looks_dead = mem < cfg.anergy_floor * median
    healthy_now = throughput > 0.5 * median
    healthy_count = torch.where(state.anergic & healthy_now,
                                state.healthy_count + 1, 0).to(torch.int32)
    revived = healthy_count >= cfg.revival_steps
    anergic = (state.anergic | looks_dead) & ~revived
    # revive with a fresh (median) memory so they are not re-anergized
    mem = torch.where(revived, median, mem)

    # regulation: target share proportional to *memory* (delayed), with
    # hysteresis
    live = ~anergic
    weights = torch.where(live, torch.clamp(mem, min=1e-6), 0.0)
    target = weights / torch.clamp(weights.sum(), min=1e-9)
    target = torch.where(live, torch.clamp(target, min=cfg.min_frac), 0.0)
    target = target / torch.clamp(target.sum(), min=1e-9)
    frac = hysteresis(state.frac, target, cfg.up_rate, cfg.down_rate)
    frac = torch.where(live, frac, 0.0)
    frac = frac / torch.clamp(frac.sum(), min=1e-9)
    return SchedulerState(mem=mem, frac=frac, anergic=anergic,
                          healthy_count=healthy_count)


def step_time(state: SchedulerState, speeds, work: float = 1.0):
    """Simulated wall-time of one DP step: max over live workers of
    share/speed; ``inf`` for a fleet with no live worker (the max over an
    empty set), never 0.0."""
    speeds = torch.as_tensor(speeds, dtype=F32, device=state.frac.device)
    live = ~state.anergic
    t = torch.where(live, state.frac * work / torch.clamp(speeds, min=1e-9),
                    0.0)
    return torch.where(live.any(), t.amax(), float("inf"))


def simulate(speeds_trace, cfg: SchedulerConfig = SchedulerConfig(),
             static: bool = False, device="cuda") -> torch.Tensor:
    """Run the scheduler over a (T, W) per-step speed trace; returns the
    (T,) per-step times on ``device``. ``static=True`` freezes the uniform
    assignment — the baseline the immune scheduler is compared against."""
    trace = torch.as_tensor(speeds_trace, dtype=F32, device=device)
    state = init_scheduler(trace.shape[1], device=device)
    times = []
    for speeds in trace:
        times.append(step_time(state, speeds))
        if not static:
            state = observe(state, speeds, cfg)
    return torch.stack(times) if times else \
        torch.zeros((0,), dtype=F32, device=device)
