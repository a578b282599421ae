#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's compared numbers over
many seeds (the lower reading), the control's (the plain reference one
precision below the configuration's, in the program's place; the upper
reading) and the planted faults', all in one process at the cell's own
sizes.

    python3 portbench/tools/calibrate.py --workload NAME --seeds 1-12 \
        [--control-seeds 1-3] [--seconds 10]

Serving: each seed serves a short window at the cell's load through the
same ``drivers/`` code as a run and judges its sample as a run does; the
control is the float8 reference's own first choice at each judged position,
and the fault a served token altered where it is produced (the last of each
judged answer). Training: each seed runs the program's three checked steps (set-up
of a run) and the reference after them; on the control seeds also the
float8 reference and the fault "half of the batch left out" (the reference
on the first half of each batch's rows, the mean over those). A step that
returns its state unchanged reads 1 by the change's measure and needs no
run. One JSON line per seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def serve_seed(cell, seed, seconds, control: bool, device):
    import torch
    from portbench.core import report
    from portbench.core.trace import Trace
    from portbench.drivers import serve
    s = serve.Serve(cell, seed, seconds, device)
    s.setup()
    r = report.Run(cell, device, Trace(torch, False))
    s.window(r)
    s.drain()
    s.readings(r)
    judged = s.sample()
    s.release()
    out = {"seed": seed, "requests": len(s.reqs),
           "unanswered": r.counters["unanswered"]}
    seqs = [serve.served(j) for j in judged]
    out["logit_gap"], out["tokens"] = serve.logit_gaps(s.m, seed, seqs,
                                                       device)
    v = s.m["vocab_size"]
    altered = [(p, o[:-1] + [(o[-1] + 1) % v]) for p, o in seqs]
    out["fault_token_altered"], _ = serve.logit_gaps(s.m, seed, altered,
                                                     device)
    if control:
        out["control_float8"], _ = serve.logit_gaps(s.m, seed, seqs, device,
                                                    quant="float8")
    return out


def train_seed(cell, seed, control: bool, device):
    from portbench.drivers import train
    t = train.Train(cell, seed, 0, device)
    t.setup()
    prog = {"losses": t.losses, "grad_norms": t.grad_norms,
            "change": t.change}
    batches = t.batches
    t.release()
    ref = train.follow(t.m, t.t, t.r, seed, batches, device)
    out = {"seed": seed, **train.gaps(prog, ref)}
    if control:
        low = train.follow(t.m, t.t, t.r, seed, batches, device,
                           quant="float8")
        out["control_float8"] = train.gaps(low, ref)
        half = [b[: b.shape[0] // 2] for b in batches]
        fault = train.follow(t.m, t.t, t.r, seed, half, device)
        out["fault_half_batch"] = train.gaps(fault, ref)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from portbench.core import spec
    cell = spec.Cell(args.workload, ROOT)
    ctl = set(seeds(args.control_seeds))
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "serve":
            out = serve_seed(cell, seed, args.seconds, seed in ctl,
                             args.device)
        else:
            out = train_seed(cell, seed, seed in ctl, args.device)
        out["s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
