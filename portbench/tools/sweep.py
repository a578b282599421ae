#!/usr/bin/env python3
"""Find the highest arrival rate a serving cell sustains: one set-up, then
a window at each rate in turn on a fresh engine (same weights), each
followed by its drain. A rate is sustained when no request is refused or
left unanswered and the backlog does not grow (the mean queue depth of the
window's last quarter is not above its first quarter's by more than
``--grow`` requests).

    python3 portbench/tools/sweep.py --workload minicpm-2b.docqa \
        --rates 2,4,6,8 --seconds 30 --seed 7

Prints one JSON line per rate. Used once to fix a mix's rate; the
benchmark's runs never search for one.
"""
import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--grow", type=float, default=2.0)
    args = ap.parse_args()
    import torch
    from portbench.core import report, spec, stats
    from portbench.core.trace import Trace
    from portbench.drivers import serve
    cell = spec.Cell(args.workload, ROOT)
    s = serve.Serve(cell, args.seed, args.seconds, "cuda")
    t0 = time.perf_counter()
    s.setup()
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    for rate in [float(x) for x in args.rates.split(",")]:
        s.engine = None
        gc.collect()
        torch.cuda.empty_cache()
        s.traffic = dict(cell.traffic, rate_per_s=rate)
        s.reqs = serve.requests(s.traffic, s.seed, s.seconds,
                                s.m["vocab_size"])
        s.engine = s.eng_mod.Engine(s.params, s.cfg, s.ecfg, device="cuda",
                                    router_bias=s.bias)
        r = report.Run(cell, "cuda", Trace(torch, False))
        s.window(r)
        s.drain()
        s.readings(r)
        q = s.queue_depth
        n = max(1, len(q) // 4)
        first = sum(q[:n]) / n
        last = sum(q[-n:]) / n
        ttft = r.samples["ttft_s"]
        fin = [t for t in ttft if math.isfinite(t)]
        out = {"rate": rate, "requests": len(ttft),
               "refused": r.counters["refused"],
               "unanswered": r.counters["unanswered"],
               "missing": len(ttft) - len(fin),
               "queue_first": first, "queue_last": last,
               "ttft_p50_ms": stats.percentile(ttft, 50) * 1e3,
               "ttft_p90_ms": stats.percentile(ttft, 90) * 1e3,
               "step_p50_ms": stats.percentile(r.samples["step_s"], 50) * 1e3,
               "prefills": len(r.samples["prefill_lens"]),
               "decode_tokens": r.counters["decode_tokens"],
               "preemptions": r.counters["preemptions"],
               "sustained": (r.counters["refused"] == 0
                             and r.counters["unanswered"] == 0
                             and last <= first + args.grow)}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
