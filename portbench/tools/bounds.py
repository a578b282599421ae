#!/usr/bin/env python3
"""Run a cell as the check does, each run a process of its own, and read
the spread that sets its bounds: ``--sets`` sets over the same seeds, then
optional traced runs.

    python3 portbench/tools/bounds.py --workload NAME --seeds 1,2,3,4,5,6 \
        --sets 2 --seconds 40 [--trace-seeds 7,8,9] [--out FILE]

Each run's result line (with its seed, set, exit code and wall seconds)
goes to ``--out`` as JSON lines; a summary follows on standard output: per
set and metric the median and the spread (interquartile distance over the
median, ``statistics.quantiles`` n=4), and the wider of the sets.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def one(workload, seed, seconds, trace) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench/run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], capture_output=True, text=True, cwd=ROOT)
    out = {"seed": seed, "trace": trace, "rc": proc.returncode,
           "wall_s": time.perf_counter() - t0}
    lines = proc.stdout.strip().splitlines()
    try:
        out["result"] = json.loads(lines[-1])
    except (IndexError, ValueError):
        out["stderr"] = proc.stderr[-3000:]
    out["notes"] = [ln for ln in proc.stderr.splitlines()
                    if ln.startswith("portbench: ")]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            r = one(args.workload, seed, args.seconds, 0)
            r["set"] = k
            runs.append(r)
            line = json.dumps(r)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    for seed in [int(s) for s in args.trace_seeds.split(",") if s]:
        r = one(args.workload, seed, args.seconds, 1)
        r["set"] = "trace"
        line = json.dumps(r)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    summary = {}
    for k in range(args.sets):
        vals = {}
        for r in runs:
            if r["set"] == k and "result" in r:
                for name, m in r["result"]["metrics"].items():
                    vals.setdefault(name, []).append(m["value"])
        for name, v in vals.items():
            q1, q2, q3 = statistics.quantiles(v, n=4) if len(v) > 1 \
                else (v[0],) * 3
            summary.setdefault(name, []).append(
                {"median": statistics.median(v), "spread": (q3 - q1) / q2,
                 "n": len(v)})
    print(json.dumps({"summary": summary,
                      "widest": {n: max(s["spread"] for s in v)
                                 for n, v in summary.items()},
                      "correct": sum(1 for r in runs if "result" in r
                                     and r["result"]["correct"]),
                      "runs": len(runs)}), flush=True)


if __name__ == "__main__":
    main()
