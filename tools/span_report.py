#!/usr/bin/env python3
"""One traced run of a benchmark cell, read through the program's own spans
(``repro_torch.telemetry``) beside the profiler's device timeline.

    python3 tools/span_report.py --workload minicpm-2b.docqa --seed N

Needs one CUDA card. Runs the cell as ``portbench/run.py --trace 1`` does and
prints its result line, then one JSON line ``spans`` with:

* ``counts``, ``dropped``: spans recorded in the window by name, and those
  the session dropped;
* ``median_ms`` / ``total_s``: each span name's median and summed host time;
* ``launch_share``: the ``*.launch`` spans' summed time over the window's
  (serving cells), to read beside ``idle_in_launch_share.serve``;
* ``idle_gaps``: the window's ten longest device idle gaps, each as
  ``[innermost program span@start, seconds, step]``: the gap named by the
  innermost program span the host was in at its middle (``queue`` spans
  left out; the harness's span where no program span covers it), and
  ``step`` the attributes of the ``step`` span around it (``tick`` and, at
  the step's start, ``residents``, ``queue_len``, ``pages_in_use``), or
  None outside a step;
* ``slow_prefills``: the ten longest ``prefill`` spans, each with its
  ``rid`` (None for a chunk of several requests), ``tokens``, ``ms`` and
  the ``tick`` of its step;
* ``slow_queue``: the ten longest ``queue`` waits, each ``rid`` and ``ms``;
* ``flash_in_prefill``: the share of flash device operations that start
  inside a ``prefill`` span placed on the profiler's clock (the clock
  check; serving cells);
* ``phases_ms`` / ``phases_share``: the ``forward``, ``backward``,
  ``optimizer`` and ``router`` device milliseconds summed over the
  window's steps, and their sum as a share of the window (training cells).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _step_of(session, span):
    """The ``step`` span around ``span``, or None."""
    while span.parent >= 0:
        span = session.spans[span.parent]
        if span.name == "step":
            return span
    return None


def _longest(spans, n: int = 10) -> list:
    return sorted(spans, key=lambda x: -x.seconds)[:n]


def report(run, session) -> dict:
    """The ``spans`` line of a traced run whose program recorded
    ``session``."""
    tr = run.trace
    spans = [x for x in session.spans
             if x.t1 is not None and tr.pc0 <= x.t1 <= tr.pc1]
    by = {}
    for x in spans:
        by.setdefault(x.name, []).append(x.seconds)
    out = {"counts": {k: len(v) for k, v in by.items()},
           "dropped": session.dropped,
           "median_ms": {k: statistics.median(v) * 1e3
                         for k, v in by.items()},
           "total_s": {k: sum(v) for k, v in by.items()}}
    steps = [x for x in spans if x.name == "train_step"]
    if steps:
        per = {}
        for st in steps:
            for c in session.children(st):
                ms = session.device_ms(c)
                if ms is not None:
                    per[c.name] = per.get(c.name, 0.0) + ms
        out["phases_ms"] = per
        out["phases_share"] = sum(per.values()) / 1e3 / tr.window_s
        out["steps"] = len(steps)
    launch = sum(x.seconds for x in spans if x.name.endswith(".launch"))
    if launch:
        out["launch_share"] = launch / tr.window_s
    # what the host was doing: innermost first (a request's queue span is
    # its wait, not the host's); the same gaps again, named by their step
    inner = sorted((x for x in spans if x.name != "queue"),
                   key=lambda x: x.seconds)
    gaps = tr.idle_gaps([(x.name, x.t0, x.t1) for x in inner]
                        + list(run.spans), 10)
    around = tr.idle_gaps([(str(x.index), x.t0, x.t1) for x in spans
                           if x.name == "step"], 10)
    out["idle_gaps"] = []
    for (name, sec), (where, _) in zip(gaps, around):
        index = where.rsplit("@", 1)[0]
        out["idle_gaps"].append(
            [name, sec, session.spans[int(index)].attrs
             if index.isdigit() else None])
    prefills = [x for x in spans if x.name == "prefill"]
    if prefills:
        out["slow_prefills"] = []
        for x in _longest(prefills):
            step = _step_of(session, x)
            out["slow_prefills"].append(
                {"rid": x.rid, "tokens": (x.attrs or {}).get("tokens"),
                 "ms": x.seconds * 1e3,
                 "tick": step.attrs["tick"] if step else None})
    queued = [x for x in spans if x.name == "queue"]
    if queued:
        out["slow_queue"] = [{"rid": x.rid, "ms": x.seconds * 1e3}
                             for x in _longest(queued)]
    marks = sorted((tr.ns(x.t0), tr.ns(x.t1)) for x in prefills)
    flash = tr.calls("flash")
    if marks and flash:
        inside = sum(any(a <= f0 < b for a, b in marks) for f0, _ in flash)
        out["flash_in_prefill"] = {"share": inside / len(flash),
                                   "flash_ops": len(flash)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    # the kernel build cache portbench/run.py uses
    cache = ROOT / "build" / "portbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import importlib

    import torch
    from portbench.core import report as bench_report
    from portbench.core import spec
    from portbench.run import clock
    from repro_torch import telemetry
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 3
    cell = spec.Cell(args.workload, ROOT)
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['kind']}")
    run = driver.run(cell, args.seed, cell.run_seconds, True, "cuda", clock)
    print(json.dumps(bench_report.result(run, True)), flush=True)
    print(json.dumps({"spans": report(run, telemetry.last())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
