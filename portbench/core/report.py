"""What a run hands its metric readers, and the line it prints.

The cell's ``drivers/<kind>.py`` fills a :class:`Run`; each metric is read
from it by its own reader (``metrics/<name>.py``: ``read(run)`` returns a
number, or None where it finds nothing to read, and the metric is then
left out of the line). The last line of standard output is the result; the numbers the
output check compared, each beside its limit, come last in it and last on
standard error.
"""
from __future__ import annotations

import json
import math
import sys


class Run:
    """The readings of one run. Times in seconds on the host's clock."""

    def __init__(self, cell, device: str, trace):
        self.cell = cell
        self.device = device
        self.trace = trace          # core.trace.Trace (events if traced)
        self.model = cell.config["model"]
        self.setup_s = None
        self.window_s = None
        self.check_s = 0.0          # the output check, after the window
        self.spans = []             # (name, t0, t1) inside the window
        self.counters = {}
        self.samples = {}           # name -> list of values
        self.peaks = None           # core.peaks entry of the card, or None
        self.checks = {}            # name -> {"value", "limit"}
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.device_kind = None

    def span_seconds(self, name: str) -> list:
        return [t1 - t0 for n, t0, t1 in self.spans if n == name]

    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values())


def _number(x):
    x = float(x)
    return x if math.isfinite(x) else None


def result(run: Run, trace: bool) -> dict:
    metrics = {}
    for entry in run.cell.metrics(trace):
        value = run.cell.reader(entry["name"])(run)
        if value is None:
            continue
        metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    device = {"platform": "gpu" if run.device == "cuda" else run.device,
              "kind": run.device_kind, "count": run.cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct(), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if trace and run.trace.busy_s is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(10),
                            "idle_gaps": run.trace.idle_gaps(run.spans, 10)}
    out["checks"] = {k: {"value": _number(c["value"]),
                         "limit": c["limit"]} for k, c in run.checks.items()}
    return out


def emit(out: dict) -> None:
    """The checks last on standard error, then the result line last on
    standard output."""
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
