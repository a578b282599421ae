#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration, traffic mix and metrics; the mix's ``kind`` picks the
driver (``portbench/drivers/<kind>.py``). Without a CUDA card, or with
fewer cards than the cell asks for, it prints no result and exits 3; if
anything of JAX or of the JAX package is loaded once the window has closed,
it names it on standard error and exits 4.
"""
import time

T_TOP = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def process_age() -> float:
    """Seconds since this process started (its start time in the process
    table against the system's uptime), so set-up counts the interpreter's
    start too."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_TOP = process_age()


def clock() -> float:
    return AGE_AT_TOP + time.perf_counter() - T_TOP


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "portbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from portbench.core import guard, report, spec
    cell = spec.Cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 3
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    run = driver.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                     clock)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"portbench: loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 4
    print(f"portbench: counters {run.counters}", file=sys.stderr)
    print(f"portbench: setup {run.setup_s:.2f} s, window {run.window_s:.2f} s,"
          f" check {run.check_s:.2f} s, process {clock():.2f} s",
          file=sys.stderr)
    report.emit(report.result(run, bool(args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
