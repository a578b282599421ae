#!/usr/bin/env python3
"""Registers, spills and stack of every kernel in the port's CUDA sources,
as ``ptxas -v`` reports them for ``sm_90a`` (the flags of
``repro_torch.kernels._build``). Needs ``nvcc``, so it runs on the machine
with the card:

    python3 tools/ptxas_report.py [SUBSTRING ...]

Prints one JSON line a kernel entry: its demangled name, registers a
thread, spill stores / loads and stack frame in bytes. With arguments, only
the entries whose demangled name holds one of them (e.g. ``256``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '(\w+)'")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")


def demangle(names: list) -> list:
    tool = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(_build._nvcc()), "cu++filt")
    if not os.path.exists(tool):
        tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def report(src) -> list:
    """ptxas's figures for each entry function of one source."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "k.o"), str(src)],
            capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stderr}")
    rows, cur = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        if m := ENTRY.search(line):
            cur = {"source": src.name, "kernel": m.group(1)}
            rows.append(cur)
        elif cur is not None and (m := FRAME.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := REGS.search(line)):
            cur["registers"] = int(m.group(1))
    for row, name in zip(rows, demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows


def main() -> int:
    keep = sys.argv[1:]
    for src in sorted(_build.CSRC.glob("*.cu")):
        for row in report(src):
            if not keep or any(k in row["kernel"] for k in keep):
                print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
