#!/usr/bin/env python3
"""The kernels of two trees of the port (paged decode, paged verify, flash
attention, the grouped matmul, the grid step), side by side on one card,
through ``chip_smoke.py``'s own checks and timings.

    python3 tools/kernel_ab.py --roots OLD,NEW [--seed 0]
    python3 tools/kernel_ab.py --one ROOT [--seed 0]

Needs one CUDA card. Each root is a checkout of this repository (for the
parent commit: ``git archive <commit> | tar -x -C build/parent``). With
``--roots`` the trees run in turns, OLD, NEW, NEW, OLD; each run is its own
process that imports the port from ``<root>/src`` (and builds its kernels
under ``<root>/build``) and this checkout's ``chip_smoke.py``, and calls its
``check_paged``, ``check_verify``, ``check_flash``, ``check_gmm``,
``check_grid_step`` and the matching ``time_*`` on inputs drawn from
``--seed`` (the attention kernels also at kimi-k2's 64 / 8 heads and head
dim 112, ``KIMI_DECODE``, ``KIMI_VERIFY`` and flash at S = 1000; the grouped
matmul also at kimi-k2's expert widths). A failed check is recorded in the run's ``failed`` list instead
of ending it, so a tree that breaks a check (an older body, a planted
fault) still reports every reading. A tree whose wrappers predate the
per-body counts has each launch counted under one body, ``"any"``; a tree
without ``grid_step_planes`` (one launch a plane) has its stacks neither
checked nor timed. Prints one JSON line per run, then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMED = ("ms", "library_ms", "device_ms", "library_device_ms", "bound_ms",
         "max_abs_err")
# the kernels without a library call (paged decode and verify, the grid step)
NO_LIB_TIMED = ("ms", "device_ms", "bound_ms", "max_abs_err")


class _AllLaunches:
    """``launches_by_path`` of a wrapper without one: every body is one."""

    def __init__(self, wrapper):
        self.wrapper = wrapper

    def __getitem__(self, path):
        return self.wrapper.launches


def one(root: str, seed: int) -> dict:
    """Checks and times of the port under ``root`` (this process only)."""
    import torch
    sys.path[:0] = [ROOT, os.path.join(os.path.abspath(root), "src")]
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as flash_pkg
    from repro_torch.kernels import grid_step as grid_pkg
    from repro_torch.kernels import moe_gmm as gmm_pkg
    from repro_torch.kernels import paged_attention as paged_pkg
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.grid_step import grid_step, grid_step_ref
    from repro_torch.kernels.moe_gmm import gmm_ref, moe_gmm
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_ref, paged_attention_verify,
        paged_attention_verify_ref)
    from repro_torch.serve import traces
    failed = []
    cs.check = lambda cond, msg: cond or failed.append(msg)
    paths = {}
    for pkg, wrappers in ((flash_pkg, [flash_attention]),
                          (gmm_pkg, [moe_gmm]),
                          (paged_pkg, [paged_attention,
                                       paged_attention_verify]),
                          (grid_pkg, [grid_step])):
        paths[pkg] = getattr(pkg, "kernel_path", lambda *a, **k: "any")
        for wrapper in wrappers:
            if not hasattr(wrapper, "launches_by_path"):
                wrapper.launches_by_path = _AllLaunches(wrapper)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    paged = cs.check_paged(torch, gen, paged_attention, paged_attention_ref,
                           paths[paged_pkg])
    verify = cs.check_verify(torch, gen, paged_attention_verify,
                             paged_attention_verify_ref, paged_attention,
                             paths[paged_pkg])
    flash = cs.check_flash(torch, gen, flash_attention, attention_ref,
                           paths[flash_pkg])
    gmm = cs.check_gmm(torch, gen, moe_gmm, gmm_ref, paths[gmm_pkg])
    planes = getattr(grid_pkg, "grid_step_planes", None)
    grid = cs.check_grid_step(torch, gen, grid_step, planes, grid_step_ref,
                              paths[grid_pkg])
    pt = cs.time_paged(torch, gen, paged_attention, paged_attention_ref)
    vt = cs.time_verify(torch, gen, paged_attention_verify,
                        paged_attention_verify_ref,
                        cs.verify_positions(
                            traces, configs.get_config("smollm-360m"), seed))
    ft = cs.time_flash(torch, gen, flash_attention, attention_ref)
    pt112 = cs.time_paged(torch, gen, paged_attention, paged_attention_ref,
                          **cs.KIMI_DECODE)
    vt112 = cs.time_verify(torch, gen, paged_attention_verify,
                           paged_attention_verify_ref, **cs.KIMI_VERIFY)
    ft112 = cs.time_flash(torch, gen, flash_attention, attention_ref, h=64,
                          hk=8, d=112, lengths=(1000,))
    gt = cs.time_gmm(torch, gen, moe_gmm, gmm_ref)
    grid_t = cs.time_grid_step(torch, gen, grid_step, planes, grid_step_ref)
    return {"root": root, "failed": failed, "paged_checks": paged,
            "verify_checks": verify, "flash_checks": flash,
            "gmm_checks": gmm, "grid_checks": grid,
            "paged_decode": {k: pt[k] for k in NO_LIB_TIMED},
            "paged_verify": {k: vt[k] for k in NO_LIB_TIMED},
            "flash_1000": {k: ft[k] for k in TIMED},
            "flash_383": {k: ft["s383"][k] for k in TIMED},
            "paged_decode_d112": {k: pt112[k] for k in NO_LIB_TIMED},
            "paged_verify_d112": {k: vt112[k] for k in NO_LIB_TIMED},
            "flash_1000_d112": {k: ft112[k] for k in TIMED},
            "gmm_decode": {k: gt[k] for k in TIMED},
            "gmm_prefill": {k: gt["prefill"][k] for k in TIMED},
            "gmm_kimi_decode": {k: gt["kimi"][k] for k in TIMED},
            "gmm_kimi_prefill": {k: gt["kimi_prefill"][k] for k in TIMED},
            "grid_step": {shape: {k: t[k] for k in NO_LIB_TIMED}
                          for shape, t in grid_t.items()}}


def run(root: str, seed: int) -> str:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--one", root, "--seed", str(seed), "--child"],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"kernel_ab: {root} failed ({proc.returncode}):\n"
                         f"{proc.stdout}{proc.stderr}")
    return proc.stdout.strip().splitlines()[-1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--roots", help="OLD,NEW")
    group.add_argument("--one", help="one ROOT")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(one(args.one, args.seed)))
        return 0
    roots = [args.one] if args.one else args.roots.split(",")
    order = roots if len(roots) == 1 else [roots[0], roots[1], roots[1],
                                           roots[0]]
    for root in order:
        print(run(root, args.seed), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
