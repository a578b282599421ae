"""The paper's experiment end to end on the port: extract a CMOS netlist
with immune-balanced mobile agents, print the statements (the paper's
output format) and the population dynamics (the paper's Fig. 3).

    PYTHONPATH=src python -m repro_torch.launch.vlsi --layout nand|dff \\
        --agents N [--seed S] [--max-steps M] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given (the observer's fixpoint
test then runs the grid-step kernel's plain version). The counterpart of the
JAX package's ``examples/vlsi_extraction.py``: the same layout, agents and
seed give the same cycles and the same netlist.
"""
from __future__ import annotations

import argparse

import torch

from ..core.vlsi import extractor, layout, reference


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layout", choices=["nand", "dff"], default="nand")
    ap.add_argument("--agents", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=8000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda but no CUDA device is visible "
                 "(pass --device cpu to run the plain versions)")
    if args.agents < 1 or args.max_steps < 1:
        ap.error("--agents and --max-steps must be positive")

    lay = layout.nand_layout() if args.layout == "nand" \
        else layout.dff_layout()
    oracle = reference.extract(lay)
    print(f"layout: {args.layout} ({lay.shape[1]}x{lay.shape[2]}), "
          f"{len(oracle.fets)} transistors, {len(oracle.equivs)} node pairs")

    grid, steps, pops, _ = extractor.run_extraction(
        lay, n_agents=args.agents, seed=args.seed, max_steps=args.max_steps,
        record=True, device=args.device)
    sim = extractor.harvest(grid, lay)
    ok, msg = extractor.netlists_equivalent(sim, oracle)
    print(f"extracted in {steps} MIMD cycles with {args.agents} agents on "
          f"{args.device} — netlist "
          f"{'EQUIVALENT to oracle' if ok else 'MISMATCH: ' + msg}")
    print(f"redundant statements deduplicated: {sim.duplicates}\n")

    print("netlist (paper statement format):")
    for i, f in enumerate(sorted(sim.fets, key=str)):
        s, d = sorted(n for _, n in f.sd)
        print(f"  {'PFET' if f.pol == 'p' else 'NFET'} {i}: S {s}, D {d}, "
              f"G {f.g[1]}, L {f.l}, W {f.w}")
    for e in sorted(sim.equivs, key=str):
        a, b = sorted(n for _, n in e.nodes)
        print(f"  Contact: Node {a} == Node {b}")

    print("\npopulation dynamics (paper Fig. 3):")
    marks = [t for t in (0, 5, 20, 50, 100, 200) if t < args.max_steps] \
        + [min(steps, args.max_steps - 1) - 1]
    print("  step  " + "  ".join(f"{n[:9]:>9s}"
                                 for n in extractor.TYPE_NAMES))
    for t in marks:
        print(f"  {t:4d}  " + "  ".join(f"{int(c):9d}" for c in pops[t]))
    return {"steps": steps, "equivalent": ok, "duplicates": sim.duplicates,
            "fets": len(sim.fets), "equivs": len(sim.equivs)}


if __name__ == "__main__":
    main()
