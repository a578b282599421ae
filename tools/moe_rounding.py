#!/usr/bin/env python3
"""Where the bf16 logits gap between two MoE serving runs comes from.

    python3 tools/moe_rounding.py [--seed 0] [--requests 8]

Needs one CUDA card. Serves the first ``--requests`` requests of
``chip_smoke.py``'s MoE trace on full-width ``granite-moe-3b-a800m`` (random
weights from ``--seed``, zero router bias) in four bf16 arrangements of the
attention and expert routes, with and without cuBLAS's reduced-precision
bf16 reductions, and in fp32 on both backends; then prints, for pairs of
runs, chip_smoke's bf16 agreement rule (logits within atol + rtol * |ref|,
rtol = atol = 1e-1, up to each request's first differing token):

* ``K`` / ``T``: the kernel and the torch backend;
* ``K_attn+einsum``: kernel attention, expert products on einsums;
* ``T_attn+gmm``: torch attention, expert products on the grouped-matmul
  kernel;
* ``F32_kernel`` / ``F32_torch``: the same weights in fp32.

The expert route is swapped by wrapping ``models.moe.moe_ffn``, the function
the transformer calls; the engine's own backend switch picks the rest.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("moe_rounding: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import api, traces
    from repro_torch.serve import engine as eng_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    cfg = configs.get_config(cs.MOE_ARCH)
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")
    bias = torch.zeros((cfg.num_layers, cfg.num_experts), device="cuda")

    def serve(p, c, backend, experts=None, reduced=True):
        """One run; ``experts`` forces the expert route."""
        flag = torch.backends.cuda.matmul
        flag.allow_bf16_reduced_precision_reduction = reduced
        trace = cs.moe_trace(traces, c, args.seed)[:args.requests]
        eng = eng_mod.Engine(p, c, cs.moe_config(eng_mod, backend),
                             device="cuda", router_bias=bias)
        inner = moe_mod.moe_ffn
        if experts is not None:
            moe_mod.moe_ffn = lambda pp, x, cc, b, backend="kernel": inner(
                pp, x, cc, b, backend=experts)
        try:
            t0 = time.perf_counter()
            eng.run(trace, max_ticks=2000)
            torch.cuda.synchronize()
        finally:
            moe_mod.moe_ffn = inner
            flag.allow_bf16_reduced_precision_reduction = True
        print(f"served {backend} experts={experts or backend} "
              f"reduced={reduced} {c.dtype} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        return eng.completed

    runs = {"K": serve(params, cfg, "kernel"),
            "T": serve(params, cfg, "torch"),
            "K_attn+einsum": serve(params, cfg, "kernel", experts="torch"),
            "T_attn+gmm": serve(params, cfg, "torch", experts="kernel"),
            "K_full_reduction": serve(params, cfg, "kernel", reduced=False),
            "T_full_reduction": serve(params, cfg, "torch", reduced=False)}
    up = copy.deepcopy(params).float()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    runs["F32_kernel"] = serve(up, cfg32, "kernel")
    runs["F32_torch"] = serve(up, cfg32, "torch")
    pairs = [("K", "T"), ("K", "K_attn+einsum"), ("T", "T_attn+gmm"),
             ("K_full_reduction", "T_full_reduction"),
             ("F32_kernel", "F32_torch")] + [
        (name, "F32_torch") for name in ("K", "T", "K_attn+einsum",
                                         "T_attn+gmm")]
    for a, b in pairs:
        res = cs.agreement(torch, model_lib, api, runs[a], runs[b],
                           *cs.BF16_TOL)
        print(json.dumps({
            "pair": f"{a} vs {b}", "max_logits_diff": res["max_logits_diff"],
            "max_diff_over_tol": res["max_diff_over_tol"],
            "violations": res["violations"],
            "first_divergence": sorted((d["rid"], d["at"])
                                       for d in res["diverged"])}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
