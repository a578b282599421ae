#!/usr/bin/env python3
"""How far equally valid bf16 roundings of full-width gemma-7b's serving run
lie from each other and from fp32 arithmetic.

    python3 tools/dense_rounding.py [--seed 0]

Needs one CUDA card. Serves ``chip_smoke.py``'s phase-12 trace
(``gemma_trace``) on full-width ``gemma-7b`` (random weights from
``--seed``) in five bf16 arrangements: the kernel and the torch attention
backends (``K``, ``T``), each also with cuBLAS's reduced-precision bf16
reductions turned off (``K_full_reduction``, ``T_full_reduction``; PyTorch
allows them by default), and the torch backend with its attention
arithmetic in fp32 on the bf16 q, k and v, its output rounded to bf16 as
every route's is (``T_fp32_attention``: ``layers._sdpa`` and
``_sdpa_chunked`` wrapped; no rounding of scores or probabilities). Then
the same weights, upcast to fp32 in place, on both backends
(``F32_kernel``, ``F32_torch``). Prints, for pairs of
runs, chip_smoke's agreement ratio: the largest |a - b| / (atol + rtol *
|b|) over logits up to each request's first differing token, at
rtol = atol = 1e-1 (1e-3 for the fp32 pair). The bf16 runs' ratios against
``F32_torch`` are what ``bf16_rule`` compares.
"""
from __future__ import annotations

import argparse
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
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("dense_rounding: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib
    from repro_torch.serve import api, traces
    from repro_torch.serve import engine as eng_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    cfg = configs.get_config(cs.GEMMA_ARCH)
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")

    def fp32_math(fn):
        def run(q, k, v, *a, **kw):
            return fn(q.float(), k.float(), v.float(), *a, **kw).to(q.dtype)
        return run

    def serve(c, backend, reduced=True, exact_attention=False):
        flag = torch.backends.cuda.matmul
        flag.allow_bf16_reduced_precision_reduction = reduced
        trace = cs.gemma_trace(traces, c, args.seed)
        eng = eng_mod.Engine(params, c, cs.engine_config(eng_mod, backend),
                             device="cuda")
        inner = layers._sdpa, layers._sdpa_chunked
        if exact_attention:
            layers._sdpa, layers._sdpa_chunked = map(fp32_math, inner)
        try:
            t0 = time.perf_counter()
            eng.run(trace, max_ticks=2000)
            torch.cuda.synchronize()
        finally:
            flag.allow_bf16_reduced_precision_reduction = True
            layers._sdpa, layers._sdpa_chunked = inner
        print(f"served {backend} reduced={reduced} exact_attention="
              f"{exact_attention} {c.dtype} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        done = eng.completed
        del eng
        torch.cuda.empty_cache()
        return done

    runs = {"K": serve(cfg, "kernel"), "T": serve(cfg, "torch"),
            "K_full_reduction": serve(cfg, "kernel", reduced=False),
            "T_full_reduction": serve(cfg, "torch", reduced=False),
            "T_fp32_attention": serve(cfg, "torch", exact_attention=True)}
    params.float()                        # in place, one parameter at a time
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    runs["F32_kernel"] = serve(cfg32, "kernel")
    runs["F32_torch"] = serve(cfg32, "torch")
    pairs = [(name, "F32_torch", cs.BF16_TOL) for name in (
        "K", "T", "K_full_reduction", "T_full_reduction",
        "T_fp32_attention")] + [
        ("K", "T", cs.BF16_TOL), ("K", "T_fp32_attention", cs.BF16_TOL),
        ("T", "T_fp32_attention", cs.BF16_TOL),
        ("K_full_reduction", "T_full_reduction", cs.BF16_TOL),
        ("K", "K_full_reduction", cs.BF16_TOL),
        ("T", "T_full_reduction", cs.BF16_TOL),
        ("F32_kernel", "F32_torch", cs.FP32_TOL)]
    for a, b, tol in pairs:
        res = cs.agreement(torch, model_lib, api, runs[a], runs[b], *tol)
        print(json.dumps({
            "pair": f"{a} vs {b}", "rtol_atol": tol[0],
            "max_logits_diff": res["max_logits_diff"],
            "max_diff_over_tol": res["max_diff_over_tol"],
            "max_abs_logit": res["max_abs_logit"],
            "violations": res["violations"],
            "first_divergence": sorted((d["rid"], d["at"])
                                       for d in res["diverged"])}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
