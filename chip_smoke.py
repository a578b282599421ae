#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero; there is no CPU fallback):

1. Device: the card's name and power limit (``nvidia-smi``), then the build
   of every CUDA kernel from ``src/repro_torch/kernels/csrc``.
2. Kernels: each kernel held against its plain PyTorch version on the card —
   paged decode at smollm-360m width (Hkv=5, G=3, D=64, page=16; fp32 and
   bf16; ragged lengths; a +-1e4 null page) plus MHA and MQA cases, flash
   attention at H=15, Hkv=5, D=64 for S in {1, 17, 128, 383, 1000}, causal
   and not. Tolerances: 1e-5 (paged) / 5e-5 (flash) in fp32, 5e-2 in bf16.
   Then each kernel, its plain version and (flash only) PyTorch's SDPA are
   timed with CUDA events at main-path shapes, beside the bound from the
   bytes and flops those shapes need.
3. Engine: smollm-360m at its full published config (32 layers, d_model
   960, 15/5 heads, head_dim 64, d_ff 2560, vocab 49,152, bf16; random
   weights from ``--seed``) serves 16 requests of ``synthetic_trace``
   (prompts 100 / 383, heavy prompt 1000, 32 / 128 new tokens, two seeded
   lanes at temperature 0.8) through ``Engine.run`` with one-shot prefill.
   Every request must finish with its full token budget, the paged kernel
   must have launched 32 x decode ticks and flash 32 x prefills. The same
   trace is served again on the torch attention backend: per request the
   logits must agree within rtol = atol = 5e-2 (the allclose form of
   tests/test_kernels.py) up to the first token where the two runs differ,
   and such a divergence is allowed only where the reference's own margin
   (on the sampled lanes: of the tempered, Gumbel-perturbed scores) is below
   that tolerance. The same comparison runs in fp32 at full width on five
   requests within 1e-3. ``torch.profiler`` traces ten decode ticks with all
   eight slots busy (device time by kernel, the device's idle share). A
   smoke-size fp32 engine must also emit exactly its one-shot ``generate``
   tokens.

The second-to-last lines are one JSON object ``{"kernels": [...]}`` and the
``nvidia-smi`` name/power line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"paged": {"float32": 1e-5, "bfloat16": 5e-2},
       "flash": {"float32": 5e-5, "bfloat16": 5e-2}}
# (rtol, atol) on logits. bf16 at full depth: the torch backend rounds the
# scores and the probabilities to bf16 before their products (the JAX
# package's _sdpa), the kernels keep both in fp32 (as the TPU kernels do);
# through 32 layers that gap alone reaches ~1.2x the 5e-2 kernel tolerance,
# while the same comparison in fp32 agrees to ~1e-5.
BF16_TOL = (1e-1, 1e-1)
FP32_TOL = (1e-3, 1e-3)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds of ``fn`` on the card: CUDA events over ``iters``
    launches after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def paged_inputs(torch, gen, b, h, hk, d, page, maxp, dtype, lengths=None):
    dev = "cuda"
    num_pages = b * maxp + 1
    q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(num_pages, page, hk, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(num_pages, page, hk, d, generator=gen, device=dev).to(dtype)
    kp[0], vp[0] = 1e4, -1e4                      # dirty null page
    if lengths is None:
        lengths = torch.randint(1, maxp * page + 1, (b,), generator=gen,
                                device=dev)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    perm = (torch.randperm(num_pages - 1, generator=gen, device=dev) + 1).cpu()
    table = torch.zeros(b, maxp, dtype=torch.int32)
    n = 0
    for i, ln in enumerate(lengths.cpu().tolist()):
        npg = -(-ln // page)
        table[i, :npg] = perm[n:n + npg].to(torch.int32)
        n += npg
    return q, kp, vp, table.to(dev), lengths


def check_paged(torch, gen, paged_attention, paged_attention_ref) -> list:
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for (b, h, hk, d, page, maxp) in [(8, 15, 5, 64, 16, 96),   # smollm
                                          (3, 4, 4, 64, 8, 4),      # MHA
                                          (2, 8, 1, 128, 16, 3)]:   # MQA
            q, kp, vp, table, lengths = paged_inputs(
                torch, gen, b, h, hk, d, page, maxp, dtype)
            out = paged_attention(q, kp, vp, table, lengths)
            torch.cuda.synchronize()
            ref = paged_attention_ref(q, kp, vp, table, lengths)
            err = (out.float() - ref.float()).abs().max().item()
            name = str(dtype).split(".")[-1]
            check(err <= TOL["paged"][name],
                  f"paged {name} {(b, h, hk, d, page)} err {err}")
            kp[0], vp[0] = 0.0, 0.0                   # clean null page
            clean = paged_attention(q, kp, vp, table, lengths)
            check(torch.equal(clean, out),
                  f"paged {name}: null-page contents leaked into the output")
            cases.append({"shape": [b, h, hk, d, page, maxp], "dtype": name,
                          "max_abs_err": err})
    return cases


def check_flash(torch, gen, flash_attention, attention_ref) -> list:
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for s in (1, 17, 128, 383, 1000):
            for causal in (True, False):
                q = torch.randn(1, 15, s, 64, generator=gen, device="cuda").to(dtype)
                k = torch.randn(1, 5, s, 64, generator=gen, device="cuda").to(dtype)
                v = torch.randn(1, 5, s, 64, generator=gen, device="cuda").to(dtype)
                out = flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                ref = attention_ref(q, k, v, causal=causal)
                err = (out.float() - ref.float()).abs().max().item()
                check(err <= TOL["flash"][name],
                      f"flash {name} S={s} causal={causal} err {err}")
                cases.append({"s": s, "causal": causal, "dtype": name,
                              "max_abs_err": err})
    return cases


def time_paged(torch, gen, paged_attention, paged_attention_ref) -> dict:
    """Main-path decode shape: 8 slots at smollm width over a 1536-token
    block table, lengths typical of the trace's in-flight mix. Eight pool
    copies (one per layer-like call, 126 MB) rotate so the pages come from
    HBM, as they do across the 32 layers of a real tick."""
    lengths = [116, 399, 1064, 130, 391, 102, 403, 1100]
    b, h, hk, d, page, maxp = 8, 15, 5, 64, 16, 96
    q, kp, vp, table, lens = paged_inputs(torch, gen, b, h, hk, d, page, maxp,
                                          torch.bfloat16, lengths)
    pools = [(kp.clone(), vp.clone()) for _ in range(8)]
    it = iter(range(10 ** 9))

    def kern():
        k_, v_ = pools[next(it) % len(pools)]
        paged_attention(q, k_, v_, table, lens)

    ms = cuda_ms(torch, kern)
    plain_ms = cuda_ms(torch, lambda: paged_attention_ref(q, kp, vp, table,
                                                          lens), iters=20)
    out = paged_attention(q, kp, vp, table, lens)
    err = (out.float() - paged_attention_ref(q, kp, vp, table, lens).float()
           ).abs().max().item()
    es = 2
    live = sum(lengths)
    nbytes = (2 * b * h * d * es + 2 * live * hk * d * es
              + table.numel() * 4 + b * 4)
    flops = 4 * live * h * d
    bound_ms, by = bound(nbytes, flops, "bfloat16")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err,
            "shape": {"B": b, "H": h, "Hkv": hk, "D": d, "page": page,
                      "maxp": maxp, "lengths": lengths, "dtype": "bfloat16"}}


def time_flash(torch, gen, flash_attention, attention_ref) -> dict:
    """Main-path prefill shape: the trace's heavy 1000-token prompt at
    smollm width, bf16, causal. SDPA runs on K/V expanded to 15 heads
    (expanded outside the timed region)."""
    import torch.nn.functional as F
    b, h, hk, s, d = 1, 15, 5, 1000, 64
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(b, hk, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(b, hk, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    ms = cuda_ms(torch, lambda: flash_attention(q, k, v, causal=True))
    plain_ms = cuda_ms(torch, lambda: attention_ref(q, k, v, causal=True),
                       iters=20)
    ke = k.repeat_interleave(h // hk, dim=1)
    ve = v.repeat_interleave(h // hk, dim=1)
    lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, ke, ve, is_causal=True))
    out = flash_attention(q, k, v, causal=True)
    err = (out.float() - attention_ref(q, k, v, causal=True).float()
           ).abs().max().item()
    es = 2
    nbytes = (2 * b * h * s * d + 2 * b * hk * s * d) * es
    flops = 4 * b * h * d * (s * (s + 1) // 2)
    bound_ms, by = bound(nbytes, flops, "bfloat16")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err,
            "shape": {"B": b, "H": h, "Hkv": hk, "S": s, "D": d,
                      "causal": True, "dtype": "bfloat16"}}


# ---------------------------------------------------------------------------
# phase 3: the engine on smollm-360m
# ---------------------------------------------------------------------------
def make_trace(traces, cfg, seed: int):
    trace = traces.synthetic_trace(cfg, num_requests=16, seed=seed,
                                   prompt_lens=(100, 383), heavy_prompt=1000,
                                   light_tokens=32, heavy_tokens=128)
    for req in trace:
        if req.rid in (3, 10):                    # seeded sampled lanes
            req.params = dataclasses.replace(req.params, temperature=0.8)
    return trace


def engine_config(eng_mod, backend: str, capture_logits: bool = True):
    return eng_mod.EngineConfig(num_slots=8, page_size=16, max_cache=1536,
                                prefill_chunk=0, num_classes=3,
                                latency_budget=512.0, attn_backend=backend,
                                capture_logits=capture_logits)


def serve(torch, eng_mod, params, cfg, trace, backend: str):
    """Serve ``trace`` through ``Engine.run`` on the card; returns the
    engine, its stats and the wall seconds (ending in a synchronize)."""
    eng = eng_mod.Engine(params, cfg, engine_config(eng_mod, backend),
                         device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = eng.run(trace, max_ticks=2000)
    torch.cuda.synchronize()
    return eng, stats, time.perf_counter() - t0


def profile_decode(torch, eng_mod, params, cfg, trace, ticks: int = 10) -> dict:
    """Where a decode tick's time goes: fill all 8 slots from ``trace``,
    warm up, then trace ``ticks`` decode ticks with ``torch.profiler``.
    Device busy time is the sum of the kernels' and copies' device time
    (one stream, so they do not overlap); the rest of the window's wall
    time is the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng = eng_mod.Engine(params, cfg, engine_config(eng_mod, "kernel",
                                                    capture_logits=False),
                         device="cuda")
    for req in trace[:eng.ecfg.num_slots]:
        eng.submit(dataclasses.replace(req, arrival=0))
    for _ in range(3):
        eng.step()
    check(all(r is not None for r in eng.slots), "profile: slots not full")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only: an operator's row repeats its kernels' time
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type != DeviceType.CPU and ev.self_device_time_total]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    paged = sum(r[0] for r in rows if "paged_decode_kernel" in r[2])
    return {"ticks": ticks, "wall_ms_per_tick": wall_ms / ticks,
            "device_ms_per_tick": busy / ticks,
            "idle_share": 1.0 - busy / wall_ms if busy else None,
            "paged_kernel_ms_per_tick": paged / ticks,
            "top": [{"kernel": k[:80], "ms_per_tick": ms / ticks,
                     "calls_per_tick": n / ticks} for ms, n, k in rows[:8]]}


def tol_at(ref: np.ndarray, rtol: float, atol: float) -> np.ndarray:
    """The allclose bound ``atol + rtol * |ref|`` (the form of
    tests/test_kernels.py's tolerances)."""
    return atol + rtol * np.abs(ref)


def divergence_ok(torch, model_lib, api, req, i: int, la: np.ndarray,
                  lb: np.ndarray, tok_a: int, tok_b: int, rtol: float,
                  atol: float) -> tuple[bool, Optional[float]]:
    """At the first token ``i`` where the kernel run chose ``tok_a`` and the
    reference ``tok_b`` (their logits ``la`` / ``lb`` already within the
    tolerance): a greedy lane must have had a reference top-2 margin below
    the tolerance; a sampled lane must reproduce both choices when the
    lane's own sampler (same key, same fold index) is re-run on the two
    logit rows, so the flip comes from the logits gap alone (the Gumbel
    noise is indexed by rank, so two near-tied logits that swap rank swap
    their noise)."""
    p = req.params
    if p.is_greedy:
        margin = float(lb[tok_b] - lb[tok_a])
        return margin < float(tol_at(lb[tok_b], rtol, atol)), margin
    spec = api.spec_for([p], "cuda")

    def draw(row):
        lg = torch.as_tensor(row, device="cuda")[None]
        return int(model_lib.sample_tokens(lg, spec, i)[0, 0])

    return draw(la) == tok_a and draw(lb) == tok_b, None


def prefill_vs_fp32(torch, model_lib, params, cfg, kernel_reqs,
                    torch_reqs) -> dict:
    """Each bf16 run's first-token logits against the same bf16 weights run
    in fp32 (torch backend): which rounding lands closer to exact."""
    import copy
    up = copy.deepcopy(params).float()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ref = {r.rid: r for r in torch_reqs}
    err_k = err_t = 0.0
    for r in kernel_reqs:
        cache = model_lib.init_cache(cfg32, 1, len(r.tokens), up.device)
        lg = model_lib.prefill(up, cfg32, r.prompts(up.device), cache,
                               attn_backend="torch")[0][0, -1].cpu().numpy()
        err_k = max(err_k, float(np.abs(r.out_logits[0] - lg).max()))
        err_t = max(err_t, float(np.abs(ref[r.rid].out_logits[0] - lg).max()))
    return {"kernel_run_vs_fp32": err_k, "torch_run_vs_fp32": err_t}


def agreement(torch, model_lib, api, kernel_reqs, torch_reqs, rtol: float,
              atol: float) -> dict:
    """Per request: logits of the kernel run within ``atol + rtol * |ref|``
    of the torch-backend run's up to (and at) the first token where the
    two runs differ; a divergence only where the reference's margin is below
    that tolerance. Returns the measured gaps and the list of violations."""
    ref = {r.rid: r for r in torch_reqs}
    worst, ratio, scale, diverged, bad = 0.0, 0.0, 0.0, [], []
    for ra in kernel_reqs:
        rb = ref[ra.rid]
        n = len(ra.out_tokens)
        check(len(rb.out_tokens) == n and len(ra.out_logits) == n
              and len(rb.out_logits) == n,
              f"request {ra.rid}: token/logit counts differ between backends")
        first = next((i for i in range(n)
                      if ra.out_tokens[i] != rb.out_tokens[i]), n)
        for i in range(min(first + 1, n)):
            la, lb = ra.out_logits[i], rb.out_logits[i]
            check(np.isfinite(la).all(), f"request {ra.rid}: non-finite logits")
            diff = np.abs(la - lb)
            r = float((diff / tol_at(lb, rtol, atol)).max())
            worst = max(worst, float(diff.max()))
            ratio = max(ratio, r)
            scale = max(scale, float(np.abs(lb).max()))
            if r > 1.0:
                bad.append({"rid": ra.rid, "token": i,
                            "max_diff": float(diff.max()), "over_tol": r})
        if first < n:
            ok, margin = divergence_ok(
                torch, model_lib, api, rb, first, ra.out_logits[first],
                rb.out_logits[first], ra.out_tokens[first],
                rb.out_tokens[first], rtol, atol)
            diverged.append({"rid": ra.rid, "at": first, "margin": margin})
            if not ok:
                bad.append({"rid": ra.rid, "token": first, "margin": margin})
    return {"max_logits_diff": worst, "max_diff_over_tol": ratio,
            "max_abs_logit": scale, "diverged": diverged,
            "violations": len(bad), "first_violations": bad[:5]}


def smoke_oneshot_parity(torch, configs, model_lib, eng_mod, api, traces,
                         seed: int) -> int:
    """Smoke-size fp32 engine (kernels on the card) against the port's own
    one-shot ``generate``: token-identical."""
    cfg = configs.get_config("smollm-360m").smoke()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model_lib.init_params(cfg, gen, device="cuda")
    trace = traces.synthetic_trace(cfg, num_requests=6, seed=seed,
                                   temperature=0.8, sample_seed=seed)
    eng = eng_mod.Engine(params, cfg, eng_mod.EngineConfig(num_slots=3,
                                                           max_cache=96),
                         device="cuda")
    eng.run(trace, max_ticks=500)
    check(len(eng.completed) == len(trace), "smoke engine left requests")
    for req in eng.completed:
        probe = api.ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params)
        out = api.generate(params, cfg, probe, max_cache=96)
        check(out.tokens == req.out_tokens,
              f"smoke request {req.rid}: engine {req.out_tokens} != "
              f"one-shot {out.tokens}")
    return len(eng.completed)


def main() -> int:
    ap = argparse.ArgumentParser(description="on-card smoke of the port")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    from repro_torch.models import model as model_lib
    from repro_torch.serve import api, traces
    from repro_torch.serve import engine as eng_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: device and build --------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    print(smi_line)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f}s "
          f"({_build.library_path().name})")

    # -- phase 2: kernels -----------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    paged_cases = check_paged(torch, gen, paged_attention, paged_attention_ref)
    flash_cases = check_flash(torch, gen, flash_attention, attention_ref)
    print("kernel checks: " + json.dumps({"paged": paged_cases,
                                          "flash": flash_cases}))
    paged_t = time_paged(torch, gen, paged_attention, paged_attention_ref)
    flash_t = time_flash(torch, gen, flash_attention, attention_ref)
    print("kernel timing shapes: " + json.dumps(
        {"paged_attention": paged_t["shape"],
         "flash_attention": flash_t["shape"]}))

    # -- phase 3: the engine on smollm-360m -----------------------------------
    cfg = configs.get_config("smollm-360m")
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")
    print(f"smollm-360m: {model_lib.param_count(params) / 1e6:.1f}M params, "
          f"{cfg.num_layers} layers, dtype {cfg.dtype}")
    trace = make_trace(traces, cfg, args.seed)
    paged_attention.launches = 0
    flash_attention.launches = 0
    eng, stats, wall = serve(torch, eng_mod, params, cfg, trace, "kernel")
    paged_n, flash_n = paged_attention.launches, flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(stats["completed"] == len(trace) and not stats["shed"]
          and not stats["rejected"] and not stats["corrupted"],
          f"not every request completed: {stats}")
    for req in eng.completed:
        check(req.finish_reason == "length"
              and len(req.out_tokens) == req.max_new_tokens,
              f"request {req.rid} ended {req.finish_reason} after "
              f"{len(req.out_tokens)}/{req.max_new_tokens} tokens")
    check(paged_n == cfg.num_layers * stats["decode_ticks"],
          f"paged launches {paged_n} != {cfg.num_layers} x "
          f"{stats['decode_ticks']} decode ticks")
    check(flash_n == cfg.num_layers * stats["prefills"],
          f"flash launches {flash_n} != {cfg.num_layers} x "
          f"{stats['prefills']} prefills")
    decode_tokens = stats["tokens"] - stats["completed"]   # seeds come from prefill
    print("engine: " + json.dumps({
        "requests": stats["completed"], "tokens": stats["tokens"],
        "wall_s": wall, "ticks": stats["ticks"],
        "decode_ticks": stats["decode_ticks"], "prefills": stats["prefills"],
        "decode_tok_per_s": decode_tokens / stats["decode_seconds"],
        "ms_per_tick": 1e3 * stats["decode_seconds"] / stats["decode_ticks"],
        "peak_mem_gb": peak_gb, "p50_latency_ticks": stats["p50_latency"],
        "p99_latency_ticks": stats["p99_latency"],
        "goodput": stats["goodput"], "paged_launches": paged_n,
        "flash_launches": flash_n, "capture_logits": True}))
    ref_trace = make_trace(traces, cfg, args.seed)
    eng_ref, stats_ref, wall_ref = serve(torch, eng_mod, params, cfg,
                                         ref_trace, "torch")
    agree = agreement(torch, model_lib, api, eng.completed,
                      eng_ref.completed, *BF16_TOL)
    exact = prefill_vs_fp32(torch, model_lib, params, cfg, eng.completed,
                            eng_ref.completed)
    print("agreement vs torch backend (bf16): " + json.dumps(
        {**agree, "rtol": BF16_TOL[0], "atol": BF16_TOL[1],
         "first_token_logits_vs_fp32": exact,
         "torch_wall_s": wall_ref,
         "torch_ms_per_tick": 1e3 * stats_ref["decode_seconds"]
         / stats_ref["decode_ticks"]}))
    prof = profile_decode(torch, eng_mod, params, cfg,
                          make_trace(traces, cfg, args.seed))
    print("decode tick profile: " + json.dumps(prof))
    del eng, eng_ref, params

    # the same comparison in fp32 at full width and depth: what is left
    # there is summation order, so the bf16 gap above is rounding
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = model_lib.init_params(
        cfg32, torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")
    runs = []
    for backend in ("kernel", "torch"):
        short = [dataclasses.replace(r, params=dataclasses.replace(
            r.params, max_new_tokens=16)) for r in
            make_trace(traces, cfg32, args.seed)[:5]]
        runs.append(serve(torch, eng_mod, params32, cfg32, short, backend)[0])
    agree32 = agreement(torch, model_lib, api, runs[0].completed,
                        runs[1].completed, *FP32_TOL)
    print("agreement vs torch backend (fp32): " + json.dumps(
        {**agree32, "rtol": FP32_TOL[0], "atol": FP32_TOL[1]}))
    del runs, params32
    for name, res in (("bf16", agree), ("fp32", agree32)):
        check(not res["violations"], f"{name} agreement with the torch "
              f"backend failed: {res['first_violations']}")

    n_smoke = smoke_oneshot_parity(torch, configs, model_lib, eng_mod, api,
                                   traces, args.seed)
    print(f"smoke engine == one-shot generate on {n_smoke} requests")

    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:161",
         "launches": paged_n, **{k: paged_t[k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:70",
         "launches": flash_n, **{k: flash_t[k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
