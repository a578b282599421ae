"""Serving entry point of the port: the continuous-batching engine on a
synthetic open-loop arrival trace, admission governed by the immune
primitives, per-token ``RequestOutput`` deltas streamed as they are emitted.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --stream --requests 40 --slots 4 [--device cpu] \
        [--policy fifo] [--attn-backend torch] \
        [--temperature 0.8 --top-p 0.9 --sample-seed 7] \
        [--trace shared-prefix|contention|agentic] [--no-prefix-sharing] \
        [--pin-pages 8] [--admission reserve] [--prefill-streams 2] \
        [--spec-decode 4 --spec-draft-layers 1]

Runs on ``cuda`` unless ``--device cpu`` is given; the weights are random
from ``--seed``. Every family serves: an MoE arch (``--arch
granite-moe-3b-a800m``) with a zero router bias of shape (num_layers, E), as
the JAX package does without ``--restore``; the SSM (``mamba2-130m``), the
RG-LRU hybrid (``recurrentgemma-9b``), the VLM (``paligemma-3b``) and audio
(``musicgen-medium``) with the random patches / frames the traces attach
(``traces.attach_modality_inputs``). The one-shot batch path,
``--replicas``, ``--faults``, ``--journal`` and ``--restore`` arrive with
later port slices and are rejected here.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch import configs
from repro_torch.models import model as model_lib
from repro_torch.serve import engine as eng_mod
from repro_torch.serve import traces

LATER = {"replicas": "slice 6 (the fleet router)",
         "faults": "slice 6 (fault injection)",
         "journal": "slice 6 (durability)",
         "restore": "slice 7 (checkpoints)"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--stream", action="store_true",
                    help="continuous-batching engine on a synthetic trace "
                         "(the only mode this port serves so far)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--policy", default="immune", choices=("immune", "fifo"))
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--latency-budget", type=float, default=24.0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=None,
                    help="page-pool size incl. the null page; default fully "
                         "provisioned")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="chunked prefill size; 0 = one-shot prefill")
    ap.add_argument("--prefill-streams", type=int, default=1)
    ap.add_argument("--prefix-sharing", default=True,
                    action=argparse.BooleanOptionalAction)
    ap.add_argument("--attn-backend", default="kernel",
                    choices=("kernel", "torch"),
                    help="route of every hand-written kernel (attention "
                         "and the MoE expert products): the CUDA kernels "
                         "(plain versions on CPU tensors) or the torch "
                         "oracle (gather attention, expert einsums)")
    ap.add_argument("--trace", default="bursty",
                    choices=("bursty", "shared-prefix", "contention",
                             "agentic"),
                    help="synthetic arrival trace: bursty heterogeneous, "
                         "system-prompt traffic (prefix sharing), page-pool "
                         "contention (preemption), or agentic multi-turn "
                         "re-submission with grown prompts (prefix sharing "
                         "and speculative decoding)")
    ap.add_argument("--pin-pages", type=int, default=0)
    ap.add_argument("--admission", default="preempt",
                    choices=("preempt", "reserve"))
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="self-speculative decoding: draft K tokens per tick "
                         "through the first --spec-draft-layers layers and "
                         "verify them in one batched paged step (0 = off; "
                         "ticks with sampled, penalized or logprob residents "
                         "run plain)")
    ap.add_argument("--spec-draft-layers", type=int, default=0,
                    help="truncated draft depth in layers (required > 0 and "
                         "< num_layers with --spec-decode)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--show-stream", type=int, default=4,
                    help="print stream deltas for this many request ids")
    for name in LATER:
        ap.add_argument(f"--{name}", default=None,
                        help=f"not ported yet: {LATER[name]}")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    for name, where in LATER.items():
        if getattr(args, name) is not None:
            ap.error(f"--{name} is not ported yet; it arrives with {where}")
    if not args.stream:
        ap.error("only --stream (the continuous-batching engine) is ported "
                 "so far; the one-shot batch path arrives with slice 6")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda but no CUDA device is visible "
                 "(pass --device cpu to run the plain versions)")

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = model_lib.init_params(cfg, gen, device=args.device)
    bias = (torch.zeros((cfg.num_layers, cfg.num_experts))
            if cfg.num_experts else None)
    lcm = math.lcm(args.page_size, args.prefill_chunk or 1)
    # a VLM's patch prefix occupies cache positions ahead of the prompt
    raw = args.prompt_len + cfg.frontend_tokens + args.steps + 48
    ecfg = eng_mod.EngineConfig(
        num_slots=args.slots, max_cache=-(-raw // lcm) * lcm,
        policy=args.policy, num_classes=3,
        latency_budget=args.latency_budget, page_size=args.page_size,
        num_pages=args.pages, prefill_chunk=args.prefill_chunk,
        prefix_sharing=args.prefix_sharing, attn_backend=args.attn_backend,
        prefill_streams=args.prefill_streams, pin_pages=args.pin_pages,
        admission_mode=args.admission, spec_decode=args.spec_decode,
        spec_draft_layers=args.spec_draft_layers)
    sampling = dict(temperature=args.temperature, top_p=args.top_p,
                    top_k=args.top_k, sample_seed=args.sample_seed)
    if args.trace == "shared-prefix":
        trace = traces.shared_prefix_trace(
            cfg, num_requests=args.requests,
            prefix_len=max(args.prompt_len, 2 * args.page_size),
            decode_lens=(args.steps // 2, args.steps), **sampling)
    elif args.trace == "contention":
        trace = traces.contention_trace(
            cfg, num_requests=args.requests, hog_prompt=2 * args.page_size,
            hog_tokens=args.steps, **sampling)
    elif args.trace == "agentic":
        trace = traces.agentic_trace(
            cfg, sessions=max(1, args.requests // 4), turns=4,
            base_prompt=max(args.prompt_len, 2 * args.page_size),
            decode_lens=(args.steps // 2, args.steps), **sampling)
    else:
        trace = traces.synthetic_trace(cfg, num_requests=args.requests,
                                       heavy_tokens=args.steps + 8, **sampling)

    eng = eng_mod.Engine(params, cfg, ecfg, device=args.device,
                         router_bias=bias)
    t0 = time.perf_counter()
    for out in eng.stream(trace, max_ticks=50 * args.requests):
        if out.rid >= args.show_stream or \
                (not out.new_tokens and not out.finished):
            continue
        tail = f" [{out.finish_reason}, {out.latency_ticks} ticks]" \
            if out.finished and out.latency_ticks is not None \
            else (f" [{out.finish_reason}]" if out.finished else "")
        print(f"  tick {out.tick:4d} req {out.rid} += {out.new_tokens}{tail}")
    stats = eng.stats()
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[{args.policy} on {args.device}, {args.attn_backend} attention] "
          f"{stats['completed']} completed / {stats['shed']} shed / "
          f"{stats['rejected']} rejected of {len(trace)} requests in "
          f"{stats['ticks']} ticks ({dt:.1f}s wall)")
    print(f"  throughput {stats['throughput']:.2f} tok/tick | p50 "
          f"{stats['p50_latency']:.0f} / p99 {stats['p99_latency']:.0f} ticks"
          f" | goodput {stats['goodput']:.2f} | "
          f"{stats['mid_stream_admissions']} mid-stream admissions")
    print(f"  paged KV: {stats['pages_hw']}/{stats['pages_budget']} pages "
          f"high-water | {stats['chunked_prefill_chunks']} prefill chunks | "
          f"{stats['prefills']} one-shot prefills | prefix hit rate "
          f"{stats['prefix_hit_rate']:.2f} | {stats['cow_forks']} CoW forks "
          f"| {stats['preemptions']} preemptions "
          f"({stats['replayed_tokens']} tokens replayed)")
    if args.spec_decode:
        print(f"  spec decode: k={stats['spec_decode']} | "
              f"{stats['spec_ticks']} spec ticks | accept rate "
              f"{stats['spec_accept_rate']:.2f} "
              f"({stats['spec_accepted']}/{stats['spec_drafted']} drafts) "
              f"| {stats['spec_emitted']} tokens emitted speculatively")
    return stats


if __name__ == "__main__":
    main()
