"""Serving entry point of the port: one-shot batched prefill + decode, the
continuous-batching engine on a synthetic open-loop trace, or a fleet of
engine replicas behind the placement router.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke [--device cpu] --batch 4 --steps 32

``--stream`` serves a synthetic arrival trace through the engine, admission
governed by the immune primitives, per-token ``RequestOutput`` deltas
streamed as they are emitted:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --stream --requests 40 --slots 4 [--device cpu] \
        [--policy fifo] [--attn-backend torch] \
        [--temperature 0.8 --top-p 0.9 --sample-seed 7] \
        [--trace shared-prefix|returning-tenant|contention|agentic|fleet] \
        [--no-prefix-sharing] [--pin-pages 8] [--admission reserve] \
        [--prefill-streams 2] [--spec-decode 4 --spec-draft-layers 1] \
        [--logprobs]

``--logprobs`` records each chosen token's logprob (the raw model
distribution) and streams it beside the token (``lp [...]``).

``--replicas N`` (with ``--stream``) serves the trace through the placement
router (``serve.router``): N replicas, one global queue, per-tick placement
under ``--router immune|rr|jsq``. ``--faults "crash@8:r1 rejoin@24:r1"``
scripts tick-exact replica faults (``serve.faults`` grammar); ``--trace
fleet-faults`` sizes a crash + rejoin plan to the trace. ``--journal PATH``
arms the write-ahead journal (with ``--snapshot-dir`` / ``--snapshot-every``,
warm snapshots); a plan with ``poweroff@tick`` (``--trace fleet-poweroff``
sizes one) drives ``serve.durability.run_durable``, which recovers a fresh
fleet from the journal and the snapshot:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --device cpu --stream --trace fleet-faults --replicas 3 \
        --router immune --faults "crash@8:r1 rejoin@24:r1"
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --device cpu --stream --trace fleet-poweroff --replicas 2 \
        --journal serve.wal --snapshot-dir serve-snap --snapshot-every 4

Runs on ``cuda`` unless ``--device cpu`` is given; the weights are random
from ``--seed``. Every family serves: an MoE arch with a zero router bias of
shape (num_layers, E), as the JAX package does without ``--restore``; the
SSM, hybrid, VLM and audio families with the random patches / frames the
traces attach. ``--restore DIR`` serves the newest checkpoint a training
run left in DIR (``launch.train``): its params, and its router bias for an
MoE arch:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --device cpu --batch 2 --steps 8 --restore /tmp/run1
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time

import torch

from repro_torch import configs, prng
from repro_torch.configs.base import TrainConfig
from repro_torch.dist import checkpoint as ckpt
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.serve import decode, durability
from repro_torch.serve import engine as eng_mod
from repro_torch.serve import router as rt_mod
from repro_torch.serve import traces
from repro_torch.serve.faults import FaultInjector, FaultPlan
from repro_torch.train import train_step as ts


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--batch", type=int, default=4,
                    help="one-shot path: prompts in the batch")
    ap.add_argument("--stream", action="store_true",
                    help="continuous-batching engine on a synthetic trace "
                         "instead of a one-shot fixed batch")
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
                    choices=("bursty", "shared-prefix", "returning-tenant",
                             "contention", "agentic", "fleet", "fleet-faults",
                             "fleet-poweroff"),
                    help="synthetic arrival trace: bursty heterogeneous, "
                         "system-prompt traffic (prefix sharing), "
                         "returning-tenant bursts (the pinned prefix cache), "
                         "page-pool contention (preemption), agentic "
                         "multi-turn re-submission (prefix sharing and "
                         "speculative decoding), multi-tenant fleet traffic "
                         "(the placement router), the fleet trace with a "
                         "sized crash + rejoin plan (failover), or with a "
                         "sized poweroff + restart (journal and snapshot "
                         "recovery)")
    ap.add_argument("--replicas", type=int, default=1,
                    help=">1: serve through the placement router "
                         "(serve.router): N replicas, one global queue")
    ap.add_argument("--router", default="immune",
                    choices=rt_mod.POLICIES,
                    help="placement policy: immune (prefix affinity -> "
                         "anergy draining -> least remembered cost), "
                         "round-robin, or join-shortest-queue")
    ap.add_argument("--faults", default=None, metavar="PLAN",
                    help="tick-exact replica faults for a --replicas > 1 "
                         "run, e.g. 'crash@8:r1 rejoin@24:r1 "
                         "slow@4+10:r0:x3' (serve.faults grammar)")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="write-ahead request journal (serve.durability); "
                         "needed by a plan with poweroff@tick (a temporary "
                         "one is made when missing)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="warm-snapshot directory (pinned prefix cache with "
                         "its K/V, immune memories, router books)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="warm-snapshot cadence in fleet ticks (0 = off)")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="journal group commit: one fsync per this many "
                         "ticks (submits fsync at once)")
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
    ap.add_argument("--logprobs", action="store_true",
                    help="record each chosen token's logprob (raw model "
                         "distribution) and stream it with the token")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--show-stream", type=int, default=4,
                    help="print stream deltas for this many request ids")
    ap.add_argument("--restore", default=None, metavar="DIR",
                    help="serve the newest checkpoint of a training run's "
                         "workdir (its params and MoE router bias)")
    return ap


def restore(args, cfg):
    """(params, router bias) of the newest checkpoint in ``args.restore``,
    restored against a fresh train state (the JAX package's layout, fp32
    moments, as ``launch.train`` writes them)."""
    gen = torch.Generator(device=args.device).manual_seed(0)
    state = ts.init_train_state(gen, cfg, TrainConfig(), device=args.device)
    tree, step = ckpt.restore(args.restore, ts.state_tree(state, cfg))
    if tree is None:
        raise SystemExit(f"no usable checkpoint in {args.restore}")
    state = ts.load_state_tree(state, tree, cfg)
    print(f"restored step {step} from {args.restore}")
    bias = state.router.bias if state.router is not None else None
    return state.params, bias


def make_trace(ap, args, cfg) -> list:
    """The ``--trace`` requests; a fleet trace with faults sets
    ``args.faults`` to its sized plan when none was given."""
    sampling = dict(temperature=args.temperature, top_p=args.top_p,
                    top_k=args.top_k, sample_seed=args.sample_seed)
    prefix = max(args.prompt_len, 2 * args.page_size)
    if args.trace == "shared-prefix":
        return traces.shared_prefix_trace(
            cfg, num_requests=args.requests, prefix_len=prefix,
            decode_lens=(args.steps // 2, args.steps), **sampling)
    if args.trace == "returning-tenant":
        return traces.returning_tenant_trace(
            cfg, prefix_len=prefix, bursts=max(2, args.requests // 12),
            decode_lens=(args.steps // 2,), **sampling)
    if args.trace == "contention":
        return traces.contention_trace(
            cfg, num_requests=args.requests, hog_prompt=2 * args.page_size,
            hog_tokens=args.steps, **sampling)
    if args.trace == "agentic":
        return traces.agentic_trace(
            cfg, sessions=max(1, args.requests // 4), turns=4,
            base_prompt=prefix, decode_lens=(args.steps // 2, args.steps),
            **sampling)
    if args.trace.startswith("fleet"):
        fleet_kw = dict(num_requests=args.requests, prefix_len=prefix,
                        decode_lens=(args.steps // 2, args.steps), **sampling)
        if args.trace == "fleet":
            return traces.fleet_trace(cfg, **fleet_kw)
        if args.replicas < 2:
            ap.error(f"--trace {args.trace} needs --replicas > 1 (its faults "
                     f"fire through the router's fault injector)")
        if args.trace == "fleet-faults":
            trace, spec = traces.failover_fleet_trace(
                cfg, replicas=args.replicas, crash_replica=args.replicas - 1,
                **fleet_kw)
        else:
            trace, spec = traces.poweroff_fleet_trace(cfg, **fleet_kw)
        args.faults = args.faults or spec
        return trace
    return traces.synthetic_trace(cfg, num_requests=args.requests,
                                  heavy_tokens=args.steps + 8, **sampling)


def serve_batch(args, params, cfg, bias) -> torch.Tensor:
    """The one-shot path: ``--batch`` prompts of ``--prompt-len`` tokens
    (drawn as the JAX package draws them, ``jax.random.randint`` under key
    1), ``--steps`` greedy tokens each through ``decode.generate``."""
    key = torch.as_tensor(prng.PRNGKey(1).astype("int64"))
    prompts = {"tokens": prng.randint(key, (args.batch, args.prompt_len), 0,
                                      cfg.vocab_size).long().to(args.device)}
    gen = torch.Generator().manual_seed(1)
    if cfg.family == "vlm":
        prompts["patches"] = torch.randn(
            (args.batch, cfg.frontend_tokens, cfg.frontend_dim),
            generator=gen).to(args.device)
    if cfg.family == "audio":
        prompts["frames"] = torch.randn(
            (args.batch, args.prompt_len, cfg.frontend_dim),
            generator=gen).to(args.device)
    t0 = time.perf_counter()
    toks, _ = decode.generate(params, cfg, prompts,
                              max_cache=args.prompt_len + args.steps + 8,
                              steps=args.steps, attn_backend=args.attn_backend,
                              router_bias=bias)
    toks = toks.cpu()
    dt = time.perf_counter() - t0
    print(f"{args.batch} x {args.steps} tokens in {dt:.1f}s; "
          f"{args.batch * args.steps / dt:.1f} tok/s")
    for i, row in enumerate(toks):
        print(f"  seq {i}: {row.tolist()}")
    return toks


def serve_fleet(args, params, cfg, ecfg, bias, trace) -> dict:
    """The ``--replicas`` drive: a router over fresh replicas, under the
    fault plan and the journal when asked; prints the fleet summary."""
    def make_engine():
        return eng_mod.Engine(params, cfg, ecfg, device=args.device,
                              router_bias=bias)

    def make_router():
        injector = FaultInjector(FaultPlan.parse(args.faults),
                                 engine_factory=make_engine) \
            if args.faults else None
        return rt_mod.Router([make_engine() for _ in range(args.replicas)],
                             rt_mod.RouterConfig(policy=args.router),
                             injector=injector)

    poweroff = bool(args.faults) and "poweroff" in args.faults
    if poweroff and not args.journal:
        args.journal = os.path.join(tempfile.mkdtemp(prefix="serve_wal_"),
                                    "journal.wal")
        print(f"poweroff plan with no --journal: journaling to "
              f"{args.journal}")
    if args.faults:
        print(f"fault plan: {args.faults}")
    t0 = time.perf_counter()
    if poweroff:
        _, stats = durability.run_durable(
            make_router, trace, args.journal, snapshot_dir=args.snapshot_dir,
            snapshot_every=args.snapshot_every, sync_every=args.sync_every,
            max_ticks=50 * args.requests)
    else:
        router = make_router()
        if args.journal:
            router.attach_durability(
                durability.RequestJournal(args.journal,
                                          sync_every=args.sync_every),
                snapshot_dir=args.snapshot_dir,
                snapshot_every=args.snapshot_every)
        stats = router.run(trace, max_ticks=50 * args.requests)
        if router.journal is not None:
            router.journal.close()
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[{args.router} x {args.replicas} on {args.device}] "
          f"{stats['completed']} completed / {stats['shed']} shed / "
          f"{stats['rejected']} rejected of {args.requests} requests in "
          f"{stats['ticks']} ticks ({dt:.1f}s wall)")
    print(f"  throughput {stats['throughput']:.2f} tok/tick | p50 "
          f"{stats['p50_latency']:.0f} / p99 {stats['p99_latency']:.0f} "
          f"ticks | goodput {stats['goodput']:.2f}")
    print(f"  placements {stats['placements']} (imbalance "
          f"{stats['placement_imbalance']:.2f}) | affinity "
          f"{stats['affinity_hits']}/{stats['affinity_checks']} hits "
          f"({stats['affinity_tokens']} resident tokens) | "
          f"{stats['drain_skips']} drain skips / "
          f"{stats['drain_overflow']} overflow")
    print(f"  fleet: {stats['prefill_tokens']} prefill tokens | "
          f"{stats['preemptions']} preemptions | "
          f"{stats['replayed_tokens']} tokens replayed | "
          f"{stats['pinned_pages_adopted']} pinned pages adopted")
    for i, p in enumerate(stats["per_replica"]):
        print(f"  replica {i}: {p['completed']} completed | "
              f"p99 {p['p99_latency']:.0f} ticks | pages hw "
              f"{p['pages_hw']}/{p['pages_budget']} | pinned-hit rate "
              f"{p['pinned_hit_rate']:.2f}")
    if args.faults:
        print(f"  failover: {stats['deaths']} deaths / "
              f"{stats['rejoins']} rejoins, "
              f"{stats['replaced_requests']} re-placed "
              f"({stats['retries']} retries, {stats['failed']} "
              f"failed), recovery {stats['recovery_ticks']} ticks, "
              f"health {stats['health']}")
    if args.journal:
        d = stats["durability"]
        j = d["journal"] or {}
        print(f"  durability: {stats.get('restarts', 0)} restarts | "
              f"journal {j.get('records', 0)} records / "
              f"{j.get('syncs', 0)} fsyncs "
              f"(group commit {j.get('sync_every', 1)}) | "
              f"recovered {d['recovered_finished']} finished + "
              f"{d['recovered_open']} replayed | "
              f"{d['recovered_pinned_pages']} pinned pages warm | "
              f"{d['snapshots']} snapshots")
    return stats


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda but no CUDA device is visible "
                 "(pass --device cpu to run the plain versions)")
    if args.replicas > 1 and not args.stream:
        ap.error("--replicas needs --stream (the fleet serves a trace)")
    if args.faults and args.replicas < 2:
        ap.error("--faults needs --stream --replicas > 1 (faults target "
                 "replicas behind the router)")

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    layers.set_mesh_axes(make_host_mesh(device=args.device))
    if args.restore:
        params, bias = restore(args, cfg)
    else:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        params = model_lib.init_params(cfg, gen, device=args.device)
        bias = (torch.zeros((cfg.num_layers, cfg.num_experts),
                            device=args.device)
                if cfg.num_experts else None)
    if not args.stream:
        return serve_batch(args, params, cfg, bias)

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
    trace = make_trace(ap, args, cfg)
    if args.logprobs:
        for req in trace:
            req.params = dataclasses.replace(req.params, logprobs=True)
    if args.replicas > 1:
        return serve_fleet(args, params, cfg, ecfg, bias, trace)

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
        lp = f" lp {[round(x, 6) for x in out.new_logprobs]}" \
            if out.new_logprobs is not None else ""
        print(f"  tick {out.tick:4d} req {out.rid} += {out.new_tokens}{lp}"
              f"{tail}")
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
