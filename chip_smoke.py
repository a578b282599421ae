#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero; there is no CPU fallback):

1. Device: the card's name and power limit (``nvidia-smi``), then the build
   of every CUDA kernel from ``src/repro_torch/kernels/csrc``.
2. Kernels: each kernel held against its plain PyTorch version on the card —
   paged decode at smollm-360m width (Hkv=5, G=3, D=64, page=16; fp32 and
   bf16; ragged lengths; a +-1e4 null page) plus MHA and MQA cases; the
   paged verify step at the same width for Sq in {1, 2, 5, 7} with ragged
   first positions (page boundaries, rows past the table's capacity), plus
   MHA and MQA, and at Sq = 1 bitwise the decode kernel at lengths = pos + 1;
   both also at D = 256 (paligemma-3b's 8 / 1 heads and gemma-7b's 16 /
   16), at D = 112 (kimi-k2's 64 / 8, on "mma") and at qwen3-4b's decode
   and spec shape (B = 8, GQA 32 / 8 at D = 128 over a 96-page table)
   (``PAGED_CASES``, ``VERIFY_CASES``); decode also at phase 8's shapes,
   musicgen-medium's 24 / 24 heads at D = 64 over a 26-page table and
   paligemma-3b's over a 25-page one, and at minicpm-2b's (B = 8, 36 / 36
   at D = 64, 96 pages); flash attention at H=15, Hkv=5, D=64 for S in {1,
   17, 64, 65, 128, 383, 1000}, at B=2 for D in {16, 32, 128}, S in {64,
   65, 383}, at D = 256 (8 / 1 heads) and D = 112 (64 / 8) for S in {64,
   65, 383, 1000}, at musicgen-medium's 24 / 24 heads for S in {100, 383},
   at gemma-7b's 16 / 16 heads (D = 256) for S in {65, 383}, at qwen3-4b's
   32 / 8 heads (D = 128) for S in {65, 383, 1000} and at minicpm-2b's 36
   / 36 for S = 1000, causal and not; the MoE grouped matmul at granite-moe-3b-a800m's widths (E, C, D, F)
   = (40, 64, 1536, 512), (40, 64, 512, 1536), (40, 320, 1536, 512), (40,
   252, 1536, 512), at (3, 37, 96, 80) and at kimi-k2's (D = 7168, F = 2048
   both ways at C = 4 and 28, over 8 experts), with seeded group sizes that
   include 0 and C, and live values, then NaN, in the rows past each group.
   Tolerances: 1e-5 (paged, verify) / 5e-5 (flash) in fp32, 5e-2 in bf16,
   and for paged decode, verify and flash also the worst row's ||out - ref||
   / ||ref|| (1e-4 fp32, 2e-2 bf16: a split or KV tile lost or mis-weighted
   on late rows fails it); grouped matmul allclose 2e-4 fp32 / 2e-1 bf16
   with its dead rows exactly 0.0. Every kernel but the grid step has two
   bodies (the tensor cores, "mma"; CUDA cores, "cuda_core"), picked from
   dtype, shapes and alignment: bf16 calls take "mma" (the grouped matmul
   only where D and F are multiples of 8, the attention kernels at every
   head dim, all only with 16-byte-aligned pointers), fp32 calls
   "cuda_core"; every check must count its launch under the body
   ``kernel_path`` names. Then each kernel, its plain
   version and a library call (SDPA for flash, ``torch.bmm`` for the
   grouped matmul) are timed with CUDA events at main-path shapes, beside
   the bound from the bytes and flops those shapes need (decode: B=8 at lengths 102-1100; verify: B=8, Sq=5 at the spec
   trace's positions; flash at S = 1000 and 383; at D = 256: decode at
   paligemma-3b's decode shape (B=8, 8 / 1 heads, lengths 304-372) and at
   gemma-7b's (B=8, 16 / 16 heads, lengths 102-1016), verify at
   paligemma's (Sq = 5 from those lengths), flash at S=1000 with 8 / 1 and
   16 / 16 heads beside SDPA; at D = 112 decode and verify at kimi-k2's
   64 / 8 heads over gemma-7b's lengths, flash at S = 1000 beside SDPA;
   at D = 128 decode and verify (Sq = 5) at qwen3-4b's 32 / 8 heads over
   the same lengths and table, flash at S = 1000 and 383; minicpm-2b's
   decode (36 / 36, D = 64) and its flash at S = 1000; training's flash
   at the training shapes of minicpm-2b (2 x 2,048, 36 / 36 at D = 64)
   and qwen3-4b (32 / 8 at D = 128): the forward with its log-sum-exp held
   to ``attention_fwd_ref`` (output rows within ``FLASH_ROW_TOL``, lse
   within ``FLASH_LSE_TOL``) and timed beside the serving call, the
   backward held to its plain version on the kernel's output and lse
   (each gradient's worst row within ``FLASH_BWD_ROW_TOL``) and to the
   plain chain from the plain forward (each gradient whole within
   ``FLASH_CHAIN_TOL``), two calls bitwise equal, then timed
   beside SDPA's backward;
   the grouped matmul at the decode tick's gate / up shape with one tick's
   group sizes and at a 1000-token prefill's (C = 252), and at kimi-k2's
   (384 experts, 7168 x 2048, C = 4 and 28)). No single PyTorch call
   gathers pages,
   so paged decode and verify have no library time; beside them SDPA over
   the same live K / V already gathered into a padded contiguous layout
   (gather not timed) is printed, labelled as not the same function. Every
   kernel also reports ``device_ms`` (``torch.profiler``'s device time a
   call; events time the wrappers' host work where a call's kernel is
   short). Each timed attention shape's output is also held to the
   tolerances above.
3. Engine: smollm-360m at its full published config (32 layers, d_model
   960, 15/5 heads, head_dim 64, d_ff 2560, vocab 49,152, bf16; random
   weights from ``--seed``) serves 16 requests of ``synthetic_trace``
   (prompts 100 / 383, heavy prompt 1000, 32 / 128 new tokens, two seeded
   lanes at temperature 0.8) through ``Engine.run`` with one-shot prefill.
   Every request must finish with its full token budget, the paged kernel
   must have launched 32 x decode ticks and flash 32 x prefills, each call
   on the body its ``kernel_path`` predicts (the tensor cores). The same
   trace is served again on the torch attention backend: per request the
   logits must agree within rtol = atol = 5e-2 (the allclose form of
   tests/test_kernels.py) up to the first token where the two runs differ,
   and such a divergence is allowed only where the reference's own margin
   (on the sampled lanes: of the tempered, Gumbel-perturbed scores) is below
   that tolerance. The same comparison runs in fp32 at full width on five
   requests within 1e-3. ``torch.profiler`` traces ten decode ticks with all
   eight slots busy (device time by kernel, the device's idle share). A
   smoke-size fp32 engine (smollm-360m, and granite-moe-3b-a800m with a
   seeded nonzero router bias) must also emit exactly its one-shot
   ``generate`` tokens, with logits within 1e-3.
4. Speculative decoding: full-width smollm-360m cut to 16 layers
   (``SPEC_LAYERS``; bf16, ``--seed`` weights) made draft-friendly at depth
   8 serves a 12-request ``agentic_trace``
   (4 sessions x 3 turns, 32 / 64 new tokens, greedy) on 8 slots with
   chunked prefill (16) and prefix sharing, once with ``spec_decode=4,
   spec_draft_layers=8`` and once without, both on the kernel backend.
   Every request must finish with its budget, spec ticks must run, the
   verify kernel must have launched 16 x spec ticks and the decode kernel
   16 x plain ticks + 8 x 4 x spec ticks, each on its predicted body (the
   tensor cores), and the two runs' streams must agree by the rule of
   phase 3 (bf16 rtol = atol = 1e-1; a divergence only where the non-spec
   run's top-2 margin is below that tolerance).
5. Slot groups: at full width (16 layers), two parents on one 200-token prompt
   — one ``n=2``, one ``best_of=3``, temperature 0.8, seeded — with chunked
   prefill and prefix sharing. Each parent must assemble with its lanes in the
   reference's rank order, shared prompt pages must be adopted, and each lane
   must agree (same rule) with the same member served alone.
   ``torch.profiler`` traces ten spec ticks and ten plain ticks with all eight
   slots of the spec trace busy (one-shot prefill, 128 new tokens).
6. MoE serving: granite-moe-3b-a800m at its published widths cut to 16 layers
   (``MOE_LAYERS``; 32 published; d_model 1536, 24/8 heads, 40 experts top-8,
   expert d_ff 512, vocab 49,155, capacity factor 1.25, bf16; random weights
   from ``--seed``; zero router bias) serves 12 requests of
   ``synthetic_trace`` (prompts 100 / 250 / 400, 32 new tokens, two seeded
   lanes at temperature 0.8) on 8 slots with one-shot prefill, on the kernel
   and the torch backends. Every request must finish with its budget; the
   grouped matmul must have launched exactly 3 x 16 x (decode ticks +
   prefills), paged decode 16 x decode ticks and flash 16 x prefills, each
   kernel (here and in the spec run below) every time on the body its
   ``kernel_path`` predicts. The same trace on the same weights in fp32 must
   agree between the two backends by the rule of phase 3 at 1e-3; in bf16
   (where routing flips at near-tied experts move the logits of any two
   roundings beyond the 1e-1 rule, see ``MOE_BF16_SLACK``) the kernel run must
   be within that rule of the fp32 run or no farther from it than the torch
   run is, within 25%. It prints ms per tick, decode tok/s, peak memory, the
   mean expert load CV and the prefill drop fraction, and a ``torch.profiler``
   window of ten ticks. Then four greedy requests are served on the same
   weights made draft-friendly at depth 8, with ``spec_decode=4`` and without:
   verify runs the grouped matmul at C = 320, and the streams must agree by
   the same rule.

7. The paper's VLSI extraction pipeline (``repro_torch.core.vlsi``): the
   grid-step kernel against its plain version, exactly (max error 0), at
   (16, 32), (40, 32), (33, 16), (64, 128), (8, 256), (1, 7), (80, 128)
   and (4096, 4096) through ``grid_step``, and through ``grid_step_planes``
   on the stacks (4, 80, 128) (the observer's), (4, 40, 32), (3, 7, 5) (odd
   H * W) and (4, 4096, 4096), and on stacks that start 1 or 2 words past
   a 16-byte boundary; on extractor planes and on any int32 (negative
   labels, cond values outside {0, 1}); every call on the body
   ``kernel_path`` predicts ("vec4", 16-byte accesses, or "scalar"). Its
   time (events and the profiler's device time), plain time and bound at
   (80, 128), (4, 80, 128), (4, 40, 32), (4096, 4096) and (4, 4096, 4096).
   Then ``run_extraction`` on the
   NAND layout (64 agents, seeds 1 and 2) on the card and on the CPU: the
   blackboard, cycle count and agents must be equal bit for bit. The
   paper's Fig. 3 run: the DFF tile (32 transistors, 80 x 128) with 175
   agents, seed 0, ``record=True`` — cycles beside the JAX package's 2,396,
   populations at cycles 0, 5, 20, 50, 100, 200 and the last, and the Fig.
   3 shape (finder crash, labeller spike, labellers die out, all agents end
   as propagators). The Fig. 4 sweep (NAND at 64, 128, 256 agents, seeds 0
   and 1) with its log-log slope. Every netlist must be equivalent to the
   serial oracle, and every run must launch the grid-step kernel exactly
   cycles + 1 times (the observer's test on its four label planes, one
   launch, before each cycle and at the end), every time on the "vec4"
   body, and no other kernel. ``torch.profiler`` traces 20 cycles of the DFF
   run from cycle 100. Last, the immune straggler scheduler simulates a
   16-worker, 400-step fleet with one straggler on the card and on the CPU
   (relative 1e-6) and must beat the static assignment.

8. The SSM, hybrid, VLM and audio families at their published configs (one cut
   in depth, below), bf16, random weights from ``--seed``, 8 slots, page 16
   (``FAMILY_TRAFFIC``): mamba2-130m (24 layers, d_model 768, state 128, chunk
   64; 8 requests, prompts 128 / 256 / 100 / 200, chunked prefill 64 for the
   aligned ones), recurrentgemma-9b (cut to 20 layers, ``FAMILY_LAYERS``: 6
   Griffin groups and the 2-layer tail of the published 38; d_model 4096, lru
   4096, window 2048, MQA at D = 256; 6 requests, prompts 100 / 600 and one of
   2,500 whose ring buffer wraps in prefill), paligemma-3b (18 layers, d_model
   2048, 8 / 1 heads at D = 256, 256 patches of width 1152; 8 requests,
   prompts 32 / 100 after the prefix) and musicgen-medium (48 layers, d_model
   1536, 24 / 24 heads at D = 64, frames of width 128; 8 requests, prompts 100
   / 383); 32 new tokens, two lanes sampled at temperature 0.8. Checks: (a)
   every request finishes with its budget; (b) in fp32 at full width (the bf16
   weights upcast in place) each engine stream agrees with one-shot
   ``generate`` by phase 3's rule at ``FP32_TOL``; (c) paligemma and musicgen:
   the kernel backend against the torch backend, at ``FP32_TOL`` in fp32 and
   ``BF16_TOL`` in bf16, where a miss in bf16 passes only if the kernel run is
   the closer of the two to fp32 arithmetic on the same weights and within
   ``BF16_FP32_CAP`` x ``BF16_TOL`` of it (``bf16_rule``: musicgen's 48 layers
   put the torch backend's bf16 score rounding ~2% past the rule; phase 2
   holds the kernels at both models' decode and prefill shapes); (d) mamba's
   chunked prefill against one-shot in fp32: logits within 1e-4, greedy lanes
   token-equal, a sampled lane parting only where phase 3's rule explains the
   flip by the logit gap (``SSM_CHUNK_TOL``; each flip's seed, tokens and gaps
   printed under ``sampled_flips``); (e) launch counts: paged decode
   num_layers x decode ticks and flash num_layers x prefills on musicgen,
   paged decode 18 x decode ticks at D = 256 (on "mma") and no flash on
   paligemma (its prefix-LM prefill takes the torch path), no kernel on
   mamba and recurrentgemma, every call on the body ``kernel_path``
   predicts; (f) a
   ``torch.profiler`` window of ten decode ticks per model (printed, not
   checked).

9. The serving fleet (``serve.router``, ``serve.faults``,
   ``serve.durability``): full-width smollm-360m cut to 16 layers
   (``FLEET_LAYERS``; bf16, ``--seed`` weights; fp32 where said) in
   replicas of the JAX benchmark's config (2 slots,
   page 16, chunked prefill 16, immune admission; max_cache 64 and 4 pinned
   pages for routing and failover, 96 and 8 for durability), every replica
   on the one card, sharing the weights. (a) Routing: 24 requests of
   ``fleet_trace`` (3 tenants, 32-token prefixes) under rr, jsq and immune
   at 2 replicas and immune at 1: every rid terminates, per-rid tokens are
   equal across the four runs, the immune run takes affinity hits; a
   profiled window of five fleet ticks. (b) Failover:
   ``failover_fleet_trace`` at 3 replicas (a crash and a cold rejoin) plus
   a pressure shock of 2 pages on replica 0, fault-free immune, then immune
   and rr under the plan in bf16, and the fault-free and faulted immune
   pair in fp32: one death detected and one rejoin, zero lost rids, every
   completed rid's tokens equal to the fault-free run's, the device memory
   after the rejoin less than one replica's pool above what it was before
   the crash (the fenced replica's pool is freed). (c) Durability: the
   durability trace (2 tenants, 64-token prefixes, 8 new tokens, hot
   tenant 0.9), power off after the arrival horizon and restart 4 ticks
   later under ``run_durable`` at 2 replicas, warm (snapshot every 2
   ticks) and cold (journal only), in a temporary directory: zero lost and
   zero duplicated rids, tokens equal to the fault-free run, pinned pages
   restored warm, and the warm restart re-prefilling at most 0.5x the cold
   one's tokens; seconds a snapshot, snapshot bytes, journal records and
   fsyncs printed. Every run counts its launches from 0: paged decode once
   a decode tick a layer of every replica (fallen ones included), flash
   once a one-shot prefill a layer (none: every fleet prompt prefills in
   chunks), nothing else, every bf16 call on ``mma``.
10. Training (``repro_torch.train``): attention through the flash kernels
   (forward with its log-sum-exp, the deterministic backward) in bf16, the
   torch route in fp32: (c) one
   train step from one state on one
   batch on the card and on the CPU, fp32 with TF32 off, at the CPU tests'
   smoke sizes (smollm-360m and granite-moe-3b-a800m): ``sample_batch``
   bitwise equal, the loss within 1e-5, every gradient leaf within 1e-5 of
   its max-abs, the new state and metrics within 5e-5 (AdamW eps 1e-4, as
   the CPU parity test). (a) Full-width smollm-360m (32 layers, bf16) at
   the reference CLI's batch and sequence, 8 x 128, through ``Trainer``:
   run A uninterrupted (8 steps), run B killed by ``failure_at=6`` past its
   step-4 checkpoint, run B2 resuming it in the same workdir; every param
   and AdamW leaf of A and B2 ``torch.equal``; A's losses finite and the
   last below the first; ``launch.serve --restore`` (in-process, torch
   route) serves 2 greedy requests from A's checkpoint token-equal to A's
   model served from memory; one step profiled (wall, device ms, idle
   share, top device ops), one step under deterministic mode (warn only:
   what it flags is printed), the trainer's checkpoints and restore timed,
   a checkpoint's bytes. (b) granite-moe-3b-a800m at ``MOE_LAYERS``, 6
   ``train_step`` at 4 x 128: every loss and load CV finite, the router
   bias moved off zero, per-step load CV and drop fraction printed.
   Launches, counted from 0 for each run (``train_launches``): A, B, B2 and
   (b), bf16 at head dim 64, launch the flash forward layers x steps times
   and its backward layers x steps times, all on ``mma``; (c) (fp32) and
   the ``--restore`` serving (torch route) none; no serving kernel
   anywhere.

11. The mesh (``repro_torch.dist.sharding``, ``launch.mesh``,
   ``launch.dryrun``), with no kernel on its path: (a) ``make_host_mesh()``
   on the card — one NCCL rank, a 1 x 1 ('data', 'model') mesh — and the
   card's memory beside the dry-run's 80 GB constant; (b) full-width
   smollm-360m params and AdamW state, and granite-moe-3b-a800m params at
   ``MOE_LAYERS`` with expert parallel, placed by the sharding rules: every
   leaf a CUDA DTensor whose local shard is ``torch.equal`` to the plain
   leaf; (c) ``serve_step`` on the placed smollm-360m against the plain
   model, bf16, B = 8, a dense cache of 1,024, 16 greedy steps: tokens
   equal, logits ``torch.equal`` (if not, the largest gap is printed and
   held at phase 3's rtol = atol = 1e-1); (d) ``python -m
   repro_torch.launch.dryrun --arch smollm-360m --shape decode_32k``, and
   with ``--multi-pod``, in subprocesses: every record ``ok`` with 256 /
   512 chips, the key terms printed.

12. gemma-7b at its full published config (28 layers, d_model 3072, 16 / 16
   heads at head_dim 256, d_ff 24,576 GeGLU, vocab 256,000, tied and scaled
   embeddings, bf16, 8.54 B parameters; random weights from ``--seed``)
   serves 8 requests of ``synthetic_trace`` (prompts 100 / 383 and the
   heavy class's 1,000, 32 new tokens, two seeded lanes at temperature 0.8)
   on phase 3's engine config (8 slots, page 16, max_cache 1536, one-shot
   prefill), on the kernel and the torch backends. Every request finishes
   with its budget; the kernel run launches flash 28 x prefills and paged
   decode 28 x decode ticks, every call on "mma" (the D = 256 tensor-core
   bodies), the torch run nothing; logits agree by ``bf16_rule`` (phase 3's
   rule, else the kernel run within ``BF16_FP32_CAP`` of the same weights
   served in fp32 on the torch backend, which then runs, and no farther
   from them than ``GEMMA_BF16_SLACK`` x the torch run), with the ratios
   printed. ``torch.profiler`` windows of ten decode ticks (all eight slots
   busy) and of one prefill of the 1,000-token prompt.
13. kimi-k2-1t-a32b at its published width cut to one of its 61 layers
   (``KIMI_LAYERS``; d_model 7168, 64 / 8 heads at head_dim 112, 384
   experts top-8, expert d_ff 2048, vocab 163,840, immune router with zero
   bias, bf16, 18.2 B parameters; random weights from ``--seed``) serves
   phase 12's 8 requests on phase 3's engine config, on the kernel and the
   torch backends. Every request finishes with its budget; the kernel run
   launches flash once a prefill, paged decode once a decode tick and the
   grouped matmul 3 x (ticks + prefills), every call on "mma" (the D = 112
   tensor-core bodies), the torch run nothing. Phase 6's MoE rule: the
   same weights built afresh in fp32 from the seed agree between the two
   backends within 1e-3 (the kernel run on the CUDA-core bodies), and the
   bf16 kernel run is no farther from the fp32 run than the bf16 torch run
   is, within ``MOE_BF16_SLACK``. Peak memory of each build and run;
   ``torch.profiler`` windows of ten decode ticks and of one 1,000-token
   prefill.

14. qwen3-4b at its full published config (36 layers, d_model 2560, GQA 32
   / 8 at head_dim 128 with qk-norm, d_ff 9,728, vocab 151,936, rope theta
   1e6, tied, bf16, 4.02 B parameters; random weights from ``--seed``):
   (a) phase 12's 8 requests on phase 3's engine config on both backends,
   flash 36 x prefills and paged decode 36 x decode ticks on "mma" (the
   torch run nothing), logits by ``bf16_rule``; (b) four greedy requests
   on the same weights made draft-friendly at depth 8, ``spec_decode=4``
   and without: verify 36 x spec ticks on "mma", the streams by phase 3's
   rule; (c) preemption by page exhaustion, the JAX package's bar
   (``benchmarks/serve_engine.py`` ``run_preemption``) at full width: a
   16-request ``contention_trace`` (``PREEMPT_TRACE``) on 8 slots, page
   16, max_cache 1,536, chunked prefill ``PREEMPT_CHUNK`` and a pool of
   ``PREEMPT_PAGES`` pages, under ``admission_mode`` "reserve" and
   "preempt": every request with its budget, at least one preemption and
   one replayed token, preempt's ``concurrency_hw`` above reserve's, the
   schedule the CPU predicts (``PREEMPT_PLAN``), each preempted request's
   stream held to its uninterrupted run (the full pool) by phase 3's bf16
   rule; in fp32 (the same weights upcast, the CUDA-core bodies) the
   preempt run up to the first completion of a request that replayed
   tokens, its schedule so far bf16's, and the preempted requests done by
   then token for token with their uninterrupted runs, logits within 1e-3;
   concurrency, p50 / p99 in ticks, goodput, preemptions and replayed
   tokens printed; (d) ``torch.profiler`` windows of ten decode ticks and
   of a 1,000-token prefill, as in phase 12.
15. minicpm-2b at its full published config (40 layers, d_model 2304, MHA
   36 / 36 at head_dim 64, d_ff 5,760, vocab 122,753, tied, bf16, 2.72 B
   parameters): (a) phase 12's 8 requests on both backends, flash 40 x
   prefills and paged decode 40 x ticks on "mma", logits by ``bf16_rule``,
   profiled windows as in phase 14; (b) three ``train_step`` calls at 4 x
   128 under a WSD ``TrainConfig`` whose warmup, plateau and decay each
   take a step, AdamW's moments in fp32 (``WSD_STEPS``): losses finite,
   each step's learning rate the CPU's ``optimizer.schedule``, peak
   memory, flash forward and backward 40 x 3 launches on "mma"
   (``train_launches``); one smoke-size fp32 step on the
   card and on the CPU under WSD (torch route, no launch), held as phase 10
   (c) holds smollm-360m.

Phases 3-15 each set every launch count to 0 just before they drive their
path and read the counts just after. Phases 3, 12, 14 and 15 and every
phase-8 model but recurrentgemma-9b run at full depth; phases 4-6, 9, 13
and recurrentgemma-9b at the depths above, so the whole run stays inside
1,200 s (phase 13 also so that its weights fit the card).

The second-to-last lines are one JSON object ``{"kernels": [...]}`` and the
``nvidia-smi`` name/power line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"paged": {"float32": 1e-5, "bfloat16": 5e-2},
       "flash": {"float32": 5e-5, "bfloat16": 5e-2},
       "gmm": {"float32": 2e-4, "bfloat16": 2e-1}}
# Flash beside TOL["flash"]: the worst (batch, head, query row) of
# ||out - ref|| / ||ref|| over the head dim. A late row's values at S = 1000
# are ~1/sqrt(S) ~ 0.03, below the absolute bf16 limit, while one 64-row KV
# tile dropped from such a row moves this ratio by ~8/sqrt(S) ~ 0.25.
FLASH_ROW_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the flash backward against its plain version (which repeats its
# arithmetic in fp32 on the card): the worst row of each gradient by
# row_rel_err, bf16 outputs and summation order apart. A row's norm is
# floored at FLASH_BWD_ROW_FLOOR: some gradient rows are zero (the first
# query's dq), where the kernel's round-off (~1e-8 an entry from N(0, 1)
# inputs) would divide by nothing
FLASH_BWD_ROW_TOL, FLASH_BWD_ROW_FLOOR = 2e-2, 1e-2
# the training forward's log-sum-exp against the plain one, relative to the
# largest |lse| (at least 1): round-off is ~1e-6 of it, while a row missing
# one 64-row KV tile of 2,048 moves its lse by ~3e-2
FLASH_LSE_TOL = 1e-5
# the backward from the kernel's forward against the plain chain (the plain
# backward from the plain forward's output and lse), each gradient whole:
# ||got - plain|| / ||plain||. The two forwards' outputs differ by the
# kernel's bf16 P (~40% of the output's entries one bf16 step apart), which
# reaches every gradient through Delta = rowsum(dO o O) and reads ~2e-3,
# while an lse off by 0.03 reads ~3e-2. Row by row it cannot tell them
# apart: where a row's attention is nearly one-hot, dP - Delta cancels and
# that Delta step alone moves dq's row by ~0.06-0.09
FLASH_CHAIN_TOL = 1e-2
# Paged decode and verify beside TOL["paged"], the same ratio and limits: a
# late row over ~1,000 positions has values ~0.03, below the absolute bf16
# limit, while one split dropped or weighted 1.1x in the merge moves it by
# far more than 2e-2.
PAGED_ROW_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (rtol, atol) on logits. bf16 at full depth: the torch backend rounds the
# scores and the probabilities to bf16 before their products (the JAX
# package's _sdpa), the kernels keep both in fp32 (as the TPU kernels do);
# through 32 layers that gap alone reaches ~1.2x the 5e-2 kernel tolerance,
# while the same comparison in fp32 agrees to ~1e-5.
BF16_TOL = (1e-1, 1e-1)
FP32_TOL = (1e-3, 1e-3)
# MoE in bf16: routing is discontinuous, so any change of rounding flips
# near-tied expert choices and moves granite-moe-3b-a800m's logits by ~2x
# BF16_TOL — the JAX package's own arithmetic (the torch backend) as much as
# the kernels, and swapping only the expert GEMM (cuBLAS bf16 einsum for the
# grouped-matmul kernel, bitwise equal in fp32) as well (on an H100 80GB
# HBM3 at 700 W, four bf16 arrangements of kernels and einsums all landed
# 0.24-0.26 from fp32 arithmetic, 2.0-2.2x the allclose bound). The MoE phase
# therefore holds kernel-vs-torch agreement in fp32 at full width (FP32_TOL)
# and, in bf16, holds the kernel run within the bf16 rule of fp32 arithmetic
# or no farther from it than the torch run, with this slack (the four
# arrangements spread by ~10%).
MOE_BF16_SLACK = 1.25
# Phase 8's bf16 kernel-vs-torch rule (``bf16_rule``) where the two runs
# part past BF16_TOL: the kernel run no farther from fp32 arithmetic than
# the torch run, and never past this multiple of BF16_TOL from it
# (musicgen-medium's 48 layers: kernel run 1.158x, torch run 1.277x on an
# NVIDIA H100 80GB HBM3 at 700 W)
BF16_FP32_CAP = 1.25
# Phase 12's slack on "no farther from fp32 than the torch run". On
# full-width gemma-7b (28 layers, d_model 3072) every bf16 arrangement of
# the same weights lands 1.10-1.17x BF16_TOL from fp32 arithmetic, exact
# fp32 attention included, and any two of them 1.29-1.37x apart
# (``tools/dense_rounding.py`` on an NVIDIA H100 80GB HBM3 at 700 W: torch
# backend with fp32 attention 1.103, torch backend 1.142, kernel backend
# 1.166), so which run lands closer is the rest of the bf16 arithmetic, not
# the attention: the three spread by 1.057x, and this allows about twice
# that. BF16_FP32_CAP still bounds the kernel run.
GEMMA_BF16_SLACK = 1.10


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


def device_rows(torch, warm, run) -> tuple:
    """``run()`` under ``torch.profiler``, after ``warm()`` in the
    profiler's warm-up step; both end in a sync. It traces the card's
    activity alone: only device rows are read, and tracing the host's
    operators as well inflated a window's wall time (a qwen3-4b decode
    tick 134.5 ms so traced, 97.6 not, in two calls on an NVIDIA H100 80GB
    HBM3 at 700 W). Returns (run's wall
    ms, [(device ms, launches, name)] of the device rows with device
    time, largest first). On an H100 the
    profiler left launches unrecorded: the first ones of a session (a DFF
    window one grid-step call short), which the warm-up step now takes,
    and, late in a long process, some of a short window's (4 of 20, or all
    20), which ``device_ms`` detects and measures again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    done = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: done.append(p.key_averages())) \
            as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    # device-side rows only: the step's own range spans the whole window
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in done[0]
            if ev.device_type != DeviceType.CPU and ev.self_device_time_total
            and not ev.key.startswith("ProfilerStep")]
    return wall_ms, sorted(rows, reverse=True)


def device_ms(torch, fn, iters: int = 20):
    """Mean device time of one call of ``fn``: its kernels' device time,
    summed by ``torch.profiler`` over ``iters`` calls after ``iters`` warm-up
    calls. CUDA events around back-to-back calls read the host's launch rate
    instead where a call's host time (a wrapper's checks, allocation and
    ``ctypes`` call) exceeds its kernel's. A window counts only where every
    kernel it recorded ran a whole multiple of ``iters`` times (a call
    launches the same kernels each time); up to three windows, else None
    (not measured)."""
    def calls():
        for _ in range(iters):
            fn()

    for _ in range(3):
        _, rows = device_rows(torch, calls, calls)
        if rows and all(n % iters == 0 for _, n, _ in rows):
            return sum(ms for ms, _, _ in rows) / iters
        print(f"device_ms: window of {iters} calls dropped, launches "
              f"recorded {[(n, k[:40]) for _, n, k in rows]}", file=sys.stderr)
    return None


# what the kernels line reports of each timed shape (LIB_TIMED: also the
# library call's device time, where one PyTorch call computes the function)
TIMED = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
         "device_ms")
LIB_TIMED = TIMED + ("library_device_ms",)


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def row_rel_err(out, ref, floor: float = 1e-30) -> float:
    """The worst row of ``||out - ref|| / max(||ref||, floor)`` over the
    last dim."""
    o, r = out.float(), ref.float()
    return ((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(floor)
            ).max().item()


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


# (B, H, Hkv, D, page, maxp): smollm-360m's width, MHA, MQA, then the wider
# head dims of the served models: paligemma-3b (D = 256, MQA 8 / 1),
# gemma-7b (D = 256, MHA 16 / 16) and kimi-k2 (D = 112, GQA 64 / 8); then
# phase 8's decode shapes: musicgen-medium (24 / 24 heads at D = 64, G = 1,
# a 26-page table) and paligemma-3b (a 25-page table); last, the decode
# shapes of phases 14 and 15: qwen3-4b (GQA 32 / 8 at D = 128) and
# minicpm-2b (MHA 36 / 36 at D = 64), 8 slots over a 96-page table; each
# with the split count ``split_rule`` gives the engine's calls
PAGED_CASES = [(8, 15, 5, 64, 16, 96), (3, 4, 4, 64, 8, 4),
               (2, 8, 1, 128, 16, 3), (8, 8, 1, 256, 16, 32),
               (3, 16, 16, 256, 16, 24), (3, 64, 8, 112, 16, 24),
               (8, 24, 24, 64, 16, 26), (8, 8, 1, 256, 16, 25),
               (8, 32, 8, 128, 16, 96), (8, 36, 36, 64, 16, 96)]
# the verify step also at qwen3-4b's spec shape in phase 14 (B = 8, 32 / 8
# heads at D = 128, the 96-page table)
VERIFY_CASES = [(8, 15, 5, 64, 16, 32), (3, 4, 4, 64, 8, 6),
                (2, 8, 1, 128, 16, 4), (4, 8, 1, 256, 16, 24),
                (2, 16, 16, 256, 16, 12), (2, 64, 8, 112, 16, 12),
                (8, 32, 8, 128, 16, 96)]


def check_paged(torch, gen, paged_attention, paged_attention_ref,
                kernel_path) -> list:
    """``PAGED_CASES`` in fp32 and bf16 at ragged lengths:
    within TOL["paged"] and PAGED_ROW_TOL, each launch counted under the body
    ``kernel_path`` names, and the +-1e4 null page never read."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for (b, h, hk, d, page, maxp) in PAGED_CASES:
            q, kp, vp, table, lengths = paged_inputs(
                torch, gen, b, h, hk, d, page, maxp, dtype)
            name = str(dtype).split(".")[-1]
            path = kernel_path(dtype, head_dim=d)
            p0 = paged_attention.launches_by_path[path]
            out = paged_attention(q, kp, vp, table, lengths)
            torch.cuda.synchronize()
            check(paged_attention.launches_by_path[path] == p0 + 1,
                  f"paged {name} {(b, h, hk, d, page)} did not take the "
                  f"{path} body")
            ref = paged_attention_ref(q, kp, vp, table, lengths)
            err = (out.float() - ref.float()).abs().max().item()
            rel = row_rel_err(out, ref)
            check(err <= TOL["paged"][name],
                  f"paged {name} {(b, h, hk, d, page)} err {err}")
            check(rel <= PAGED_ROW_TOL[name],
                  f"paged {name} {(b, h, hk, d, page)} row error {rel}")
            kp[0], vp[0] = 0.0, 0.0                   # clean null page
            clean = paged_attention(q, kp, vp, table, lengths)
            check(torch.equal(clean, out),
                  f"paged {name}: null-page contents leaked into the output")
            cases.append({"shape": [b, h, hk, d, page, maxp], "dtype": name,
                          "path": path, "max_abs_err": err,
                          "row_rel_err": rel})
    return cases


def verify_inputs(torch, gen, b, sq, h, hk, d, page, maxp, dtype, pos=None):
    """Verify-step inputs: every page a row can reach is mapped; by default
    ragged first positions with one lane at a page boundary and one whose
    last rows run past the table's capacity; a +-1e4 null page."""
    dev = "cuda"
    num_pages = b * maxp + 1
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(num_pages, page, hk, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(num_pages, page, hk, d, generator=gen, device=dev).to(dtype)
    kp[0], vp[0] = 1e4, -1e4
    if pos is None:
        pos = torch.randint(0, maxp * page - sq + 1, (b,), generator=gen,
                            device=dev).cpu()
        pos[0] = page
        pos[-1] = maxp * page - max(sq - 2, 1)
    pos = torch.as_tensor(pos).to(torch.int32)
    perm = (torch.randperm(num_pages - 1, generator=gen, device=dev) + 1).cpu()
    table = torch.zeros(b, maxp, dtype=torch.int32)
    n = 0
    for i, p0 in enumerate(pos.tolist()):
        npg = min(maxp, -(-(p0 + sq) // page))
        table[i, :npg] = perm[n:n + npg].to(torch.int32)
        n += npg
    return q, kp, vp, table.to(dev), pos.to(dev)


def check_verify(torch, gen, verify, verify_ref, paged_attention,
                 kernel_path) -> list:
    """``VERIFY_CASES`` for Sq in {1, 2, 5, 7} in fp32 and bf16:
    within TOL["paged"] and PAGED_ROW_TOL, each launch counted under the body
    ``kernel_path`` names, the null page never read, and at
    Sq = 1 bitwise the decode kernel at lengths = pos + 1."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for (b, h, hk, d, page, maxp) in VERIFY_CASES:
            for sq in (1, 2, 5, 7):
                q, kp, vp, table, pos = verify_inputs(
                    torch, gen, b, sq, h, hk, d, page, maxp, dtype)
                path = kernel_path(dtype, head_dim=d)
                p0 = verify.launches_by_path[path]
                out = verify(q, kp, vp, table, pos)
                torch.cuda.synchronize()
                check(verify.launches_by_path[path] == p0 + 1,
                      f"verify {name} {(b, sq, h, hk, d, page)} did not "
                      f"take the {path} body")
                ref = verify_ref(q, kp, vp, table, pos)
                err = (out.float() - ref.float()).abs().max().item()
                rel = row_rel_err(out, ref)
                check(err <= TOL["paged"][name],
                      f"verify {name} {(b, sq, h, hk, d, page)} err {err}")
                check(rel <= PAGED_ROW_TOL[name],
                      f"verify {name} {(b, sq, h, hk, d, page)} row error "
                      f"{rel}")
                if sq == 1:
                    dec = paged_attention(q[:, 0].contiguous(), kp, vp,
                                          table, pos + 1)
                    check(torch.equal(out[:, 0], dec),
                          f"verify {name} Sq=1 differs from the decode kernel")
                kp[0], vp[0] = 0.0, 0.0               # clean null page
                check(torch.equal(verify(q, kp, vp, table, pos), out),
                      f"verify {name}: null-page contents leaked")
                cases.append({"shape": [b, sq, h, hk, d, page, maxp],
                              "dtype": name, "path": path,
                              "max_abs_err": err, "row_rel_err": rel})
    return cases


# (B, H, Hkv, D, S): smollm-360m's width at the engine's prompt lengths
# (both tile edges: 64, 65), then every other head dim at two sequences,
# then paligemma-3b's D = 256 (8 / 1 heads) and kimi-k2's D = 112 (64 / 8),
# then musicgen-medium's prefills in phase 8 (24 / 24 heads, G = 1),
# gemma-7b's in phase 12 (16 / 16 heads at D = 256; S = 1000 is timed),
# qwen3-4b's in phase 14 (GQA 32 / 8 at D = 128) and minicpm-2b's 1,000-token
# prefill in phase 15 (36 / 36 heads at D = 64)
FLASH_CASES = ([(1, 15, 5, 64, s) for s in (1, 17, 64, 65, 128, 383, 1000)]
               + [(2, 15, 5, d, s) for d in (16, 32, 128)
                  for s in (64, 65, 383)]
               + [(1, h, hk, d, s) for h, hk, d in ((8, 1, 256), (64, 8, 112))
                  for s in (64, 65, 383, 1000)]
               + [(1, 24, 24, 64, s) for s in (100, 383)]
               + [(1, 16, 16, 256, s) for s in (65, 383)]
               + [(1, 32, 8, 128, s) for s in (65, 383, 1000)]
               + [(1, 36, 36, 64, 1000)])


def check_flash(torch, gen, flash_attention, attention_ref,
                kernel_path) -> list:
    """Every case in fp32 and bf16, causal and not, within TOL["flash"] and
    FLASH_ROW_TOL; each launch must be counted under the body
    ``kernel_path`` names."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for (b, h, hk, d, s) in FLASH_CASES:
            for causal in (True, False):
                q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
                k = torch.randn(b, hk, s, d, generator=gen, device="cuda").to(dtype)
                v = torch.randn(b, hk, s, d, generator=gen, device="cuda").to(dtype)
                path = kernel_path(dtype, head_dim=d)
                p0 = flash_attention.launches_by_path[path]
                out = flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                check(flash_attention.launches_by_path[path] == p0 + 1,
                      f"flash {name} did not take the {path} body")
                ref = attention_ref(q, k, v, causal=causal)
                err = (out.float() - ref.float()).abs().max().item()
                rel = row_rel_err(out, ref)
                check(err <= TOL["flash"][name],
                      f"flash {name} B={b} D={d} S={s} causal={causal} "
                      f"err {err}")
                check(rel <= FLASH_ROW_TOL[name],
                      f"flash {name} B={b} D={d} S={s} causal={causal} "
                      f"row error {rel}")
                cases.append({"b": b, "d": d, "s": s, "causal": causal,
                              "dtype": name, "path": path,
                              "max_abs_err": err, "row_rel_err": rel})
    return cases


def dense_sdpa(torch, q, k_pages, v_pages, table, bound) -> dict:
    """SDPA over the live K / V of each lane, gathered beforehand (not
    timed) into a padded contiguous (B, H, L, D) layout with K / V expanded
    to the q heads, L the longest lane's live positions; ``bound`` (B, Sq)
    the last position each query row attends. Not the same function as a
    paged kernel (no page gather, padded positions read): a yardstick only.
    q: (B, Sq, H, D)."""
    import torch.nn.functional as F
    b, sq, h, d = q.shape
    hk = k_pages.shape[2]
    length = int(bound.max().item()) + 1
    idx = table.long()

    def dense(pages):
        x = pages[idx].reshape(b, -1, hk, d)[:, :length]
        return x.transpose(1, 2).repeat_interleave(h // hk, dim=1).contiguous()

    k, v = dense(k_pages), dense(v_pages)
    qq = q.transpose(1, 2).contiguous()
    mask = (torch.arange(length, device=q.device)[None, None, :]
            <= bound[:, :, None])[:, None]

    def fn():
        return F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)

    return {"ms": cuda_ms(torch, fn), "device_ms": device_ms(torch, fn),
            "padded_positions": length,
            "note": "not the same function: no page gather, padded K/V"}


# paligemma-3b's decode shape in phase 8: 8 slots, MQA 8 / 1 at D = 256, a
# 400-token block table, 256 patches + a 32 / 100-token prompt + 16 tokens
PALIGEMMA_DECODE = dict(h=8, hk=1, d=256, maxp=25,
                        lengths=[304, 372, 304, 372, 304, 372, 304, 372])
# verify at the same heads and table, Sq = 5 from those lengths (no main path
# verifies at D = 256: speculation is refused for the VLM family)
PALIGEMMA_VERIFY = dict(h=8, hk=1, d=256, maxp=25,
                        positions=PALIGEMMA_DECODE["lengths"])
# gemma-7b's decode shape in phase 12: 8 slots, MHA 16 / 16 at D = 256 over
# its 1536-token block table, lengths of the trace's in-flight mix
GEMMA_DECODE = dict(h=16, hk=16, d=256, maxp=96,
                    lengths=[116, 399, 1016, 130, 391, 102, 403, 1016])
# kimi-k2's decode shape in phase 13: 8 slots, GQA 64 / 8 at D = 112 over the
# same 1536-token block table and in-flight lengths (its trace is gemma-7b's)
KIMI_DECODE = dict(h=64, hk=8, d=112, maxp=96,
                   lengths=GEMMA_DECODE["lengths"])
# verify at the same heads and table, Sq = 5 from those lengths (no main path
# verifies at D = 112: phase 13 does not speculate)
KIMI_VERIFY = dict(h=64, hk=8, d=112, maxp=96,
                   positions=KIMI_DECODE["lengths"])
# qwen3-4b's decode shape in phase 14: 8 slots, GQA 32 / 8 at D = 128 over
# the same 1536-token block table and in-flight lengths (phase 14 serves
# gemma-7b's trace); verify at its heads, Sq = 5 from those lengths (phase
# 14's spec run verifies at this width)
QWEN_DECODE = dict(h=32, hk=8, d=128, maxp=96,
                   lengths=GEMMA_DECODE["lengths"])
QWEN_VERIFY = dict(h=32, hk=8, d=128, maxp=96,
                   positions=QWEN_DECODE["lengths"])
# minicpm-2b's decode shape in phase 15: 8 slots, MHA 36 / 36 at D = 64,
# the same table and lengths
MINICPM_DECODE = dict(h=36, hk=36, d=64, maxp=96,
                      lengths=GEMMA_DECODE["lengths"])


def time_paged(torch, gen, paged_attention, paged_attention_ref, h=15, hk=5,
               d=64, maxp=96,
               lengths=(116, 399, 1064, 130, 391, 102, 403, 1100)) -> dict:
    """Main-path decode shape (default: 8 slots at smollm width over a
    1536-token block table, lengths typical of the trace's in-flight mix).
    Eight pool copies (one per layer-like call, 126 MB at smollm) rotate so
    the pages come from HBM, as they do across the layers of a real
    tick."""
    lengths = list(lengths)
    b, page = len(lengths), 16
    q, kp, vp, table, lens = paged_inputs(torch, gen, b, h, hk, d, page, maxp,
                                          torch.bfloat16, lengths)
    pools = [(kp.clone(), vp.clone()) for _ in range(8)]
    it = iter(range(10 ** 9))

    def kern():
        k_, v_ = pools[next(it) % len(pools)]
        paged_attention(q, k_, v_, table, lens)

    ms = cuda_ms(torch, kern)
    dev_ms = device_ms(torch, kern)
    plain_ms = cuda_ms(torch, lambda: paged_attention_ref(q, kp, vp, table,
                                                          lens), iters=20)
    dense = dense_sdpa(torch, q[:, None], kp, vp, table, (lens - 1)[:, None])
    out = paged_attention(q, kp, vp, table, lens)
    ref = paged_attention_ref(q, kp, vp, table, lens)
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref)
    what = f"timed paged decode {(b, h, hk, d, page, maxp)}"
    check(err <= TOL["paged"]["bfloat16"], f"{what} err {err}")
    check(rel <= PAGED_ROW_TOL["bfloat16"], f"{what} row error {rel}")
    es = 2
    live = sum(lengths)
    nbytes = (2 * b * h * d * es + 2 * live * hk * d * es
              + table.numel() * 4 + b * 4)
    flops = 4 * live * h * d
    bound_ms, by = bound(nbytes, flops, "bfloat16")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": None, "dense_sdpa": dense, "bound_ms": bound_ms,
            "bound_by": by, "max_abs_err": err, "row_rel_err": rel,
            "shape": {"B": b, "H": h, "Hkv": hk, "D": d, "page": page,
                      "maxp": maxp, "lengths": lengths, "dtype": "bfloat16"}}


def verify_positions(traces, cfg, seed: int) -> list:
    """Verify timing positions: the spec trace's first 8 requests, 16
    tokens into their decode."""
    return [len(r.tokens) + 16 for r in spec_trace(traces, cfg, seed)[:8]]


def time_verify(torch, gen, verify, verify_ref, positions: list, h=15, hk=5,
                d=64, maxp=32) -> dict:
    """Spec-tick verify shape: 8 slots, Sq = 5 (k = 4 drafts), by default
    at smollm width over a 32-page table (max_cache 512), first positions
    from the spec trace. Eight pool copies rotate so the pages come from
    HBM."""
    b, sq, page = len(positions), 5, 16
    q, kp, vp, table, pos = verify_inputs(torch, gen, b, sq, h, hk, d, page,
                                          maxp, torch.bfloat16, positions)
    pools = [(kp.clone(), vp.clone()) for _ in range(8)]
    it = iter(range(10 ** 9))

    def kern():
        k_, v_ = pools[next(it) % len(pools)]
        verify(q, k_, v_, table, pos)

    ms = cuda_ms(torch, kern)
    dev_ms = device_ms(torch, kern)
    plain_ms = cuda_ms(torch, lambda: verify_ref(q, kp, vp, table, pos),
                       iters=20)
    rows = pos.long()[:, None] + torch.arange(sq, device=pos.device)
    dense = dense_sdpa(torch, q, kp, vp, table,
                       rows.clamp(max=maxp * page - 1))
    out, ref = verify(q, kp, vp, table, pos), verify_ref(q, kp, vp, table, pos)
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref)
    check(err <= TOL["paged"]["bfloat16"], f"timed verify err {err}")
    check(rel <= PAGED_ROW_TOL["bfloat16"], f"timed verify row error {rel}")
    es = 2
    # each row r attends positions 0 .. pos + r (capped at the table)
    live = sum(min(p0 + sq, maxp * page) for p0 in positions)
    attended = sum(min(p0 + r + 1, maxp * page) for p0 in positions
                   for r in range(sq))
    nbytes = (2 * b * sq * h * d * es + 2 * live * hk * d * es
              + table.numel() * 4 + b * 4)
    flops = 4 * attended * h * d
    bound_ms, by = bound(nbytes, flops, "bfloat16")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": None,
            "library_note": "no single PyTorch call gathers pages",
            "dense_sdpa": dense, "bound_ms": bound_ms, "bound_by": by,
            "max_abs_err": err,
            "shape": {"B": b, "Sq": sq, "H": h, "Hkv": hk, "D": d,
                      "page": page, "maxp": maxp, "pos": positions,
                      "dtype": "bfloat16"}}


def time_flash(torch, gen, flash_attention, attention_ref, h=15, hk=5, d=64,
               lengths=(1000, 383)) -> dict:
    """Main-path prefill shape (default: the trace's heavy 1000-token
    prompt at smollm width, bf16, causal; then its 383-token prompt, under
    ``s383``). SDPA runs on K/V expanded to the q heads (expanded outside
    the timed region)."""
    import torch.nn.functional as F
    res = {}
    for s in lengths:
        b = 1
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
        dev_ms = device_ms(torch, lambda: flash_attention(q, k, v, causal=True))
        lib_dev_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True))
        out = flash_attention(q, k, v, causal=True)
        ref = attention_ref(q, k, v, causal=True)
        err = (out.float() - ref.float()).abs().max().item()
        rel = row_rel_err(out, ref)
        check(err <= TOL["flash"]["bfloat16"],
              f"timed flash D={d} S={s} err {err}")
        check(rel <= FLASH_ROW_TOL["bfloat16"],
              f"timed flash D={d} S={s} row error {rel}")
        es = 2
        nbytes = (2 * b * h * s * d + 2 * b * hk * s * d) * es
        flops = 4 * b * h * d * (s * (s + 1) // 2)
        bound_ms, by = bound(nbytes, flops, "bfloat16")
        res[s] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                  "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
                  "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err,
                  "shape": {"B": b, "H": h, "Hkv": hk, "S": s, "D": d,
                            "causal": True, "dtype": "bfloat16"}}
    first, *rest = lengths
    return {**res[first], **{f"s{s}": res[s] for s in rest}}


def time_flash_bwd(torch, gen, h: int, hk: int, d: int, s: int = 2048,
                   b: int = 2) -> dict:
    """Training's flash kernels at a training shape (default minicpm-2b's
    batch and sequence, 2 x 2,048, bf16, causal). The forward with its
    log-sum-exp (the instance training runs): its output against
    ``attention_fwd_ref`` within ``FLASH_ROW_TOL`` and its lse within
    ``FLASH_LSE_TOL``, then its time (events and device), its bound (q, k, v
    read, out and lse written once; 4 D flops a kept pair) and the serving
    call's device time at the same shape (no lse). The backward on the
    kernel's own output and lse: each gradient's worst row against
    ``attention_bwd_ref`` on the same inputs within ``FLASH_BWD_ROW_TOL``,
    and each gradient whole against the plain backward of the plain
    forward's output and lse (the whole chain) within ``FLASH_CHAIN_TOL``,
    two calls bitwise equal, then its
    time (events and device), its bound (the four products, 8 D flops a
    kept pair; q, k, v, o, do, lse read and dq, dk, dv written once), the
    plain version's, and SDPA's backward alone on K / V expanded to the q
    heads (the yardstick; the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ops import _launch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = rnd(b, h, s, d), rnd(b, hk, s, d), rnd(b, hk, s, d), \
        rnd(b, h, s, d)
    what = f"flash training H={h}/{hk} D={d} S={s}"
    lse = torch.empty(b, h, s, device="cuda")
    o = _launch(q, k, v, True, lse)
    ref_o, ref_lse = attention_fwd_ref(q, k, v)
    fwd_rel = row_rel_err(o, ref_o)
    lse_err = (lse - ref_lse).abs().max().item()
    lse_scale = max(ref_lse.abs().max().item(), 1.0)
    check(fwd_rel <= FLASH_ROW_TOL["bfloat16"],
          f"{what}: forward row error {fwd_rel}")
    check(lse_err <= FLASH_LSE_TOL * lse_scale,
          f"{what}: lse error {lse_err} (largest |lse| {lse_scale})")
    fwd_nbytes = (2 * b * h * s * d + 2 * b * hk * s * d) * 2 + 4 * b * h * s
    fwd_bound, fwd_by = bound(fwd_nbytes, 4 * b * h * d * (s * (s + 1) // 2),
                              "bfloat16")
    forward = {
        "ms": cuda_ms(torch, lambda: _launch(q, k, v, True, lse)),
        "device_ms": device_ms(torch, lambda: _launch(q, k, v, True, lse)),
        "serving_device_ms": device_ms(
            torch, lambda: flash_attention(q, k, v, causal=True)),
        "bound_ms": fwd_bound, "bound_by": fwd_by,
        "max_abs_err": (o.float() - ref_o.float()).abs().max().item(),
        "row_rel_err": fwd_rel, "lse_abs_err": lse_err}

    got = flash_attention_bwd(q, k, v, o, do, lse)
    again = flash_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"{what}: two backward calls differ")
    ref = attention_bwd_ref(q, k, v, o, do, lse)
    errs = [row_rel_err(x, r, FLASH_BWD_ROW_FLOOR) for x, r in zip(got, ref)]
    check(max(errs) <= FLASH_BWD_ROW_TOL,
          f"{what}: backward worst rows {errs}")
    chain = attention_bwd_ref(q, k, v, ref_o, do, ref_lse)
    chain_errs = [((x.float() - r.float()).norm() / r.float().norm()).item()
                  for x, r in zip(got, chain)]
    check(max(chain_errs) <= FLASH_CHAIN_TOL,
          f"{what}: backward from the kernel's forward against the plain "
          f"chain, relative errors {chain_errs}")
    del ref_o, ref_lse, chain
    ms = cuda_ms(torch, lambda: flash_attention_bwd(q, k, v, o, do, lse))
    dev_ms = device_ms(torch, lambda: flash_attention_bwd(q, k, v, o, do,
                                                          lse))
    plain_ms = cuda_ms(torch, lambda: attention_bwd_ref(q, k, v, o, do, lse),
                       iters=3, warmup=1)
    leaves = [q.clone().requires_grad_(),
              k.repeat_interleave(h // hk, dim=1).requires_grad_(),
              v.repeat_interleave(h // hk, dim=1).requires_grad_()]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)

    def sdpa_bwd():
        torch.autograd.grad(out, leaves, do, retain_graph=True)

    lib_ms = cuda_ms(torch, sdpa_bwd)
    lib_dev_ms = device_ms(torch, sdpa_bwd)
    nbytes = 2 * (4 * b * h * s * d + 4 * b * hk * s * d) + 4 * b * h * s
    flops = 8 * b * h * d * (s * (s + 1) // 2)
    bound_ms, by = bound(nbytes, flops, "bfloat16")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": max(
                (x.float() - r.float()).abs().max().item()
                for x, r in zip(got, ref)),
            "row_rel_err": dict(zip(("dq", "dk", "dv"), errs)),
            "chain_rel_err": dict(zip(("dq", "dk", "dv"), chain_errs)),
            "forward": forward,
            "shape": {"B": b, "H": h, "Hkv": hk, "S": s, "D": d,
                      "causal": True, "dtype": "bfloat16"}}


# (E, C, D, F): granite-moe-3b-a800m's gate/up and down products at decode
# (8 slots x top-8, dropless: C = 64), the gate/up product at verify (8 x 5
# rows: C = 320) and at a 1000-token prefill (cf 1.25: C = 252), odd sizes,
# then kimi-k2's expert widths both ways (gate / up D = 7168 -> F = 2048,
# down 2048 -> 7168) at its decode capacity (``moe.capacity``: 4) and its
# 1000-token prefill's (28), over 8 of its 384 experts so that the plain
# version's fp32 copy of the weights stays small
GMM_SHAPES = [(40, 64, 1536, 512), (40, 64, 512, 1536), (40, 320, 1536, 512),
              (40, 252, 1536, 512), (3, 37, 96, 80),
              (8, 4, 7168, 2048), (8, 4, 2048, 7168), (8, 28, 7168, 2048),
              (8, 28, 2048, 7168)]


def decode_group_sizes(torch, gen, e: int, tokens: int, k: int):
    """Group sizes of one decode tick: each of ``tokens`` lanes routes to
    ``k`` distinct experts, drawn uniformly from ``gen``."""
    picks = torch.rand(tokens, e, generator=gen, device="cuda").argsort(-1)
    return torch.bincount(picks[:, :k].reshape(-1), minlength=e).to(
        torch.int32)


def check_gmm(torch, gen, moe_gmm, gmm_ref, kernel_path) -> list:
    """Every shape in fp32 and bf16, seeded group sizes with 0 and C, rows
    past each group holding live values, then NaN: allclose to the plain
    version at the tolerances of tests/test_kernels.py, dead rows and empty
    groups exactly 0.0; each launch counted under the body ``kernel_path``
    names."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL["gmm"][name]
        for (e, c, d, f) in GMM_SHAPES:
            x = torch.randn(e, c, d, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(e, d, f, generator=gen, device="cuda")
                 / d ** 0.5).to(dtype)
            sizes = torch.randint(0, c + 1, (e,), generator=gen,
                                  device="cuda", dtype=torch.int32)
            sizes[0], sizes[-1] = 0, c
            dead = torch.arange(c, device="cuda")[None, :] >= sizes[:, None]
            path = kernel_path(dtype, d, f)
            for dead_rows in ("live values", "NaN"):
                if dead_rows == "NaN":
                    x[dead] = float("nan")
                p0 = moe_gmm.launches_by_path[path]
                out = moe_gmm(x, w, sizes)
                torch.cuda.synchronize()
                check(moe_gmm.launches_by_path[path] == p0 + 1,
                      f"gmm {name} {(e, c, d, f)} did not take the {path} "
                      f"body")
                ref = gmm_ref(x, w, sizes)
                diff = (out.float() - ref.float()).abs()
                err = diff.max().item()
                over = (diff / (tol + tol * ref.float().abs())).max().item()
                check(over <= 1.0, f"gmm {name} {(e, c, d, f)} dead rows "
                      f"{dead_rows}: err {err} ({over:.2f}x the allclose "
                      f"bound)")
                check(bool((out[dead] == 0).all()),
                      f"gmm {name} {(e, c, d, f)} dead rows {dead_rows}: a "
                      f"dead row is not exactly 0")
                cases.append({"shape": [e, c, d, f], "dtype": name,
                              "path": path, "dead_rows_hold": dead_rows,
                              "max_abs_err": err,
                              "dead_rows": int(dead.sum())})
    return cases


def time_gmm_at(torch, gen, moe_gmm, gmm_ref, shape, sizes,
                copies: int = 4) -> dict:
    """The gate / up product at ``shape`` (bf16) with ``sizes`` live rows
    per expert, dead rows of x zero as the dispatch leaves them. ``copies``
    weight copies (four: 252 MB at granite-moe's widths) rotate so the
    weights come from HBM, as across the 32 layers of a tick (one copy of
    kimi-k2's 11.3 GB is far past the 50 MB L2). ``torch.bmm`` on the same
    (E, C, D) x (E, D, F) computes every row of every expert."""
    e, c, d, f = shape
    x = torch.randn(e, c, d, generator=gen, device="cuda").to(torch.bfloat16)
    x = torch.where(torch.arange(c, device="cuda")[None, :, None]
                    < sizes[:, None, None], x, torch.zeros((), device="cuda",
                                                           dtype=x.dtype))
    ws = [torch.randn(e, d, f, generator=gen, device="cuda").div_(d ** 0.5)
          .to(torch.bfloat16) for _ in range(copies)]
    it = iter(range(10 ** 9))

    def w():
        return ws[next(it) % copies]

    ms = cuda_ms(torch, lambda: moe_gmm(x, w(), sizes))
    plain_ms = cuda_ms(torch, lambda: gmm_ref(x, w(), sizes), iters=20)
    lib_ms = cuda_ms(torch, lambda: torch.bmm(x, w()))
    dev_ms = device_ms(torch, lambda: moe_gmm(x, w(), sizes))
    lib_dev_ms = device_ms(torch, lambda: torch.bmm(x, w()))
    err = (moe_gmm(x, ws[0], sizes).float()
           - gmm_ref(x, ws[0], sizes).float()).abs().max().item()
    es = 2
    live = sizes.cpu().tolist()
    rows, experts = sum(live), sum(1 for n in live if n)
    # each live expert's weights, the live rows of x and group_sizes read
    # once; the whole (E, C, F) output written once (its dead rows are zeros
    # the contract requires)
    nbytes = experts * d * f * es + rows * d * es + e * c * f * es + e * 4
    flops = 2 * rows * d * f
    bound_ms, by = bound(nbytes, flops, "bfloat16")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err,
            "shape": {"E": e, "C": c, "D": d, "F": f, "dtype": "bfloat16",
                      "group_sizes": live, "live_rows": rows,
                      "live_experts": experts,
                      "library": "torch.bmm over all C rows"}}


def time_gmm(torch, gen, moe_gmm, gmm_ref) -> dict:
    """Decode shape of the gate / up product (E=40, C=64, D=1536, F=512)
    with one decode tick's group sizes (8 lanes x top-8 over 40 experts);
    then (under ``prefill``) a 1000-token prompt's gate / up product at its
    capacity C = 252 (cf 1.25), its 8,000 assignments drawn uniformly and
    cut at C; then the same two at kimi-k2's widths in phase 13 (under
    ``kimi`` and ``kimi_prefill``: 384 experts, D = 7168, F = 2048, C = 4
    and 28)."""
    res = time_gmm_at(torch, gen, moe_gmm, gmm_ref, (40, 64, 1536, 512),
                      decode_group_sizes(torch, gen, 40, 8, 8))
    pre = decode_group_sizes(torch, gen, 40, 1000, 8).clamp(max=252)
    res["prefill"] = time_gmm_at(torch, gen, moe_gmm, gmm_ref,
                                 (40, 252, 1536, 512), pre)
    res["kimi"] = time_gmm_at(torch, gen, moe_gmm, gmm_ref,
                              (384, 4, 7168, 2048),
                              decode_group_sizes(torch, gen, 384, 8, 8), 1)
    pre = decode_group_sizes(torch, gen, 384, 1000, 8).clamp(max=28)
    res["kimi_prefill"] = time_gmm_at(torch, gen, moe_gmm, gmm_ref,
                                      (384, 28, 7168, 2048), pre, 1)
    return res


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


def profile_decode(torch, eng_mod, params, cfg, reqs, ecfg,
                   ticks: int = 10, router_bias=None) -> dict:
    """Where a decode tick's time goes: fill all 8 slots of an engine built
    from ``ecfg`` with ``reqs``, warm up (three ticks, then one in the
    profiler's warm-up step), then trace ``ticks`` ticks (plain or spec,
    whichever ``ecfg`` runs) with ``torch.profiler``. Device busy
    time is the sum of the kernels' and copies' device time (one stream, so
    they do not overlap); the rest of the window's wall time is the device's
    idle share."""
    eng = eng_mod.Engine(params, cfg, ecfg, device="cuda",
                         router_bias=router_bias)
    for req in reqs[:eng.ecfg.num_slots]:
        eng.submit(dataclasses.replace(req, arrival=0, out_tokens=[],
                                       out_logits=[]))
    for _ in range(3):
        eng.step()
    check(all(r is not None for r in eng.slots), "profile: slots not full")
    torch.cuda.synchronize()

    def run():
        for _ in range(ticks):
            eng.step()

    wall_ms, rows = device_rows(torch, eng.step, run)
    check(all(r is not None for r in eng.slots),
          "profile: a request finished inside the window")
    busy = sum(r[0] for r in rows)
    # paged_decode / paged_verify: the split launches and their merges
    ours = {name: sum(r[0] for r in rows if name in r[2]) / ticks
            for name in ("paged_decode", "paged_verify", "moe_gmm")}
    return {"ticks": ticks, "spec_ticks": eng.spec_ticks,
            "wall_ms_per_tick": wall_ms / ticks,
            "device_ms_per_tick": busy / ticks,
            "idle_share": 1.0 - busy / wall_ms if busy else None,
            "kernel_ms_per_tick": ours,
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
                         seed: int, arch: str) -> dict:
    """Smoke-size fp32 engine (kernels on the card) against the port's own
    one-shot ``generate``: token-identical, logits within 1e-3 (an MoE arch
    with a seeded nonzero router bias)."""
    cfg = configs.get_config(arch).smoke()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model_lib.init_params(cfg, gen, device="cuda")
    bias = None
    if cfg.num_experts:
        bias = 0.5 * torch.randn(cfg.num_layers, cfg.num_experts,
                                 generator=gen, device="cuda")
    trace = traces.synthetic_trace(cfg, num_requests=6, seed=seed,
                                   temperature=0.8, sample_seed=seed)
    eng = eng_mod.Engine(params, cfg, eng_mod.EngineConfig(
        num_slots=3, max_cache=96, capture_logits=True), device="cuda",
        router_bias=bias)
    eng.run(trace, max_ticks=500)
    check(len(eng.completed) == len(trace), f"{arch} smoke engine left "
          f"requests")
    worst = 0.0
    for req in eng.completed:
        probe = api.ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params)
        out = api.generate(params, cfg, probe, max_cache=96,
                           capture_logits=True, router_bias=bias)
        check(out.tokens == req.out_tokens,
              f"{arch} smoke request {req.rid}: engine {req.out_tokens} != "
              f"one-shot {out.tokens}")
        for la, lb in zip(req.out_logits, probe.out_logits):
            check(bool((np.abs(la - lb) <= tol_at(lb, *FP32_TOL)).all()),
                  f"{arch} smoke request {req.rid}: logits off one-shot by "
                  f"{float(np.abs(la - lb).max())}")
            worst = max(worst, float(np.abs(la - lb).max()))
    return {"arch": arch, "requests": len(eng.completed),
            "max_logits_diff": worst}


# ---------------------------------------------------------------------------
# phases 4 and 5: speculative decoding and slot groups at full width
# ---------------------------------------------------------------------------
SPEC_K, SPEC_DEPTH = 4, 8

# Depth cuts that keep the whole run inside its 1,200 s limit on a slower
# host (nine phases at full depth took 910 s of command time on an NVIDIA
# H100 80GB HBM3 at 700.00 W, and a host 1.6x slower was seen; with phase
# 12, 966.7 s on a host where phase 7 ran 1.4x slower than before): these
# earlier paths run fewer layers of their published configs, every width
# unchanged. Phases 3 (the main path), 12, 14 and 15 run at full depth, and
# so do the other phase-8 families.
SPEC_LAYERS = 16                          # phases 4-5, smollm-360m: 32
MOE_LAYERS = 16                           # phases 6, 10b, 11, granite: 32
FAMILY_LAYERS = {"recurrentgemma-9b": 20}  # phase 8: 38 (6 groups + tail)
FLEET_LAYERS = 16                         # phase 9, smollm-360m: 32
# Phase 13, kimi-k2-1t-a32b: 1 of its 61 layers, every width published. One
# layer holds 18.20 B parameters (the experts 3 x 384 x 7168 x 2048 = 16.91
# B, the tied embedding 1.17 B, attention 0.116 B): 36.4 GB in bf16, 72.8 GB
# in fp32. Two layers take 70.4 GB in bf16 before the 22.5 GB fp32 draw of
# an expert leaf (``layers._normal`` draws in fp32, then casts): no fit on
# one 80 GB card.
KIMI_LAYERS = 1


def spec_trace(traces, cfg, seed: int):
    """12 agentic requests: 4 sessions x 3 turns on 256-token conversations
    grown by 32 / 64 tokens a turn, 32 / 64 new tokens, greedy."""
    return traces.agentic_trace(cfg, sessions=4, turns=3, base_prompt=256,
                                grow_lens=(32, 64), decode_lens=(32, 64),
                                turn_gap=8, seed=seed)


def spec_config(eng_mod, spec: bool, capture_logits: bool = True):
    return eng_mod.EngineConfig(
        num_slots=8, page_size=16, max_cache=512, prefill_chunk=16,
        prefix_sharing=True, num_classes=3, latency_budget=512.0,
        attn_backend="kernel", capture_logits=capture_logits,
        spec_decode=SPEC_K if spec else 0,
        spec_draft_layers=SPEC_DEPTH if spec else 0)


def reset_counts(counters: dict) -> None:
    """Every launch count, and every count by body, to 0."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_path"):
            fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)


def path_counts(counters: dict) -> dict:
    """{kernel: {body: launches}} for the kernels with more than one body."""
    return {name: dict(fn.launches_by_path) for name, fn in counters.items()
            if hasattr(fn, "launches_by_path")}


def main_bodies(torch, kernel_paths: dict, cfg) -> dict:
    """The body every bf16 call of each kernel takes on ``cfg``'s main
    paths, as the wrappers' ``kernel_path`` predict it: paged decode and
    verify, flash, and the grouped matmul at the expert widths."""
    bf, d = torch.bfloat16, cfg.head_dim
    return {"paged_attention": kernel_paths["paged"](bf, head_dim=d),
            "paged_attention_verify": kernel_paths["paged"](bf, head_dim=d),
            "flash_attention": kernel_paths["flash"](bf, head_dim=d),
            "moe_gmm": kernel_paths["gmm"](bf, cfg.d_model, cfg.d_ff)}


def check_bodies(counters: dict, n: dict, what: str, bodies: dict) -> dict:
    """On a bf16 main path every launch of each kernel with more than one
    body must have taken the body in ``bodies`` (``main_bodies``); returns
    the counts by body."""
    paths = path_counts(counters)
    for name, by in paths.items():
        want = bodies[name]
        check(by[want] == n[name] and sum(by.values()) == n[name],
              f"{what}: {name} launches by body {by} of {n[name]}; every "
              f"bf16 call must take the {want} body")
    return paths


def run_counted(torch, counters: dict, serve_fn):
    """Call ``serve_fn`` with every launch count set to 0 just before and
    read just after; returns (its result, wall seconds, {kernel:
    launches}). The counts by body stay on the wrappers for
    ``path_counts``."""
    reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve_fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {name: fn.launches for name, fn in counters.items()}


def run_summary(stats, wall: float) -> dict:
    ticks = stats["decode_ticks"] + stats["spec_ticks"]
    host = stats["decode_seconds"] + stats["spec_seconds"]
    decode_tokens = stats["tokens"] - stats["completed"]   # seeds: prefill
    return {"requests": stats["completed"], "tokens": stats["tokens"],
            "wall_s": wall, "ticks": stats["ticks"],
            "decode_ticks": stats["decode_ticks"],
            "spec_ticks": stats["spec_ticks"],
            "spec_accept_rate": stats["spec_accept_rate"],
            "spec_emitted": stats["spec_emitted"],
            "ms_per_tick": 1e3 * host / max(ticks, 1),
            "ms_per_spec_tick": 1e3 * stats["spec_seconds"]
            / max(stats["spec_ticks"], 1),
            "decode_tok_per_s": decode_tokens / max(host, 1e-9),
            "shared_pages_adopted": stats["shared_pages_adopted"],
            "prefill_tokens": stats["prefill_tokens"]}


def check_budgets(eng, what: str) -> None:
    for req in eng.completed:
        check(req.finish_reason == "length"
              and len(req.out_tokens) == req.max_new_tokens,
              f"{what}: request {req.rid} ended {req.finish_reason} after "
              f"{len(req.out_tokens)}/{req.max_new_tokens} tokens")


def spec_phase(torch, eng_mod, traces, model_lib, api, params, cfg,
               seed: int, counters: dict,
               kernel_paths: dict) -> tuple[dict, int]:
    """Phase 4; returns (report, verify launches on the spec run)."""
    bodies = main_bodies(torch, kernel_paths, cfg)
    runs = {}
    for spec in (True, False):
        trace = spec_trace(traces, cfg, seed)
        eng = eng_mod.Engine(params, cfg, spec_config(eng_mod, spec),
                             device="cuda")
        stats, wall, n = run_counted(
            torch, counters, lambda: eng.run(trace, max_ticks=3000))
        check(stats["completed"] == len(trace) and not stats["shed"]
              and not stats["rejected"] and not stats["corrupted"],
              f"spec={spec}: not every request completed: {stats}")
        check_budgets(eng, f"spec={spec}")
        paths = check_bodies(counters, n, f"spec={spec}", bodies)
        runs[spec] = (eng, stats, wall, n, paths)
    eng, stats, wall, n, paths = runs[True]
    check(stats["spec_ticks"] > 0, "the spec run ran no spec tick")
    check(n["paged_attention_verify"] == cfg.num_layers * stats["spec_ticks"],
          f"verify launches {n['paged_attention_verify']} != "
          f"{cfg.num_layers} x {stats['spec_ticks']} spec ticks")
    want = cfg.num_layers * stats["decode_ticks"] \
        + SPEC_DEPTH * SPEC_K * stats["spec_ticks"]
    check(n["paged_attention"] == want,
          f"spec run decode launches {n['paged_attention']} != {want}")
    plain = runs[False]
    check(plain[3]["paged_attention_verify"] == 0
          and plain[3]["paged_attention"]
          == cfg.num_layers * plain[1]["decode_ticks"],
          f"non-spec run launches {plain[3]}")
    agree = agreement(torch, model_lib, api, eng.completed,
                      plain[0].completed, *BF16_TOL)
    check(not agree["violations"], f"spec and non-spec streams disagree: "
          f"{agree['first_violations']}")
    report = {"spec": {**run_summary(stats, wall), "launches": n,
                       "paths": paths},
              "non_spec": {**run_summary(plain[1], plain[2]),
                           "launches": plain[3], "paths": plain[4]},
              "agreement": {**agree, "rtol": BF16_TOL[0],
                            "atol": BF16_TOL[1]},
              "k": SPEC_K, "draft_layers": SPEC_DEPTH}
    return report, n["paged_attention_verify"]


def group_phase(torch, eng_mod, groups, model_lib, api, params, cfg,
                seed: int, counters: dict, kernel_paths: dict) -> dict:
    """Phase 5: an n=2 and a best_of=3 parent on one prompt."""
    rng = np.random.default_rng(seed + 5)
    prompt = rng.integers(0, cfg.vocab_size, size=200).astype(np.int32)

    def parents():
        return [api.ServeRequest(rid=rid, tokens=prompt, arrival=rid,
                                 params=api.SamplingParams(
                                     temperature=0.8, seed=seed + 11 * rid,
                                     max_new_tokens=32, **kw))
                for rid, kw in ((0, dict(n=2)), (1, dict(n=1, best_of=3)))]

    ecfg = spec_config(eng_mod, False)
    eng = eng_mod.Engine(params, cfg, ecfg, device="cuda")
    finals, wall, n = run_counted(
        torch, counters, lambda: {o.rid: o for o in eng.stream(
            parents(), max_ticks=2000) if o.finished})
    stats = eng.stats()
    check(stats["groups_submitted"] == 2
          and stats["group_members_completed"] == 5,
          f"groups: {stats['groups_submitted']} parents, "
          f"{stats['group_members_completed']} members completed")
    check_budgets(eng, "groups")
    check(stats["shared_pages_adopted"] > 0, "no shared prompt page adopted")
    check(n["paged_attention"] == cfg.num_layers * stats["decode_ticks"] > 0,
          f"group run decode launches {n}")
    check_bodies(counters, n, "groups", main_bodies(torch, kernel_paths, cfg))
    members = {r.rid: r for r in eng.completed if r.group >= 0}
    for parent in parents():
        done = finals.get(parent.rid)
        check(done is not None and done.finish_reason == "length",
              f"parent {parent.rid} did not assemble")
        lanes = sorted((r for r in members.values() if r.group == parent.rid),
                       key=lambda r: r.lane)
        order = groups.rank(lanes)
        keep = order[:parent.params.n] if parent.params.best_of \
            else sorted(order[:parent.params.n])
        check([o.rid for o in done.group_outputs]
              == [lanes[i].rid for i in keep],
              f"parent {parent.rid}: lanes out of rank order")
        check(done.tokens == lanes[keep[0]].out_tokens,
              f"parent {parent.rid}: stream is not its winning lane's")
    # each lane against the same member served alone (its own engine)
    alone = []
    for parent in parents():
        for m in groups.expand(parent):
            solo = eng_mod.Engine(params, cfg, ecfg, device="cuda")
            solo.run([m], max_ticks=500)
            check(len(solo.completed) == 1, f"member {m.rid} alone failed")
            alone.extend(solo.completed)
    agree = agreement(torch, model_lib, api, list(members.values()), alone,
                      *BF16_TOL)
    check(not agree["violations"], f"group lanes disagree with members "
          f"served alone: {agree['first_violations']}")
    return {"wall_s": wall, "ticks": stats["ticks"],
            "decode_ticks": stats["decode_ticks"],
            "shared_pages_adopted": stats["shared_pages_adopted"],
            "prefill_tokens": stats["prefill_tokens"], "launches": n,
            "parents": {rid: {"lanes": [o.rid for o in out.group_outputs],
                              "tokens": len(out.tokens)}
                        for rid, out in finals.items()
                        if out.group_outputs is not None},
            "agreement_vs_alone": {**agree, "rtol": BF16_TOL[0],
                                   "atol": BF16_TOL[1]}}


# ---------------------------------------------------------------------------
# phase 6: MoE serving on granite-moe-3b-a800m
# ---------------------------------------------------------------------------
MOE_ARCH = "granite-moe-3b-a800m"


def moe_trace(traces, cfg, seed: int, num_requests: int = 12):
    """Prompts of 100 / 250 / 400 tokens, 32 new tokens each, greedy but
    for two seeded lanes at temperature 0.8."""
    trace = traces.synthetic_trace(cfg, num_requests=num_requests, seed=seed,
                                   prompt_lens=(100, 250, 400),
                                   heavy_frac=0.0, light_tokens=32)
    for req in trace:
        kw = dict(max_new_tokens=32)
        if req.rid in (3, 10):
            kw["temperature"] = 0.8
        req.params = dataclasses.replace(req.params, **kw)
    return trace


def moe_config(eng_mod, backend: str, spec: bool = False,
               capture_logits: bool = True):
    return eng_mod.EngineConfig(
        num_slots=8, page_size=16, max_cache=1024, prefill_chunk=0,
        num_classes=3, latency_budget=512.0, attn_backend=backend,
        capture_logits=capture_logits, spec_decode=SPEC_K if spec else 0,
        spec_draft_layers=SPEC_DEPTH if spec else 0)


class MoEStatsRecorder:
    """Keeps every ``moe_ffn`` call's ``MoEStats`` (device tensors, read
    once at the end) by wrapping the module function the transformer calls;
    one-token calls are decode, draft or verify rows, longer ones prefill."""

    def __init__(self, moe_mod):
        self.moe_mod, self.calls = moe_mod, []

    def __enter__(self):
        ffn = self.inner = self.moe_mod.moe_ffn

        def recording(params, x, cfg, bias, backend="kernel"):
            y, stats = ffn(params, x, cfg, bias, backend=backend)
            self.calls.append((x.shape[1], x.shape[0] * x.shape[1], stats))
            return y, stats

        self.moe_mod.moe_ffn = recording
        return self

    def __exit__(self, *exc):
        self.moe_mod.moe_ffn = self.inner

    def summary(self, torch, router) -> dict:
        out = {}
        for kind, want in (("prefill", lambda s: s > 1),
                           ("decode", lambda s: s == 1)):
            calls = [(t, st) for s, t, st in self.calls if want(s)]
            if not calls:
                continue
            cv = torch.stack([router.load_cv(st.load_frac)
                              for _, st in calls]).cpu().numpy()
            drop = torch.stack([st.drop_frac for _, st in calls]).cpu().numpy()
            toks = np.asarray([t for t, _ in calls], np.float64)
            out[kind] = {"calls": len(calls),
                         "mean_load_cv": float(cv.mean()),
                         "drop_frac_token_weighted":
                         float((drop * toks).sum() / toks.sum()),
                         "max_drop_frac": float(drop.max())}
        return out


def moe_phase(torch, configs, eng_mod, traces, model_lib, api, moe_mod,
              router, spec_mod, seed: int, counters: dict,
              kernel_paths: dict) -> tuple:
    """Phase 6 and the MoE spec run. Returns (report, moe_gmm launches on
    the kernel-backend serving run)."""
    cfg = dataclasses.replace(configs.get_config(MOE_ARCH),
                              num_layers=MOE_LAYERS)
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    bias = torch.zeros((cfg.num_layers, cfg.num_experts), device="cuda")
    bodies = main_bodies(torch, kernel_paths, cfg)
    nparams = model_lib.param_count(params)
    print(f"{MOE_ARCH}: {nparams / 1e9:.3f}B params "
          f"({model_lib.active_param_count(params, cfg) / 1e9:.3f}B active), "
          f"{cfg.num_layers} layers, {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token}, dtype {cfg.dtype}")
    runs = {}
    for backend in ("kernel", "torch"):
        trace = moe_trace(traces, cfg, seed)
        eng = eng_mod.Engine(params, cfg, moe_config(eng_mod, backend),
                             device="cuda", router_bias=bias)
        torch.cuda.reset_peak_memory_stats()
        with MoEStatsRecorder(moe_mod) as rec:
            stats, wall, n = run_counted(
                torch, counters, lambda: eng.run(trace, max_ticks=2000))
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(stats["completed"] == len(trace) and not stats["shed"]
              and not stats["rejected"] and not stats["corrupted"],
              f"moe {backend}: not every request completed: {stats}")
        check_budgets(eng, f"moe {backend}")
        calls = stats["decode_ticks"] + stats["prefills"]
        if backend == "kernel":
            want = {"moe_gmm": 3 * cfg.num_layers * calls,
                    "paged_attention": cfg.num_layers * stats["decode_ticks"],
                    "flash_attention": cfg.num_layers * stats["prefills"],
                    "paged_attention_verify": 0}
            paths = check_bodies(counters, n, f"moe {backend}", bodies)
        else:
            want = {name: 0 for name in counters}
        check(n == want, f"moe {backend} launches {n} != {want}")
        runs[backend] = (eng, stats, wall, n, peak, rec.summary(torch, router))
    eng, stats, wall, n, peak, routing = runs["kernel"]
    agree = agreement(torch, model_lib, api, eng.completed,
                      runs["torch"][0].completed, *BF16_TOL)
    # the same weights and trace in fp32 arithmetic on both backends: here
    # the kernels must compute the reference's function (see MOE_BF16_SLACK)
    import copy
    up = copy.deepcopy(params).float()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    exact = {}
    for backend in ("kernel", "torch"):
        e32 = eng_mod.Engine(up, cfg32, moe_config(eng_mod, backend),
                             device="cuda", router_bias=bias)
        t32 = moe_trace(traces, cfg32, seed)
        st32 = e32.run(t32, max_ticks=2000)
        check(st32["completed"] == len(t32), f"moe fp32 {backend}: {st32}")
        check_budgets(e32, f"moe fp32 {backend}")
        exact[backend] = e32.completed
    del up
    agree32 = agreement(torch, model_lib, api, exact["kernel"],
                        exact["torch"], *FP32_TOL)
    check(not agree32["violations"], f"moe kernel and torch runs disagree "
          f"in fp32: {agree32['first_violations']}")
    vs_exact = {name: agreement(torch, model_lib, api, runs[name][0].completed,
                                exact["torch"], *BF16_TOL)
                for name in ("kernel", "torch")}
    ratio = {name: r["max_diff_over_tol"] for name, r in vs_exact.items()}
    check(ratio["kernel"] <= max(1.0, MOE_BF16_SLACK * ratio["torch"]),
          f"moe bf16 kernel run is farther from fp32 arithmetic than the "
          f"torch run: {ratio}")
    report = {"kernel": {**run_summary(stats, wall), "prefills":
                         stats["prefills"], "launches": n, "paths": paths,
                         "peak_mem_gb": peak, "routing": routing},
              "torch": {**run_summary(runs["torch"][1], runs["torch"][2]),
                        "peak_mem_gb": runs["torch"][4]},
              "agreement_bf16": {**agree, "rtol": BF16_TOL[0],
                                 "atol": BF16_TOL[1]},
              "agreement_fp32": {**agree32, "rtol": FP32_TOL[0],
                                 "atol": FP32_TOL[1]},
              "bf16_vs_fp32": {name: {k: r[k] for k in (
                  "max_logits_diff", "max_diff_over_tol", "violations")}
                  for name, r in vs_exact.items()},
              "bf16_slack": MOE_BF16_SLACK}
    del exact
    report["profile"] = profile_decode(
        torch, eng_mod, params, cfg, moe_trace(traces, cfg, seed),
        moe_config(eng_mod, "kernel", capture_logits=False),
        router_bias=bias)
    gmm_n = n["moe_gmm"]
    del runs, eng

    # MoE spec run: four greedy requests, k = 4, draft depth 8, on weights
    # made draft-friendly; verify runs the grouped matmul at C = 320
    drafty = spec_mod.make_draft_friendly(params, cfg, SPEC_DEPTH)
    del params
    greedy = [r for r in moe_trace(traces, cfg, seed)
              if r.params.is_greedy][:4]
    spec_runs = {}
    for spec in (True, False):
        reqs = [dataclasses.replace(r, arrival=0, out_tokens=[],
                                    out_logits=[]) for r in greedy]
        eng = eng_mod.Engine(drafty, cfg, moe_config(eng_mod, "kernel", spec),
                             device="cuda", router_bias=bias)
        st, w, cnt = run_counted(torch, counters,
                                 lambda: eng.run(reqs, max_ticks=500))
        check_bodies(counters, cnt, f"moe spec={spec}", bodies)
        check(st["completed"] == len(reqs), f"moe spec={spec}: {st}")
        check_budgets(eng, f"moe spec={spec}")
        spec_runs[spec] = (eng, st, w, cnt)
    eng, st, w, cnt = spec_runs[True]
    check(st["spec_ticks"] > 0, "the MoE spec run ran no spec tick")
    drafts = SPEC_DEPTH * SPEC_K * st["spec_ticks"]
    want = {"paged_attention_verify": cfg.num_layers * st["spec_ticks"],
            "paged_attention": cfg.num_layers * st["decode_ticks"] + drafts,
            "flash_attention": cfg.num_layers * st["prefills"],
            "moe_gmm": 3 * (cfg.num_layers * (st["decode_ticks"]
                                              + st["prefills"]
                                              + st["spec_ticks"]) + drafts)}
    check(cnt == want, f"moe spec run launches {cnt} != {want}")
    spec_agree = agreement(torch, model_lib, api, eng.completed,
                           spec_runs[False][0].completed, *BF16_TOL)
    check(not spec_agree["violations"], f"moe spec and non-spec streams "
          f"disagree: {spec_agree['first_violations']}")
    report["spec"] = {"spec": {**run_summary(st, w), "launches": cnt},
                      "non_spec": {**run_summary(spec_runs[False][1],
                                                 spec_runs[False][2]),
                                   "launches": spec_runs[False][3]},
                      "agreement": {**spec_agree, "rtol": BF16_TOL[0],
                                    "atol": BF16_TOL[1]},
                      "k": SPEC_K, "draft_layers": SPEC_DEPTH}
    return report, gmm_n


# ---------------------------------------------------------------------------
# phase 8: the SSM, hybrid, VLM and audio families at full width
# ---------------------------------------------------------------------------
FAMILY_ARCHS = ("mamba2-130m", "recurrentgemma-9b", "paligemma-3b",
                "musicgen-medium")
# (requests, prompt lengths by rid, max_cache, prefill chunk); 32 new tokens
FAMILY_TRAFFIC = {
    "mamba2-130m": (8, (128, 256, 100, 200), 320, 64),
    "recurrentgemma-9b": (6, (100, 600, 100, 600, 100, 2500), 2560, 0),
    "paligemma-3b": (8, (32, 100), 400, 0),
    "musicgen-medium": (8, (100, 383), 416, 0)}
FAMILY_SAMPLED = (1, 4)                  # lanes at temperature 0.8, seeded
FAMILY_BOTH_BACKENDS = ("paligemma-3b", "musicgen-medium")
# mamba's chunked prefill against one-shot: logits within this, greedy lanes
# token-equal (a sampled lane's Gumbel draw over 50,280 near-tied random-
# weight logits flips at ~1e-6 gaps: 1 or 2 of 64 sampled draws a run on an
# NVIDIA H100 80GB HBM3 at 700 W, each reproduced from its two logit rows;
# each flip's seed, tokens and gaps are printed under ``sampled_flips``)
SSM_CHUNK_TOL = (1e-4, 1e-4)


def family_trace(traces, cfg, seed: int, profile: bool = False):
    """Phase 8's traffic for ``cfg`` (``FAMILY_TRAFFIC``), with the random
    patches / frames the traces attach. ``profile``: eight requests of the
    first two prompt lengths, all greedy, so that every slot is busy
    through a profiled window (which ends before the 32nd token)."""
    n, lens, _, _ = FAMILY_TRAFFIC[cfg.name]
    if profile:
        n, lens = 8, lens[:2]
    trace = traces.synthetic_trace(cfg, num_requests=n, seed=seed,
                                   prompt_lens=lens, heavy_frac=0.0)
    for req in trace:
        kw = dict(max_new_tokens=32)
        if req.rid in FAMILY_SAMPLED and not profile:
            kw["temperature"] = 0.8
        req.params = dataclasses.replace(req.params, **kw)
    return trace


def family_config(eng_mod, cfg, backend: str, capture_logits: bool = True):
    _, lens, max_cache, chunk = FAMILY_TRAFFIC[cfg.name]
    return eng_mod.EngineConfig(
        num_slots=8, page_size=16, max_cache=max_cache, prefill_chunk=chunk,
        num_classes=len(lens), latency_budget=512.0, attn_backend=backend,
        capture_logits=capture_logits)


def family_launches(cfg, stats) -> dict:
    """Launches a kernel-backend run without speculation must count: paged
    decode once a decode tick in each full-attention layer, flash once a
    one-shot prefill in each full-attention layer of a causal (not
    prefix-LM) stack, the grouped matmul three times (gate, up, down) a
    layer of an MoE stack each decode tick and one-shot prefill (phase 6's
    count); nothing else (sliding-window, SSM and RG-LRU layers take no
    kernel)."""
    # full-attention layers: none in the SSM, and none in the hybrid (its
    # attention layers are all sliding-window)
    attn = 0 if cfg.family in ("ssm", "hybrid") else cfg.num_layers
    moe = cfg.num_layers if cfg.family == "moe" else 0
    return {"paged_attention": attn * stats["decode_ticks"],
            "paged_attention_verify": 0,
            "flash_attention": (0 if cfg.family == "vlm" else attn)
            * stats["prefills"],
            "moe_gmm": 3 * moe * (stats["decode_ticks"] + stats["prefills"])}


def family_serve(torch, eng_mod, params, cfg, trace, backend: str,
                 counters: dict, ecfg=None, router_bias=None):
    """Serve ``trace`` on the card (engine config ``ecfg``, by default
    ``family_config``'s; an MoE stack's ``router_bias``), every launch count
    set to 0 just before; returns (engine, stats, wall s, launches, peak
    GB)."""
    eng = eng_mod.Engine(params, cfg,
                         ecfg or family_config(eng_mod, cfg, backend),
                         device="cuda", router_bias=router_bias)
    torch.cuda.reset_peak_memory_stats()
    stats, wall, n = run_counted(torch, counters,
                                 lambda: eng.run(trace, max_ticks=2000))
    what = f"{cfg.name} {cfg.dtype} {backend}"
    check(stats["completed"] == len(trace) and not stats["shed"]
          and not stats["rejected"] and not stats["corrupted"],
          f"{what}: not every request completed: {stats}")
    check_budgets(eng, what)
    return eng, stats, wall, n, torch.cuda.max_memory_allocated() / 1e9


def oneshot_of(api, params, cfg, reqs, max_cache: int) -> list:
    """Each request served alone by one-shot ``generate`` (logits kept)."""
    out = []
    for req in reqs:
        probe = api.ServeRequest(rid=req.rid, tokens=req.tokens,
                                 params=req.params, patches=req.patches,
                                 frames=req.frames)
        api.generate(params, cfg, probe, max_cache=max_cache,
                     capture_logits=True)
        out.append(probe)
    return out


def family_phase(torch, configs, eng_mod, traces, model_lib, api, arch: str,
                 seed: int, counters: dict, kernel_paths: dict) -> dict:
    """Phase 8 for one architecture: (a) budgets and (e) launch counts on
    the bodies ``kernel_path`` predicts, in bf16, and (f) a profiled window;
    then the same weights upcast to fp32 in place (the bf16 copy is gone
    when the fp32 one is whole): (b) the engine against one-shot
    ``generate``, (c) kernel against torch, (d) mamba's chunked prefill
    against one-shot, and (c) in bf16 (``bf16_rule``)."""
    t0 = time.perf_counter()
    cfg = configs.get_config(arch)
    if arch in FAMILY_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=FAMILY_LAYERS[arch])
    max_cache = FAMILY_TRAFFIC[arch][2]
    backends = ("kernel", "torch") if arch in FAMILY_BOTH_BACKENDS \
        else ("kernel",)
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    rep = {"params_b": model_lib.param_count(params) / 1e9,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "head_dim": cfg.head_dim}
    bf16 = {}
    for backend in backends:
        eng, stats, wall, n, peak = family_serve(
            torch, eng_mod, params, cfg, family_trace(traces, cfg, seed),
            backend, counters)
        want = family_launches(cfg, stats) if backend == "kernel" \
            else dict.fromkeys(counters, 0)
        check(n == want, f"{arch} {backend} launches {n} != {want}")
        paths = check_bodies(counters, n, f"{arch} {backend}",
                             main_bodies(torch, kernel_paths, cfg)) \
            if backend == "kernel" else None
        bf16[backend] = eng.completed
        rep[backend] = {**run_summary(stats, wall), "prefills":
                        stats["prefills"], "chunked_prefill_chunks":
                        stats["chunked_prefill_chunks"], "launches": n,
                        "paths": paths, "peak_mem_gb": peak}
    prof_cfg = family_config(eng_mod, cfg, "kernel", capture_logits=False
                             )._replace(prefill_chunk=0)
    torch.cuda.reset_peak_memory_stats()
    rep["profile"] = profile_decode(torch, eng_mod, params, cfg,
                                    family_trace(traces, cfg, seed, True),
                                    prof_cfg)
    rep["profile"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()

    params.float()                   # in place, one parameter at a time
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    fp32 = {}
    for backend in backends:
        eng = family_serve(torch, eng_mod, params, cfg32,
                           family_trace(traces, cfg32, seed), backend,
                           counters)[0]
        fp32[backend] = eng.completed
    ref = oneshot_of(api, params, cfg32, fp32["kernel"], max_cache)
    tol = SSM_CHUNK_TOL if cfg.family == "ssm" else FP32_TOL
    vs = agreement(torch, model_lib, api, fp32["kernel"], ref, *tol)
    check(not vs["violations"], f"{arch} fp32 engine and one-shot disagree: "
          f"{vs['first_violations']}")
    rep["engine_vs_oneshot_fp32"] = {**{k: vs[k] for k in (
        "max_logits_diff", "max_diff_over_tol", "diverged")},
        "rtol": tol[0], "atol": tol[1]}
    if cfg.family == "ssm":
        # greedy lanes token-equal; a sampled lane may part only where the
        # rule above showed its own sampler draws both tokens from the two
        # logit rows (their gap, within SSM_CHUNK_TOL, flips a near-tie)
        chunked = [r for r in fp32["kernel"]
                   if len(r.tokens) % FAMILY_TRAFFIC[arch][3] == 0]
        parted = {d["rid"] for d in vs["diverged"]}
        bad = [r.rid for r in chunked if r.params.is_greedy
               and r.rid in parted]
        check(chunked and not bad, f"{arch}: chunked prefill of greedy "
              f"requests {bad} not token-equal to one-shot "
              f"({vs['diverged']})")
        rep["chunked_rids"] = [r.rid for r in chunked]
        rep["sampled_draws"] = sum(len(r.out_tokens) for r in fp32["kernel"]
                                   if not r.params.is_greedy)
        rep["sampled_flips"] = flip_details(fp32["kernel"], ref,
                                            vs["diverged"])
    if len(backends) == 2:
        agree32 = agreement(torch, model_lib, api, fp32["kernel"],
                            fp32["torch"], *FP32_TOL)
        check(not agree32["violations"], f"{arch} fp32 kernel and torch "
              f"runs disagree: {agree32['first_violations']}")
        rep["kernel_vs_torch_fp32"] = {k: agree32[k] for k in (
            "max_logits_diff", "max_diff_over_tol", "diverged")}
        rep["kernel_vs_torch_bf16"] = bf16_rule(torch, model_lib, api, arch,
                                                bf16, lambda: fp32["torch"])
    del params, bf16, fp32, ref
    torch.cuda.empty_cache()
    rep["phase_s"] = time.perf_counter() - t0
    return rep


def flip_details(runs: list, refs: list, diverged: list) -> list:
    """Each first differing draw of ``diverged`` (``agreement``'s list): the
    lane's seed and temperature, the two tokens (run, reference), the
    reference row's logit gap between them, the run row's, and the largest
    gap between the two rows."""
    run, ref = {r.rid: r for r in runs}, {r.rid: r for r in refs}
    out = []
    for d in diverged:
        ra, rb, i = run[d["rid"]], ref[d["rid"]], d["at"]
        la, lb = ra.out_logits[i], rb.out_logits[i]
        ta, tb = ra.out_tokens[i], rb.out_tokens[i]
        out.append({"rid": d["rid"], "seed": ra.params.seed,
                    "temperature": ra.params.temperature, "at": i,
                    "tokens": [int(ta), int(tb)],
                    "ref_gap": float(lb[tb] - lb[ta]),
                    "run_gap": float(la[ta] - la[tb]),
                    "rows_max_diff": float(np.abs(la - lb).max())})
    return out


def bf16_rule(torch, model_lib, api, arch: str, bf16: dict, exact,
              slack: float = 1.0) -> dict:
    """Kernel against torch backend in bf16 by phase 3's rule at
    ``BF16_TOL``. The torch backend rounds the scores to bf16 before the
    softmax (the JAX package's ``_sdpa``), the kernels keep them in fp32, and
    the gap grows with depth (~1.2x the 5e-2 kernel tolerance at smollm's 32
    layers, phase 3). Where the rule fails, the kernel run must be the closer
    of the two to fp32 arithmetic on the same weights (``exact()``, the
    torch backend's requests in fp32, called only then): within ``BF16_TOL``
    of it, or no farther from it than the torch run and within
    ``BF16_FP32_CAP`` x ``BF16_TOL`` of it — the form of phase 6's bf16
    check, without its routing slack (phase 12 passes ``slack`` =
    ``GEMMA_BF16_SLACK``: the kernel run no farther than ``slack`` x the
    torch run's distance). Phase 2 holds the kernels themselves at these
    models' shapes (``PAGED_CASES``, ``FLASH_CASES``)."""
    agree = agreement(torch, model_lib, api, bf16["kernel"], bf16["torch"],
                      *BF16_TOL)
    out = {k: agree[k] for k in ("max_logits_diff", "max_diff_over_tol",
                                 "diverged", "violations")}
    if agree["violations"]:
        ref = exact()
        ratio = {name: agreement(torch, model_lib, api, bf16[name], ref,
                                 *BF16_TOL)["max_diff_over_tol"]
                 for name in ("kernel", "torch")}
        check(ratio["kernel"] <= max(1.0, slack * ratio["torch"]),
              f"{arch} bf16 kernel and torch runs disagree "
              f"({agree['first_violations']}) and the kernel run is farther "
              f"from fp32 arithmetic than {slack} x the torch run: {ratio}")
        check(ratio["kernel"] <= BF16_FP32_CAP,
              f"{arch} bf16 kernel and torch runs disagree "
              f"({agree['first_violations']}) and the kernel run is past "
              f"{BF16_FP32_CAP}x BF16_TOL from fp32 arithmetic: {ratio}")
        out["vs_fp32_over_tol"] = ratio
        out["slack"] = slack
    return out


# ---------------------------------------------------------------------------
# phase 7: the paper's VLSI extraction pipeline
# ---------------------------------------------------------------------------
GRID_SHAPES = [(16, 32), (40, 32), (33, 16), (64, 128), (8, 256), (1, 7),
               (80, 128), (4096, 4096)]
# stacks for grid_step_planes: the observer's (4, 80, 128), the NAND's
# planes, an odd H * W (planes at odd word offsets, the 4-byte body), and
# four full-size planes
GRID_STACKS = [(4, 80, 128), (4, 40, 32), (3, 7, 5), (4, 4096, 4096)]
# (stack, words past a 16-byte boundary): views that take the 4-byte body
GRID_OFFSET_STACKS = [((4, 40, 32), 1), ((4, 80, 128), 2), ((3, 7, 5), 1)]
GRID_TIMED = [(80, 128), (4, 80, 128), (4, 40, 32), (4096, 4096),
              (4, 4096, 4096)]
FIG3_AGENTS, FIG3_MAX_STEPS = 175, 6000
FIG3_MARKS = (0, 5, 20, 50, 100, 200)
# the JAX package's DFF run (175 agents, seed 0) ends after this many
# cycles; a port equal to it bit for bit ends there too
DFF_JAX_CYCLES = 2396
FIG4_AGENTS, FIG4_SEEDS = (64, 128, 256), (0, 1)
PROFILE_CYCLES, PROFILE_FROM = 20, 100


def grid_inputs(torch, gen, shape, kind: str, offset: int = 0):
    """Labels and cond of ``shape`` as views ``offset`` int32 words into
    fresh buffers. ``extractor``: a conductor mask and labels on it (the
    observer's planes); ``any_int32``: negative labels, cond values outside
    {0, 1}."""
    n = int(np.prod(shape)) + offset
    if kind == "extractor":
        cond = (torch.rand(n, generator=gen, device="cuda") < 0.6) \
            .to(torch.int32)
        lab = torch.randint(0, 1000, (n,), generator=gen, device="cuda",
                            dtype=torch.int32) * cond
    else:
        lab = torch.randint(-50, 100, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        cond = torch.randint(-3, 4, (n,), generator=gen, device="cuda",
                             dtype=torch.int32)
    return lab[offset:].view(shape), cond[offset:].view(shape)


def check_grid_step(torch, gen, grid_step, grid_step_planes, grid_step_ref,
                    kernel_path) -> list:
    """Exact equality with the plain version on every shape, stack and input
    kind, each call one launch on the body ``kernel_path`` predicts. With
    ``grid_step_planes`` None (a tree from before it) only the planes."""
    cases = [(shape, 0) for shape in GRID_SHAPES]
    if grid_step_planes is not None:
        cases += [(shape, 0) for shape in GRID_STACKS] + GRID_OFFSET_STACKS
    out = []
    for shape, offset in cases:
        fn = grid_step if len(shape) == 2 else grid_step_planes
        for kind in ("extractor", "any_int32"):
            lab, cond = grid_inputs(torch, gen, shape, kind, offset)
            path = kernel_path(shape[-1], aligned=offset % 4 == 0)
            n0, p0 = grid_step.launches, grid_step.launches_by_path[path]
            got = fn(lab, cond)
            err = int((got.long() - grid_step_ref(lab, cond).long())
                      .abs().max().item())
            what = f"grid_step {shape} +{offset} words ({kind})"
            check(err == 0, f"{what}: max error {err}")
            check(grid_step.launches == n0 + 1
                  and grid_step.launches_by_path[path] == p0 + 1,
                  f"{what}: not one launch on the {path} body")
            out.append({"shape": list(shape), "offset_words": offset,
                        "inputs": kind, "path": path, "max_abs_err": err})
    return out


def time_grid_step(torch, gen, grid_step, grid_step_planes,
                   grid_step_ref) -> dict:
    """The kernel, its plain version and the bound at GRID_TIMED: the
    observer's plane and stack (the DFF tile's 80 x 128, four label planes),
    the NAND's stack, and a full-size plane and stack. A call reads labels
    and cond and writes out once (12 bytes a cell) and does ~9 int32
    operations a cell (4 neighbour tests, 4 maxima, the cell's own test),
    counted against the CUDA-core rate. ``ms`` is CUDA events over
    back-to-back calls (the wrapper's host time where the kernel is
    shorter), ``device_ms`` the profiler's device time a call. No single
    PyTorch call computes this function, so there is no library time. With
    ``grid_step_planes`` None only the planes are timed."""
    out = {}
    for shape in GRID_TIMED:
        if len(shape) == 3 and grid_step_planes is None:
            continue
        fn = grid_step if len(shape) == 2 else grid_step_planes
        lab, cond = grid_inputs(torch, gen, shape, "extractor")
        cells = int(np.prod(shape))
        iters = 200 if cells < 10 ** 6 else 20
        ms = cuda_ms(torch, lambda: fn(lab, cond), iters=iters)
        dev = device_ms(torch, lambda: fn(lab, cond))
        plain_ms = cuda_ms(torch, lambda: grid_step_ref(lab, cond),
                           iters=iters)
        err = int((fn(lab, cond).long()
                   - grid_step_ref(lab, cond).long()).abs().max().item())
        bound_ms, by = bound(12 * cells, 9 * cells, "float32")
        out["x".join(map(str, shape))] = {
            "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "max_abs_err": err}
    return out


def same_run(torch, a, b, what: str) -> None:
    """Two ``run_extraction`` results equal bit for bit: blackboard, cycle
    count and every agent field."""
    (ga, sa, _, aa), (gb, sb, _, ab) = a, b
    check(sa == sb, f"{what}: {sa} cycles against {sb}")
    check(np.array_equal(ga, gb), f"{what}: blackboards differ at "
          f"{np.argwhere(ga != gb)[:5].tolist()}")
    for f in aa._fields:
        check(torch.equal(getattr(aa, f).cpu(), getattr(ab, f).cpu()),
              f"{what}: agents' {f} differ")


def netlist_ok(extractor, reference, grid, lay, what: str):
    sim = extractor.harvest(grid, lay)
    ok, msg = extractor.netlists_equivalent(sim, reference.extract(lay))
    check(ok, f"{what}: netlist not equivalent to the oracle: {msg}")
    return sim


def profile_extraction(torch, extractor, am, prng, lay) -> dict:
    """Where a cycle's time goes: the DFF run (175 agents, seed 0) stepped
    to cycle PROFILE_FROM, then PROFILE_CYCLES cycles of the run loop (the
    observer's test, then one step) under ``torch.profiler``, the two
    cycles before them in its warm-up step. Device busy time is the sum of
    the kernels' and copies' device time (one stream); the rest of the
    window's wall time is the device's idle share."""
    grid = extractor.make_grid(lay, "cuda")
    h, w = grid.shape[1:]
    model = extractor.make_extractor(FIG3_AGENTS, (h, w))
    ka, key = prng.split(am.as_key(prng.PRNGKey(0), "cuda"), 2).unbind(0)
    agents = am.uniform_random_agents(ka, FIG3_AGENTS, h, w,
                                      extractor.STATE_SIZE,
                                      init_type=extractor.FINDER,
                                      device="cuda")

    def cycles(t0, n):
        nonlocal grid, agents, key
        for t in range(t0, t0 + n):
            check(not extractor.done_fn(grid), "profile: run ended early")
            key, sub = prng.split(key, 2).unbind(0)
            grid, agents = model.step(grid, agents, sub, t)

    cycles(0, PROFILE_FROM - 2)
    torch.cuda.synchronize()
    wall_ms, rows = device_rows(
        torch, lambda: cycles(PROFILE_FROM - 2, 2),
        lambda: cycles(PROFILE_FROM, PROFILE_CYCLES))
    busy = sum(r[0] for r in rows)
    n = PROFILE_CYCLES
    return {"cycles": n, "from_cycle": PROFILE_FROM,
            "wall_ms_per_cycle": wall_ms / n,
            "device_ms_per_cycle": busy / n,
            "idle_share": 1.0 - busy / wall_ms if busy else None,
            "device_calls_per_cycle": sum(r[1] for r in rows) / n,
            "grid_step_ms_per_cycle": sum(
                r[0] for r in rows if "grid_step_kernel" in r[2]) / n,
            "grid_step_calls_per_cycle": sum(
                r[1] for r in rows if "grid_step_kernel" in r[2]) / n,
            "top": [{"kernel": k[:80], "ms_per_cycle": ms / n,
                     "calls_per_cycle": c / n} for ms, c, k in rows[:8]]}


def straggler_trace(seed: int, t: int = 400, w: int = 16) -> np.ndarray:
    """A 16-worker fleet with one persistent straggler at 0.3x speed (the
    ``persistent_straggler`` fleet of benchmarks/scheduler_bench.py)."""
    rng = np.random.default_rng(seed)
    speeds = 1.0 + 0.05 * rng.standard_normal((t, w))
    speeds[:, 0] *= 0.3
    return np.clip(speeds, 1e-3, None).astype(np.float32)


def vlsi_phase(torch, counters: dict, seed: int) -> tuple:
    """Phase 7. Returns (report, kernel report for grid_step)."""
    from repro_torch import prng
    from repro_torch.core import agent_model as am
    from repro_torch.core import scheduler
    from repro_torch.core.vlsi import extractor, layout, reference
    from repro_torch.kernels.grid_step import (grid_step, grid_step_planes,
                                               grid_step_ref, kernel_path)
    report = {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    report["grid_step_checks"] = check_grid_step(
        torch, gen, grid_step, grid_step_planes, grid_step_ref, kernel_path)
    timing = time_grid_step(torch, gen, grid_step, grid_step_planes,
                            grid_step_ref)
    report["grid_step_timing"] = timing

    def counted(fn, what, w):
        out, wall, n = run_counted(torch, counters, fn)
        cycles = out[1]
        want = {name: 0 for name in counters}
        # the observer's test before each cycle and at the end: one launch
        # for its four label planes
        want["grid_step"] = cycles + 1
        check(n == want, f"{what}: launches {n} != {want}")
        by = path_counts(counters)["grid_step"]
        check(by[kernel_path(w)] == n["grid_step"],
              f"{what}: grid_step launches by body {by}; every one must "
              f"take the {kernel_path(w)} body")
        return out, wall, n["grid_step"]

    # NAND, 64 agents: the card against the port on the CPU, bit for bit
    nand = layout.nand_layout()
    report["nand_card_vs_cpu"] = []
    for s in (1, 2):
        card, wall, n = counted(lambda: extractor.run_extraction(
            nand, 64, seed=s, device="cuda"), f"nand seed {s}",
            nand.shape[-1])
        t0 = time.perf_counter()
        host = extractor.run_extraction(nand, 64, seed=s, device="cpu")
        host_wall = time.perf_counter() - t0
        same_run(torch, card, host, f"nand seed {s} card vs cpu")
        for run in (card, host):
            netlist_ok(extractor, reference, run[0], nand, f"nand seed {s}")
        report["nand_card_vs_cpu"].append({
            "seed": s, "cycles": card[1], "equal": True, "card_wall_s": wall,
            "cpu_wall_s": host_wall, "grid_step_launches": n})

    # Fig. 3: the DFF tile (32 transistors) at 175 agents -- the main path
    dff = layout.dff_layout()
    (grid, steps, pops, _), wall, gs_n = counted(
        lambda: extractor.run_extraction(dff, FIG3_AGENTS, seed=0,
                                         max_steps=FIG3_MAX_STEPS,
                                         record=True, device="cuda"),
        "dff fig3", dff.shape[-1])
    check(steps < FIG3_MAX_STEPS, f"dff did not finish in {FIG3_MAX_STEPS}")
    sim = netlist_ok(extractor, reference, grid, dff, "dff fig3")
    late = steps - 1
    fin, lab, prop = (pops[:, t] for t in (extractor.FINDER,
                                           extractor.LABELLER,
                                           extractor.PROPAGATOR))
    shape = {"finder_crash": bool(fin[late] < fin[:30].max() / 4),
             "labeller_spike": bool(lab[:50].max() >= lab[0]),
             "labellers_die_out": bool(lab[late] == 0),
             "all_propagators": bool(prop[late] == FIG3_AGENTS),
             "propagators_start_low": bool(prop[0] < FIG3_AGENTS / 2)}
    check(all(shape.values()), f"dff fig3 shape: {shape}")
    report["fig3"] = {
        "agents": FIG3_AGENTS, "cycles": steps,
        "jax_cycles_expected": DFF_JAX_CYCLES,
        "equal_to_jax_count": steps == DFF_JAX_CYCLES, "wall_s": wall,
        "ms_per_cycle": 1e3 * wall / steps, "equivalent": True,
        "duplicates": sim.duplicates, "grid_step_launches": gs_n,
        "grid_step_paths": path_counts(counters)["grid_step"],
        "shape": shape,
        "populations": {str(t): pops[t].tolist()
                        for t in (*FIG3_MARKS, late)},
        "types": list(extractor.TYPE_NAMES)}

    # Fig. 4: cycles against agents on the NAND (as fig4_speedup --quick)
    rows = []
    for n_agents in FIG4_AGENTS:
        cyc = []
        for s in FIG4_SEEDS:
            (g, c, _, _), _, _ = counted(lambda: extractor.run_extraction(
                nand, n_agents, seed=s, max_steps=8000, device="cuda"),
                f"fig4 n={n_agents} seed {s}", nand.shape[-1])
            netlist_ok(extractor, reference, g, nand,
                       f"fig4 n={n_agents} seed {s}")
            cyc.append(c)
        rows.append({"agents": n_agents, "cycles": cyc,
                     "mean": float(np.mean(cyc))})
    slope = float(np.polyfit(np.log([r["agents"] for r in rows]),
                             np.log([r["mean"] for r in rows]), 1)[0])
    report["fig4"] = {"rows": rows, "loglog_slope": slope}

    report["profile"] = profile_extraction(torch, extractor, am, prng, dff)

    # the immune straggler scheduler: card against CPU, immune vs static
    trace = straggler_trace(seed)
    sched = {}
    for static in (False, True):
        card = scheduler.simulate(trace, static=static, device="cuda").cpu()
        host = scheduler.simulate(trace, static=static, device="cpu")
        err = float(((card - host).abs() / host.abs()).max())
        check(err <= 1e-6, f"scheduler static={static}: card vs cpu "
              f"relative error {err}")
        sched["static" if static else "immune"] = {
            "total_time": float(card.sum()), "max_rel_err_vs_cpu": err}
    check(sched["immune"]["total_time"] < sched["static"]["total_time"],
          f"immune scheduler does not beat static: {sched}")
    report["scheduler"] = {"workers": trace.shape[1], "steps": trace.shape[0],
                           **sched}

    # the main path's call: the observer's stack of four label planes
    kern = {**{k: timing["4x80x128"][k] for k in TIMED}, "launches": gs_n,
        "paths": report["fig3"]["grid_step_paths"]}
    kern["max_abs_err"] = max(c["max_abs_err"]
                              for c in report["grid_step_checks"])
    return report, kern


# ---------------------------------------------------------------------------
# phase 9: the serving fleet (router, failover, journal, warm snapshots)
# ---------------------------------------------------------------------------
# the JAX benchmark's replica (benchmarks/serve_engine.py run_routing,
# run_failover, run_durability): 2 slots, page 16, chunk 16, immune
# admission; only the model is full width
FLEET_REQUESTS = 24
FLEET_TICKS = 50 * FLEET_REQUESTS        # the JAX benchmark's backstop


def fleet_config(eng_mod, tenants: int, max_cache: int, pin_pages: int,
                 budget: float, extra_pages: int = 0):
    return eng_mod.EngineConfig(
        num_slots=2, max_cache=max_cache, policy="immune",
        num_classes=tenants, latency_budget=budget, page_size=16,
        num_pages=2 * (max_cache // 16) + 1 + extra_pages, prefill_chunk=16,
        pin_pages=pin_pages, attn_backend="kernel")


def routing_trace(traces, cfg, seed: int):
    return traces.fleet_trace(cfg, tenants=3, num_requests=FLEET_REQUESTS,
                              prefix_len=32, seed=seed)


def durability_trace(traces, cfg, seed: int):
    return traces.fleet_trace(cfg, tenants=2, num_requests=FLEET_REQUESTS,
                              prefix_len=64, suffix_lens=(4,),
                              decode_lens=(8,), hot_frac=0.9, burst_every=2,
                              burst_size=4, seed=seed)


def fleet_books(router) -> dict:
    """rid -> tokens of every completion the fleet holds."""
    return {r.rid: list(r.out_tokens) for r in router.completed}


def check_accounted(stats, what: str) -> None:
    """Zero lost rids: every request ends in an accounted bucket."""
    done = stats["completed"] + stats["shed"] + stats["rejected"] \
        + stats["corrupted"] + stats["failed"]
    check(done == FLEET_REQUESTS and stats["unserved"] == 0,
          f"{what}: {done} of {FLEET_REQUESTS} rids accounted, "
          f"{stats['unserved']} unserved")


def check_same_tokens(got: dict, ref: dict, what: str) -> None:
    off = [rid for rid, toks in got.items() if ref.get(rid, toks) != toks]
    check(not off, f"{what}: rids {off} part from the reference run")


def fleet_launch_check(cfg, counters: dict, n: dict, engines, what: str,
                       bodies: dict) -> dict:
    """Paged decode once a decode tick in every layer of every replica
    (fallen ones included), flash once a one-shot prefill, nothing else,
    every bf16 call on the body ``kernel_path`` predicts."""
    ticks = sum(e.decode_ticks for e in engines)
    prefills = sum(e.prefills for e in engines)
    want = {"paged_attention": cfg.num_layers * ticks,
            "paged_attention_verify": 0,
            "flash_attention": cfg.num_layers * prefills, "moe_gmm": 0}
    check(n == want and n["paged_attention"] > 0,
          f"{what}: launches {n} != {want}")
    if cfg.dtype == "bfloat16":
        check_bodies(counters, n, what, bodies)
    return {"launches": n, "paths": path_counts(counters)}


def fleet_summary(stats, wall: float) -> dict:
    return {"completed": stats["completed"], "shed": stats["shed"],
            "ticks": stats["ticks"], "placements": stats["placements"],
            "p50_latency_ticks": stats["p50_latency"],
            "p99_latency_ticks": stats["p99_latency"],
            "affinity_hit_rate": stats["affinity_hit_rate"],
            "wall_s": wall, "ms_per_fleet_tick": 1e3 * wall
            / max(stats["ticks"], 1),
            "prefill_tokens": stats["prefill_tokens"]}


def profile_fleet(torch, router_mod, eng_mod, params, cfg, traces, seed: int,
                  ticks: int = 5) -> dict:
    """Where a fleet tick's time goes: a 2-replica immune fleet on the
    routing trace, stepped until both replicas decode, then ``ticks`` fleet
    ticks under ``torch.profiler`` after one warm-up tick."""
    ecfg = fleet_config(eng_mod, 3, 64, 4, 64.0)
    rt = router_mod.Router([eng_mod.Engine(params, cfg, ecfg, device="cuda")
                            for _ in range(2)])
    for req in routing_trace(traces, cfg, seed):
        rt.submit(dataclasses.replace(req, arrival=0))
    for _ in range(4):
        rt.step()
    check(all(e.active_host.any() for e in rt.engines),
          "fleet profile: a replica is idle")

    def run():
        for _ in range(ticks):
            rt.step()

    wall_ms, rows = device_rows(torch, rt.step, run)
    busy = sum(r[0] for r in rows)
    return {"replicas": 2, "ticks": ticks,
            "wall_ms_per_tick": wall_ms / ticks,
            "device_ms_per_tick": busy / ticks,
            "idle_share": 1.0 - busy / wall_ms if busy else None,
            "paged_decode_ms_per_tick": sum(
                r[0] for r in rows if "paged_decode" in r[2]) / ticks,
            "top": [{"kernel": k[:80], "ms_per_tick": ms / ticks,
                     "calls_per_tick": n / ticks} for ms, n, k in rows[:6]]}


def fleet_phase(torch, configs, eng_mod, traces, model_lib, router_mod,
                faults, durability, seed: int, counters: dict,
                kernel_paths: dict) -> tuple:
    """Phase 9: full-width smollm-360m replicas at ``FLEET_LAYERS`` behind
    the placement router.
    (a) routing: the fleet trace under rr, jsq and immune at 2 replicas and
    immune at 1; every rid terminates, per-rid tokens equal across the four
    runs, the immune run takes affinity hits. (b) failover: a crash of one of
    3 replicas with a cold rejoin and a pressure shock, detected (one death,
    one rejoin), zero lost rids, tokens equal to the fault-free run, under
    immune and rr in bf16 and immune in fp32; the fenced replica's pool is
    freed. (c) durability: a power loss after the arrival horizon, restart
    4 ticks later, 2 replicas under ``run_durable``, warm (snapshot every 2
    ticks) and cold (journal only): zero lost and zero duplicated rids,
    tokens equal to the fault-free run, pages restored warm, and the warm
    restart re-prefills at most 0.5x the cold one's tokens. Every run's
    launches counted from 0 (paged decode a decode tick a layer, flash a
    one-shot prefill a layer, all bf16 calls on ``mma``). Returns (report,
    paged launches, flash launches) of 9a's immune 2-replica run."""
    import tempfile
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config("smollm-360m"),
                              num_layers=FLEET_LAYERS)
    bodies = main_bodies(torch, kernel_paths, cfg)
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    rep: dict = {"model": cfg.name, "layers": cfg.num_layers,
                 "dtype": cfg.dtype}

    # -- 9a: routing ----------------------------------------------------------
    ecfg = fleet_config(eng_mod, 3, 64, 4, 64.0)
    routing, ref, main_n = {}, {}, None
    for policy, n_rep in (("rr", 2), ("jsq", 2), ("immune", 2),
                          ("immune", 1)):
        what = f"9a {policy} x{n_rep}"
        rt = router_mod.Router(
            [eng_mod.Engine(params, cfg, ecfg, device="cuda")
             for _ in range(n_rep)], router_mod.RouterConfig(policy=policy))
        stats, wall, n = run_counted(torch, counters, lambda: rt.run(
            routing_trace(traces, cfg, seed), max_ticks=FLEET_TICKS))
        check_accounted(stats, what)
        launches = fleet_launch_check(cfg, counters, n, rt.engines, what,
                                      bodies)
        for rid, toks in fleet_books(rt).items():
            ref.setdefault(rid, toks)
        check_same_tokens(fleet_books(rt), ref, what)
        routing[f"{policy}_x{n_rep}"] = {**fleet_summary(stats, wall),
                                         **launches}
        if (policy, n_rep) == ("immune", 2):
            check(stats["affinity_hits"] > 0, f"{what}: no affinity hit")
            main_n = n
    rep["routing"] = routing
    rep["fleet_tick_profile"] = profile_fleet(torch, router_mod, eng_mod,
                                              params, cfg, traces, seed)

    # -- 9b: failover ---------------------------------------------------------
    def failover(p, c, dtype: str) -> dict:
        def trace():            # fresh requests a run: serving mutates them
            return traces.failover_fleet_trace(
                c, replicas=3, num_requests=FLEET_REQUESTS, tenants=3,
                prefix_len=32, seed=seed)

        spec = trace()[1] + " pressure@2+6:r0:p2"
        crash_at = int(spec.split("crash@")[1].split(":")[0])
        rejoin_at = int(spec.split("rejoin@")[1].split(":")[0])

        def replica():
            return eng_mod.Engine(p, c, ecfg, device="cuda")

        clean = router_mod.Router([replica() for _ in range(3)])
        s, wall, n = run_counted(torch, counters, lambda: clean.run(
            trace()[0], max_ticks=FLEET_TICKS))
        check_accounted(s, f"9b clean {dtype}")
        fleet_launch_check(c, counters, n, clean.engines,
                           f"9b clean {dtype}", bodies)
        ref = fleet_books(clean)
        out = {"plan": spec, "clean": fleet_summary(s, wall)}
        del clean
        pool_bytes = sum(t.numel() * t.element_size()
                         for seg in replica().pool["layers"]
                         for leaf in seg for t in leaf.values())
        for policy in (("immune", "rr") if dtype == "bfloat16"
                       else ("immune",)):
            what = f"9b {policy} {dtype}"
            mem = {}

            class Probe(faults.FaultInjector):
                """Reads the allocated device memory just before the crash
                and just after the rejoin."""

                def begin_tick(self, router):
                    if router.tick == crash_at:
                        torch.cuda.synchronize()
                        mem["before_crash"] = torch.cuda.memory_allocated()
                    super().begin_tick(router)
                    if router.tick == rejoin_at:
                        torch.cuda.synchronize()
                        mem["after_rejoin"] = torch.cuda.memory_allocated()

            rt = router_mod.Router(
                [replica() for _ in range(3)],
                router_mod.RouterConfig(policy=policy),
                injector=Probe(faults.FaultPlan.parse(spec),
                               engine_factory=replica))
            s, wall, n = run_counted(torch, counters, lambda: rt.run(
                trace()[0], max_ticks=FLEET_TICKS))
            check(s["deaths"] == 1 and s["rejoins"] == 1
                  and s["replaced_requests"] > 0,
                  f"{what}: deaths {s['deaths']}, rejoins {s['rejoins']}, "
                  f"re-placed {s['replaced_requests']}")
            check(s["faults"]["pressure_shocks"] == 1,
                  f"{what}: the pressure shock did not fire")
            check_accounted(s, what)
            check_same_tokens(fleet_books(rt), ref, what)
            launches = fleet_launch_check(c, counters, n,
                                          rt.engines + rt.fallen, what,
                                          bodies)
            grown = mem["after_rejoin"] - mem["before_crash"]
            check(grown < pool_bytes and rt.fallen[0].pool is None,
                  f"{what}: {grown} bytes more after the rejoin than before "
                  f"the crash (one replica's pool: {pool_bytes}); the fenced "
                  f"replica's pool was not released")
            replayed = [r for r in rt.completed if r.rid in rt.replaced_rids]
            out[policy] = {**fleet_summary(s, wall), **launches,
                           "deaths": s["deaths"], "rejoins": s["rejoins"],
                           "replaced_requests": s["replaced_requests"],
                           "retries": s["retries"], "failed": s["failed"],
                           "recovery_ticks": s["recovery_ticks"],
                           "replayed_tokens": s["replayed_tokens"],
                           "replayed_requests_completed": len(replayed),
                           "pages_seized": s["faults"]["pages_seized"],
                           "mem_before_crash": mem["before_crash"],
                           "mem_after_rejoin": mem["after_rejoin"],
                           "pool_bytes": pool_bytes}
            del rt
        return out

    rep["failover"] = {"bfloat16": failover(params, cfg, "bfloat16")}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = model_lib.init_params(
        cfg32, torch.Generator(device="cuda").manual_seed(seed),
        device="cuda")
    rep["failover"]["float32"] = failover(params32, cfg32, "float32")
    del params32

    # -- 9c: durability -------------------------------------------------------
    dcfg = fleet_config(eng_mod, 2, 96, 8, 50.0 * FLEET_REQUESTS,
                        extra_pages=8)
    clean = router_mod.Router([eng_mod.Engine(params, cfg, dcfg,
                                              device="cuda")
                               for _ in range(2)])
    s, wall, n = run_counted(torch, counters, lambda: clean.run(
        durability_trace(traces, cfg, seed), max_ticks=FLEET_TICKS))
    check_accounted(s, "9c clean")
    ref = fleet_books(clean)
    horizon = max(r.arrival for r in durability_trace(traces, cfg, seed))
    off = max(horizon + 2, (3 * s["ticks"]) // 5)
    spec = f"poweroff@{off} restart@{off + 4}"
    dur = {"plan": spec, "clean": fleet_summary(s, wall)}
    del clean
    snap_s: list = []

    class TimedRouter(router_mod.Router):
        def _save_snapshot(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._save_snapshot()
            snap_s.append(time.perf_counter() - t0)

    prefill = {}
    with tempfile.TemporaryDirectory(prefix="fleet_durability_") as tmp:
        for warm in (True, False):
            what = f"9c {'warm' if warm else 'cold'}"
            d = os.path.join(tmp, "warm" if warm else "cold")

            def make():
                return TimedRouter(
                    [eng_mod.Engine(params, cfg, dcfg, device="cuda")
                     for _ in range(2)],
                    router_mod.RouterConfig(policy="immune"),
                    injector=faults.FaultInjector(
                        faults.FaultPlan.parse(spec)))

            snap_s.clear()
            (rt, s), wall, n = run_counted(
                torch, counters, lambda: durability.run_durable(
                    make, durability_trace(traces, cfg, seed),
                    os.path.join(d, "journal.wal"),
                    snapshot_dir=os.path.join(d, "snap") if warm else None,
                    snapshot_every=2, max_ticks=FLEET_TICKS))
            check(s["restarts"] == 1, f"{what}: {s['restarts']} restarts")
            check_accounted(s, what)
            rids = [r.rid for r in rt.completed]
            check(len(rids) == len(set(rids)),
                  f"{what}: duplicated completions")
            check_same_tokens(fleet_books(rt), ref, what)
            check(n["paged_attention"] > 0
                  and n["paged_attention"] % cfg.num_layers == 0
                  and n["paged_attention_verify"] == n["moe_gmm"] == 0,
                  f"{what}: launches {n}")
            check_bodies(counters, n, what, bodies)
            d_stats = s["durability"]
            prefill[warm] = sum(e.prefill_tokens for e in rt.engines)
            snap_dir = os.path.join(d, "snap")
            snap_bytes = None
            if warm:
                check(d_stats["recovered_pinned_pages"] > 0,
                      f"{what}: no pinned page restored warm")
                newest = sorted(os.listdir(snap_dir))[-1]
                snap_bytes = sum(
                    os.path.getsize(os.path.join(snap_dir, newest, f))
                    for f in os.listdir(os.path.join(snap_dir, newest)))
            j = d_stats["journal"]
            dur["warm" if warm else "cold"] = {
                **fleet_summary(s, wall), "launches": n,
                "recovered_finished": d_stats["recovered_finished"],
                "recovered_open": d_stats["recovered_open"],
                "recovered_pinned_pages": d_stats["recovered_pinned_pages"],
                "post_restart_prefill_tokens": prefill[warm],
                "snapshots": len(snap_s),
                "s_per_snapshot": (sum(snap_s) / len(snap_s)
                                   if snap_s else None),
                "snapshot_bytes": snap_bytes,
                "journal_records": j["records"], "journal_fsyncs": j["syncs"],
                "journal_bytes": j["synced_bytes"]}
            del rt
    ratio = prefill[True] / max(prefill[False], 1)
    check(ratio <= 0.5, f"9c: the warm restart re-prefilled {prefill[True]} "
          f"tokens, {ratio:.2f}x the cold restart's {prefill[False]} "
          f"(bar 0.5x)")
    dur["warm_over_cold_prefill"] = ratio
    rep["durability"] = dur
    rep["phase_s"] = time.perf_counter() - t_phase
    del params
    return rep, main_n


# ---------------------------------------------------------------------------
# phase 10: training (the trainer, auto-resume, the router's regulation)
# ---------------------------------------------------------------------------
# 10a: the reference CLI's batch and sequence; 8 steps, a checkpoint every
# 4, the injected failure at step 6 (past the first checkpoint)
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAILURE_AT = 8, 4, 6
# 10b: granite-moe-3b-a800m at phase 6's depth
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH = 6, 4
# 10c: the CPU parity tests' tolerances (of each leaf's max-abs), and their
# eps: at 1e-8 a first Adam step is sign(g), which rounding flips on
# gradient entries at the noise floor
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_STATE_TOL = 1e-5, 1e-5, 5e-5
# bf16 training on one card runs its attention through the flash kernels,
# so the bf16 runs of phases 10 and 15 expect their launches; the CPU
# rehearsals of those phases, which train through the torch route, set it
# False
FLASH_TRAINING = True
TRAIN_PARITY_EPS = 1e-4


def train_launches(torch, cfg, steps: int, counters: dict, what: str,
                   on: bool) -> dict:
    """The launch check of one training run of ``steps`` steps on ``cfg``
    (every layer an attention layer), counted from 0 (``reset_train_counts``):
    ``on`` (a bf16 run on one card, which trains through flash), the
    forward launches layers x steps times (twice under remat, which reruns
    the forward in the backward) and the backward layers x steps times,
    every one on ``mma``; else (the torch route: fp32, serving without
    prefill) neither; no other kernel launches. Returns the counts."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    fwd = cfg.num_layers * steps * (1 if cfg.remat == "none" else 2)
    want = {**dict.fromkeys(counters, 0), "flash_attention": fwd if on else 0,
            "flash_attention_bwd": cfg.num_layers * steps if on else 0}
    got = {name: fn.launches for name, fn in counters.items()}
    got["flash_attention_bwd"] = flash_attention_bwd.launches
    check(got == want, f"{what}: launches {got}, want {want}")
    mma = {"flash_attention": counters["flash_attention"],
           "flash_attention_bwd": flash_attention_bwd}
    for name, fn in mma.items():
        check(fn.launches_by_path["mma"] == want[name],
              f"{what}: {name} by body {fn.launches_by_path}, want every "
              f"launch on mma")
    return got


def reset_train_counts(counters: dict) -> None:
    """``reset_counts`` of ``counters`` and of the flash backward."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    reset_counts({**counters, "flash_attention_bwd": flash_attention_bwd})


def leaf_rel_err(torch, a, b) -> float:
    """max |a - b| over max |a| (floor 1e-30), in float64."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))


def card_vs_cpu(torch, configs, arch: str, seed: int,
                schedule: str = "cosine") -> dict:
    """10c: one train step from one state on one batch, on the card and on
    the CPU, at the smoke size the CPU tests use (fp32, TF32 off): the loss,
    every gradient leaf, then the new state and the metrics."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import pipeline
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.train import train_step as ts
    cfg = configs.get_config(arch).smoke()
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=0, decay_steps=100,
                       schedule=schedule, eps=TRAIN_PARITY_EPS)
    tree = ts.train_state_to_numpy(ts.init_train_state(
        torch.Generator().manual_seed(seed), cfg, tcfg, device="cpu"), cfg)
    states = {d: ts.train_state_from_numpy(tree, cfg, d)
              for d in ("cuda", "cpu")}
    batches = {d: pipeline.sample_batch(cfg, 4, 32,
                                        pipeline.init_data_state(d))[0]
               for d in ("cuda", "cpu")}
    check(all(torch.equal(batches["cuda"][k].cpu(), batches["cpu"][k])
              for k in batches["cpu"]),
          f"{arch}: sample_batch on the card != on the CPU")
    got = {d: ts.loss_and_grads(st.params, cfg, batches[d],
                                st.router.bias if st.router else None)
           for d, st in states.items()}
    loss_err = abs(float(got["cuda"][0]) - float(got["cpu"][0]))
    grad_err = max(leaf_rel_err(torch, c, g) for c, g in
                   zip(got["cpu"][2], got["cuda"][2]))
    new = {d: ts.train_step(st, batches[d], cfg, tcfg) for d, st in
           states.items()}
    la, _ = ckpt.flatten(ts.state_tree(new["cpu"][0], cfg))
    lb, _ = ckpt.flatten(ts.state_tree(new["cuda"][0], cfg))
    state_err = max(leaf_rel_err(torch, a.float(), b.float())
                    for a, b in zip(la, lb))
    metric_err = max(abs(float(a) - float(b)) for a, b in
                     zip(new["cpu"][1], new["cuda"][1]))
    check(loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
          and state_err <= TRAIN_STATE_TOL and metric_err <= TRAIN_STATE_TOL,
          f"{arch}: card vs CPU loss {loss_err}, grads {grad_err}, state "
          f"{state_err}, metrics {metric_err}")
    return {"loss_abs_err": loss_err, "grad_rel_err": grad_err,
            "state_rel_err": state_err, "metric_abs_err": metric_err,
            "leaves": len(la)}


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def train_phase(torch, configs, seed: int, counters: dict) -> dict:
    """Phase 10. (a) full-width smollm-360m through ``Trainer``: run A
    uninterrupted, run B killed at ``TRAIN_FAILURE_AT`` and run B2 resuming
    it in the same workdir, A == B2 bitwise (every param and AdamW leaf);
    the loss falls; ``launch.serve --restore`` serves two greedy requests
    from A's checkpoint, token-equal to A's model served from memory; one
    step profiled, a checkpoint timed. (b) granite-moe-3b-a800m at
    ``MOE_LAYERS``: ``train_step`` with the immune router's regulation.
    (c) card vs CPU in fp32. Each run's launches by ``train_launches``."""
    import tempfile
    import warnings
    from repro_torch import prng
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import pipeline
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import model as model_lib
    from repro_torch.serve import decode
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    reset_train_counts(counters)
    rep = {"parity_fp32": {arch: card_vs_cpu(torch, configs, arch, seed)
                           for arch in ("smollm-360m", MOE_ARCH)}}
    launches = {"parity_fp32": train_launches(
        torch, configs.get_config("smollm-360m").smoke(), 0, counters,
        "10c fp32 parity", on=False)}

    # -- 10a ------------------------------------------------------------------
    cfg = configs.get_config("smollm-360m")
    tcfg = TrainConfig(learning_rate=1e-3,
                       warmup_steps=max(TRAIN_STEPS // 20, 5),
                       decay_steps=TRAIN_STEPS, seed=seed)
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    class Timed(Trainer):
        """The trainer, timing its checkpoints and its init-or-restore."""

        def _checkpoint(self, state, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._checkpoint(state, step)
            self.times.setdefault("save_s", []).append(
                time.perf_counter() - t0)

        def init_or_restore(self):
            t0 = time.perf_counter()
            out = super().init_or_restore()
            torch.cuda.synchronize()
            self.times["init_or_restore_s"] = time.perf_counter() - t0
            return out

    try:
        def trainer(sub, **kw):
            tr = Timed(cfg=cfg, tcfg=tcfg, workdir=os.path.join(work, sub),
                       batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=1,
                       device="cuda", **kw)
            tr.times = {}
            return tr

        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # the uninterrupted run checkpoints only at its end
        reset_train_counts(counters)
        tr_a = trainer("a", ckpt_every=TRAIN_STEPS)
        state_a = tr_a.train(TRAIN_STEPS)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        launches["run_a"] = train_launches(
            torch, cfg, TRAIN_STEPS, counters, "10a run A", on=FLASH_TRAINING)
        losses = [h["loss"] for h in tr_a.history]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"smollm-360m loss did not fall: {losses}")
        reset_train_counts(counters)
        try:
            trainer("b", ckpt_every=TRAIN_CKPT_EVERY,
                    failure_at=TRAIN_FAILURE_AT).train(TRAIN_STEPS)
            fail("the injected failure did not fire")
        except RuntimeError as e:
            check("injected node failure" in str(e), f"run B raised {e!r}")
        launches["run_b"] = train_launches(
            torch, cfg, TRAIN_FAILURE_AT, counters, "10a run B",
            on=FLASH_TRAINING)
        reset_train_counts(counters)
        tr_b2 = trainer("b", ckpt_every=TRAIN_CKPT_EVERY)
        state_b2 = tr_b2.train(TRAIN_STEPS)
        launches["run_b2"] = train_launches(
            torch, cfg, TRAIN_STEPS - TRAIN_CKPT_EVERY, counters, "10a run B2",
            on=FLASH_TRAINING)
        check(tr_b2.history[0]["step"] == TRAIN_CKPT_EVERY,
              f"run B2 resumed at step {tr_b2.history[0]['step']}")
        la, _ = ckpt.flatten(ts.state_tree(state_a, cfg))
        lb, _ = ckpt.flatten(ts.state_tree(state_b2, cfg))
        same = [bool(torch.equal(a, b)) for a, b in zip(la, lb)]
        differ = [i for i, ok in enumerate(same) if not ok]
        check(len(la) == len(lb) and not differ,
              f"resume not bitwise: leaves {differ} of {len(la)} differ")
        times = {"run_a": tr_a.times, "run_b2": tr_b2.times}
        nbytes = dir_bytes(os.path.join(work, "a", f"step_{TRAIN_STEPS:08d}"))
        del state_b2, tr_b2, la, lb

        # serve the checkpoint (torch route: no kernel launches)
        reset_train_counts(counters)
        argv = ["--arch", "smollm-360m", "--device", "cuda", "--batch", "2",
                "--steps", "8", "--attn-backend", "torch", "--restore",
                os.path.join(work, "a")]
        served = serve_cli.main(argv)
        args = serve_cli.build_parser().parse_args(argv)
        key = torch.as_tensor(prng.PRNGKey(1).astype("int64"))
        prompts = {"tokens": prng.randint(
            key, (args.batch, args.prompt_len), 0, cfg.vocab_size)
            .long().cuda()}
        mem, _ = decode.generate(state_a.params, cfg, prompts,
                                 max_cache=args.prompt_len + args.steps + 8,
                                 steps=args.steps, attn_backend="torch")
        check(torch.equal(served, mem.cpu()),
              f"--restore tokens {served.tolist()} != from memory "
              f"{mem.tolist()}")
        launches["restore"] = train_launches(torch, cfg, 0, counters,
                                             "10a serve --restore", on=False)

        # where a step's time goes, and one checkpoint's
        data = pipeline.DataState(step=torch.tensor(
            TRAIN_STEPS, dtype=torch.int32, device="cuda"))
        batch, _ = pipeline.sample_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, data)
        holder = [state_a]

        def one_step():
            holder[0], _ = ts.train_step(holder[0], batch, cfg, tcfg)

        wall_ms, rows = device_rows(torch, one_step, one_step)
        busy = sum(r[0] for r in rows)
        # which ops of the step deterministic mode would flag (warn only)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                one_step()
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        flagged = sorted({str(w.message)[:160] for w in caught})
        rep["smollm-360m"] = {
            "params_m": model_lib.param_count(state_a.params) / 1e6,
            "layers": cfg.num_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TRAIN_STEPS, "ckpt_every": TRAIN_CKPT_EVERY,
            "failure_at": TRAIN_FAILURE_AT, "losses": losses,
            "run_a_s": wall_a,
            "sec_per_step": [h["sec_per_step"] for h in tr_a.history],
            "resume_bitwise": True, "leaves_compared": len(same),
            "restore_tokens_equal": True,
            "step_profile": {
                "wall_ms": wall_ms, "device_ms": busy,
                "idle_share": 1.0 - busy / wall_ms if busy else None,
                "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                        for ms, n, k in rows[:8]]},
            "deterministic_warnings": flagged,
            "checkpoint": {"bytes": nbytes, **times},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state_a, holder, tr_a
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- 10b ------------------------------------------------------------------
    mcfg = dataclasses.replace(configs.get_config(MOE_ARCH),
                               num_layers=MOE_LAYERS)
    mtcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5,
                        decay_steps=MOE_TRAIN_STEPS, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_train_state(
        torch.Generator(device="cuda").manual_seed(seed), mcfg, mtcfg,
        device="cuda")
    data = pipeline.init_data_state("cuda")
    steps = []
    reset_train_counts(counters)
    for _ in range(MOE_TRAIN_STEPS):
        batch, data = pipeline.sample_batch(mcfg, MOE_TRAIN_BATCH, TRAIN_SEQ,
                                            data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = ts.train_step(state, batch, mcfg, mtcfg)
        torch.cuda.synchronize()
        steps.append({"loss": float(m.loss), "load_cv": float(m.load_cv),
                      "drop_frac": float(m.drop_frac),
                      "s": time.perf_counter() - t0})
    check(all(np.isfinite([s["loss"] for s in steps]))
          and all(np.isfinite([s["load_cv"] for s in steps])),
          f"{MOE_ARCH} training: non-finite loss or load_cv {steps}")
    bias_abs = float(state.router.bias.abs().max())
    check(bias_abs > 0, f"{MOE_ARCH}: the router bias never moved")
    rep[MOE_ARCH] = {
        "params_b": model_lib.param_count(state.params) / 1e9,
        "layers": mcfg.num_layers, "batch": MOE_TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": steps, "router_bias_max_abs": bias_abs,
        "router_steps": int(state.router.steps[0]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    launches[MOE_ARCH] = train_launches(torch, mcfg, MOE_TRAIN_STEPS,
                                        counters, "10b", on=FLASH_TRAINING)
    del state
    torch.cuda.empty_cache()
    rep["launches"] = launches
    return rep


# ---------------------------------------------------------------------------
# phase 11: the mesh — host mesh, placement, serve_step on DTensors, dry-run
# ---------------------------------------------------------------------------
MESH_BATCH, MESH_CACHE, MESH_STEPS = 8, 1024, 16
MESH_TOL = 1e-1                          # phase 3's bf16 rule, if not bitwise


def placed_equal(torch, shd, tree, plain_leaves, specs, mesh, cfg=None):
    """Place ``tree`` (a copy of the plain one) with ``specs``; every leaf
    must be a CUDA DTensor whose local shard is ``torch.equal`` to the
    plain leaf (a 1 x 1 mesh holds every tensor whole). Returns the
    placed tree and the count of leaves."""
    from torch.distributed.tensor import DTensor
    placed = shd.place(tree, specs, mesh, cfg)
    leaves = list(placed.parameters()) if cfg is not None \
        else shd_leaves(placed)
    check(len(leaves) == len(plain_leaves),
          f"mesh: {len(leaves)} placed leaves of {len(plain_leaves)}")
    for a, b in zip(leaves, plain_leaves):
        check(isinstance(a, DTensor) and a.device.type == "cuda",
              f"mesh: a placed leaf is {type(a).__name__} on {a.device}")
        check(torch.equal(a.to_local(), b),
              "mesh: a placed leaf's local shard differs from the plain leaf")
    return placed, len(leaves)


def shd_leaves(tree) -> list:
    from repro_torch.dist.checkpoint import flatten
    return flatten(tree)[0]


def mesh_phase(torch, configs, seed: int, counters: dict) -> dict:
    """Phase 11. (a) the host mesh on the card: one rank, NCCL, the card's
    memory beside the dry-run's constant. (b) full-width smollm-360m params
    and AdamW state and granite-moe-3b-a800m params at ``MOE_LAYERS``
    (expert parallel) placed by the sharding rules: CUDA DTensors whose
    local shards equal the plain leaves. (c) ``serve_step`` on the placed
    smollm-360m against the plain one, bf16, B = 8, a dense cache of 1,024,
    16 greedy steps: tokens equal and logits ``torch.equal`` (else the
    largest gap is reported and held at phase 3's rule). (d) the dry-run of
    smollm-360m ``decode_32k`` on both production meshes in subprocesses.
    No kernel launches in the phase: ``serve_step`` runs the torch
    route."""
    import copy
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib
    from repro_torch.serve import decode
    from repro_torch.train import train_step as ts
    rep = {}
    reset_counts(counters)

    # -- 11a ------------------------------------------------------------------
    mesh = make_host_mesh()
    total = torch.cuda.get_device_properties(0).total_memory
    rep["host_mesh"] = {"mesh": str(mesh), "backend": dist.get_backend(),
                        "world_size": dist.get_world_size(),
                        "device_type": mesh.device_type,
                        "total_memory_bytes": total,
                        "dryrun_hbm_bytes": dryrun.HBM_BYTES}
    check(mesh.device_type == "cuda" and dist.get_backend() == "nccl"
          and dist.get_world_size() == 1,
          f"mesh: the host mesh is not one NCCL rank on the card: "
          f"{rep['host_mesh']}")
    print(f"host mesh: {mesh} backend {dist.get_backend()} world "
          f"{dist.get_world_size()}; card memory {total} B beside the "
          f"dry-run's {dryrun.HBM_BYTES:.0f} B")
    layers.set_mesh_axes(mesh)

    # -- 11b ------------------------------------------------------------------
    t0 = time.perf_counter()
    cfg = configs.get_config("smollm-360m")
    pcfg = ParallelConfig()
    state = ts.init_train_state(
        torch.Generator(device="cuda").manual_seed(seed), cfg, TrainConfig(),
        device="cuda")
    plain_state = state._replace(params=None)
    placed = copy.deepcopy(state)
    specs = shd.train_state_shardings(placed, cfg, mesh, pcfg)
    _, n_params = placed_equal(torch, shd, placed.params,
                               list(state.params.parameters()),
                               specs.params, mesh, cfg)
    _, n_state = placed_equal(torch, shd, placed._replace(params=None),
                              shd_leaves(plain_state),
                              specs._replace(params=None), mesh)
    del placed, plain_state
    mcfg = dataclasses.replace(configs.get_config(MOE_ARCH),
                               num_layers=MOE_LAYERS)
    moe_plain = model_lib.init_params(
        mcfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    moe_specs = shd.param_shardings(moe_plain, mcfg, mesh, pcfg)
    check(moe_specs["stack"][0][0]["moe"]["w_gate"][1] == "model",
          "mesh: granite's experts are not expert-parallel")
    _, n_moe = placed_equal(torch, shd, copy.deepcopy(moe_plain),
                            list(moe_plain.parameters()), moe_specs, mesh,
                            mcfg)
    del moe_plain
    torch.cuda.synchronize()
    rep["placement"] = {"smollm_params": n_params, "smollm_state": n_state,
                        "granite_params": n_moe, "granite_layers": MOE_LAYERS,
                        "s": time.perf_counter() - t0}

    # -- 11c ------------------------------------------------------------------
    plain = state.params.requires_grad_(False)
    del state
    torch.cuda.empty_cache()
    meshed = shd.place(copy.deepcopy(plain), shd.param_shardings(
        plain, cfg, mesh, pcfg), mesh, cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    first = torch.randint(0, cfg.vocab_size, (MESH_BATCH, 1), generator=gen,
                          device="cuda", dtype=torch.int32)

    def greedy_run(params, placed_run: bool):
        cache = model_lib.init_cache(cfg, MESH_BATCH, MESH_CACHE, "cuda")
        tok = first
        if placed_run:
            cache = shd.place(cache, shd.cache_shardings(cache, cfg, mesh,
                                                         pcfg), mesh)
        toks, logits = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(MESH_STEPS):
                batch = {"token": tok}
                if placed_run:
                    batch = shd.place(batch, shd.batch_shardings(
                        batch, mesh, pcfg), mesh)
                lg, cache = decode.serve_step(params, cfg, batch, cache)
                if placed_run:
                    lg = lg.full_tensor()
                logits.append(lg)
                tok = decode.greedy(lg)
                toks.append(tok)
        torch.cuda.synchronize()
        return (torch.cat(toks, 1), torch.stack(logits),
                time.perf_counter() - t0)

    reset_counts(counters)
    p_tok, p_lg, p_s = greedy_run(plain, False)
    m_tok, m_lg, m_s = greedy_run(meshed, True)
    n = {name: fn.launches for name, fn in counters.items()}
    check(not any(n.values()), f"phase 11 launched kernels: {n}")
    bitwise = bool(torch.equal(p_lg, m_lg))
    gap = float((p_lg - m_lg).abs().max())
    tokens_equal = bool(torch.equal(p_tok, m_tok))
    if not bitwise:
        ref = p_lg.double()
        check(bool(((m_lg.double() - ref).abs()
                    <= MESH_TOL + MESH_TOL * ref.abs()).all()),
              f"mesh serve_step: logits beyond rtol = atol = {MESH_TOL} "
              f"(max gap {gap})")
    rep["serve_step"] = {"batch": MESH_BATCH, "cache": MESH_CACHE,
                         "steps": MESH_STEPS, "dtype": cfg.dtype,
                         "tokens_equal": tokens_equal,
                         "logits_bitwise": bitwise, "max_gap": gap,
                         "plain_s": p_s, "dtensor_s": m_s, "launches": n}
    check(tokens_equal, f"mesh serve_step: tokens differ (max logit gap "
          f"{gap})")
    del meshed, plain, p_lg, m_lg
    layers.set_mesh_axes(None)
    torch.cuda.empty_cache()

    # -- 11d ------------------------------------------------------------------
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_dry_")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    runs = []
    for extra in ([], ["--multi-pod"]):            # both at once
        out = os.path.join(work, f"d{len(runs)}.jsonl")
        runs.append((out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "smollm-360m", "--shape", "decode_32k", "--out", out] + extra,
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    recs = []
    try:
        for out, proc in runs:
            _, err = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"dry-run: exit {proc.returncode}: "
                  f"{err[-1500:]}")
            with open(out) as f:
                recs += [json.loads(line) for line in f]
    finally:
        for _, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    check([(r["status"], r["chips"]) for r in recs]
          == [("ok", 256), ("ok", 512)], f"dry-run records: {recs}")
    keys = ("mesh", "chips", "flops_per_device", "hbm_bytes_per_device",
            "state_bytes_per_device", "collective_bytes_per_device",
            "collective_by_kind", "t_compute_s", "t_memory_s",
            "t_collective_s", "dominant", "roofline_frac",
            "torch_flops_per_device", "memory", "fits_hbm", "compile_s")
    rep["dryrun"] = {"records": [{k: r[k] for k in keys} for r in recs],
                     "s": time.perf_counter() - t0}
    return rep


# ---------------------------------------------------------------------------
# phase 12: gemma-7b at its full published config
# ---------------------------------------------------------------------------
GEMMA_ARCH = "gemma-7b"


def gemma_trace(traces, cfg, seed: int):
    """Eight requests of ``synthetic_trace``: prompts 100 / 383 and the
    heavy class's 1,000 (drawn at ``heavy_frac`` 0.15: two at seed 0), 32
    new tokens each, two seeded lanes (``FAMILY_SAMPLED``) at temperature
    0.8."""
    trace = traces.synthetic_trace(cfg, num_requests=8, seed=seed,
                                   prompt_lens=(100, 383), heavy_prompt=1000)
    for req in trace:
        kw = dict(max_new_tokens=32)
        if req.rid in FAMILY_SAMPLED:
            kw["temperature"] = 0.8
        req.params = dataclasses.replace(req.params, **kw)
    return trace


def profile_prefill(torch, model_lib, params, cfg, req,
                    router_bias=None) -> dict:
    """One one-shot prefill of ``req`` on the kernel backend under
    ``torch.profiler`` (another in the warm-up step, each into a fresh dense
    cache; an MoE stack's ``router_bias``):
    wall and device ms, the device's idle share, flash's device ms and
    calls, the top device rows."""
    prompts = req.prompts("cuda")
    caches = [model_lib.init_cache(cfg, 1, len(req.tokens), "cuda")
              for _ in range(2)]

    def once(cache):
        with torch.no_grad():
            model_lib.prefill(params, cfg, prompts, cache,
                              attn_backend="kernel", router_bias=router_bias)

    wall_ms, rows = device_rows(torch, lambda: once(caches[0]),
                                lambda: once(caches[1]))
    busy = sum(r[0] for r in rows)
    flash = [r for r in rows if "flash" in r[2]]
    return {"prompt": len(req.tokens), "wall_ms": wall_ms,
            "device_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if busy else None,
            "flash_ms": sum(r[0] for r in flash),
            "flash_calls": sum(r[1] for r in flash),
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for ms, n, k in rows[:8]]}


def dense_profiles(torch, eng_mod, traces, model_lib, params, cfg,
                   seed: int) -> dict:
    """Phases 12, 14 (d) and 15: ``torch.profiler`` windows of ten decode
    ticks with all eight slots of ``gemma_trace`` busy and of one prefill
    of its longest (1,000-token) prompt."""
    trace = gemma_trace(traces, cfg, seed)
    out = {"profile": profile_decode(
        torch, eng_mod, params, cfg, trace,
        engine_config(eng_mod, "kernel", capture_logits=False))}
    torch.cuda.empty_cache()
    out["profile_prefill"] = profile_prefill(
        torch, model_lib, params, cfg, max(trace, key=lambda r: len(r.tokens)))
    torch.cuda.empty_cache()
    return out


def mma_bodies(torch, kernel_paths: dict, cfg) -> dict:
    """``main_bodies`` of a dense config, checked to be the tensor-core
    bodies for paged decode, verify and flash at its head dim."""
    bodies = main_bodies(torch, kernel_paths, cfg)
    attn = {k: bodies[k] for k in ("paged_attention",
                                   "paged_attention_verify",
                                   "flash_attention")}
    check(set(attn.values()) == {"mma"},
          f"{cfg.name}: kernel_path predicts {attn} at head dim "
          f"{cfg.head_dim}; its bf16 calls must take the tensor-core bodies")
    return bodies


def serve_backends(torch, eng_mod, traces, params, cfg, seed: int,
                   counters: dict, bodies: dict, rep: dict) -> dict:
    """``gemma_trace`` on phase 3's engine config on the kernel and the
    torch backends (phases 12, 14, 15): every request with its budget, the
    kernel run's launches those ``family_launches`` counts, every call on
    its body in ``bodies``, the torch run's none. Fills ``rep[backend]``;
    returns the completed requests by backend."""
    done = {}
    for backend in ("kernel", "torch"):
        eng, stats, wall, n, peak = family_serve(
            torch, eng_mod, params, cfg, gemma_trace(traces, cfg, seed),
            backend, counters, engine_config(eng_mod, backend))
        want = family_launches(cfg, stats) if backend == "kernel" \
            else dict.fromkeys(counters, 0)
        check(n == want, f"{cfg.name} {backend} launches {n} != {want}")
        paths = check_bodies(counters, n, f"{cfg.name} {backend}",
                             bodies) if backend == "kernel" else None
        done[backend] = eng.completed
        rep[backend] = {**run_summary(stats, wall),
                        "prefills": stats["prefills"], "launches": n,
                        "paths": paths, "peak_mem_gb": peak}
        del eng
        torch.cuda.empty_cache()
    return done


def gemma_phase(torch, configs, eng_mod, traces, model_lib, api, seed: int,
                counters: dict, kernel_paths: dict) -> dict:
    """Phase 12: full-width gemma-7b (head dim 256), bf16, ``--seed``
    weights, serves ``gemma_trace`` through ``Engine.run`` on phase 3's
    engine config (8 slots, page 16, max_cache 1536, one-shot prefill) on
    the kernel and the torch backends. Checks: every request finishes with
    its budget; the kernel run launches paged decode 28 x decode ticks and
    flash 28 x prefills, every call on ``mma`` (the torch run none);
    logits agree by ``bf16_rule`` (phase 3's rule, else the kernel run
    within ``BF16_FP32_CAP`` of the same weights served in fp32 on the
    torch backend and no farther than ``GEMMA_BF16_SLACK`` x the torch
    run's distance). A
    profiled window of ten decode ticks with all eight slots busy, and one
    profiled prefill of the longest prompt."""
    t0 = time.perf_counter()
    cfg = configs.get_config(GEMMA_ARCH)
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    rep = {"params_b": model_lib.param_count(params) / 1e9,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "init_s": time.perf_counter() - t0}
    bodies = mma_bodies(torch, kernel_paths, cfg)
    bf16 = serve_backends(torch, eng_mod, traces, params, cfg, seed,
                          counters, bodies, rep)
    rep.update(dense_profiles(torch, eng_mod, traces, model_lib, params,
                              cfg, seed))

    def exact():
        """The same weights upcast to fp32 in place, the torch backend."""
        t1 = time.perf_counter()
        params.float()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        eng = family_serve(torch, eng_mod, params, cfg32,
                           gemma_trace(traces, cfg32, seed), "torch",
                           counters, engine_config(eng_mod, "torch"))[0]
        rep["fp32_s"] = time.perf_counter() - t1
        return eng.completed

    rep["kernel_vs_torch_bf16"] = bf16_rule(torch, model_lib, api,
                                            GEMMA_ARCH, bf16, exact,
                                            GEMMA_BF16_SLACK)
    del params, bf16
    torch.cuda.empty_cache()
    rep["phase_s"] = time.perf_counter() - t0
    return rep


# ---------------------------------------------------------------------------
# phase 13: kimi-k2 at its full published width, one layer
# ---------------------------------------------------------------------------
KIMI_ARCH = "kimi-k2-1t-a32b"


def kimi_phase(torch, configs, eng_mod, traces, model_lib, api, moe_mod,
               router, seed: int, counters: dict, kernel_paths: dict) -> dict:
    """Phase 13: kimi-k2 at its published width cut to ``KIMI_LAYERS``
    (GQA 64 / 8 at head dim 112, 384 experts top-8, expert d_ff 2048,
    vocab 163,840, immune router, zero router bias), bf16, ``--seed``
    weights, serves ``gemma_trace`` on phase 3's engine config on the kernel
    and the torch backends. Checks: every request finishes with its budget;
    the kernel run launches flash once a prefill, paged decode once a tick
    and the grouped matmul 3 x (ticks + prefills) a layer, every call on
    ``mma`` (the D = 112 tensor-core bodies), the torch run nothing. Then
    phase 6's MoE rule: the same weights built afresh in fp32 from the same
    seed (the bf16 ones are these rounded: ``layers._normal`` draws in fp32)
    served on both backends agree within ``FP32_TOL`` (the kernel run on the
    CUDA-core bodies), and the bf16 kernel run is within ``BF16_TOL`` of the
    fp32 torch run or no farther from it than ``MOE_BF16_SLACK`` x the bf16
    torch run. Profiled windows of ten decode ticks (all eight slots busy)
    and of one 1,000-token prefill. Peak memory of every build and run."""
    t0 = time.perf_counter()
    gc.collect()                         # earlier phases' engines, cycles
    torch.cuda.empty_cache()             # and all: the fp32 model needs 73 GB
    resident = torch.cuda.memory_allocated() / 1e9
    cfg = dataclasses.replace(configs.get_config(KIMI_ARCH),
                              num_layers=KIMI_LAYERS)
    bias = torch.zeros((cfg.num_layers, cfg.num_experts), device="cuda")

    def build(c):
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        p = model_lib.init_params(
            c, torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
        torch.cuda.synchronize()
        return p, {"init_s": time.perf_counter() - t1, "init_peak_mem_gb":
                   torch.cuda.max_memory_allocated() / 1e9}

    params, built = build(cfg)
    rep = {"params_b": model_lib.param_count(params) / 1e9,
           "active_params_b": model_lib.active_param_count(params, cfg) / 1e9,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "head_dim": cfg.head_dim, "experts": cfg.num_experts,
           "top_k": cfg.experts_per_token, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "router_mode": cfg.router_mode,
           "dtype": cfg.dtype, "resident_gb_at_start": resident,
           "bf16_build": built}
    bodies = main_bodies(torch, kernel_paths, cfg)
    check(set(bodies.values()) == {"mma"},
          f"{KIMI_ARCH}: kernel_path predicts {bodies} at head dim "
          f"{cfg.head_dim}, experts {cfg.d_model} x {cfg.d_ff}; its bf16 "
          f"calls must take the tensor-core bodies")
    bf16 = {}
    for backend in ("kernel", "torch"):
        with MoEStatsRecorder(moe_mod) as rec:
            eng, stats, wall, n, peak = family_serve(
                torch, eng_mod, params, cfg, gemma_trace(traces, cfg, seed),
                backend, counters, engine_config(eng_mod, backend), bias)
        want = family_launches(cfg, stats) if backend == "kernel" \
            else dict.fromkeys(counters, 0)
        check(n == want, f"{KIMI_ARCH} {backend} launches {n} != {want}")
        paths = check_bodies(counters, n, f"{KIMI_ARCH} {backend}",
                             bodies) if backend == "kernel" else None
        bf16[backend] = eng.completed
        rep[backend] = {**run_summary(stats, wall),
                        "prefills": stats["prefills"], "launches": n,
                        "paths": paths, "peak_mem_gb": peak,
                        "routing": rec.summary(torch, router)}
        del eng
        torch.cuda.empty_cache()
    trace = gemma_trace(traces, cfg, seed)
    rep["profile"] = profile_decode(
        torch, eng_mod, params, cfg, trace,
        engine_config(eng_mod, "kernel", capture_logits=False),
        router_bias=bias)
    torch.cuda.empty_cache()
    rep["profile_prefill"] = profile_prefill(
        torch, model_lib, params, cfg, max(trace, key=lambda r: len(r.tokens)),
        bias)
    del params
    gc.collect()                         # the engines' cycles hold the weights
    torch.cuda.empty_cache()

    # the same weights in fp32, built afresh (converting the bf16 tree in
    # place would peak near 84 GB beside a 22.5 GB fp32 expert leaf)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32, rep["fp32_build"] = build(cfg32)
    exact = {}
    for backend in ("kernel", "torch"):
        eng, stats, wall, n, peak = family_serve(
            torch, eng_mod, params32, cfg32, gemma_trace(traces, cfg32, seed),
            backend, counters, engine_config(eng_mod, backend), bias)
        want = family_launches(cfg32, stats) if backend == "kernel" \
            else dict.fromkeys(counters, 0)
        check(n == want, f"{KIMI_ARCH} fp32 {backend} launches {n} != {want}")
        if backend == "kernel":
            check_bodies(counters, n, f"{KIMI_ARCH} fp32 kernel",
                         dict.fromkeys(bodies, "cuda_core"))
        exact[backend] = eng.completed
        rep[f"fp32_{backend}"] = {"wall_s": wall, "launches": n,
                                  "peak_mem_gb": peak}
        del eng
    del params32
    torch.cuda.empty_cache()
    agree32 = agreement(torch, model_lib, api, exact["kernel"],
                        exact["torch"], *FP32_TOL)
    check(not agree32["violations"], f"{KIMI_ARCH} kernel and torch runs "
          f"disagree in fp32: {agree32['first_violations']}")
    vs_exact = {name: agreement(torch, model_lib, api, bf16[name],
                                exact["torch"], *BF16_TOL)
                for name in ("kernel", "torch")}
    ratio = {name: r["max_diff_over_tol"] for name, r in vs_exact.items()}
    check(ratio["kernel"] <= max(1.0, MOE_BF16_SLACK * ratio["torch"]),
          f"{KIMI_ARCH} bf16 kernel run is farther from fp32 arithmetic than "
          f"{MOE_BF16_SLACK} x the torch run: {ratio}")
    agree = agreement(torch, model_lib, api, bf16["kernel"], bf16["torch"],
                      *BF16_TOL)
    rep["agreement_fp32"] = {**{k: agree32[k] for k in (
        "max_logits_diff", "max_diff_over_tol", "diverged", "violations")},
        "rtol": FP32_TOL[0], "atol": FP32_TOL[1]}
    rep["agreement_bf16"] = {k: agree[k] for k in (
        "max_logits_diff", "max_diff_over_tol", "diverged", "violations")}
    rep["bf16_vs_fp32"] = {name: {k: r[k] for k in (
        "max_logits_diff", "max_diff_over_tol", "violations")}
        for name, r in vs_exact.items()}
    rep["bf16_slack"] = MOE_BF16_SLACK
    rep["phase_s"] = time.perf_counter() - t0
    return rep


# ---------------------------------------------------------------------------
# phase 14: qwen3-4b at its full published config
# ---------------------------------------------------------------------------
QWEN_ARCH = "qwen3-4b"
# (c) preemption by page exhaustion, the JAX package's bar
# (benchmarks/serve_engine.py run_preemption: worst-case reservation against
# preempt-mode admission on one contention trace and one undersized pool)
# at full width: 16 greedy requests, light prompts of 100 / 383 tokens with
# 16 / 17 new tokens, every 4th a hog with a 1,000-token prompt and 128 new
# tokens, on 8 slots, page 16, max_cache 1,536 and a pool of 144 pages plus
# the null page, about half the ~290 that 8 full slots of this mix hold.
PREEMPT_TRACE = dict(num_requests=16, prompt_lens=(100, 383),
                     hog_prompt=1000, light_tokens=16, hog_tokens=128,
                     hog_every=4)
PREEMPT_PAGES = 144
# Chunked prefill at 256 tokens: the JAX bar chunks its 32-token hog prompt
# in 2 and its light prompts in 1; at 16 a 1,000-token hog prompt takes 63
# chunk ticks, each a second 36-layer pass beside the decode pass, at 256
# it takes 4, and a run of the trace 330 ticks (~31 s on an NVIDIA H100
# 80GB HBM3 at 700 W)
PREEMPT_CHUNK = 256
# The bf16 runs' schedule. It depends only on the lengths (every lane
# greedy, none stops early), so the CPU predicts it on a 1-layer model
# (tests/test_torch_qwen3.py) and the card must repeat it.
PREEMPT_PLAN = {"reserve": {"ticks": 329, "concurrency_hw": 4,
                            "preemptions": 0, "replayed_tokens": 0},
                "preempt": {"ticks": 330, "concurrency_hw": 8,
                            "preemptions": 22, "preempted_requests": 10,
                            "replayed_tokens": 30}}


def preempt_config(eng_mod, mode: str, pages: Optional[int],
                   capture_logits: bool = True):
    """Phase 14 (c)'s engine: ``pages`` pages plus the null page (None:
    fully provisioned, phase 14 (a)'s pool), ``mode`` admission."""
    return eng_mod.EngineConfig(
        num_slots=8, page_size=16, max_cache=1536,
        prefill_chunk=PREEMPT_CHUNK, num_classes=3, latency_budget=512.0,
        attn_backend="kernel", capture_logits=capture_logits,
        admission_mode=mode, num_pages=None if pages is None else pages + 1)


def uninterrupted(torch, eng_mod, traces, model_lib, api, params, cfg,
                  seed: int, counters: dict, bodies: dict,
                  victims: list) -> dict:
    """The preempted requests ``victims`` served again from their fresh
    trace entries on the full pool (no preemption), every call on its body
    in ``bodies``, and held to it: bf16 by phase 3's rule, fp32 token for
    token with logits within ``FP32_TOL``."""
    what = f"{cfg.name} {cfg.dtype} preemption"
    fresh = {r.rid: r for r in traces.contention_trace(cfg, seed=seed,
                                                        **PREEMPT_TRACE)}
    alone = [dataclasses.replace(fresh[r.rid], arrival=0) for r in victims]
    eng, st, wall, n, _ = family_serve(
        torch, eng_mod, params, cfg, alone, "kernel", counters,
        preempt_config(eng_mod, "preempt", None))
    check(st["preemptions"] == 0, f"{what}: the uninterrupted run "
          f"preempted {st['preemptions']} times")
    check_bodies(counters, n, f"{what} uninterrupted", bodies)
    exact = cfg.dtype == "float32"
    agree = agreement(torch, model_lib, api, victims, eng.completed,
                      *(FP32_TOL if exact else BF16_TOL))
    check(not agree["violations"], f"{what}: preempted streams disagree "
          f"with their uninterrupted runs: {agree['first_violations']}")
    if exact:
        check(not agree["diverged"], f"{what}: preempted streams' tokens "
              f"differ from their uninterrupted runs: {agree['diverged']}")
    out = {"rids": sorted(r.rid for r in victims),
           "preemptions": {r.rid: r.preemptions for r in victims},
           "replayed_tokens": {r.rid: r.replayed_tokens for r in victims},
           "uninterrupted_wall_s": wall, "uninterrupted_ticks": st["ticks"],
           "agreement": {**{k: agree[k] for k in (
               "max_logits_diff", "max_diff_over_tol", "diverged",
               "violations")}, "rule": "fp32" if exact else "bf16"}}
    del eng
    torch.cuda.empty_cache()
    return out


def preemption(torch, eng_mod, traces, model_lib, api, params, cfg,
               seed: int, counters: dict, bodies: dict) -> dict:
    """Phase 14 (c) in bf16: ``contention_trace`` under each admission mode
    on the undersized pool, every request with its budget, launches those
    ``family_launches`` counts on ``bodies``; the schedule ``PREEMPT_PLAN``
    (preemption fires and replays, preempt admits deeper than reserve);
    each preempted request held to its ``uninterrupted`` run."""
    what = f"{cfg.name} {cfg.dtype} preemption"
    rep, runs = {}, {}
    for mode in ("reserve", "preempt"):
        trace = traces.contention_trace(cfg, seed=seed, **PREEMPT_TRACE)
        eng, stats, wall, n, peak = family_serve(
            torch, eng_mod, params, cfg, trace, "kernel", counters,
            preempt_config(eng_mod, mode, PREEMPT_PAGES,
                           capture_logits=mode == "preempt"))
        check(n == family_launches(cfg, stats),
              f"{what} {mode}: launches {n} != {family_launches(cfg, stats)}")
        paths = check_bodies(counters, n, f"{what} {mode}", bodies)
        runs[mode] = (eng, stats)
        rep[mode] = {**{k: stats[k] for k in (
            "completed", "ticks", "decode_ticks", "chunked_prefill_chunks",
            "concurrency_hw", "pages_hw", "preemptions", "preempted_requests",
            "replayed_tokens", "p50_latency", "p99_latency", "goodput")},
            "wall_s": wall, "launches": n, "paths": paths,
            "peak_mem_gb": peak}
        got = {k: stats[k] for k in PREEMPT_PLAN[mode]}
        check(got == PREEMPT_PLAN[mode], f"{what} {mode}: schedule {got}, "
              f"the CPU's {PREEMPT_PLAN[mode]}")
    eng = runs["preempt"][0]
    rep["schedule"] = {r.rid: [r.preemptions, r.replayed_tokens]
                       for r in eng.completed}
    rep["preempted"] = uninterrupted(
        torch, eng_mod, traces, model_lib, api, params, cfg, seed, counters,
        bodies, [r for r in eng.completed if r.preemptions])
    rep["pool_pages"] = PREEMPT_PAGES
    rep["prefill_chunk"] = PREEMPT_CHUNK
    del runs, eng
    torch.cuda.empty_cache()
    return rep


def preemption_fp32(torch, eng_mod, traces, model_lib, api, params, cfg,
                    seed: int, counters: dict, bodies: dict,
                    schedule: dict) -> dict:
    """Phase 14 (c) in fp32, cut short: the preempt run on the same trace
    and pool, stepped until the first request that replayed tokens
    completes, launches those ``family_launches`` counts on ``bodies``.
    Every request done by then was preempted and replayed as in the bf16
    run (``schedule``: rid -> [preemptions, replayed tokens]); the
    preempted ones are held to their ``uninterrupted`` runs."""
    what = f"{cfg.name} {cfg.dtype} preemption"
    eng = eng_mod.Engine(params, cfg, preempt_config(
        eng_mod, "preempt", PREEMPT_PAGES), device="cuda")
    trace = traces.contention_trace(cfg, seed=seed, **PREEMPT_TRACE)

    def until_replayed():
        for out in eng.stream(trace, max_ticks=2000):
            if out.finished and any(r.rid == out.rid and r.replayed_tokens
                                    for r in eng.completed):
                break
        return eng.stats()

    stats, wall, n = run_counted(torch, counters, until_replayed)
    check(n == family_launches(cfg, stats),
          f"{what}: launches {n} != {family_launches(cfg, stats)}")
    paths = check_bodies(counters, n, what, bodies)
    check_budgets(eng, what)
    done = {r.rid: [r.preemptions, r.replayed_tokens] for r in eng.completed}
    check(done and all(done[rid] == schedule[rid] for rid in done),
          f"{what}: preemptions and replays {done}, bf16's {schedule}")
    victims = [r for r in eng.completed if r.preemptions]
    check(any(r.replayed_tokens for r in victims),
          f"{what}: no preempted request replayed tokens: {done}")
    rep = {"ticks": stats["ticks"], "completed": stats["completed"],
           "preemptions": stats["preemptions"],
           "replayed_tokens": stats["replayed_tokens"], "wall_s": wall,
           "launches": n, "paths": paths}
    rep["preempted"] = uninterrupted(
        torch, eng_mod, traces, model_lib, api, params, cfg, seed, counters,
        bodies, victims)
    del eng
    torch.cuda.empty_cache()
    return rep


def dense_spec(torch, eng_mod, traces, spec_mod, model_lib, api, params,
               cfg, seed: int, counters: dict, bodies: dict) -> dict:
    """Phase 14 (b): four greedy requests of ``gemma_trace`` on the same
    weights made draft-friendly at depth ``SPEC_DEPTH``, ``spec_decode`` =
    ``SPEC_K`` and without, on phase 3's engine config: budgets, verify
    launched num_layers x spec ticks, paged decode num_layers x plain
    ticks + ``SPEC_DEPTH`` x ``SPEC_K`` x spec ticks, flash num_layers x
    prefills, every call on its body; the streams agree by phase 3's rule."""
    drafty = spec_mod.make_draft_friendly(params, cfg, SPEC_DEPTH)
    runs = {}
    for spec in (True, False):
        reqs = [dataclasses.replace(r, arrival=0)
                for r in gemma_trace(traces, cfg, seed)
                if r.params.is_greedy][:4]
        ecfg = engine_config(eng_mod, "kernel")._replace(
            spec_decode=SPEC_K if spec else 0,
            spec_draft_layers=SPEC_DEPTH if spec else 0)
        eng, st, wall, n, _ = family_serve(torch, eng_mod, drafty, cfg, reqs,
                                           "kernel", counters, ecfg)
        check_bodies(counters, n, f"{cfg.name} spec={spec}", bodies)
        runs[spec] = (eng, st, wall, n)
    eng, st, wall, n = runs[True]
    check(st["spec_ticks"] > 0, f"{cfg.name}: the spec run ran no spec tick")
    layers = cfg.num_layers
    want = {"paged_attention_verify": layers * st["spec_ticks"],
            "paged_attention": layers * st["decode_ticks"]
            + SPEC_DEPTH * SPEC_K * st["spec_ticks"],
            "flash_attention": layers * st["prefills"], "moe_gmm": 0}
    check(n == want, f"{cfg.name} spec run launches {n} != {want}")
    plain = runs[False]
    check(plain[3] == family_launches(cfg, plain[1]),
          f"{cfg.name} non-spec run launches {plain[3]}")
    agree = agreement(torch, model_lib, api, eng.completed,
                      plain[0].completed, *BF16_TOL)
    check(not agree["violations"], f"{cfg.name} spec and non-spec streams "
          f"disagree: {agree['first_violations']}")
    out = {"spec": {**run_summary(st, wall), "launches": n},
           "non_spec": {**run_summary(plain[1], plain[2]),
                        "launches": plain[3]},
           "agreement": {**agree, "rtol": BF16_TOL[0], "atol": BF16_TOL[1]},
           "k": SPEC_K, "draft_layers": SPEC_DEPTH}
    del runs, eng, drafty
    torch.cuda.empty_cache()
    return out




def qwen_phase(torch, configs, eng_mod, traces, model_lib, api, spec_mod,
               seed: int, counters: dict, kernel_paths: dict) -> dict:
    """Phase 14: full-width qwen3-4b (36 layers, GQA 32 / 8 at head dim
    128, qk-norm), bf16, ``--seed`` weights. (a) ``gemma_trace`` on both
    backends (``serve_backends``), flash 36 x prefills and paged decode 36
    x ticks on ``mma``, logits by ``bf16_rule``; (d) profiled windows of
    ten decode ticks and of one 1,000-token prefill; (c) ``preemption`` in
    bf16; (b) ``dense_spec``; then the same weights upcast to fp32 in
    place: ``preemption_fp32`` on the CUDA-core bodies, and the fp32 torch
    run ``bf16_rule`` reads where the 1e-1 rule misses."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config(QWEN_ARCH)
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    rep = {"params_b": model_lib.param_count(params) / 1e9,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "head_dim": cfg.head_dim, "qk_norm": cfg.qk_norm,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "rope_theta": cfg.rope_theta, "dtype": cfg.dtype,
           "init_s": time.perf_counter() - t0}
    check(cfg.qk_norm and cfg.head_dim == 128, f"{QWEN_ARCH}: {cfg}")
    bodies = mma_bodies(torch, kernel_paths, cfg)
    seconds = {}
    t1 = time.perf_counter()
    bf16 = serve_backends(torch, eng_mod, traces, params, cfg, seed,
                          counters, bodies, rep)
    rep.update(dense_profiles(torch, eng_mod, traces, model_lib, params,
                              cfg, seed))
    seconds["serve_and_profile"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rep["preemption_bf16"] = preemption(torch, eng_mod, traces, model_lib,
                                        api, params, cfg, seed, counters,
                                        bodies)
    seconds["preemption_bf16"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rep["spec"] = dense_spec(torch, eng_mod, traces, spec_mod, model_lib, api,
                             params, cfg, seed, counters, bodies)
    seconds["spec"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    params.float()                   # in place, one parameter at a time
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rep["preemption_fp32"] = preemption_fp32(
        torch, eng_mod, traces, model_lib, api, params, cfg32, seed,
        counters, dict.fromkeys(bodies, "cuda_core"),
        rep["preemption_bf16"]["schedule"])
    seconds["preemption_fp32"] = time.perf_counter() - t1

    def exact():
        """The same weights (upcast above), the torch backend."""
        t2 = time.perf_counter()
        eng = family_serve(torch, eng_mod, params, cfg32,
                           gemma_trace(traces, cfg32, seed), "torch",
                           counters, engine_config(eng_mod, "torch"))[0]
        rep["fp32_s"] = time.perf_counter() - t2
        return eng.completed

    rep["kernel_vs_torch_bf16"] = bf16_rule(torch, model_lib, api,
                                            QWEN_ARCH, bf16, exact)
    del params, bf16
    gc.collect()
    torch.cuda.empty_cache()
    rep["seconds"] = seconds
    rep["phase_s"] = time.perf_counter() - t0
    return rep


# ---------------------------------------------------------------------------
# phase 15: minicpm-2b at its full published config, serving and training
# ---------------------------------------------------------------------------
MINICPM_ARCH = "minicpm-2b"
# 15 (b): three steps at 4 x 128 under WSD: step 1 in the warmup (lr x
# 1/2), step 2 on the plateau (stable_frac x decay_steps = 2), step 3 in
# the 1-sqrt decay tail. AdamW's moments in fp32 (2 x 10.9 GB), updated
# in place
WSD_STEPS, WSD_BATCH = 3, 4


def wsd_config(seed: int):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(learning_rate=1e-3, schedule="wsd", warmup_steps=2,
                       decay_steps=4, stable_frac=0.5, seed=seed)


def minicpm_phase(torch, configs, eng_mod, traces, model_lib, api,
                  seed: int, counters: dict, kernel_paths: dict) -> dict:
    """Phase 15: full-width minicpm-2b (40 layers, MHA 36 / 36 at head dim
    64, vocab 122,753, tied), bf16, ``--seed`` weights. (a)
    ``gemma_trace`` on both backends (``serve_backends``: flash 40 x
    prefills and paged decode 40 x ticks on ``mma``), logits by
    ``bf16_rule`` (the same weights upcast for its fp32 run), profiled
    windows of ten decode ticks and one 1,000-token prefill. (b) Three
    ``train_step`` calls at 4 x 128 under ``wsd_config`` (warmup, stable
    and decay each a step; fp32 moments): losses finite, each step's
    learning rate the CPU's ``optimizer.schedule``, peak memory, flash
    forward and backward launches by ``train_launches``; then one
    smoke-size fp32 step on the card and on the CPU (``card_vs_cpu``, the
    WSD schedule), which launches nothing."""
    from repro_torch.data import pipeline
    from repro_torch.dist.checkpoint import flatten
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config(MINICPM_ARCH)
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    rep = {"params_b": model_lib.param_count(params) / 1e9,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "init_s": time.perf_counter() - t0}
    bodies = mma_bodies(torch, kernel_paths, cfg)
    bf16 = serve_backends(torch, eng_mod, traces, params, cfg, seed,
                          counters, bodies, rep)
    rep.update(dense_profiles(torch, eng_mod, traces, model_lib, params,
                              cfg, seed))

    def exact():
        """The same weights upcast to fp32 in place, the torch backend."""
        t1 = time.perf_counter()
        params.float()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        eng = family_serve(torch, eng_mod, params, cfg32,
                           gemma_trace(traces, cfg32, seed), "torch",
                           counters, engine_config(eng_mod, "torch"))[0]
        rep["fp32_s"] = time.perf_counter() - t1
        return eng.completed

    rep["kernel_vs_torch_bf16"] = bf16_rule(torch, model_lib, api,
                                            MINICPM_ARCH, bf16, exact)
    del params, bf16
    gc.collect()
    torch.cuda.empty_cache()
    rep["serve_s"] = time.perf_counter() - t0

    # -- 15b: training under WSD --------------------------------------------
    t1 = time.perf_counter()
    reset_train_counts(counters)
    tcfg = wsd_config(seed)
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_train_state(
        torch.Generator(device="cuda").manual_seed(seed), cfg, tcfg,
        device="cuda")
    data = pipeline.init_data_state("cuda")
    steps = []
    for _ in range(WSD_STEPS):
        batch, data = pipeline.sample_batch(cfg, WSD_BATCH, TRAIN_SEQ, data)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state, m = ts.train_step(state, batch, cfg, tcfg)
        torch.cuda.synchronize()
        cpu_lr = float(opt.schedule(tcfg, torch.tensor(int(state.step),
                                                       dtype=torch.int32)))
        steps.append({"step": int(state.step), "loss": float(m.loss),
                      "lr": float(m.lr), "cpu_lr": cpu_lr,
                      "s": time.perf_counter() - t2})
    check(all(np.isfinite([s["loss"] for s in steps])),
          f"{MINICPM_ARCH} training: non-finite loss {steps}")
    check(all(s["lr"] == s["cpu_lr"] for s in steps),
          f"{MINICPM_ARCH} training: the card's learning rates are not the "
          f"CPU's schedule: {steps}")
    lrs = [s["lr"] for s in steps]
    check(lrs[0] < lrs[1] > lrs[2] > 0, f"{MINICPM_ARCH}: the WSD steps do "
          f"not cover warmup, plateau and decay: {lrs}")
    rep["train"] = {"batch": WSD_BATCH, "seq": TRAIN_SEQ, "steps": steps,
                    "schedule": dataclasses.asdict(tcfg),
                    "moments": str(flatten(state.opt.mu)[0][0].dtype),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "train_s": time.perf_counter() - t1,
                    "launches": train_launches(
                        torch, cfg, WSD_STEPS, counters, "15b",
                        on=FLASH_TRAINING)}
    del state, batch, data
    gc.collect()
    torch.cuda.empty_cache()
    reset_train_counts(counters)
    rep["parity_fp32"] = card_vs_cpu(torch, configs, MINICPM_ARCH, seed,
                                     schedule="wsd")
    rep["parity_fp32"]["launches"] = train_launches(
        torch, configs.get_config(MINICPM_ARCH).smoke(), 0, counters,
        "15b fp32 parity", on=False)
    rep["phase_s"] = time.perf_counter() - t0
    return rep


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
    from repro_torch.core import router
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import kernel_path as flash_path
    from repro_torch.kernels.grid_step import grid_step
    from repro_torch.kernels.moe_gmm import gmm_ref, moe_gmm
    from repro_torch.kernels.moe_gmm import kernel_path as gmm_path
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_ref, paged_attention_verify,
        paged_attention_verify_ref)
    from repro_torch.kernels.paged_attention import kernel_path as paged_path
    from repro_torch.kernels.paged_attention.ops import \
        HEAD_DIMS as paged_pkg_dims
    from repro_torch.kernels.flash_attention.ops import \
        HEAD_DIMS as flash_pkg_dims
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import api, durability, faults, groups, traces
    from repro_torch.serve import engine as eng_mod
    from repro_torch.serve import router as router_mod
    from repro_torch.serve import spec as spec_mod
    counters = {"paged_attention": paged_attention,
                "paged_attention_verify": paged_attention_verify,
                "flash_attention": flash_attention, "moe_gmm": moe_gmm}
    kernel_paths = {"paged": paged_path, "flash": flash_path,
                    "gmm": gmm_path}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_start = {"1": time.perf_counter()}
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

    phase_start["2"] = time.perf_counter()
    # -- phase 2: kernels -----------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    paged_cases = check_paged(torch, gen, paged_attention, paged_attention_ref,
                              paged_path)
    verify_cases = check_verify(torch, gen, paged_attention_verify,
                                paged_attention_verify_ref, paged_attention,
                                paged_path)
    flash_cases = check_flash(torch, gen, flash_attention, attention_ref,
                              flash_path)
    gmm_cases = check_gmm(torch, gen, moe_gmm, gmm_ref, gmm_path)
    print("kernel checks: " + json.dumps({"paged": paged_cases,
                                          "verify": verify_cases,
                                          "flash": flash_cases,
                                          "moe_gmm": gmm_cases}))
    cfg = configs.get_config("smollm-360m")
    positions = verify_positions(traces, cfg, args.seed)
    paged_t = time_paged(torch, gen, paged_attention, paged_attention_ref)
    verify_t = time_verify(torch, gen, paged_attention_verify,
                           paged_attention_verify_ref, positions)
    flash_t = time_flash(torch, gen, flash_attention, attention_ref)
    # the head dim 256 on the paths of phases 8 and 12: paligemma-3b's and
    # gemma-7b's decode, verify at paligemma's heads, and flash at both
    # models' heads (8 / 1, 16 / 16) beside SDPA
    paged256_t = time_paged(torch, gen, paged_attention, paged_attention_ref,
                            **PALIGEMMA_DECODE)
    paged256_t["gemma"] = time_paged(torch, gen, paged_attention,
                                     paged_attention_ref, **GEMMA_DECODE)
    verify256_t = time_verify(torch, gen, paged_attention_verify,
                              paged_attention_verify_ref, **PALIGEMMA_VERIFY)
    flash256_t = time_flash(torch, gen, flash_attention, attention_ref, h=8,
                            hk=1, d=256, lengths=(1000,))
    flash256_t["gemma"] = time_flash(torch, gen, flash_attention,
                                     attention_ref, h=16, hk=16, d=256,
                                     lengths=(1000,))
    # the head dim 112 on phase 13's path: kimi-k2's decode (64 / 8 heads),
    # verify at its heads, flash at its 1,000-token prefill beside SDPA
    paged112_t = time_paged(torch, gen, paged_attention, paged_attention_ref,
                            **KIMI_DECODE)
    verify112_t = time_verify(torch, gen, paged_attention_verify,
                              paged_attention_verify_ref, **KIMI_VERIFY)
    flash112_t = time_flash(torch, gen, flash_attention, attention_ref, h=64,
                            hk=8, d=112, lengths=(1000,))
    # the head dim 128 at qwen3-4b's GQA 32 / 8 on phase 14's path (decode,
    # verify under speculation, its prefills beside SDPA) and minicpm-2b's
    # 36 / 36 at D = 64 on phase 15's (decode, a 1,000-token prefill)
    paged128_t = time_paged(torch, gen, paged_attention, paged_attention_ref,
                            **QWEN_DECODE)
    verify128_t = time_verify(torch, gen, paged_attention_verify,
                              paged_attention_verify_ref, **QWEN_VERIFY)
    flash128_t = time_flash(torch, gen, flash_attention, attention_ref, h=32,
                            hk=8, d=128, lengths=(1000, 383))
    paged_mc_t = time_paged(torch, gen, paged_attention, paged_attention_ref,
                            **MINICPM_DECODE)
    flash_mc_t = time_flash(torch, gen, flash_attention, attention_ref, h=36,
                            hk=36, d=64, lengths=(1000,))
    # the flash backward at the training shapes of minicpm-2b (its
    # benchmark cell, 2 x 2,048) and qwen3-4b (GQA 32 / 8 at D = 128)
    flash_bwd_t = {"minicpm": time_flash_bwd(torch, gen, 36, 36, 64),
                   "qwen3": time_flash_bwd(torch, gen, 32, 8, 128)}
    gmm_t = time_gmm(torch, gen, moe_gmm, gmm_ref)
    print("kernel timing shapes: " + json.dumps(
        {"paged_attention": paged_t["shape"],
         "paged_attention_verify": {**verify_t["shape"],
                                    "library": verify_t["library_note"]},
         "flash_attention": [flash_t["shape"], flash_t["s383"]["shape"]],
         "paged_attention_d256": [paged256_t["shape"],
                                  paged256_t["gemma"]["shape"]],
         "paged_attention_verify_d256": verify256_t["shape"],
         "flash_attention_d256": [flash256_t["shape"],
                                  flash256_t["gemma"]["shape"]],
         "paged_attention_d112": paged112_t["shape"],
         "paged_attention_verify_d112": verify112_t["shape"],
         "flash_attention_d112": flash112_t["shape"],
         "paged_attention_d128": paged128_t["shape"],
         "paged_attention_verify_d128": verify128_t["shape"],
         "flash_attention_d128": [flash128_t["shape"],
                                  flash128_t["s383"]["shape"]],
         "paged_attention_minicpm": paged_mc_t["shape"],
         "flash_attention_minicpm": flash_mc_t["shape"],
         "flash_attention_bwd": [t["shape"] for t in flash_bwd_t.values()],
         "moe_gmm": [gmm_t["shape"]] + [gmm_t[k]["shape"] for k in (
             "prefill", "kimi", "kimi_prefill")]}))
    print("paged kernels beside SDPA on the same live K / V, gathered and "
          "padded beforehand (not the same function): " + json.dumps(
              {"paged_attention": {"device_ms": paged_t["device_ms"],
                                   "dense_sdpa": paged_t["dense_sdpa"]},
               "paged_attention_verify": {
                   "device_ms": verify_t["device_ms"],
                   "dense_sdpa": verify_t["dense_sdpa"]},
               "paged_attention_d112": {
                   "device_ms": paged112_t["device_ms"],
                   "dense_sdpa": paged112_t["dense_sdpa"]},
               "paged_attention_verify_d112": {
                   "device_ms": verify112_t["device_ms"],
                   "dense_sdpa": verify112_t["dense_sdpa"]},
               "paged_attention_d128": {
                   "device_ms": paged128_t["device_ms"],
                   "dense_sdpa": paged128_t["dense_sdpa"]},
               "paged_attention_verify_d128": {
                   "device_ms": verify128_t["device_ms"],
                   "dense_sdpa": verify128_t["dense_sdpa"]},
               "paged_attention_minicpm": {
                   "device_ms": paged_mc_t["device_ms"],
                   "dense_sdpa": paged_mc_t["dense_sdpa"]}}))

    phase_start["3"] = time.perf_counter()
    # -- phase 3: the engine on smollm-360m -----------------------------------
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")
    print(f"smollm-360m: {model_lib.param_count(params) / 1e6:.1f}M params, "
          f"{cfg.num_layers} layers, dtype {cfg.dtype}")
    trace = make_trace(traces, cfg, args.seed)
    reset_counts(counters)
    eng, stats, wall = serve(torch, eng_mod, params, cfg, trace, "kernel")
    paged_n, flash_n = paged_attention.launches, flash_attention.launches
    engine_paths = check_bodies(
        counters, {name: fn.launches for name, fn in counters.items()},
        "engine", main_bodies(torch, kernel_paths, cfg))
    flash_paths = engine_paths["flash_attention"]
    check(paged_attention_verify.launches == 0,
          "the plain engine launched the verify kernel")
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
        "paged_paths": engine_paths["paged_attention"],
        "flash_launches": flash_n, "flash_paths": flash_paths,
        "capture_logits": True}))
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
                          make_trace(traces, cfg, args.seed),
                          engine_config(eng_mod, "kernel",
                                        capture_logits=False))
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

    for arch in ("smollm-360m", MOE_ARCH):
        print("smoke engine == one-shot generate (fp32): " + json.dumps(
            smoke_oneshot_parity(torch, configs, model_lib, eng_mod, api,
                                 traces, args.seed, arch)))

    phase_start["4-5"] = time.perf_counter()
    # -- phases 4 and 5: speculative decoding and slot groups -----------------
    cfg45 = dataclasses.replace(cfg, num_layers=SPEC_LAYERS)
    params = model_lib.init_params(
        cfg45, torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")
    drafty = spec_mod.make_draft_friendly(params, cfg45, SPEC_DEPTH)
    spec_rep, verify_n = spec_phase(torch, eng_mod, traces, model_lib, api,
                                    drafty, cfg45, args.seed, counters,
                                    kernel_paths)
    print("spec decode: " + json.dumps(spec_rep))
    long = [dataclasses.replace(r, params=dataclasses.replace(
        r.params, max_new_tokens=128)) for r in spec_trace(traces, cfg45,
                                                           args.seed)]
    for spec in (True, False):
        ecfg = spec_config(eng_mod, spec, capture_logits=False)._replace(
            prefill_chunk=0)
        prof = profile_decode(torch, eng_mod, drafty, cfg45, long, ecfg)
        print(f"{'spec' if spec else 'plain'} tick profile (spec trace): "
              + json.dumps(prof))
    del drafty
    group_rep = group_phase(torch, eng_mod, groups, model_lib, api, params,
                            cfg45, args.seed, counters, kernel_paths)
    print("slot groups: " + json.dumps(group_rep))
    del params

    phase_start["6"] = time.perf_counter()
    # -- phase 6: MoE serving on granite-moe-3b-a800m -------------------------
    moe_rep, gmm_n = moe_phase(torch, configs, eng_mod, traces, model_lib, api,
                               moe_mod, router, spec_mod, args.seed, counters,
                               kernel_paths)
    print("moe serving: " + json.dumps(moe_rep))

    phase_start["7"] = time.perf_counter()
    # -- phase 7: the paper's VLSI extraction pipeline ------------------------
    t0 = time.perf_counter()
    vlsi_rep, grid_k = vlsi_phase(torch, {**counters, "grid_step": grid_step},
                                  args.seed)
    vlsi_rep["phase_s"] = time.perf_counter() - t0
    print("vlsi extraction: " + json.dumps(vlsi_rep))

    phase_start["8"] = time.perf_counter()
    # -- phase 8: the SSM, hybrid, VLM and audio families ---------------------
    family_rep = {}
    for arch in FAMILY_ARCHS:
        family_rep[arch] = family_phase(torch, configs, eng_mod, traces,
                                        model_lib, api, arch, args.seed,
                                        counters, kernel_paths)
        print(f"{arch}: " + json.dumps(family_rep[arch]))
    phase8 = {arch: r["kernel"]["launches"] for arch, r in family_rep.items()}

    phase_start["9"] = time.perf_counter()
    # -- phase 9: the serving fleet -------------------------------------------
    fleet_rep, phase9 = fleet_phase(torch, configs, eng_mod, traces,
                                    model_lib, router_mod, faults,
                                    durability, args.seed, counters,
                                    kernel_paths)
    print("serving fleet: " + json.dumps(fleet_rep))

    phase_start["10"] = time.perf_counter()
    # -- phase 10: training ---------------------------------------------------
    train_rep = train_phase(torch, configs, args.seed,
                            {**counters, "grid_step": grid_step})
    print("training: " + json.dumps(train_rep))

    phase_start["11"] = time.perf_counter()
    # -- phase 11: the mesh ---------------------------------------------------
    mesh_rep = mesh_phase(torch, configs, args.seed,
                          {**counters, "grid_step": grid_step})
    print("mesh: " + json.dumps(mesh_rep))

    phase_start["12"] = time.perf_counter()
    # -- phase 12: gemma-7b at its full published config ----------------------
    gemma_rep = gemma_phase(torch, configs, eng_mod, traces, model_lib, api,
                            args.seed, counters, kernel_paths)
    phase12 = gemma_rep["kernel"]["launches"]
    print(f"{GEMMA_ARCH}: " + json.dumps(gemma_rep))

    phase_start["13"] = time.perf_counter()
    # -- phase 13: kimi-k2 at its full published width, one layer ------------
    kimi_rep = kimi_phase(torch, configs, eng_mod, traces, model_lib, api,
                          moe_mod, router, args.seed, counters, kernel_paths)
    phase13 = kimi_rep["kernel"]["launches"]
    phase13_paths = kimi_rep["kernel"]["paths"]
    print(f"{KIMI_ARCH}: " + json.dumps(kimi_rep))

    phase_start["14"] = time.perf_counter()
    # -- phase 14: qwen3-4b at its full published config ----------------------
    qwen_rep = qwen_phase(torch, configs, eng_mod, traces, model_lib, api,
                          spec_mod, args.seed, counters, kernel_paths)
    print(f"{QWEN_ARCH}: " + json.dumps(qwen_rep))
    phase14 = {"serve": qwen_rep["kernel"]["launches"],
               "spec": qwen_rep["spec"]["spec"]["launches"],
               "preempt": qwen_rep["preemption_bf16"]["preempt"]["launches"]}

    phase_start["15"] = time.perf_counter()
    # -- phase 15: minicpm-2b at its full published config --------------------
    minicpm_rep = minicpm_phase(torch, configs, eng_mod, traces, model_lib,
                                api, args.seed, counters, kernel_paths)
    print(f"{MINICPM_ARCH}: " + json.dumps(minicpm_rep))
    phase15 = minicpm_rep["kernel"]["launches"]

    def later(name: str) -> dict:
        """A kernel's launches in phases 14 and 15, by run."""
        return {"phase14_launches": {k: n[name] for k, n in phase14.items()},
                "phase15_launches": phase15[name]}

    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:161",
         "launches": paged_n, "paths": engine_paths["paged_attention"],
         **{k: paged_t[k] for k in TIMED},
         "head_dims": list(paged_pkg_dims),
         "d256": {k: paged256_t[k] for k in TIMED},
         "d256_gemma": {k: paged256_t["gemma"][k] for k in TIMED},
         "phase8_launches": {a: n["paged_attention"]
                             for a, n in phase8.items()},
         "phase9_launches": phase9["paged_attention"],
         "phase12_launches": phase12["paged_attention"],
         "phase12_paths": gemma_rep["kernel"]["paths"]["paged_attention"],
         "d112": {k: paged112_t[k] for k in TIMED},
         "phase13_launches": phase13["paged_attention"],
         "phase13_paths": phase13_paths["paged_attention"],
         "d128": {k: paged128_t[k] for k in TIMED},
         "minicpm": {k: paged_mc_t[k] for k in TIMED},
         **later("paged_attention")},
        {"name": "paged_attention_verify", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:118",
         "launches": verify_n,
         "paths": spec_rep["spec"]["paths"]["paged_attention_verify"],
         "head_dims": list(paged_pkg_dims),
         "phase8_launches": {a: n["paged_attention_verify"]
                             for a, n in phase8.items()},
         "phase12_launches": phase12["paged_attention_verify"],
         "phase13_launches": phase13["paged_attention_verify"],
         "phase13_paths": phase13_paths["paged_attention_verify"],
         "d112": {k: verify112_t[k] for k in TIMED},
         **{k: verify_t[k] for k in TIMED},
         "d256": {k: verify256_t[k] for k in TIMED},
         "d128": {k: verify128_t[k] for k in TIMED},
         **later("paged_attention_verify")},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:70",
         "launches": flash_n, "paths": flash_paths,
         **{k: flash_t[k] for k in LIB_TIMED},
         "s383": {k: flash_t["s383"][k] for k in LIB_TIMED},
         "head_dims": list(flash_pkg_dims),
         "d256": {k: flash256_t[k] for k in LIB_TIMED},
         "d256_gemma": {k: flash256_t["gemma"][k] for k in LIB_TIMED},
         "phase8_launches": {a: n["flash_attention"]
                             for a, n in phase8.items()},
         "phase9_launches": phase9["flash_attention"],
         "phase12_launches": phase12["flash_attention"],
         "phase12_paths": gemma_rep["kernel"]["paths"]["flash_attention"],
         "d112": {k: flash112_t[k] for k in LIB_TIMED},
         "phase13_launches": phase13["flash_attention"],
         "phase13_paths": phase13_paths["flash_attention"],
         "d128": {k: flash128_t[k] for k in LIB_TIMED},
         "d128_s383": {k: flash128_t["s383"][k] for k in LIB_TIMED},
         "minicpm": {k: flash_mc_t[k] for k in LIB_TIMED},
         **later("flash_attention")},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "none (the TPU kernel has no backward)",
         **{k: flash_bwd_t["minicpm"][k] for k in LIB_TIMED},
         **{k: flash_bwd_t["minicpm"][k] for k in (
             "row_rel_err", "chain_rel_err", "forward")},
         "qwen3": {k: flash_bwd_t["qwen3"][k] for k in LIB_TIMED + (
             "row_rel_err", "chain_rel_err", "forward")},
         "phase10_launches": train_rep["launches"],
         "phase15_launches": minicpm_rep["train"]["launches"]},
        {"name": "moe_gmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
         "replaces": "src/repro/kernels/moe_gmm/kernel.py:45",
         "launches": gmm_n, "paths": moe_rep["kernel"]["paths"]["moe_gmm"],
         **{k: gmm_t[k] for k in LIB_TIMED},
         "prefill": {k: gmm_t["prefill"][k] for k in LIB_TIMED},
         "kimi": {k: gmm_t["kimi"][k] for k in LIB_TIMED},
         "kimi_prefill": {k: gmm_t["kimi_prefill"][k] for k in LIB_TIMED},
         "phase13_launches": phase13["moe_gmm"],
         "phase13_paths": phase13_paths["moe_gmm"]},
        {"name": "grid_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grid_step.cu",
         "replaces": "src/repro/kernels/grid_step/kernel.py:59", **grid_k},
    ]
    names = list(phase_start) + ["end"]
    phase_start["end"] = time.perf_counter()
    print("phase seconds: " + json.dumps(
        {n: phase_start[m] - phase_start[n]
         for n, m in zip(names, names[1:])}))
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
