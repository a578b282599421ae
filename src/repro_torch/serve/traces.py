"""Synthetic open-loop arrival traces for the serving engine (PyTorch port of
``repro/serve/traces.py``: the bursty, returning-tenant, contention, fleet,
shared-prefix and agentic traces).

They emit ``ServeRequest``s for ``Engine.submit``/``run``/``stream``; every
trace takes the sampling knobs (``temperature``/``top_p``/``top_k``/
``sample_seed``) and derives per-request seeds as ``sample_seed + rid``, so a
sampled trace replays token-identically. With the same arguments each trace
draws exactly the JAX package's prompts and modality inputs (same numpy
generator, same order).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..configs.base import ModelConfig
from .api import SamplingParams, ServeRequest


def attach_modality_inputs(req: ServeRequest, cfg: ModelConfig,
                           rng) -> ServeRequest:
    """Give a request the frontend inputs its family needs (random stand-ins
    for the stub frontends): a VLM's ``frontend_tokens`` patches, audio's
    one frame per prompt token."""
    if cfg.family == "vlm":
        req.patches = rng.standard_normal(
            (cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        req.frames = rng.standard_normal(
            (len(req.tokens), cfg.frontend_dim)).astype(np.float32)
    return req


def _params(max_new_tokens: int, temperature: float, top_p: float, top_k: int,
            sample_seed: int, rid: int) -> SamplingParams:
    return SamplingParams(temperature=temperature, top_p=top_p, top_k=top_k,
                          seed=sample_seed + rid,
                          max_new_tokens=int(max_new_tokens))


def synthetic_trace(cfg: ModelConfig, num_requests: int = 40, seed: int = 0,
                    burst_every: int = 10, burst_size: int = 8,
                    light_tokens: int = 5, heavy_tokens: int = 40,
                    heavy_frac: float = 0.15,
                    prompt_lens: tuple = (8, 16),
                    heavy_prompt: Optional[int] = None,
                    temperature: float = 0.0, top_p: float = 1.0,
                    top_k: int = 0, sample_seed: int = 0
                    ) -> list:
    """Bursty heterogeneous arrivals: mostly light requests plus a heavy class
    whose decode length alone blows a chat-style latency budget. Classes:
    0..len(prompt_lens)-1 are light (one per prompt-length bucket); the last
    class is heavy. Prompt lengths come from a tiny bucket set so the engine
    compiles a bounded number of prefill shapes. ``heavy_prompt`` gives the
    heavy class a long prompt of its own (exercises chunked prefill and the
    paged pool's mixed-length admission)."""
    rng = np.random.default_rng(seed)
    reqs = []
    n_light_classes = len(prompt_lens)
    for rid in range(num_requests):
        burst = rid // burst_size
        heavy = rng.random() < heavy_frac
        plen = int(prompt_lens[rid % n_light_classes])
        if heavy and heavy_prompt is not None:
            plen = int(heavy_prompt)
        rclass = n_light_classes if heavy else rid % n_light_classes
        steps = heavy_tokens if heavy else light_tokens + rid % 3
        req = ServeRequest(
            rid=rid,
            tokens=rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32),
            params=_params(steps, temperature, top_p, top_k, sample_seed, rid),
            rclass=rclass,
            arrival=burst * burst_every + int(rng.integers(0, 3)),
        )
        reqs.append(attach_modality_inputs(req, cfg, rng))
    return reqs


def returning_tenant_trace(cfg: ModelConfig, tenants: int = 2,
                           prefix_len: int = 48, suffix_lens: tuple = (4,),
                           burst_size: int = 3, bursts: int = 2,
                           gap: int = 120, decode_lens: tuple = (6,),
                           seed: int = 0, temperature: float = 0.0,
                           top_p: float = 1.0, top_k: int = 0,
                           sample_seed: int = 0) -> list:
    """Returning-tenant traffic: each tenant owns a fixed system prompt and
    sends ``bursts`` bursts of ``burst_size`` requests, with a ``gap`` between
    bursts long enough for the engine to fully drain. Without a persistent
    prefix cache every burst re-prefills the tenant's prefix from scratch
    (refcounts hit zero between bursts); with pinning the second and later
    bursts adopt the tenant's pages out of the pinned cache and prefill only
    their suffixes. Request class = tenant id, so the pin memory learns
    per-tenant adoption value."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, cfg.vocab_size, size=prefix_len)
                .astype(np.int32) for _ in range(tenants)]
    reqs, rid = [], 0
    for b in range(bursts):
        for t in range(tenants):
            for i in range(burst_size):
                sfx = rng.integers(
                    0, cfg.vocab_size,
                    size=int(suffix_lens[rid % len(suffix_lens)])
                ).astype(np.int32)
                req = ServeRequest(
                    rid=rid,
                    tokens=np.concatenate([prefixes[t], sfx]),
                    params=_params(decode_lens[rid % len(decode_lens)],
                                   temperature, top_p, top_k, sample_seed, rid),
                    rclass=t,
                    arrival=b * gap + 2 * i,
                )
                reqs.append(attach_modality_inputs(req, cfg, rng))
                rid += 1
    return reqs


def contention_trace(cfg: ModelConfig, num_requests: int = 24,
                     prompt_lens: tuple = (8, 16), hog_prompt: int = 32,
                     light_tokens: int = 4, hog_tokens: int = 24,
                     hog_every: int = 4, arrival_every: int = 1,
                     seed: int = 0, temperature: float = 0.0,
                     top_p: float = 1.0, top_k: int = 0,
                     sample_seed: int = 0) -> list:
    """Page-pool contention: a dense arrival stream mixing short interactive
    requests with a hog class (long prompt, long decode) whose KV growth eats
    pages mid-flight. Run it against an undersized page pool: worst-case
    reservation keeps admission shallow, while preempt-mode admission fills
    slots on current footprint and resolves decode-time exhaustion by evicting
    the lowest-immune-priority slot. Hog requests are class ``len(prompt_lens)``
    (every ``hog_every``-th rid); light classes rotate over prompt buckets."""
    rng = np.random.default_rng(seed)
    n_light = len(prompt_lens)
    reqs = []
    for rid in range(num_requests):
        hog = hog_every > 0 and rid % hog_every == hog_every - 1
        plen = hog_prompt if hog else int(prompt_lens[rid % n_light])
        req = ServeRequest(
            rid=rid,
            tokens=rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32),
            params=_params(hog_tokens if hog else light_tokens + rid % 2,
                           temperature, top_p, top_k, sample_seed, rid),
            rclass=n_light if hog else rid % n_light,
            arrival=rid * arrival_every,
        )
        reqs.append(attach_modality_inputs(req, cfg, rng))
    return reqs


def fleet_trace(cfg: ModelConfig, tenants: int = 3, num_requests: int = 24,
                prefix_len: int = 32, suffix_lens: tuple = (4, 6),
                decode_lens: tuple = (6, 10), hot_tenant: int = 0,
                hot_frac: float = 0.5, burst_every: int = 6,
                burst_size: int = 4, seed: int = 0,
                temperature: float = 0.0, top_p: float = 1.0,
                top_k: int = 0, sample_seed: int = 0) -> list:
    """Multi-tenant fleet traffic for the placement router: ``tenants`` fixed
    system prompts (request class = tenant id, so placement affinity and the
    per-class cost memory both key on the tenant), arrivals in tight bursts,
    and one *hot* tenant contributing ``hot_frac`` of the volume — the
    hot-replica skew that separates placement policies. A router that keeps a
    tenant's traffic where its prompt chains already live prefills only
    suffixes; a router that sprays it re-prefills the prefix on every replica
    and convoys the hot one. Suffix and decode lengths come from tiny bucket
    sets so each replica compiles a bounded number of shapes."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, cfg.vocab_size, size=prefix_len)
                .astype(np.int32) for _ in range(tenants)]
    reqs = []
    for rid in range(num_requests):
        hot = rng.random() < hot_frac
        if tenants > 1:
            other = (hot_tenant + 1 + int(rng.integers(0, tenants - 1))) \
                % tenants
        else:
            other = hot_tenant
        t = hot_tenant if hot else other
        sfx = rng.integers(0, cfg.vocab_size,
                           size=int(suffix_lens[rid % len(suffix_lens)])
                           ).astype(np.int32)
        req = ServeRequest(
            rid=rid,
            tokens=np.concatenate([prefixes[t], sfx]),
            params=_params(decode_lens[rid % len(decode_lens)], temperature,
                           top_p, top_k, sample_seed, rid),
            rclass=t,
            arrival=(rid // burst_size) * burst_every + rid % burst_size,
        )
        reqs.append(attach_modality_inputs(req, cfg, rng))
    return reqs


def failover_fleet_trace(cfg: ModelConfig, replicas: int = 3,
                         crash_replica: int = 1, seed: int = 0,
                         rejoin: bool = True, **kw) -> tuple:
    """The fleet trace, fault-laced: ``fleet_trace`` traffic plus a matched
    crash-of-one fault-plan spec (``serve.faults.FaultPlan.parse`` grammar)
    sized to the trace — the crash lands about a third of the way through the
    arrival window (survivors absorb the evacuated work while traffic is
    still arriving, the hard case), and with ``rejoin`` the replica returns
    cold around two thirds of the window — before the tail of arrivals, so
    prefix-affinity traffic visibly rewarms its pinned cache while the run
    is still live. Returns ``(requests, plan_spec)`` — the manual-run
    variant behind ``launch/serve --trace fleet-faults``."""
    reqs = fleet_trace(cfg, seed=seed, **kw)
    horizon = max(r.arrival for r in reqs) if reqs else 0
    crash_at = max(1, horizon // 3)
    r = crash_replica % max(replicas, 1)
    spec = f"crash@{crash_at}:r{r}"
    if rejoin:
        spec += f" rejoin@{max(crash_at + 10, (2 * horizon) // 3)}:r{r}"
    return reqs, spec


def poweroff_fleet_trace(cfg: ModelConfig, seed: int = 0,
                         restart: bool = True, **kw) -> tuple:
    """The fleet trace, power-loss-laced: ``fleet_trace`` traffic plus a
    matched ``poweroff`` fault-plan spec (``serve.faults.FaultPlan.parse``
    grammar) sized to the trace — the lights go out about halfway through
    the arrival window (in-flight decodes, queued work and pending arrivals
    all straddle the loss, the hard case for the journal), and with
    ``restart`` the rebuilt fleet resumes a few ticks later, before the tail
    of arrivals. Returns ``(requests, plan_spec)`` — drive with
    ``serve.durability.run_durable`` (a plain ``Router.run`` would just die
    at the poweroff tick); the manual-run variant behind
    ``launch/serve --trace fleet-poweroff``."""
    reqs = fleet_trace(cfg, seed=seed, **kw)
    horizon = max(r.arrival for r in reqs) if reqs else 0
    off_at = max(1, horizon // 2)
    spec = f"poweroff@{off_at}"
    if restart:
        spec += f" restart@{off_at + 4}"
    return reqs, spec


def shared_prefix_trace(cfg: ModelConfig, num_requests: int = 32,
                        num_prefixes: int = 2, prefix_len: int = 32,
                        suffix_lens: tuple = (4, 8),
                        decode_lens: tuple = (6, 10),
                        arrival_every: int = 2, seed: int = 0,
                        temperature: float = 0.0, top_p: float = 1.0,
                        top_k: int = 0, sample_seed: int = 0
                        ) -> list:
    """System-prompt traffic: ``num_prefixes`` fixed prefixes, each followed by
    a per-request random suffix — the workload where prefix page sharing turns
    O(total tokens) of prefill + KV into O(unique tokens). Request class =
    prefix id (the immune memory then tracks cost per system prompt). Suffix
    and decode lengths come from tiny bucket sets so the engine compiles a
    bounded number of shapes."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, cfg.vocab_size, size=prefix_len)
                .astype(np.int32) for _ in range(num_prefixes)]
    reqs = []
    for rid in range(num_requests):
        pfx = prefixes[rid % num_prefixes]
        sfx = rng.integers(0, cfg.vocab_size,
                           size=int(suffix_lens[rid % len(suffix_lens)])
                           ).astype(np.int32)
        req = ServeRequest(
            rid=rid,
            tokens=np.concatenate([pfx, sfx]),
            params=_params(decode_lens[rid % len(decode_lens)], temperature,
                           top_p, top_k, sample_seed, rid),
            rclass=rid % num_prefixes,
            arrival=rid * arrival_every,
        )
        reqs.append(attach_modality_inputs(req, cfg, rng))
    return reqs


def agentic_trace(cfg: ModelConfig, sessions: int = 3, turns: int = 4,
                  base_prompt: int = 24, grow_lens: tuple = (6, 10),
                  decode_lens: tuple = (8, 12), turn_gap: int = 12,
                  seed: int = 0, temperature: float = 0.0, top_p: float = 1.0,
                  top_k: int = 0, sample_seed: int = 0) -> list:
    """Agentic multi-turn traffic: each session re-submits its conversation
    every turn with a grown prompt — turn ``t``'s prompt is turn ``t-1``'s
    plus a fresh extension (standing in for the appended answer and tool
    results an agent loop feeds back), so every turn's prompt has the
    previous turn's as an exact prefix: the workload of the prefix index and
    of speculative decoding. Request class = session (mod 3); arrivals are
    staggered so turns of different sessions interleave; rids are sequential
    in submission order."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=base_prompt)
               .astype(np.int32) for _ in range(sessions)]
    reqs, rid = [], 0
    for t in range(turns):
        for s in range(sessions):
            if t > 0:
                ext = rng.integers(
                    0, cfg.vocab_size,
                    size=int(grow_lens[(t + s) % len(grow_lens)])
                ).astype(np.int32)
                prompts[s] = np.concatenate([prompts[s], ext])
            req = ServeRequest(
                rid=rid, tokens=prompts[s].copy(),
                params=_params(decode_lens[rid % len(decode_lens)],
                               temperature, top_p, top_k, sample_seed, rid),
                rclass=s % 3, arrival=t * turn_gap + 2 * s)
            reqs.append(attach_modality_inputs(req, cfg, rng))
            rid += 1
    return reqs
