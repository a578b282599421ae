"""Serving API: the request-facing types both serving backends speak
(PyTorch port of ``repro/serve/api.py``).

  * ``SamplingParams`` — per-request decoding intent: temperature / top-p /
    top-k / seed, token budget, stop ids, penalties, logprobs.
    ``temperature == 0`` is exact greedy (the argmax path).
  * ``ServeRequest``   — prompt + params + the scheduling metadata the immune
    admission loop reads (``rclass``, ``arrival``, optional wall-clock
    ``deadline``).
  * ``RequestOutput``  — incremental token deltas plus finish reason and
    tick / wall-clock latency accounting; a slot-group parent's terminal
    output carries its member lanes in ``group_outputs``.

A request with ``n`` / ``best_of`` > 1 is a slot-group parent
(``serve.groups``): the engine expands it into member lanes that share its
prompt pages, and ``generate`` serves each member one-shot and assembles them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import prng
from ..configs.base import ModelConfig
from ..models import model
from . import decode

GREEDY_TEMPERATURE = 0.0


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters. Frozen: shared freely across requests.

    ``temperature == 0`` selects the exact greedy path; ``top_k == 0`` and
    ``top_p == 1.0`` disable their filters. ``seed`` fixes the request's
    PRNG key stream (bit-compatible with ``jax.random``). ``stop`` token ids
    retire the request the tick one is emitted (the stop token is kept)."""

    temperature: float = GREEDY_TEMPERATURE
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0
    max_new_tokens: int = 16
    stop: tuple = ()
    logprobs: int = 0          # k: chosen-token logprob + top-k alternatives
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    n: int = 1                 # completions to return (slot-group lanes)
    best_of: int = 0           # 0: off; >= n: sample best_of lanes, keep the
    #                            n best by cumulative chosen-token logprob

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.repetition_penalty <= 0:
            raise ValueError(
                f"repetition_penalty must be > 0, got {self.repetition_penalty}")
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.best_of and self.best_of < self.n:
            raise ValueError(
                f"best_of must be 0 or >= n, got {self.best_of} < {self.n}")
        object.__setattr__(self, "logprobs", int(self.logprobs))
        if self.logprobs < 0:
            raise ValueError(f"logprobs must be >= 0, got {self.logprobs}")
        object.__setattr__(self, "stop", tuple(int(t) for t in self.stop))

    @property
    def is_greedy(self) -> bool:
        return self.temperature == GREEDY_TEMPERATURE

    @property
    def has_penalties(self) -> bool:
        return (self.repetition_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)

    @property
    def group_size(self) -> int:
        """Engine lanes this request owns (``best_of`` supersedes ``n``)."""
        return max(self.n, self.best_of, 1)

    def key(self) -> np.ndarray:
        """Host copy of the request's base PRNG key (2,) uint32."""
        return prng.PRNGKey(self.seed)


def spec_for(params_list: Sequence[SamplingParams],
             device) -> model.SamplingSpec:
    """Stack per-request ``SamplingParams`` into the per-lane tensors."""
    def t(vals, dtype):
        return torch.as_tensor(np.asarray(vals), dtype=dtype, device=device)
    return model.SamplingSpec(
        keys=t(np.stack([p.key() for p in params_list]).astype(np.int64),
               torch.int64),
        temperature=t([p.temperature for p in params_list], torch.float32),
        top_k=t([p.top_k for p in params_list], torch.int64),
        top_p=t([p.top_p for p in params_list], torch.float32),
        rep_penalty=t([p.repetition_penalty for p in params_list],
                      torch.float32),
        pres_penalty=t([p.presence_penalty for p in params_list],
                       torch.float32),
        freq_penalty=t([p.frequency_penalty for p in params_list],
                       torch.float32))


@dataclass
class ServeRequest:
    """One serving request: prompt + sampling params + scheduling metadata.

    ``rclass`` buckets requests into the classes the immune admission
    controller remembers; ``arrival`` is the tick the request enters the
    queue; ``deadline`` is wall-clock seconds after submission and, when set,
    overrides the engine's tick budget for this request's SLO accounting.
    ``patches`` (a VLM's image prefix) and ``frames`` (audio, one row per
    prompt token) are the stub frontends' precomputed embeddings."""

    rid: int
    tokens: np.ndarray                     # (L,) int32 prompt
    params: SamplingParams = SamplingParams()
    rclass: int = 0
    arrival: int = 0
    deadline: Optional[float] = None
    patches: Optional[np.ndarray] = None   # vlm prefix embeddings (P, Fd)
    frames: Optional[np.ndarray] = None    # audio frame embeddings (L, Fd)

    # slot-group membership (serve.groups): group == -1 is a standalone
    # request; members carry the parent rid in ``group`` and their lane index
    group: int = -1
    lane: int = 0
    group_size: int = 1

    # filled in by the serving backend
    out_tokens: list = field(default_factory=list)
    out_logits: list = field(default_factory=list)    # per-token (V,) fp32
    out_logprobs: list = field(default_factory=list)
    out_topk: list = field(default_factory=list)      # per-token (ids, lps)
    finish_reason: Optional[str] = None    # "stop" | "length" | "rejected" |
    #                                        "shed" | "failed" | "corrupted"
    admit_tick: int = -1
    finish_tick: int = -1
    slot: int = -1
    submit_time: float = -1.0              # wall clock, perf_counter seconds
    finish_time: float = -1.0
    preemptions: int = 0
    retries: int = 0                       # re-placements on a survivor after
    #                                        a replica death (router failover)
    replayed_tokens: int = 0               # recorded tokens re-derived after
    #                                        preemption
    requeue_ticks: int = 0
    preempt_tick: int = -1
    prefill_tokens: int = 0                # prompt positions computed

    @property
    def max_new_tokens(self) -> int:
        return self.params.max_new_tokens

    @property
    def latency(self) -> int:
        return self.finish_tick - self.arrival

    @property
    def wall_latency_s(self) -> Optional[float]:
        if self.submit_time < 0 or self.finish_time < 0:
            return None
        return self.finish_time - self.submit_time

    def prompts(self, device) -> dict:
        """The prefill batch of one for this request (with its patches or
        frames) — what every backend feeds the model."""
        p = {"tokens": torch.as_tensor(np.asarray(self.tokens),
                                       dtype=torch.int64, device=device)[None]}
        if self.patches is not None:
            p["patches"] = torch.as_tensor(np.asarray(self.patches),
                                           device=device)[None]
        if self.frames is not None:
            p["frames"] = torch.as_tensor(np.asarray(self.frames),
                                          device=device)[None]
        return p


@dataclass
class RequestOutput:
    """One increment of a request's progress (``Engine.stream()`` yields one
    per request per tick of progress; ``generate`` one finished output)."""

    rid: int
    new_tokens: list
    tokens: list
    finished: bool
    finish_reason: Optional[str]
    tick: int
    arrival: int = 0
    admit_tick: int = -1
    finish_tick: int = -1
    latency_ticks: Optional[int] = None
    wall_latency_s: Optional[float] = None
    deadline_met: Optional[bool] = None
    new_logprobs: Optional[list] = None
    logprobs: Optional[list] = None
    top_logprobs: Optional[list] = None
    # a slot-group parent's finished member outputs in rank order
    # (cumulative chosen-token logprob for best_of, lane order for n)
    group_outputs: Optional[list] = None
    preemptions: int = 0
    requeue_ticks: int = 0


def _finish_oneshot(req: ServeRequest, stream: list, t0: float) -> RequestOutput:
    """Trim a one-shot token stream at the first stop token (inclusive,
    mirroring the engine's retirement) and fill the request/output records."""
    cut, reason = len(stream), "length"
    for i, t in enumerate(stream):
        if t in req.params.stop:
            cut, reason = i + 1, "stop"
            break
    req.out_tokens = stream[:cut]
    req.finish_reason = reason
    req.finish_time = time.perf_counter()
    if req.submit_time < 0:
        req.submit_time = t0
    return RequestOutput(
        rid=req.rid, new_tokens=list(req.out_tokens),
        tokens=list(req.out_tokens), finished=True, finish_reason=reason,
        tick=len(req.out_tokens), arrival=req.arrival, admit_tick=0,
        finish_tick=len(req.out_tokens), latency_ticks=len(req.out_tokens),
        wall_latency_s=req.finish_time - req.submit_time)


def generate(params, cfg: ModelConfig,
             requests: Union[ServeRequest, Sequence[ServeRequest]],
             max_cache: int, capture_logits: bool = False,
             attn_backend: str = "kernel", router_bias=None
             ) -> Union[RequestOutput, Sequence[RequestOutput]]:
    """One-shot serving facade: prefill + decode each request batch-of-1
    under its own ``SamplingParams`` on the model's device, returning
    finished ``RequestOutput``s — the oracle the engine is held to. With
    ``capture_logits`` each request's per-token logits rows land in
    ``req.out_logits``. A slot-group parent is expanded into its member
    lanes, each served one-shot, and assembled as the engine assembles it.
    ``router_bias`` is an MoE model's (num_layers, E) router bias."""
    from . import groups
    single = isinstance(requests, ServeRequest)
    reqs = [requests] if single else list(requests)
    outs = []
    for req in reqs:
        if req.params.group_size > 1:
            t0 = time.perf_counter()
            members = groups.expand(req)
            member_outs = [_oneshot_one(params, cfg, m, max_cache,
                                        capture_logits, attn_backend,
                                        router_bias)
                           for m in members]
            outs.append(groups.assemble(req, members, member_outs, t0))
        else:
            outs.append(_oneshot_one(params, cfg, req, max_cache,
                                     capture_logits, attn_backend,
                                     router_bias))
    return outs[0] if single else outs


def _oneshot_one(params, cfg: ModelConfig, req: ServeRequest, max_cache: int,
                 capture_logits: bool, attn_backend: str,
                 router_bias) -> RequestOutput:
    t0 = time.perf_counter()
    sp = req.params
    device = params.device
    sampling = None if (sp.is_greedy and not sp.has_penalties) \
        else spec_for([sp], device)
    res = decode.generate(params, cfg, req.prompts(device), max_cache=max_cache,
                          steps=sp.max_new_tokens, sampling=sampling,
                          return_logits=capture_logits,
                          return_logprobs=bool(sp.logprobs),
                          use_penalties=sp.has_penalties,
                          return_topk=sp.logprobs, attn_backend=attn_backend,
                          router_bias=router_bias)
    stream = [int(t) for t in res[0][0].cpu()]
    out = _finish_oneshot(req, stream, t0)
    n = len(req.out_tokens)
    idx = 2
    if capture_logits:
        lg = res[idx][0].cpu().numpy()
        idx += 1
        req.out_logits = [lg[i].copy() for i in range(n)]
    if sp.logprobs:
        lp = res[idx][0].cpu().numpy()
        idx += 1
        req.out_logprobs = [float(lp[i]) for i in range(n)]
        out.new_logprobs = list(req.out_logprobs)
        out.logprobs = list(req.out_logprobs)
        tv, ti = (x[0].cpu().numpy() for x in res[idx])
        req.out_topk = [([int(t) for t in ti[i]], [float(v) for v in tv[i]])
                        for i in range(n)]
        out.top_logprobs = list(req.out_topk)
    return out
