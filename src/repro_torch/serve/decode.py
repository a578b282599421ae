"""One-shot batched serving: prefill + greedy/sampled decode over a fixed batch
(PyTorch port of ``repro/serve/decode.py``).

``serve_step`` (one token for the whole batch against the KV cache) is the
function the decode-shape dry-runs run; ``generate`` is the port's own
one-shot oracle: the engine must emit exactly its tokens for the same
request. ``sampling`` (a ``SamplingSpec``) switches
the loop from argmax to ``model.sample_tokens`` with the engine's key
discipline (lane key folded with the index of the token being emitted).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..models import model


def serve_step(params, cfg: ModelConfig, batch: dict, cache: dict,
               router_bias: Optional[torch.Tensor] = None):
    """One new token per sequence with a KV cache — the decode dry-run
    target: ``model.decode_step`` on the torch route (the JAX package's
    default ``"xla"``), which runs no kernel. Returns (logits (B, 1, V),
    cache); the cache is updated in place."""
    return model.decode_step(params, cfg, batch, cache, attn_backend="torch",
                             router_bias=router_bias)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def null_spec(batch: int, device) -> model.SamplingSpec:
    """All-greedy placeholder lanes."""
    return model.SamplingSpec(
        keys=torch.zeros((batch, 2), dtype=torch.int64, device=device),
        temperature=torch.zeros((batch,), dtype=torch.float32, device=device),
        top_k=torch.zeros((batch,), dtype=torch.int64, device=device),
        top_p=torch.ones((batch,), dtype=torch.float32, device=device),
        rep_penalty=torch.ones((batch,), dtype=torch.float32, device=device),
        pres_penalty=torch.zeros((batch,), dtype=torch.float32, device=device),
        freq_penalty=torch.zeros((batch,), dtype=torch.float32, device=device))


def topk_logprobs(logits: torch.Tensor, k: int):
    """Top-``k`` (values, ids) of the last position's fp32 log-softmax."""
    lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
    return torch.topk(lp, k, dim=-1)


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompts: dict, max_cache: int,
             steps: int, sampling: Optional[model.SamplingSpec] = None,
             return_logits: bool = False, return_logprobs: bool = False,
             use_penalties: bool = False, return_topk: int = 0,
             attn_backend: str = "kernel",
             router_bias: Optional[torch.Tensor] = None):
    """Prefill the prompt batch (with its patches or frames), then emit
    ``steps`` tokens — argmax by default, per-lane sampled under
    ``sampling``; audio decode steps take zero frames. Returns ``(tokens (B,
    steps), cache)``, plus the per-token logits rows ``(B, steps, V)`` when
    ``return_logits``, plus each chosen token's raw-distribution logprob
    ``(B, steps)`` when ``return_logprobs``, plus ``(values, ids)``
    top-``return_topk`` logprobs ``(B, steps, k)`` when asked (always last).
    ``use_penalties`` threads the per-lane generated-token counts so the
    spec's penalty rows bite (requires ``sampling``). ``router_bias`` is an
    MoE model's (num_layers, E) router bias."""
    tokens = prompts["tokens"]
    b, device = tokens.shape[0], tokens.device
    cache = model.init_cache(cfg, b, max_cache, device)
    logits, cache = model.prefill(params, cfg, prompts, cache,
                                  attn_backend=attn_backend,
                                  router_bias=router_bias)
    do_sample = sampling is not None
    spec = sampling if do_sample else null_spec(b, device)
    step = {}
    if cfg.family == "audio":
        # decode steps see zero frames, as in the JAX package's loop and the
        # engine's tick
        step["frame"] = torch.zeros((b, 1, cfg.frontend_dim),
                                    dtype=prompts["frames"].dtype,
                                    device=device)
    tok = model.sample_tokens(logits, spec, 0) if do_sample else greedy(logits)
    use_penalties = use_penalties and do_sample
    counts = torch.zeros((b, cfg.vocab_size), dtype=torch.int32, device=device)
    rows = torch.arange(b, device=device)
    toks, lgs, lps, tks = [], [], [], []
    for t in range(steps):
        if t:
            # emitted token t comes out of decode step t-1 (the prefill
            # seeds token 0), the fold_in index both backends agree on
            logits, cache = model.decode_step(params, cfg,
                                              {"token": tok, **step}, cache,
                                              attn_backend=attn_backend,
                                              router_bias=router_bias)
            tok = model.sample_tokens(
                logits, spec, t, counts=counts if use_penalties else None) \
                if do_sample else greedy(logits)
        if use_penalties:
            counts[rows, tok[:, 0].long()] += 1
        toks.append(tok[:, 0])
        if return_logits:
            lgs.append(logits[:, -1])
        if return_logprobs:
            lps.append(model.chosen_logprob(logits, tok)[:, 0])
        if return_topk:
            tks.append(topk_logprobs(logits, return_topk))
    out = (torch.stack(toks, dim=1), cache)
    if return_logits:
        out = out + (torch.stack(lgs, dim=1),)
    if return_logprobs:
        out = out + (torch.stack(lps, dim=1),)
    if return_topk:
        out = out + ((torch.stack([v for v, _ in tks], dim=1),
                      torch.stack([i for _, i in tks], dim=1)),)
    return out
