"""Self-speculative decoding: truncated-depth draft + batched paged verify
(PyTorch port of ``repro/serve/spec.py``).

One spec tick replaces up to ``k + 1`` sequential decode ticks:

  draft   — ``k`` greedy one-token steps through only the first ``depth``
            layers of the *same* weights (``transformer.truncate_stack``):
            layer d's input depends only on layers < d, so the paged pool's
            leading-``depth`` K/V is the truncated model's cache. There are
            no draft weights and no draft cache.
  verify  — one ``model.verify_step``: rows ``[last, d_1..d_k]`` scored at
            positions ``pos..pos+k`` through the full stack. The engine
            accepts the longest draft prefix with ``d_j == argmax(row j-1)``
            plus the bonus token ``argmax(row a)``.

The JAX package holds a verify row bitwise equal to the sequential decode
row, which makes its greedy accept an exact oracle. Across frameworks, and on
the card between a (k+1)-row and a 1-row projection, the two agree within
rounding instead: the CPU tests in fp32 require equal tokens and logits
within 1e-5, and on the card in bf16 a spec and a non-spec stream may part
only at a token whose reference top-2 margin is below the tolerance.

The engine gates spec ticks to all-greedy resident batches (sampled lanes
fold PRNG keys per emitted index — a multi-token tick has no single key),
with no penalties and no logprobs. An MoE engine's router bias rides into
both draft and verify: verify routes with exactly the plain tick's bias (at
the engine's dropless decode capacity), the draft with its leading layers'
rows.

``make_draft_friendly`` is the test/bench utility that makes a random init
behave like a trained model for acceptance purposes: scaling the deep
layers' residual write-back projections toward zero leaves ``x_depth ≈ x_L``,
so the truncated head agrees with the full head often.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..models import model, transformer


def spec_tick(params: model.Model, cfg: ModelConfig, pool: dict,
              last: torch.Tensor, active: torch.Tensor, table: torch.Tensor,
              k: int, depth: int, attn_backend: str = "kernel",
              return_logits: bool = False,
              router_bias: Optional[torch.Tensor] = None):
    """One fused draft+verify tick over the whole slot batch.

    ``last`` (B, 1) is each slot's newest emitted token (its K/V not yet
    written — the engine's position invariant), ``pool["pos"]`` its cache
    position. Returns ``(drafts (B, k), argmax (B, k+1), ok (B,),
    logits (B, k+1, V) | None, pool)``; the host accept loop owns token
    emission and position advancement.

    The draft writes its K/V into the pool in place (the JAX package drafts
    into a functional copy it discards). That is sound because the draft
    writes only positions ``pos..pos+k-1`` of the first ``depth`` layers,
    and verify rewrites positions ``pos..pos+k`` of every layer with the same
    tokens before any of its attention reads them: the pool after a spec
    tick is the pool after verify alone (positions past the slot's capacity
    go to the null page in both)."""
    pairs = transformer.truncate_stack(params.blocks, cfg, pool["layers"],
                                       depth)
    tok, posv = last, pool["pos"]
    drafts = []
    for _ in range(k):
        x = model._embed(params, cfg, tok)
        x = transformer.apply_layers_decode(pairs, x, cfg, posv, table=table,
                                            active=active,
                                            attn_backend=attn_backend,
                                            bias=router_bias)
        lg = model._head(params, cfg, x)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        drafts.append(tok)
        posv = posv + 1
    drafts = torch.cat(drafts, dim=1)                          # (B, k)
    seq = torch.cat([last, drafts], dim=1)                     # (B, k+1)
    logits, pool = model.verify_step(params, cfg, {"tokens": seq}, pool,
                                     table, active=active,
                                     attn_backend=attn_backend,
                                     router_bias=router_bias)
    am = torch.argmax(logits, dim=-1).to(torch.int32)          # (B, k+1)
    ok = torch.isfinite(logits).flatten(1).all(dim=1)          # (B,)
    return drafts, am, ok, (logits if return_logits else None), pool


def accept_length(drafts, argmaxes, k: int) -> int:
    """Host-side greedy accept rule for one lane: the longest prefix of the
    ``k`` drafts where ``d_j == argmax(row j-1)``. The lane then emits that
    prefix plus the bonus token ``argmax(row a)`` — ``a + 1`` tokens."""
    a = 0
    while a < k and int(drafts[a]) == int(argmaxes[a]):
        a += 1
    return a


def make_draft_friendly(params: model.Model, cfg: ModelConfig, depth: int,
                        scale: float = 0.05) -> model.Model:
    """A copy of ``params`` with the residual write-back projections (``wo``,
    and ``w_down`` of the MLP or of every expert) of every layer >= ``depth``
    scaled toward zero (in fp32, cast back), so the deep layers barely move
    the residual stream and the truncated-depth draft's argmax usually agrees
    with the full model's. The model it is given is left unchanged."""
    out = copy.deepcopy(params)
    with torch.no_grad():
        for blk in list(out.blocks)[depth:]:
            ffn = blk.moe if hasattr(blk, "moe") else blk.mlp
            for w in (blk.mixer.wo, ffn.w_down):
                w.copy_((w.float() * scale).to(w.dtype))
    return out
