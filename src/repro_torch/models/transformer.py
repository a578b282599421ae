"""Decoder stack: blocks, the layer loop and the KV caches (PyTorch port of
``repro/models/transformer.py``, ``attn`` and ``moe`` block kinds).

The parameters are an ``nn.ModuleList`` of per-layer ``Block`` modules and the
JAX package's ``lax.scan`` over stacked layers becomes a Python loop. The
caches keep the JAX package's segment structure — ``[[{"k", "v"}]]`` with a
leading depth dimension — so one tensor holds every layer's pool (the
engine's page copies and splices touch all layers in one op) and each layer
updates its ``[l]`` view in place.

MoE stacks take ``bias``, the (num_layers, E) immune router bias: layer ``l``
routes with row ``l``, and a ``truncate_stack`` draft, being the leading
layers, takes the leading rows. ``attn_backend`` picks every hand-written
kernel's route, the expert products' included (``layers.BACKENDS``).
"""
from __future__ import annotations

import torch
from torch import nn

from .. import configs
from ..configs.base import ModelConfig
from . import layers, moe
from .layers import RMSNorm, rmsnorm


def layer_kinds(cfg: ModelConfig) -> list[str]:
    configs.require_supported(cfg)
    if cfg.family == "moe":
        return ["moe"] * cfg.num_layers
    return ["attn"] * cfg.num_layers


def segments(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """Decompose the depth into (pattern, repeats) segments."""
    kinds = layer_kinds(cfg)
    return [((kinds[0],), cfg.num_layers)]


class Block(nn.Module):
    """One pre-norm decoder block: attention, then a gated MLP (``attn``)
    or the mixture of experts (``moe``)."""

    def __init__(self, cfg: ModelConfig, kind: str, gen: torch.Generator,
                 device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device)
        self.mixer = layers.Attention(cfg, gen, device)
        self.norm2 = RMSNorm(cfg.d_model, device)
        if kind == "moe":
            self.moe = moe.MoE(cfg, gen, device)
        else:
            self.mlp = layers.MLP(cfg, gen, device)


def init_stack(cfg: ModelConfig, gen: torch.Generator, device) -> nn.ModuleList:
    return nn.ModuleList(Block(cfg, kind, gen, device)
                         for kind in layer_kinds(cfg))


def _layer_cache(seg_cache: dict, li: int) -> dict:
    return {name: t[li] for name, t in seg_cache.items()}


def _ffn_residual(blk: Block, x, cfg, bias, backend: str):
    """x + the block's feed-forward: the MoE routed with ``bias`` (its
    layer's (E,) row), or the dense MLP."""
    h = rmsnorm(blk.norm2, x, cfg)
    if hasattr(blk, "moe"):
        return x + moe.moe_ffn(blk.moe, h, cfg, bias, backend=backend)[0]
    return x + layers.mlp(blk.mlp, h, cfg)


def _row(bias, li: int):
    return None if bias is None else bias[li]


def _stack_cache(one: dict, reps: int) -> dict:
    return {name: t.unsqueeze(0).repeat((reps,) + (1,) * t.dim())
            for name, t in one.items()}


def init_stack_cache(cfg: ModelConfig, batch: int, s_max: int, dtype,
                     device) -> list:
    """Dense decode caches, mirroring the segment structure."""
    return [[_stack_cache(layers.init_attention_cache(cfg, batch, s_max, dtype,
                                                      device), reps)
             for _ in pattern] for pattern, reps in segments(cfg)]


def init_stack_cache_paged(cfg: ModelConfig, num_slots: int, s_max: int,
                           num_pages: int, page_size: int, dtype,
                           device) -> list:
    """Paged decode caches: every full-attention layer gets a physical page
    pool (num_pages, page_size, Hkv, D), stacked over depth."""
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    out = []
    for pattern, reps in segments(cfg):
        shape = (reps, num_pages, page_size, hk, hd)
        out.append([{"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}
                    for _ in pattern])
    return out


def map_block_caches(cfg: ModelConfig, fn, *trees):
    """Apply ``fn(kind, *per-position cache dicts)`` across the segment
    structure of one or more stack-cache trees, preserving the structure."""
    out = []
    for si, (pattern, _) in enumerate(segments(cfg)):
        out.append([fn(kind, *(t[si][pi] for t in trees))
                    for pi, kind in enumerate(pattern)])
    return out


def _layers(stack: nn.ModuleList, cfg: ModelConfig, caches: list):
    """(block, per-layer cache view) pairs in depth order."""
    li = 0
    for (pattern, reps), seg_cache in zip(segments(cfg), caches):
        for r in range(reps):
            for pi in range(len(pattern)):
                yield stack[li], _layer_cache(seg_cache[pi], r)
                li += 1


def apply_stack_prefill(stack: nn.ModuleList, x, cfg: ModelConfig,
                        caches: list, attn_backend: str = "kernel",
                        bias=None):
    """Full-sequence pass that fills the dense decode caches in place.
    Returns (x, caches)."""
    for li, (blk, cache) in enumerate(_layers(stack, cfg, caches)):
        y, _ = layers.attention_prefill(blk.mixer, rmsnorm(blk.norm1, x, cfg),
                                        cfg, cache, backend=attn_backend)
        x = _ffn_residual(blk, x + y, cfg, _row(bias, li), attn_backend)
    return x, caches


def truncate_stack(stack: nn.ModuleList, cfg: ModelConfig, caches: list,
                   depth: int) -> list:
    """The first ``depth`` (block, cache view) pairs — the self-speculative
    draft's weight reuse. Layer d's input depends only on layers < d, so the
    pool's leading-``depth`` K/V *is* the truncated model's cache: there are
    no draft weights and no draft cache. (The JAX package slices the stacked
    parameter and cache trees; here it is a slice of the layer walk.)"""
    return list(_layers(stack, cfg, caches))[:depth]


def apply_layers_decode(pairs, x, cfg: ModelConfig, pos: torch.Tensor,
                        table=None, active=None, attn_backend: str = "kernel",
                        bias=None):
    """One-token pass through (block, cache view) ``pairs`` — the whole stack
    (``apply_stack_decode``) or a truncated one (``truncate_stack``); pair
    ``i`` routes with bias row ``i``."""
    for li, (blk, cache) in enumerate(pairs):
        h = rmsnorm(blk.norm1, x, cfg)
        if table is not None:
            y, _ = layers.attention_decode_paged(blk.mixer, h, cfg, cache, pos,
                                                 table, active,
                                                 backend=attn_backend)
        else:
            y, _ = layers.attention_decode(blk.mixer, h, cfg, cache, pos)
        x = _ffn_residual(blk, x + y, cfg, _row(bias, li), attn_backend)
    return x


def apply_stack_decode(stack: nn.ModuleList, x, cfg: ModelConfig, caches: list,
                       pos: torch.Tensor, table=None, active=None,
                       attn_backend: str = "kernel", bias=None):
    """One-token pass. ``table``/``active`` select the paged KV path (the same
    block table for every layer); ``attn_backend`` picks its compute.
    Returns (x, caches)."""
    return apply_layers_decode(_layers(stack, cfg, caches), x, cfg, pos,
                               table=table, active=active,
                               attn_backend=attn_backend, bias=bias), caches


def apply_block_verify(blk: Block, x, cfg: ModelConfig, cache: dict,
                       pos: torch.Tensor, table: torch.Tensor, active=None,
                       attn_backend: str = "kernel", bias=None):
    """Sq-position verify block step against the paged pool (``attn`` and
    ``moe`` kinds: no slot-row state, so every (lane, position) row is
    independent; the MoE is dropless at the engine's decode capacity)."""
    y, _ = layers.attention_verify_paged(blk.mixer, rmsnorm(blk.norm1, x, cfg),
                                         cfg, cache, pos, table, active,
                                         backend=attn_backend)
    return _ffn_residual(blk, x + y, cfg, bias, attn_backend)


def apply_stack_verify(stack: nn.ModuleList, x, cfg: ModelConfig,
                       caches: list, pos: torch.Tensor, table: torch.Tensor,
                       active=None, attn_backend: str = "kernel", bias=None):
    """Sq-position verify pass (self-speculative decoding): every lane scores
    ``Sq`` consecutive positions starting at its ``pos`` in one batched step.
    Returns (x, caches)."""
    for li, (blk, cache) in enumerate(_layers(stack, cfg, caches)):
        x = apply_block_verify(blk, x, cfg, cache, pos, table, active,
                               attn_backend=attn_backend, bias=_row(bias, li))
    return x, caches


def apply_stack_prefill_chunk(stack: nn.ModuleList, x, cfg: ModelConfig,
                              caches: list, table_row: torch.Tensor, p0: int,
                              attn_backend: str = "kernel", bias=None):
    """One prefill chunk (batch of 1) against the paged pool. The chunk's
    attention has one route (gather + ``_sdpa``); ``attn_backend`` picks the
    expert products'."""
    for li, (blk, cache) in enumerate(_layers(stack, cfg, caches)):
        y, _ = layers.attention_prefill_paged(
            blk.mixer, rmsnorm(blk.norm1, x, cfg), cfg, cache, table_row, p0)
        x = _ffn_residual(blk, x + y, cfg, _row(bias, li), attn_backend)
    return x, caches


def apply_stack_prefill_chunk_multi(stack: nn.ModuleList, x, cfg: ModelConfig,
                                    caches: list, tables: torch.Tensor,
                                    p0s: torch.Tensor,
                                    attn_backend: str = "kernel", bias=None):
    """J concurrent prefill chunks (one lane per in-flight job) in one pass;
    ``attn_backend`` as in ``apply_stack_prefill_chunk``."""
    for li, (blk, cache) in enumerate(_layers(stack, cfg, caches)):
        y, _ = layers.attention_prefill_paged_multi(
            blk.mixer, rmsnorm(blk.norm1, x, cfg), cfg, cache, tables, p0s)
        x = _ffn_residual(blk, x + y, cfg, _row(bias, li), attn_backend)
    return x, caches
