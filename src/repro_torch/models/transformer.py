"""Decoder stack: blocks, the layer loop, hybrid patterns and the caches
(PyTorch port of ``repro/models/transformer.py``).

The parameters are an ``nn.ModuleList`` of per-layer ``Block`` modules in
depth order, and the JAX package's ``lax.scan`` over stacked layers becomes
a Python loop. The caches keep the JAX package's segment structure — a list
per segment of one dict per pattern position, each leaf with a leading
repeat dimension — so one tensor holds every layer of a position (the
engine's page copies and splices touch all layers in one op) and each layer
updates its ``[r]`` view in place. Hybrid archs (recurrentgemma) tile their
``block_pattern`` as a segment of whole repeats plus a tail segment.

Block kinds: ``attn`` (full attention + MLP), ``local`` (sliding-window
attention, a ring-buffer cache), ``moe`` (attention + the mixture of
experts), ``ssm`` (the mamba-2 mixer alone) and ``rglru`` (the Griffin
recurrent block + MLP). In the serving engine's paged pool only ``attn`` and
``moe`` layers are paged (``PAGED_KINDS``); the others keep one cache row
per slot.

MoE stacks take ``bias``, the (num_layers, E) immune router bias: layer ``l``
routes with row ``l``, and a ``truncate_stack`` draft, being the leading
layers, takes the leading rows. ``attn_backend`` picks every hand-written
kernel's route, the expert products' included (``layers.BACKENDS``). The
training pass (``apply_stack`` / ``apply_block``) takes no backend: it runs
the torch route under autograd, each repeat of a segment's pattern wrapped
by ``cfg.remat``.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from . import layers, moe, rglru, ssm
from .layers import RMSNorm, rmsnorm

MIXER_KINDS = ("attn", "local", "moe", "ssm", "rglru")
PAGED_KINDS = ("attn", "moe")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.family == "moe":
        return ["moe"] * cfg.num_layers
    if cfg.family == "ssm":
        return ["ssm"] * cfg.num_layers
    if cfg.family == "hybrid":
        pat = list(cfg.block_pattern)
        return [pat[i % len(pat)] for i in range(cfg.num_layers)]
    return ["attn"] * cfg.num_layers


def segments(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """Decompose the depth into (pattern, repeats) segments."""
    kinds = layer_kinds(cfg)
    if cfg.family == "hybrid":
        pat = tuple(cfg.block_pattern)
        reps = cfg.num_layers // len(pat)
        segs = [(pat, reps)] if reps else []
        tail = tuple(kinds[reps * len(pat):])
        if tail:
            segs.append((tail, 1))
        return segs
    return [((kinds[0],), cfg.num_layers)]


def layer_index(cfg: ModelConfig) -> list[tuple[int, int, int]]:
    """(segment, repeat, pattern position) of every layer in depth order."""
    return [(si, r, pi) for si, (pattern, reps) in enumerate(segments(cfg))
            for r in range(reps) for pi in range(len(pattern))]


class Block(nn.Module):
    """One pre-norm block of ``kind``: the mixer (attention, the mamba-2
    mixer or the recurrent block), then — but for ``ssm`` — a gated MLP or
    the mixture of experts."""

    def __init__(self, cfg: ModelConfig, kind: str,
                 gen: Optional[torch.Generator], device):
        super().__init__()
        if kind not in MIXER_KINDS:
            raise ValueError(kind)
        self.kind = kind
        self.norm1 = RMSNorm(cfg.d_model, device)
        if kind == "ssm":
            self.mixer = ssm.init_ssm(cfg, gen, device)
            return
        if kind == "rglru":
            self.mixer = rglru.init_rglru(cfg, gen, device)
        else:
            self.mixer = layers.Attention(cfg, gen, device)
        self.norm2 = RMSNorm(cfg.d_model, device)
        if kind == "moe":
            self.moe = moe.MoE(cfg, gen, device)
        else:
            self.mlp = layers.MLP(cfg, gen, device)


def init_stack(cfg: ModelConfig, gen: Optional[torch.Generator],
               device) -> nn.ModuleList:
    return nn.ModuleList(Block(cfg, kind, gen, device)
                         for kind in layer_kinds(cfg))


def _layer_cache(seg_cache: dict, li: int) -> dict:
    return {name: t[li] for name, t in seg_cache.items()}


def _ffn_residual(blk: Block, x, cfg, bias, backend: str):
    """x + the block's feed-forward: the MoE routed with ``bias`` (its
    layer's (E,) row), the dense MLP, or nothing (``ssm``)."""
    if blk.kind == "ssm":
        return x
    h = rmsnorm(blk.norm2, x, cfg)
    if hasattr(blk, "moe"):
        return x + moe.moe_ffn(blk.moe, h, cfg, bias, backend=backend)[0]
    return x + layers.mlp(blk.mlp, h, cfg)


def _row(bias, li: int):
    return None if bias is None else bias[li]


def apply_block(blk: Block, x, cfg: ModelConfig, bias=None,
                prefix_len: Optional[int] = None, tr=None, layer: int = 0):
    """Full-sequence (training) block. Attention runs the flash kernels
    where ``layers.flash_trains`` says so, else the torch route; the MoE's
    expert products run the torch route, as the JAX package trains through
    XLA. ``tr``, ``layer``: the step's session and the block's index, for
    the MoE's spans. Returns (x, the MoE's ``MoEStats`` or None)."""
    x = layers.constrain(x, layers.DP, None, None)
    h = rmsnorm(blk.norm1, x, cfg)
    if blk.kind == "ssm":
        return x + ssm.ssm_block(blk.mixer, h, cfg), None
    if blk.kind == "rglru":
        x = x + rglru.rglru_block(blk.mixer, h, cfg)
    else:
        window = cfg.local_window if blk.kind == "local" else None
        x = x + layers.attention(blk.mixer, h, cfg, window=window,
                                 prefix_len=prefix_len)
    h = rmsnorm(blk.norm2, x, cfg)
    if hasattr(blk, "moe"):
        y, stats = moe.moe_ffn(blk.moe, h, cfg, bias, backend="torch",
                               tr=tr, layer=layer)
        return x + y, stats
    return x + layers.mlp(blk.mlp, h, cfg), None


# the matmuls without batch dimensions (``x @ W``), which ``remat="dots"``
# keeps, as jax.checkpoint_policies.dots_with_no_batch_dims_saveable does;
# the attention einsums (``bmm``) and everything else are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``cfg.remat``: "full" recomputes the whole repeat in the backward,
    "dots" keeps the matmul outputs and recomputes the rest."""
    if cfg.remat == "full":
        return partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return partial(checkpoint, fn, use_reentrant=False,
                       context_fn=partial(create_selective_checkpoint_contexts,
                                          _save_dots))
    return fn


def apply_stack(stack: nn.ModuleList, x, cfg: ModelConfig, bias=None,
                prefix_len: Optional[int] = None, tr=None):
    """Full-sequence (training) pass. ``bias``: the (num_layers, E) immune
    router bias. Each repeat of a segment's pattern is the unit ``cfg.remat``
    wraps, as the JAX package's scan body is. ``tr``: the step's session
    (the MoE layers' spans). Returns (x, load fractions (num_layers, E) |
    None, aux loss, drop fraction, buffer fill), the last three the means
    over the MoE layers (zero without experts)."""
    blocks = list(stack)
    loads, auxs, drops, fills = [], [], [], []
    li = 0
    for pattern, reps in segments(cfg):
        for _ in range(reps):
            group = blocks[li:li + len(pattern)]
            rows = [_row(bias, li + i) for i in range(len(pattern))]

            def body(xc, group=group, rows=rows, li=li):
                sts = []
                for i, (blk, b) in enumerate(zip(group, rows)):
                    xc, st = apply_block(blk, xc, cfg, b, prefix_len, tr,
                                         li + i)
                    if st is not None:
                        sts.append(st)
                return xc, sts

            x, sts = _maybe_remat(body, cfg)(x)
            for st in sts:
                loads.append(st.load_frac)
                auxs.append(st.aux_loss)
                drops.append(st.drop_frac)
                fills.append(st.fill)
            li += len(pattern)
    if loads:
        return (x, torch.stack(loads), torch.stack(auxs).mean(),
                torch.stack(drops).mean(), torch.stack(fills).mean())
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, None, zero, zero, zero


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                     dtype, device) -> dict:
    """One layer's dense decode cache: K/V rows (``attn``, ``moe``), a ring
    buffer of min(s_max, local_window) positions (``local``), or the
    recurrent state (``ssm``, ``rglru``)."""
    if kind in PAGED_KINDS:
        return layers.init_attention_cache(cfg, batch, s_max, dtype, device)
    if kind == "local":
        return layers.init_attention_cache(
            cfg, batch, min(s_max, cfg.local_window), dtype, device)
    if kind == "ssm":
        return ssm.init_ssm_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return rglru.init_rglru_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def _stack_cache(one: dict, reps: int) -> dict:
    """``reps`` zero copies of a freshly initialised (zero) cache, stacked."""
    return {name: t.new_zeros((reps,) + tuple(t.shape))
            for name, t in one.items()}


def init_stack_cache(cfg: ModelConfig, batch: int, s_max: int, dtype,
                     device) -> list:
    """Dense decode caches, mirroring the segment structure."""
    return [[_stack_cache(init_block_cache(cfg, kind, batch, s_max, dtype,
                                           device), reps)
             for kind in pattern] for pattern, reps in segments(cfg)]


def init_stack_cache_paged(cfg: ModelConfig, num_slots: int, s_max: int,
                           num_pages: int, page_size: int, dtype,
                           device) -> list:
    """Paged decode caches: every full-attention layer gets a physical page
    pool (num_pages, page_size, Hkv, D), stacked over depth; sliding-window
    layers keep slot-row ring buffers and recurrent layers their slot-row
    states — none of those holds a worst-case sequence reservation, so only
    full attention is paged."""
    out = []
    for pattern, reps in segments(cfg):
        seg = []
        for kind in pattern:
            if kind in PAGED_KINDS:
                seg.append(_stack_cache(layers.init_attention_cache_paged(
                    cfg, num_pages, page_size, dtype, device), reps))
            else:
                seg.append(_stack_cache(init_block_cache(
                    cfg, kind, num_slots, s_max, dtype, device), reps))
        out.append(seg)
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
    for blk, (si, r, pi) in zip(stack, layer_index(cfg)):
        yield blk, _layer_cache(caches[si][pi], r)


def apply_stack_prefill(stack: nn.ModuleList, x, cfg: ModelConfig,
                        caches: list, attn_backend: str = "kernel",
                        bias=None, prefix_len: Optional[int] = None):
    """Full-sequence pass that fills the dense decode caches in place;
    ``prefix_len`` opens bidirectional attention over the first positions
    (the VLM's patch prefix). Returns (x, caches)."""
    for li, (blk, cache) in enumerate(_layers(stack, cfg, caches)):
        h = rmsnorm(blk.norm1, x, cfg)
        if blk.kind == "ssm":
            y, _ = ssm.ssm_block_prefill(blk.mixer, h, cfg, cache)
        elif blk.kind == "rglru":
            y, _ = rglru.rglru_block_prefill(blk.mixer, h, cfg, cache)
        else:
            window = cfg.local_window if blk.kind == "local" else None
            y, _ = layers.attention_prefill(blk.mixer, h, cfg, cache,
                                            backend=attn_backend,
                                            window=window,
                                            prefix_len=prefix_len)
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
    ``i`` routes with bias row ``i``. Full-attention layers take the paged
    pool when ``table`` is given; sliding-window and recurrent layers keep
    their slot-row caches either way and advance only the rows where
    ``active`` (the JAX package's freeze of inactive slots)."""
    for li, (blk, cache) in enumerate(pairs):
        h = rmsnorm(blk.norm1, x, cfg)
        if blk.kind == "ssm":
            y, _ = ssm.ssm_block_decode(blk.mixer, h, cfg, cache, active)
        elif blk.kind == "rglru":
            y, _ = rglru.rglru_block_decode(blk.mixer, h, cfg, cache, active)
        elif blk.kind == "local":
            y, _ = layers.attention_decode(blk.mixer, h, cfg, cache, pos,
                                           window=cfg.local_window,
                                           active=active)
        elif table is not None:
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


def _attention_only(blk: Block, what: str) -> None:
    """Verify and multi-job chunk prefill need rows with no cross-position
    state: attention-stack kinds only (the engine gates them)."""
    if blk.kind not in PAGED_KINDS:
        raise NotImplementedError(f"{what} unsupported for {blk.kind!r}")


def apply_block_verify(blk: Block, x, cfg: ModelConfig, cache: dict,
                       pos: torch.Tensor, table: torch.Tensor, active=None,
                       attn_backend: str = "kernel", bias=None):
    """Sq-position verify block step against the paged pool (``attn`` and
    ``moe`` kinds: no slot-row state, so every (lane, position) row is
    independent; the MoE is dropless at the engine's decode capacity)."""
    _attention_only(blk, "verify step")
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
                              slot: int = 0, attn_backend: str = "kernel",
                              bias=None):
    """One prefill chunk (batch of 1): full-attention layers write the
    chunk's K/V into the slot's pages, SSM layers thread the slot's state
    row (``slot``) across chunks. Sliding-window and RG-LRU layers are not
    chunkable (the engine prefills those configs one-shot). The chunk's
    attention has one route (gather + ``_sdpa``); ``attn_backend`` picks the
    expert products'."""
    for li, (blk, cache) in enumerate(_layers(stack, cfg, caches)):
        h = rmsnorm(blk.norm1, x, cfg)
        if blk.kind in PAGED_KINDS:
            y, _ = layers.attention_prefill_paged(blk.mixer, h, cfg, cache,
                                                  table_row, p0)
        elif blk.kind == "ssm":
            row = {name: t[slot:slot + 1] for name, t in cache.items()}
            y, _ = ssm.ssm_block_prefill_chunk(blk.mixer, h, cfg, row)
        else:
            raise NotImplementedError(
                f"chunked prefill unsupported for {blk.kind!r}")
        x = _ffn_residual(blk, x + y, cfg, _row(bias, li), attn_backend)
    return x, caches


def apply_stack_prefill_chunk_multi(stack: nn.ModuleList, x, cfg: ModelConfig,
                                    caches: list, tables: torch.Tensor,
                                    p0s: torch.Tensor,
                                    attn_backend: str = "kernel", bias=None):
    """J concurrent prefill chunks (one lane per in-flight job) in one pass —
    attention-stack kinds only; ``attn_backend`` as in
    ``apply_stack_prefill_chunk``."""
    for li, (blk, cache) in enumerate(_layers(stack, cfg, caches)):
        _attention_only(blk, "batched chunk prefill")
        y, _ = layers.attention_prefill_paged_multi(
            blk.mixer, rmsnorm(blk.norm1, x, cfg), cfg, cache, tables, p0s)
        x = _ffn_residual(blk, x + y, cfg, _row(bias, li), attn_backend)
    return x, caches
