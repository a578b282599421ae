"""Top-level model API: init / train loss / prefill / decode / sampling /
paged-pool surgery (PyTorch port of ``repro/models/model.py``), uniform
across families.

Batch layouts: train and prefill ``{"tokens": (B, S) int, "patches": (B, P,
Fd), "frames": (B, S, Fd)}``, decode ``{"token": (B, 1) int, "frame": (B,
1, Fd)}`` (patches for the VLM, frames for audio) plus a cache and its
``pos``. The model is a
:class:`Model` module; every function takes it as ``params`` so the call
shapes mirror the JAX package's. Caches are updated in place (see
``layers``); the returned cache dicts share their tensors with the inputs.
``router_bias`` is the MoE family's (num_layers, E) immune router bias
(``None`` for dense models). :func:`param_layout` maps the per-layer
parameters onto the JAX package's tree, whose stack leaves carry a leading
repeat dimension: what the optimizer and the checkpoints see.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .. import prng
from ..configs.base import ModelConfig
from . import frontends, layers, transformer
from .layers import RMSNorm, dtype_of, embed_init, rmsnorm


class SamplingSpec(NamedTuple):
    """Per-lane sampling tensors for a batch of decode lanes (one row per
    engine slot or one-shot sequence)."""

    keys: torch.Tensor          # (B, 2) int64 threefry key words
    temperature: torch.Tensor   # (B,) f32; 0 => exact argmax (greedy lane)
    top_k: torch.Tensor         # (B,) int; 0 => disabled
    top_p: torch.Tensor         # (B,) f32; 1.0 => disabled
    rep_penalty: torch.Tensor   # (B,) f32; 1.0 => disabled
    pres_penalty: torch.Tensor  # (B,) f32; 0.0 => disabled
    freq_penalty: torch.Tensor  # (B,) f32; 0.0 => disabled


class TrainOut(NamedTuple):
    loss: torch.Tensor                 # () fp32 next-token cross-entropy
    aux_loss: torch.Tensor             # Switch aux loss (0 unless MoE)
    load_frac: Optional[torch.Tensor]  # (L, E) per-layer expert load
    drop_frac: torch.Tensor
    logits_mean_abs: torch.Tensor      # cheap NaN / scale canary


class Model(nn.Module):
    """Token embedding, the block stack and the final norm (+ untied head,
    + the frontend projection of the VLM and audio families). ``gen=None``
    allocates the parameters uninitialised (to be filled, e.g. by
    :func:`params_from_numpy`)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device):
        super().__init__()
        dt = dtype_of(cfg)
        self.embed = layers._param(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                              dt, device))
        self.blocks = transformer.init_stack(cfg, gen, device)
        self.final_norm = RMSNorm(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.head = layers._param(embed_init(gen, cfg.vocab_size,
                                                 cfg.d_model, dt, device))
        if cfg.frontend_dim:
            self.frontend = frontends.init_frontend(cfg, gen, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device="cuda") -> Model:
    """Random parameters drawn from ``gen`` (on the generator's device),
    placed on ``device``."""
    return Model(cfg, gen, torch.device(device))


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))          # writable copy


class ParamLeaf:
    """One leaf of the JAX package's parameter tree, as the :class:`Model`
    holds it: the Parameters it stacks (one per repeat of its segment, in
    order; ``stacked``) or one Parameter outside the stack. ``shape``,
    ``dtype`` and ``device`` are the JAX leaf's — a norm scale
    inside the stack is (R, D), two-dimensional — so the optimizer decides
    weight decay and factoring as the JAX package does."""

    def __init__(self, name: str, stacked: bool):
        self.name = name
        self.stacked = stacked
        self.params: list[nn.Parameter] = []

    @property
    def shape(self) -> tuple:
        lead = (len(self.params),) if self.stacked else ()
        return lead + tuple(self.params[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.params[0].dtype

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def value(self) -> torch.Tensor:
        """The leaf as one tensor (a stacked copy inside the stack)."""
        if self.stacked:
            return torch.stack([p.detach() for p in self.params])
        return self.params[0].detach()

    def assign(self, t: torch.Tensor) -> None:
        """Copy the JAX-layout tensor ``t`` into the Parameters (cast to
        their dtype, moved to their device)."""
        if tuple(t.shape) != self.shape:
            raise ValueError(f"{self.name}: shape {tuple(t.shape)} != "
                             f"{self.shape}")
        with torch.no_grad():
            if self.stacked:
                for r, p in enumerate(self.params):
                    p.copy_(t[r])
            else:
                self.params[0].copy_(t)


def param_layout(params: Model, cfg: ModelConfig) -> dict:
    """The JAX package's parameter tree with a :class:`ParamLeaf` at every
    leaf: ``embed``, ``final_norm``, ``head`` and ``frontend`` as they are,
    the stack as a list per segment of one block dict per pattern position,
    each leaf stacking its repeats."""
    where = transformer.layer_index(cfg)
    stack = [[{} for _ in pattern] for pattern, _ in transformer.segments(cfg)]
    tree: dict = {"stack": stack}
    for name, p in params.named_parameters():
        path = name.split(".")
        if path[0] == "blocks":
            si, _, pi = where[int(path[1])]
            node, path, stacked = stack[si][pi], path[2:], True
        else:
            node, stacked = tree, False
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node.setdefault(path[-1], ParamLeaf(name, stacked)).params.append(p)
    return tree


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_tree(params: Model, cfg: ModelConfig) -> dict:
    """The parameters in the JAX package's tree layout (stacked copies,
    detached from autograd)."""
    return tree_map(ParamLeaf.value, param_layout(params, cfg))


def load_params(params: Model, cfg: ModelConfig, tree: dict) -> Model:
    """Copy a JAX-layout tree (tensors or numpy arrays, bf16 as ml_dtypes or
    raw 16-bit) into ``params`` in place; each leaf is cast to its
    parameter's dtype, so an MoE block's ``moe.w_router`` stays float32 in
    a bf16 model, as in the JAX package."""
    def put(leaf, node):
        if isinstance(leaf, ParamLeaf):
            leaf.assign(node if isinstance(node, torch.Tensor)
                        else _tensor(node))
        elif isinstance(leaf, dict):
            for k, v in leaf.items():
                put(v, node[k])
        else:
            for v, n in zip(leaf, node, strict=True):
                put(v, n)

    put(param_layout(params, cfg), tree)
    return params


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Model:
    """The JAX package's parameter tree (nested dicts of numpy arrays; the
    stack as a list per segment of one block dict per pattern position, each
    leaf with a leading repeat dimension) as a :class:`Model` on ``device``
    — how both packages compute on the same weights."""
    return load_params(Model(cfg, None, torch.device(device)), cfg, tree)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 as an ``ml_dtypes`` bfloat16
    array (the JAX package's numpy dtype)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Model, cfg: ModelConfig) -> dict:
    """The inverse of :func:`params_from_numpy`: the JAX package's parameter
    tree of numpy arrays."""
    return tree_map(to_numpy, params_tree(params, cfg))


def _embed(params: Model, cfg: ModelConfig, tokens: torch.Tensor):
    # gather the (possibly fsdp-sharded) table at use, keep activations on DP
    table = layers.constrain(params.embed, "model", None)
    if layers.is_dtensor(table):
        x = F.embedding(tokens.long(), table)   # the vocab-parallel lookup
    else:
        x = table[tokens.long()]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return layers.constrain(x, layers.DP, None, None)


def _head(params: Model, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(params.final_norm, x, cfg)
    table = params.embed if cfg.tie_embeddings else params.head
    table = layers.constrain(table, "model", None)
    return layers.constrain((x @ table.T).float(), layers.DP, None, "model")


def _target_logit(lg: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """lg[..., targets]. On one device a gather. On a mesh whose 'model'
    axis shards the vocab, each shard gathers the targets that fall in its
    vocab range (zero elsewhere) and the shards sum over 'model': gathering
    across the sharded dim would all-gather the full logits."""
    if not layers.is_dtensor(lg):
        return torch.gather(lg, -1, targets[..., None])[..., 0]
    mesh = lg.device_mesh
    vdim = lg.dim() - 1
    if not any(isinstance(p, Shard) and p.dim == vdim
               for p in lg.placements):
        return torch.gather(lg, -1, targets[..., None])[..., 0]
    lead = tuple(Replicate() if isinstance(p, Shard) and p.dim == vdim
                 else p for p in lg.placements)
    targets = layers.as_dtensor(targets, mesh, lead)
    vids = layers.as_dtensor(
        torch.arange(lg.shape[-1], device=lg.to_local().device), mesh,
        tuple(Shard(0) if isinstance(p, Shard) and p.dim == vdim
              else Replicate() for p in lg.placements))
    out = tuple(Partial() if isinstance(p, Shard) and p.dim == vdim
                else p for p in lg.placements)

    def local(lg_l, tgt_l, vids_l):
        rel = tgt_l - vids_l[0]
        inside = (rel >= 0) & (rel < lg_l.shape[-1])
        got = torch.gather(lg_l, -1,
                           rel.clamp(0, lg_l.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros_like(got))

    return local_map(local, out_placements=(out,),
                     in_placements=(lg.placements, lead,
                                    tuple(vids.placements)),
                     device_mesh=mesh)(lg, targets, vids)


def _meshed(fn):
    """Run a model entry point in ``layers.under_mesh()``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with layers.under_mesh():
            return fn(*args, **kwargs)
    return run


@_meshed
def train_loss(params: Model, cfg: ModelConfig, batch: dict,
               router_bias: Optional[torch.Tensor] = None) -> TrainOut:
    """Next-token cross-entropy in fp32 over ``batch["tokens"]`` (B, S) (the
    VLM's patch prefix carries no labels), plus ``aux_loss_coef`` times the
    Switch aux loss for an MoE in ``router_mode == "aux"``. The target
    logit is gathered, where the JAX package contracts a (B, S, V) one-hot.
    It takes no ``backend``: attention runs the flash kernels forward and
    backward where ``layers.flash_trains`` says so (bf16 on one card, head
    dim 64 or 128, plainly causal) and the torch route elsewhere; the
    serving kernels have no backward."""
    tokens = batch["tokens"]
    x, plen = _inputs(params, cfg, batch)
    x, load, aux, drop = transformer.apply_stack(
        params.blocks, x, cfg, bias=router_bias, prefix_len=plen or None)
    if plen:
        x = x[:, plen:]
    lg = _head(params, cfg, x)[:, :-1]                  # (B, S-1, V) fp32
    targets = tokens[:, 1:].long()
    correct = _target_logit(lg, targets)
    loss = (torch.logsumexp(lg, dim=-1) - correct).mean()
    if cfg.router_mode == "aux" and cfg.num_experts:
        loss = loss + cfg.aux_loss_coef * aux
    return TrainOut(loss=loss, aux_loss=aux, load_frac=load, drop_frac=drop,
                    logits_mean_abs=lg.detach().abs().mean())


def penalize_logits(lg: torch.Tensor, spec: SamplingSpec,
                    counts: torch.Tensor) -> torch.Tensor:
    """Per-lane repetition / presence / frequency penalties on (B, V) logits
    given ``counts`` (B, V) of generated tokens; lanes with all three at
    their neutral values are returned bitwise unchanged."""
    cnt = counts.float()
    counted = cnt > 0
    rep = spec.rep_penalty[:, None]
    scaled = torch.where(lg > 0, lg / rep, lg * rep)
    pen = torch.where(counted, scaled, lg) \
        - spec.freq_penalty[:, None] * cnt \
        - spec.pres_penalty[:, None] * counted.float()
    neutral = ((spec.rep_penalty == 1.0) & (spec.pres_penalty == 0.0)
               & (spec.freq_penalty == 0.0))
    return torch.where(neutral[:, None], lg, pen)


def sample_tokens(logits: torch.Tensor, spec: SamplingSpec, step,
                  counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per lane from last-position ``logits`` ((B, V) or (B, T, V))
    under per-lane ``SamplingSpec`` rows; the lane key is
    ``fold_in(lane key, step)`` (``step`` scalar or (B,)), so a request's
    draws depend only on its own progress. Per lane: scale by temperature,
    full stable descending sort, top-k rank mask, top-p cumulative-mass mask
    (the top token always survives), Gumbel draw over the survivors —
    bit-compatible with ``jax.random``. Temperature-0 lanes take the exact
    argmax. Returns (B, 1) int32."""
    lg = logits[:, -1] if logits.dim() == 3 else logits
    if counts is not None:
        lg = penalize_logits(lg, spec, counts)
    b, v = lg.shape
    greedy_tok = torch.argmax(lg, dim=-1)
    steps = torch.as_tensor(step, device=lg.device).to(torch.int64).expand(b)
    keys = prng.fold_in(spec.keys, steps)
    scaled = lg / spec.temperature.clamp_min(1e-6)[:, None]
    vals, idx = torch.sort(scaled, dim=-1, descending=True, stable=True)
    ranks = torch.arange(v, device=lg.device)[None, :]
    keep_k = ranks < torch.where(spec.top_k > 0, spec.top_k,
                                 torch.full_like(spec.top_k, v))[:, None]
    probs = torch.softmax(vals, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    masked = torch.where(keep_k & (mass_before < spec.top_p[:, None]), vals,
                         torch.tensor(-torch.inf, device=lg.device))
    choice = prng.categorical(keys, masked)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    tok = torch.where(spec.temperature > 0, sampled, greedy_tok)
    return tok[:, None].to(torch.int32)


def chosen_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Log-softmax of the raw fp32 logits at each lane's chosen token;
    ``logits`` (B, V) or (B, T, V) (last position), ``tok`` (B, 1) -> (B, 1)."""
    lg = logits[:, -1] if logits.dim() == 3 else logits
    lp = torch.log_softmax(lg.float(), dim=-1)
    return torch.gather(lp, 1, tok.long())


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    return {"layers": transformer.init_stack_cache(cfg, batch, s_max,
                                                   dtype_of(cfg), device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _inputs(params: Model, cfg: ModelConfig, batch: dict):
    """Prompt embeddings and the prefix length: the VLM's projected patches
    ahead of the text (a prefix of ``frontend_tokens`` positions), audio's
    projected frames added to the token embeddings, else the tokens."""
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "vlm":
        prefix = frontends.project_frontend(params.frontend, batch["patches"])
        return torch.cat([prefix, x], dim=1), prefix.shape[1]
    if cfg.family == "audio":
        x = x + frontends.project_frontend(params.frontend, batch["frames"])
    return x, 0


@_meshed
def prefill(params: Model, cfg: ModelConfig, batch: dict, cache: dict,
            attn_backend: str = "kernel",
            router_bias: Optional[torch.Tensor] = None):
    """Batched prompt processing; fills the cache (in place) and returns the
    last-position logits (B, 1, V) fp32 and the cache, whose ``pos`` counts
    the prompt's positions (a VLM's patch prefix included)."""
    x, plen = _inputs(params, cfg, batch)
    x, layer_caches = transformer.apply_stack_prefill(
        params.blocks, x, cfg, cache["layers"], attn_backend=attn_backend,
        bias=router_bias, prefix_len=plen or None)
    logits = _head(params, cfg, x[:, -1:])
    return logits, {"layers": layer_caches,
                    "pos": torch.tensor(x.shape[1], dtype=torch.int32,
                                        device=x.device)}


@_meshed
def decode_step(params: Model, cfg: ModelConfig, batch: dict, cache: dict,
                table: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None,
                attn_backend: str = "kernel",
                router_bias: Optional[torch.Tensor] = None):
    """One token for every sequence (audio adds ``batch["frame"]``).
    ``table`` (B, maxp) switches the full-attention layers onto the paged
    pool (``active`` routes inactive lanes' writes to the null page).
    ``active`` also freezes the slot-row caches (recurrent state, ring
    buffers) of inactive lanes: a garbage lane must never advance state a
    chunked prefill is threading through that row between ticks. The JAX
    package applies the freeze to the new caches it returns; here the
    layers' in-place writes are masked. Returns (logits (B, 1, V), cache
    with pos+1)."""
    x = _embed(params, cfg, batch["token"])
    if cfg.family == "audio":
        x = x + frontends.project_frontend(params.frontend, batch["frame"])
    x, layer_caches = transformer.apply_stack_decode(
        params.blocks, x, cfg, cache["layers"], cache["pos"], table=table,
        active=active, attn_backend=attn_backend, bias=router_bias)
    return _head(params, cfg, x), {"layers": layer_caches,
                                   "pos": cache["pos"] + 1}


def verify_step(params: Model, cfg: ModelConfig, batch: dict, pool: dict,
                table: torch.Tensor, active: Optional[torch.Tensor] = None,
                attn_backend: str = "kernel",
                router_bias: Optional[torch.Tensor] = None):
    """Batched k-position verify step for self-speculative decoding.

    ``batch["tokens"]`` is (B, K+1): each slot's last emitted token followed
    by its K draft proposals. Row ``j`` is scored at cache position
    ``pool["pos"] + j`` with causal access up to itself, and K/V for every
    row is written into the paged pool (in place) as a side effect. Row
    ``j``'s logits are what ``decode_step`` would produce row by row; the JAX
    package holds that bitwise, the port within rounding (see
    ``layers.attention_verify_paged``).

    Returns ``(logits (B, K+1, V), pool)``; ``pos`` is left untouched — the
    engine owns position advancement from its host-side accept loop."""
    x = _embed(params, cfg, batch["tokens"])
    x, layer_caches = transformer.apply_stack_verify(
        params.blocks, x, cfg, pool["layers"], pool["pos"], table,
        active=active, attn_backend=attn_backend, bias=router_bias)
    return _head(params, cfg, x), {"layers": layer_caches, "pos": pool["pos"]}


# ---------------------------------------------------------------------------
# paged slot-pool surgery (block-table KV cache, continuous-batching engine)
# ---------------------------------------------------------------------------
def init_slot_cache_paged(cfg: ModelConfig, num_slots: int, s_max: int,
                          num_pages: int, page_size: int, device) -> dict:
    """Per-layer physical page pools + a per-slot position vector."""
    return {"layers": transformer.init_stack_cache_paged(
                cfg, num_slots, s_max, num_pages, page_size, dtype_of(cfg),
                device),
            "pos": torch.zeros((num_slots,), dtype=torch.int32, device=device)}


def insert_slot_cache_paged(pool: dict, one: dict, cfg: ModelConfig,
                            slot: int, table_row: torch.Tensor) -> dict:
    """Splice a one-shot prefilled batch-of-1 dense cache into the pool (in
    place). Full-attention leaves: the dense (1, s_max, ...) row is reshaped
    to (maxp, page, ...) and scattered to the slot's physical pages; rows
    beyond the slot's allocation land on the null page. Slot-row leaves
    (recurrent state, ring buffers) are whole-row copies at ``slot``,
    erasing any stale state of the slot's previous occupant."""
    idx = table_row.long()

    def splice(kind, full_d, one_d):
        for name, full in full_d.items():
            if kind in transformer.PAGED_KINDS:
                reps, page = full.shape[0], full.shape[2]
                full[:, idx] = one_d[name].to(full.dtype).reshape(
                    reps, -1, page, *full.shape[3:])
            else:
                full[:, slot] = one_d[name][:, 0].to(full.dtype)
        return full_d

    transformer.map_block_caches(cfg, splice, pool["layers"], one["layers"])
    pool["pos"][slot] = one["pos"].to(pool["pos"].dtype)
    return pool


def release_slot_cache_paged(pool: dict, cfg: ModelConfig, slot: int) -> dict:
    """Retire a slot: zero its slot-row (recurrent / ring) leaves and its
    position. Physical pages are not zeroed — they return to the host free
    list, and stale contents are read masked."""
    def wipe(kind, full_d):
        if kind not in transformer.PAGED_KINDS:
            for full in full_d.values():
                full[:, slot] = 0
        return full_d

    transformer.map_block_caches(cfg, wipe, pool["layers"])
    pool["pos"][slot] = 0
    return pool


def prefill_chunk(params: Model, cfg: ModelConfig, batch: dict, pool: dict,
                  table_row: torch.Tensor, p0: int, last_idx: int,
                  slot: int = 0, attn_backend: str = "kernel",
                  router_bias: Optional[torch.Tensor] = None):
    """One chunk of a chunked prefill written straight into the paged pool
    (``batch["frames"]`` too for audio); ``slot`` is the row whose
    recurrent state an SSM threads across chunks. Returns the logits at
    in-chunk index ``last_idx`` (1, 1, V). The pool's ``pos`` is untouched.
    The chunk's attention has one route; ``attn_backend`` picks the expert
    products'."""
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "audio":
        x = x + frontends.project_frontend(params.frontend, batch["frames"])
    x, layer_caches = transformer.apply_stack_prefill_chunk(
        params.blocks, x, cfg, pool["layers"], table_row, p0, slot=slot,
        attn_backend=attn_backend, bias=router_bias)
    logits = _head(params, cfg, x[:, last_idx:last_idx + 1])
    return logits, {"layers": layer_caches, "pos": pool["pos"]}


def prefill_chunk_multi(params: Model, cfg: ModelConfig, batch: dict,
                        pool: dict, tables: torch.Tensor, p0s: torch.Tensor,
                        last_idx: torch.Tensor, attn_backend: str = "kernel",
                        router_bias: Optional[torch.Tensor] = None):
    """J concurrent prefill chunks (one in-flight job per lane) in one call;
    returns (J, 1, V) logits at each lane's ``last_idx``. Attention-stack
    configs only."""
    x = _embed(params, cfg, batch["tokens"])
    x, layer_caches = transformer.apply_stack_prefill_chunk_multi(
        params.blocks, x, cfg, pool["layers"], tables, p0s,
        attn_backend=attn_backend, bias=router_bias)
    rows = torch.arange(x.shape[0], device=x.device)
    sel = x[rows, last_idx.long()][:, None]
    return _head(params, cfg, sel), {"layers": layer_caches,
                                     "pos": pool["pos"]}


def copy_page_paged(pool: dict, cfg: ModelConfig, src: int, dst: int) -> dict:
    """Copy-on-write fork: duplicate physical page ``src`` into ``dst`` in
    every full-attention layer's pool (in place); slot-row leaves are left
    alone."""
    def cp(kind, full_d):
        if kind in transformer.PAGED_KINDS:
            for full in full_d.values():
                full[:, dst] = full[:, src]
        return full_d

    transformer.map_block_caches(cfg, cp, pool["layers"])
    return pool


def scrub_pages_paged(pool: dict, cfg: ModelConfig, pages) -> dict:
    """Zero the K/V of physical ``pages`` in every full-attention layer's
    pool (in place); slot-row leaves are left alone."""
    if not pages:
        return pool
    idx = torch.as_tensor(list(pages), dtype=torch.long,
                          device=pool["pos"].device)

    def zero(kind, full_d):
        if kind in transformer.PAGED_KINDS:
            for full in full_d.values():
                full.index_fill_(1, idx, 0)
        return full_d

    transformer.map_block_caches(cfg, zero, pool["layers"])
    return pool


def param_count(params: Model) -> int:
    return sum(p.numel() for p in params.parameters())


def active_param_count(params: Model, cfg: ModelConfig) -> int:
    """Per-token active parameters (MoE counts only k of E experts)."""
    total = param_count(params)
    if not cfg.num_experts:
        return total
    expert_total = sum(getattr(blk.moe, name).numel()
                       for blk in params.blocks if hasattr(blk, "moe")
                       for name in ("w_gate", "w_up", "w_down"))
    active_frac = cfg.experts_per_token / cfg.num_experts
    return int(total - expert_total * (1.0 - active_frac))
