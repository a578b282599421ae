"""Analytic roofline terms per (arch, shape, parallelism) cell (PyTorch port
of ``repro/launch/roofline.py``: the same arithmetic, term for term).

The compute and memory terms are derived analytically from the model math
(the accounting MaxText-style MFU uses); the dry-run records the collective
term from the collectives the sharded step issues. The hardware rates are
arguments: the dry-run passes the H100's.

All returned byte/flop counts are PER DEVICE unless suffixed _total.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig, ParallelConfig, ShapeConfig
from ..models.transformer import layer_kinds

# per-layer-activation bytes factors by remat policy (bf16 activations; coarse):
# how many bytes of saved residuals per token per d_model unit
_ACT_FACTOR = {"none": 18.0, "dots": 8.0, "full": 4.0}


@dataclass
class Terms:
    flops_total: float          # whole-step, all chips
    flops_per_device: float
    hbm_bytes_per_device: float
    state_bytes_per_device: float   # resident: params + opt (+cache for serving)
    t_compute: float
    t_memory: float


def _moe_cf(cfg: ModelConfig, pcfg: ParallelConfig) -> float:
    return pcfg.capacity_factor if pcfg.capacity_factor is not None \
        else cfg.capacity_factor


def layer_flops_per_token(cfg: ModelConfig, kind: str, s_ctx: float,
                          pcfg: ParallelConfig) -> float:
    """Forward FLOPs per token for one layer of the given mixer kind.
    ``s_ctx`` = average attended context length (S/2 causal, window, or cache len).
    """
    d = cfg.d_model
    fl = 0.0
    if kind in ("attn", "local", "moe"):
        h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        fl += 2.0 * d * hd * (2 * h + 2 * hk)           # qkvo projections
        fl += 2.0 * 2.0 * h * hd * s_ctx                # qk^T and pv
    if kind in ("attn", "local"):
        fl += 3 * 2.0 * d * cfg.d_ff                    # gated mlp
    if kind == "moe":
        cf = _moe_cf(cfg, ParallelConfig())
        fl += 2.0 * d * cfg.num_experts                 # router
        fl += cfg.experts_per_token * 3 * 2.0 * d * cfg.d_ff * cf
    if kind == "ssm":
        di = cfg.ssm_expand * d
        h_ = di // cfg.ssm_head_dim
        n, p, l = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk
        fl += 2.0 * d * (2 * di + 2 * n + h_) + 2.0 * di * d
        fl += 2.0 * cfg.ssm_conv * (di + 2 * n)
        fl += 2.0 * l * n + 2.0 * l * h_ * p + 4.0 * h_ * n * p
    if kind == "rglru":
        w = cfg.lru_width or d
        fl += 3 * 2.0 * d * w + 2 * 2.0 * w * w + 7.0 * w
        fl += 3 * 2.0 * d * cfg.d_ff                    # griffin mlp
    return fl


def step_flops_total(cfg: ModelConfig, shape: ShapeConfig,
                     pcfg: ParallelConfig) -> float:
    b, s = shape.global_batch, shape.seq_len
    kinds = layer_kinds(cfg)
    if shape.kind == "decode":
        tokens = float(b)                                # one token per sequence
        ctx = {"attn": float(s), "moe": float(s),
               "local": float(min(s, cfg.local_window)),
               "ssm": 1.0, "rglru": 1.0}
    else:
        prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
        tokens = float(b) * (s + prefix)
        ctx = {"attn": (s + prefix) / 2.0, "moe": (s + prefix) / 2.0,
               "local": min(cfg.local_window, s / 2.0),
               "ssm": 1.0, "rglru": 1.0}
    per_tok = sum(layer_flops_per_token(cfg, k, ctx.get(k, 1.0), pcfg)
                  for k in kinds)
    per_tok += 2.0 * cfg.d_model * cfg.vocab_size       # lm head
    if cfg.frontend_dim:
        per_tok += 2.0 * cfg.frontend_dim * cfg.d_model
    mult = 3.0 if shape.kind == "train" else 1.0        # fwd+bwd
    if shape.kind == "train" and (cfg.remat == "full" or pcfg.remat == "full"):
        mult += 1.0                                      # recompute fwd
    return per_tok * tokens * mult


def state_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                           pcfg: ParallelConfig, n_params: int, chips: int,
                           opt_bytes_per_param: float, cache_bytes_total: float
                           ) -> float:
    pb = 2.0 if cfg.dtype == "bfloat16" else 4.0
    # params shard over model x (data if fsdp); otherwise only model
    shard = chips if pcfg.fsdp else max(
        1, chips // (shape.global_batch and _dp_size(shape, chips)))
    params_local = n_params * pb / shard
    opt_local = (n_params * opt_bytes_per_param / shard
                 if shape.kind == "train" else 0.0)
    return params_local + opt_local + cache_bytes_total / chips


def _dp_size(shape: ShapeConfig, chips: int) -> int:
    model = 16
    return max(1, chips // model)


def step_hbm_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                              pcfg: ParallelConfig, n_params: int,
                              n_active: int, chips: int,
                              opt_bytes_per_param: float,
                              cache_bytes_total: float) -> float:
    """Coarse HBM traffic model (bf16 weights/activations, fp32 master path)."""
    pb = 2.0 if cfg.dtype == "bfloat16" else 4.0
    b, s = shape.global_batch, shape.seq_len
    act_f = _ACT_FACTOR.get(pcfg.remat if pcfg.remat != "none" else cfg.remat,
                            _ACT_FACTOR["none"])
    if shape.kind == "train":
        params_local = n_params * pb / chips if pcfg.fsdp else \
            n_params * pb / 16
        # read fwd + read bwd (+ re-read under full remat) + grad write fp32
        # + optimizer read/write (mu, nu) + param write
        passes = 3.0 + (1.0 if (pcfg.remat == "full" or cfg.remat == "full") else 0.0)
        traffic = params_local * passes + (n_params / chips) * (
            4.0 + 2.0 * opt_bytes_per_param)
        tokens_local = b * s / _dp_size(shape, chips)
        traffic += tokens_local * cfg.d_model * cfg.num_layers * act_f
        traffic += 3.0 * tokens_local * (cfg.vocab_size / 16) * 4.0  # logits fwd+bwd
        return traffic
    if shape.kind == "prefill":
        params_local = n_params * pb / chips if pcfg.fsdp else n_params * pb / 16
        tokens_local = b * s / _dp_size(shape, chips)
        traffic = params_local \
            + tokens_local * cfg.d_model * cfg.num_layers * 4.0 \
            + cache_bytes_total / chips                 # cache write
        return traffic
    # decode: weights + full cache read per token step (+1 token write)
    touched = n_active if not cfg.num_experts else min(
        n_params,
        n_active + (n_params - n_active) * min(
            1.0, b * cfg.experts_per_token / cfg.num_experts))
    return touched * pb / chips + cache_bytes_total / chips


def cache_bytes_total(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Total decode-cache bytes across the fleet for this shape."""
    if shape.kind == "train":
        return 0.0
    b, s = shape.global_batch, shape.seq_len
    pb = 2.0 if cfg.dtype == "bfloat16" else 4.0
    total = 0.0
    for kind in layer_kinds(cfg):
        if kind in ("attn", "moe"):
            total += 2 * b * s * cfg.num_kv_heads * cfg.head_dim * pb
        elif kind == "local":
            total += 2 * b * min(s, cfg.local_window) \
                * cfg.num_kv_heads * cfg.head_dim * pb
        elif kind == "ssm":
            di = cfg.ssm_expand * cfg.d_model
            h_ = di // cfg.ssm_head_dim
            total += b * h_ * cfg.ssm_state * cfg.ssm_head_dim * 4.0
            total += b * (cfg.ssm_conv - 1) * (di + 2 * cfg.ssm_state) * pb
        elif kind == "rglru":
            w = cfg.lru_width or cfg.d_model
            total += b * w * 4.0 + b * 3 * w * pb
    return total


def opt_bytes_per_param(opt_dtype: str, factored: bool) -> float:
    sd = 2.0 if opt_dtype in ("bfloat16", "bf16") else 4.0
    return sd + (0.02 * sd if factored else sd)   # mu + (nu or factored accumulators)


def analytic_terms(cfg: ModelConfig, shape: ShapeConfig, pcfg: ParallelConfig,
                   n_params: int, n_active: int, chips: int,
                   opt_dtype: str = "float32", factored: bool = False, *,
                   peak_flops: float, hbm_bw: float) -> Terms:
    obp = opt_bytes_per_param(opt_dtype, factored) if shape.kind == "train" else 0.0
    cache = cache_bytes_total(cfg, shape)
    flops_total = step_flops_total(cfg, shape, pcfg)
    flops_pd = flops_total / chips
    hbm_pd = step_hbm_bytes_per_device(cfg, shape, pcfg, n_params, n_active,
                                       chips, obp, cache)
    state_pd = state_bytes_per_device(cfg, shape, pcfg, n_params, chips, obp, cache)
    return Terms(flops_total=flops_total, flops_per_device=flops_pd,
                 hbm_bytes_per_device=hbm_pd, state_bytes_per_device=state_pd,
                 t_compute=flops_pd / peak_flops, t_memory=hbm_pd / hbm_bw)
