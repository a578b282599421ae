"""Config schema: model architectures, input shapes, parallelism and training knobs."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention / norm flavour
    act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU)
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma-style sqrt(d_model) embedding scale
    norm_eps: float = 1e-6
    use_plus_one_norm: bool = False  # gemma-style (1 + g) RMSNorm scale

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_mode: str = "immune"    # immune | aux | sign | none
    aux_loss_coef: float = 0.01
    # dispatch locality: tokens are sorted/bucketed within G groups (launchers set
    # G = the DP shard count so the sort never crosses devices; 1 = global)
    dispatch_groups: int = 1

    # SSM (mamba-2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # hybrid (recurrentgemma): temporal-mixing pattern tiled over the depth,
    # e.g. ("rglru", "rglru", "attn") -> 1:2 attention:recurrence
    block_pattern: tuple[str, ...] = ()
    lru_width: int = 0
    local_window: int = 2048

    # modality frontend stubs (vlm / audio): precomputed embeddings from input_specs
    frontend_tokens: int = 0       # e.g. SigLIP patches or EnCodec frames
    frontend_dim: int = 0

    # numerics
    dtype: str = "bfloat16"
    remat: str = "none"            # none | dots | full

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_subquadratic_path(self) -> bool:
        """Can this arch serve a 512k-token context without full quadratic attention?"""
        return self.family in ("ssm", "hybrid")

    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests."""
        kw = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            frontend_tokens=min(self.frontend_tokens, 8) if self.frontend_tokens else 0,
            frontend_dim=32 if self.frontend_dim else 0,
            lru_width=64 if self.lru_width else 0,
            local_window=32 if self.block_pattern else 2048,
            dtype="float32",
        )
        if self.num_experts:
            kw.update(num_experts=8, experts_per_token=2)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ParallelConfig:
    """Sharding strategy knobs (the §Perf hillclimb axes)."""

    fsdp: bool = True              # shard params/optimizer over 'data' (ZeRO-3 style)
    seq_shard: bool = False        # shard sequence dim over 'model' for long prefill
    expert_parallel: bool = True   # shard MoE experts over 'model'
    remat: str = "none"
    capacity_factor: Optional[float] = None  # override model capacity factor


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    schedule: str = "cosine"       # cosine | wsd (warmup-stable-decay)
    stable_frac: float = 0.8       # wsd: fraction of decay_steps held stable
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    accum_steps: int = 1
    seed: int = 0


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
