"""Architecture registry: ``get_config(arch_id)`` + input specs per (arch, shape).

The same ten architectures as the JAX package's registry, every family of
which the port builds and serves. ``input_specs`` returns plain
``InputSpec(shape, dtype)`` records instead of JAX shape structs.
"""
from __future__ import annotations

from typing import NamedTuple

from . import (gemma_7b, granite_moe_3b, kimi_k2, mamba2_130m, minicpm_2b,
               musicgen_medium, paligemma_3b, qwen3_4b, recurrentgemma_9b,
               smollm_360m)
from .base import SHAPES, ModelConfig, ParallelConfig, ShapeConfig, TrainConfig

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (minicpm_2b, smollm_360m, gemma_7b, qwen3_4b, paligemma_3b,
              granite_moe_3b, kimi_k2, recurrentgemma_9b, mamba2_130m,
              musicgen_medium)
}


class InputSpec(NamedTuple):
    """Shape and dtype name of one model input — no allocation."""
    shape: tuple
    dtype: str


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_shape(shape: str) -> ShapeConfig:
    if shape not in SHAPES:
        raise KeyError(f"unknown shape {shape!r}; available: {sorted(SHAPES)}")
    return SHAPES[shape]


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether the (arch, shape) cell runs. long_500k needs a sub-quadratic path
    (skipped for pure full-attention archs, run for SSM/hybrid)."""
    if shape.name == "long_500k" and not cfg.has_subquadratic_path:
        return False, ("skipped: full-attention arch has no sub-quadratic path for "
                       "a 512k-token context")
    return True, "ok"


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``InputSpec`` stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": InputSpec((b, s), "int32")}
        if cfg.family == "vlm":
            batch["patches"] = InputSpec(
                (b, cfg.frontend_tokens, cfg.frontend_dim), "float32")
        if cfg.family == "audio":
            batch["frames"] = InputSpec((b, s, cfg.frontend_dim), "float32")
        return batch
    # decode: one new token against a cache of seq_len
    batch = {"token": InputSpec((b, 1), "int32")}
    if cfg.family == "audio":
        batch["frame"] = InputSpec((b, 1, cfg.frontend_dim), "float32")
    return batch
