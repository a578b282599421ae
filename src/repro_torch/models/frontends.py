"""Modality frontend stubs for the VLM / audio architectures (PyTorch port of
``repro/models/frontends.py``).

The ``[vlm]`` / ``[audio]`` configs specify the transformer backbone only:
the modality frontend (SigLIP vision tower, EnCodec codec) is a stub whose
inputs are precomputed patch / frame embeddings. What is kept is the learned
projection from the frontend's embedding space into the backbone's d_model.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from .layers import _param, dense_init, dtype_of


class Frontend(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device):
        super().__init__()
        self.proj = _param(dense_init(gen, cfg.frontend_dim, cfg.d_model,
                                      dtype_of(cfg), device))


def init_frontend(cfg: ModelConfig, gen: torch.Generator, device) -> Frontend:
    return Frontend(cfg, gen, device)


def project_frontend(params: Frontend, emb: torch.Tensor) -> torch.Tensor:
    """(B, P, frontend_dim) precomputed embeddings -> (B, P, d_model)."""
    return emb.to(params.proj.dtype) @ params.proj
