"""Deterministic, checkpointable synthetic data pipeline (PyTorch port of
``repro/data/pipeline.py``).

What the trainer needs from a pipeline: deterministic iteration (a batch is
a pure function of the step counter — no host state to lose),
checkpointability (the iterator state is just the step counter) and a
learnable distribution (a fixed random bigram chain, so the training loss
measurably falls). Every draw is ``jax.random``'s, through ``prng``, so the
tokens are bitwise the JAX package's at every step; the VLM's patches and
audio's frames come from ``prng.normal``, which agrees with
``jax.random.normal`` within 2 ulp (see ``prng``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import prng
from ..configs.base import ModelConfig


class DataState(NamedTuple):
    step: torch.Tensor          # () int32 — the only iterator state


def init_data_state(device="cuda") -> DataState:
    return DataState(step=torch.zeros((), dtype=torch.int32, device=device))


def _key(seed: int, device) -> torch.Tensor:
    return torch.as_tensor(prng.PRNGKey(seed).astype("int64"), device=device)


def _bigram_table(vocab: int, seed: int, device, branch: int = 4):
    """Each token deterministically allows ``branch`` successors — a
    low-entropy language a small model can learn. (vocab, branch) int32."""
    return prng.randint(_key(seed, device), (vocab, branch), 0, vocab)


def sample_batch(cfg: ModelConfig, batch: int, seq: int, state: DataState,
                 seed: int = 1234) -> tuple[dict, DataState]:
    """The batch at ``state.step``, on the state's device: ``tokens`` (B, S)
    int32 (+ ``patches`` (B, P, Fd) for the VLM, ``frames`` (B, S, Fd) for
    audio, float32). Nothing is read back to the host."""
    dev = state.step.device
    table = _bigram_table(cfg.vocab_size, seed, dev)
    branch = table.shape[1]
    key = prng.fold_in(_key(seed + 1, dev), state.step)
    k0, k1, k2 = prng.split(key, 3).unbind(0)
    first = prng.randint(k0, (batch,), 0, cfg.vocab_size)
    choices = prng.randint(k1, (batch, seq), 0, branch).long()
    flat = table.reshape(-1)
    tok = first
    toks = []
    for t in range(seq):                     # the reference's lax.scan
        toks.append(tok)
        tok = flat[tok.long() * branch + choices[:, t]]
    out = {"tokens": torch.stack(toks, dim=1)}
    if cfg.family == "vlm":
        out["patches"] = prng.normal(k2, (batch, cfg.frontend_tokens,
                                          cfg.frontend_dim))
    if cfg.family == "audio":
        out["frames"] = prng.normal(k2, (batch, seq, cfg.frontend_dim))
    return out, DataState(step=state.step + 1)
