"""Counter-based random numbers equal to ``jax.random`` (threefry2x32).

Seeded sampling must draw the same tokens as the JAX package, so the port
reproduces the bits of JAX's default generator: ``PRNGKey``, ``fold_in``,
32-bit ``random_bits`` in JAX's partitionable layout (counter = flat element
index), ``uniform`` in float32, ``gumbel`` and ``categorical``.

Keys are ``(..., 2)`` tensors holding uint32 words. PyTorch's ``uint32``
arithmetic is limited, so every word is carried in ``int64`` and masked back
to 32 bits after each add and shift. Everything runs on the keys' device.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(np.finfo(np.float32).tiny)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block cipher on broadcastable int64 words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def _words(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    key = key.to(torch.int64) & MASK32
    return key[..., 0], key[..., 1]


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed: the
    (2,) uint32 key ``[0, seed]`` (host array)."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return np.asarray([0, seed], np.uint32)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: keys (..., 2), data broadcastable
    to keys[..., 0] (uint32 values) -> new keys (..., 2) int64 words."""
    k0, k1 = _words(keys)
    d = torch.as_tensor(data, device=keys.device).to(torch.int64) & MASK32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of shape (n,) per key: keys (..., 2) ->
    (..., n) int64 holding uint32 values. JAX's partitionable threefry feeds
    the flat element index as the counter pair (hi, lo) and XORs the two
    output words."""
    k0, k1 = _words(keys)
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(idx),
                          idx)
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform`` of shape (n,) per key: the top 23 bits
    become the mantissa of a float in [1, 2), minus one, then scaled."""
    bits = random_bits(keys, n)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """float32 ``jax.random.gumbel`` (mode "low") of shape (n,) per key."""
    u = uniform(keys, n, minval=_TINY_F32, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: keys (B, 2), logits
    (B, V) float32 -> (B,) int64 — argmax of logits plus Gumbel noise (ties
    go to the lower index, as ``jnp.argmax``)."""
    g = gumbel(keys, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)
