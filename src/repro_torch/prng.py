"""Counter-based random numbers equal to ``jax.random`` (threefry2x32).

Seeded sampling must draw the same tokens as the JAX package, so the port
reproduces the bits of JAX's default generator: ``PRNGKey``, ``fold_in``,
``split``, 32-bit ``random_bits`` in JAX's partitionable layout (counter =
flat element index), ``uniform`` in float32, ``randint``, ``gumbel`` and
``categorical``; ``counter_words`` is the pass all of them share, so a
caller can take several draws from one pass.

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


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block cipher on broadcastable int64 words.

    ``x0`` is carried unmasked: only its low 32 bits are ever read (by the
    masked xor of each round), and it grows by less than 2**33 a round, far
    inside int64. Each rotation is ``t | t >> 32`` of ``t = x1 << r``, whose
    low 32 bits are the 32-bit rotation; the mask after the xor drops the
    rest. Every op is a launch on the card, so each one saved counts."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            t = x1 << r
            x1 = ((t | (t >> 32)) ^ x0) & MASK32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0 & MASK32, x1


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
    if isinstance(data, int):
        # a fill, not a host-to-device copy (which syncs the stream)
        d = torch.full((), data & MASK32, dtype=torch.int64,
                       device=keys.device)
    else:
        d = torch.as_tensor(data, device=keys.device).to(torch.int64) & MASK32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def counter_words(keys: torch.Tensor, n: int):
    """Both threefry words of each key at the counter pairs (0, c), c < n:
    keys (..., 2) -> two (..., n) int64 tensors of uint32 values. JAX's
    partitionable threefry derives everything from these: a split keeps both
    words as the new keys, random bits XOR them."""
    k0, k1 = _words(keys)
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(idx),
                          idx)
    return torch.broadcast_tensors(y0, y1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` over a batch: keys (..., 2) -> (..., num, 2)."""
    return torch.stack(counter_words(keys, num), dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of shape (n,) per key: keys (..., 2) ->
    (..., n) int64 holding uint32 values (the flat element index is the
    counter)."""
    y0, y1 = counter_words(keys, n)
    return y0 ^ y1


def bits_to_uniform(bits: torch.Tensor, minval: float = 0.0,
                    maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms from 32 random bits, as ``jax.random.uniform``: the
    top 23 bits become the mantissa of a float in [1, 2), minus one, then
    scaled."""
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=bits.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform`` of shape (n,) per key."""
    return bits_to_uniform(random_bits(keys, n), minval, maxval)


def randint_from_split(halves: torch.Tensor, shape, minval: int,
                       maxval: int) -> torch.Tensor:
    """``randint`` given each key's split in two, halves (..., 2, 2) ->
    (..., *shape) int32: 32 high bits from the first half and 32 low bits
    from the second per element, reduced modulo the span in wrapping uint32
    arithmetic (``multiplier = 2**32 % span``), as JAX does."""
    shape = tuple(shape)
    lo_i32, hi_i32 = -(1 << 31), (1 << 31) - 1
    if not lo_i32 <= minval <= hi_i32 or not lo_i32 <= maxval <= hi_i32:
        raise ValueError(f"randint: bounds [{minval}, {maxval}) must lie in "
                         f"int32")
    n = 1
    for d in shape:
        n *= d
    bits = random_bits(halves, n)                   # (..., 2, n)
    higher, lower = bits[..., 0, :], bits[..., 1, :]
    span = maxval - minval if maxval > minval else 1
    multiplier = (2 ** 16 % span) ** 2 % span
    offset = ((higher % span) * multiplier + lower % span) & MASK32
    out = (offset % span + minval).to(torch.int32)
    return out.reshape(halves.shape[:-2] + shape)


def randint(keys: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 ``jax.random.randint`` in [minval, maxval) of ``shape`` per key:
    keys (..., 2) -> (..., *shape)."""
    return randint_from_split(split(keys, 2), shape, minval, maxval)


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
