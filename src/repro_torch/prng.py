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


# ---------------------------------------------------------------------------
# normal: XLA's single-precision erfinv of a uniform in (-1, 1)
# ---------------------------------------------------------------------------
# XLA's ErfInv32 (Giles' polynomial), its log1p (a Cephes rational for
# |x| < sqrt(2) - 1, log(1 + x) beyond) and its CPU log (Cephes' logf), in
# the order XLA evaluates them; every multiply-add that XLA's CPU backend
# contracts into one fused multiply-add is one here too.
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32: the float32 product is exact in
    float64, so only the sum rounds (twice, which parts from one fused
    rounding on about one input in 2**29)."""
    a = a.double() if isinstance(a, torch.Tensor) else _f32(a)
    b = b.double() if isinstance(b, torch.Tensor) else _f32(b)
    c = c.double() if isinstance(c, torch.Tensor) else _f32(c)
    return (a * b + c).float()


def _horner_fma(coeffs, x: torch.Tensor) -> torch.Tensor:
    r = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        r = _fma(r, x, c)
    return r


def _log_xla(v: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` of positive normal ``v`` as XLA's CPU backend
    computes it (Cephes' logf: frexp, the sqrt(1/2) fold, a degree-8
    polynomial)."""
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 126).float()
    x = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = x < _f32(0.707106781186547524)      # fold to [sqrt(1/2), sqrt 2)
    fold = torch.where(small, x, torch.zeros_like(x))
    x = x - 1.0
    e = e - small.float()
    x = x + fold
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(x, p[0], p[1])
    y1 = _fma(x, p[3], p[4])
    y2 = _fma(x, p[6], p[7])
    y = _fma(y, x, p[2])
    y1 = _fma(y1, x, p[5])
    y2 = _fma(y2, x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _f32(-2.12194440e-4))
    x = _fma(-x2, 0.5, x)
    x = x + y
    return _fma(e, _f32(0.693359375), x)


def _log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as XLA computes it: a Cephes rational below
    |x| = sqrt(2) - 1, ``log(1 + x)`` above (x > -1)."""
    x2 = x * x
    r = _horner_fma(_LOG1P_NUM, x) / _horner_fma(_LOG1P_DEN, x)
    small = _fma(-0.5, x2, (x * x2) * r)
    small = x + small
    return torch.where(x.abs() < _f32(0.41421356237309504880), small,
                       _log_xla(torch.clamp(x + 1.0,
                                            min=float(np.finfo(np.float32)
                                                      .tiny))))


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 ``lax.erf_inv`` for x in [-1, 1] (XLA's ErfInv32)."""
    w = -_log1p_xla(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_W_LT5[0]), _f32(_ERFINV_W_GE5[0]))
    for a, b in zip(_ERFINV_W_LT5[1:], _ERFINV_W_GE5[1:]):
        p = _fma(p, w, torch.where(lt, _f32(a), _f32(b)))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(keys: torch.Tensor, shape) -> torch.Tensor:
    """float32 ``jax.random.normal`` of ``shape`` per key: keys (..., 2) ->
    (..., *shape). A uniform in (-1, 1), then ``sqrt(2) * erfinv(u)``."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(keys, n, minval=lo, maxval=1.0)
    z = _f32(np.sqrt(2.0)) * erfinv_xla(u)
    return z.reshape(keys.shape[:-1] + shape)
