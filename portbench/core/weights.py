"""Weights made from ``--seed``, on the device, in the type they are served
in. Each tensor is drawn whole in one call from a generator of its own,
seeded from (seed, tensor name), so any one of them can be drawn again
alone: the reference regenerates what it needs after the program's state
is freed, and the training check redraws the starting weights leaf by leaf.

The names and shapes follow the model's published layout, one tensor per
layer and kind; :func:`load_into` copies them into the program's module by
the same names and refuses any name or shape that differs.
"""
from __future__ import annotations

import hashlib
import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NORM_STD = 0.1          # norm scales are applied as (1 + scale); drawn
#                         away from zero so a dropped scale shows


def specs(m: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, dtype name, std) of every tensor of the model ``m``
    (the configuration's ``model`` block): a decoder with tied embeddings,
    dense or with experts. A model with other tensors (an untied head,
    qk-norm) fails :func:`load_into` by name until they are added here."""
    d, h, hk, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    f, v, dt = m["d_ff"], m["vocab_size"], m["dtype"]
    out = [("embed", (v, d), dt, 0.02),        # tied: also the head
           ("final_norm.scale", (d,), "float32", NORM_STD)]
    moe = m.get("num_experts", 0)
    for layer in range(m["num_layers"]):
        p = f"blocks.{layer}."
        out += [(p + "norm1.scale", (d,), "float32", NORM_STD),
                (p + "norm2.scale", (d,), "float32", NORM_STD),
                (p + "mixer.wq", (d, h * hd), dt, 1 / math.sqrt(d)),
                (p + "mixer.wk", (d, hk * hd), dt, 1 / math.sqrt(d)),
                (p + "mixer.wv", (d, hk * hd), dt, 1 / math.sqrt(d)),
                (p + "mixer.wo", (h * hd, d), dt, 1 / math.sqrt(h * hd))]
        if moe:
            out += [(p + "moe.w_router", (d, moe), "float32",
                     1 / math.sqrt(d)),
                    (p + "moe.w_gate", (moe, d, f), dt, 1 / math.sqrt(d)),
                    (p + "moe.w_up", (moe, d, f), dt, 1 / math.sqrt(d)),
                    (p + "moe.w_down", (moe, f, d), dt, 1 / math.sqrt(f))]
        else:
            out += [(p + "mlp.w_gate", (d, f), dt, 1 / math.sqrt(d)),
                    (p + "mlp.w_up", (d, f), dt, 1 / math.sqrt(d)),
                    (p + "mlp.w_down", (f, d), dt, 1 / math.sqrt(f))]
    return out


def _seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def draw(seed: int, name: str, shape, dtype: str, std: float,
         device) -> torch.Tensor:
    """One tensor: N(0, std^2) drawn in ``dtype`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, name))
    t = torch.randn(shape, generator=gen, dtype=DTYPES[dtype], device=device)
    return t.mul_(std)


def one(m: dict, seed: int, name: str, device) -> torch.Tensor:
    """The tensor ``name`` alone, as :func:`make` draws it."""
    for n, shape, dt, std in specs(m):
        if n == name:
            return draw(seed, n, shape, dt, std, device)
    raise KeyError(name)


def make(m: dict, seed: int, device, dtype=None):
    """Every tensor in turn as (name, tensor); ``dtype`` casts each (the
    reference's float32)."""
    for name, shape, dt, std in specs(m):
        t = draw(seed, name, shape, dt, std, device)
        yield name, (t if dtype is None else t.to(dtype))


def load_into(module: torch.nn.Module, m: dict, seed: int) -> None:
    """Fill the program's parameters in place, by name."""
    params = dict(module.named_parameters())
    names = [n for n, *_ in specs(m)]
    if sorted(names) != sorted(params):
        missing = sorted(set(params) ^ set(names))[:8]
        raise ValueError(f"parameter names differ from the layout: {missing}")
    device = next(iter(params.values())).device
    with torch.no_grad():
        for name, t in make(m, seed, device):
            p = params[name]
            if tuple(p.shape) != tuple(t.shape) or p.dtype != t.dtype:
                raise ValueError(f"{name}: {tuple(p.shape)} {p.dtype} in the "
                                 f"program, {tuple(t.shape)} {t.dtype} drawn")
            p.copy_(t)
            del t
