"""The plain reference: a decoder-only transformer (dense or with a mixture
of experts routed by the immune bias) written from the published
description in plain PyTorch, in float32, with no kernel, cache or batching
of the program's. It imports nothing of the program and takes nothing the
program made: its weights are drawn again from the seed
(``portbench.core.weights``), and its inputs are the ones the benchmark
handed the program.

The block: pre-norm RMSNorm applied as ``x * rsqrt(mean(x^2) + eps) * (1 +
scale)``; attention with rotary embeddings (split halves, ``theta^(-i /
(D/2))``), grouped kv heads, causal softmax scaled by ``1/sqrt(D)``; then a
SwiGLU feed-forward, or the mixture of experts: router scores ``h @
W_router``, top-k chosen on the scores plus the router's bias (ties to the
lower expert), gates the softmax of the chosen raw scores, each expert
taking its first ``C`` assignments in token-major order (``C`` from the
capacity factor, rounded up to a multiple of 4, at least 4). The head is
the tied embedding after a final RMSNorm.

``quant="float8"`` rounds both operands of every product to float8 (e4m3,
one scale per tensor) before it, and in training stores the weights in
float8 too: the control, the configuration's bfloat16 weights and products
one precision lower.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448), returned in ``x``'s type; the gradient
    passes straight through."""
    s = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


class Reference:
    def __init__(self, m: dict, weights: dict, quant: str = None):
        # float32 products in float32: no TF32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.m = m
        self.w = weights
        self.q = fp8 if quant == "float8" else (lambda x: x)

    # -- pieces --------------------------------------------------------------
    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def rms(self, x, scale):
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["norm_eps"]) * (1.0 + scale)

    def rope(self, x, pos):
        d = x.shape[-1]
        half = d // 2
        freq = self.m["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float64, device=x.device) / half)
        ang = pos.double()[:, None] * freq[None, :]          # (S, half)
        cos = torch.cos(ang).float()[None, :, None, :]
        sin = torch.sin(ang).float()[None, :, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, p, h):
        m, w = self.m, self.w
        b, s, _ = h.shape
        nh, nk, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        q = self.mm(h, w[p + "mixer.wq"]).view(b, s, nh, hd)
        k = self.mm(h, w[p + "mixer.wk"]).view(b, s, nk, hd)
        v = self.mm(h, w[p + "mixer.wv"]).view(b, s, nk, hd)
        pos = torch.arange(s, device=h.device)
        q, k = self.rope(q, pos), self.rope(k, pos)
        k = k.repeat_interleave(nh // nk, dim=2)
        v = v.repeat_interleave(nh // nk, dim=2)
        scores = torch.einsum("bshd,bthd->bhst", self.q(q), self.q(k))
        scores = scores / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        del scores
        out = torch.einsum("bhst,bthd->bshd", self.q(probs), self.q(v))
        return self.mm(out.reshape(b, s, nh * hd), w[p + "mixer.wo"])

    def mlp(self, p, h):
        w = self.w
        g = self.mm(h, w[p + "mlp.w_gate"])
        u = self.mm(h, w[p + "mlp.w_up"])
        return self.mm(F.silu(g) * u, w[p + "mlp.w_down"])

    def capacity(self, tokens: int) -> int:
        m = self.m
        c = int(m["capacity_factor"] * tokens * m["experts_per_token"]
                / m["num_experts"])
        return max(4, -(-c // 4) * 4)

    def moe(self, p, h, bias):
        """(y, load (E,)): the load is each expert's share of the (token,
        choice) assignments, dropped ones included."""
        m, w = self.m, self.w
        b, s, d = h.shape
        e, k = m["num_experts"], m["experts_per_token"]
        x = h.reshape(b * s, d)
        t = x.shape[0]
        scores = self.mm(x, w[p + "moe.w_router"])             # (T, E)
        biased = scores.detach() + bias[None, :]
        # top-k, ties to the lower expert: order by (-score, expert)
        idx = torch.sort(biased, dim=-1, descending=True, stable=True)[1][:, :k]
        gates = torch.softmax(torch.gather(scores, 1, idx), dim=-1)
        cap = self.capacity(t)
        flat = idx.reshape(-1)                                  # token-major
        y = torch.zeros_like(x)
        counts = torch.zeros(e, dtype=torch.float32, device=x.device)
        for ex in range(e):
            where = torch.nonzero(flat == ex)[:, 0]
            counts[ex] = where.numel()
            where = where[:cap]
            if where.numel() == 0:
                continue
            tok, choice = where // k, where % k
            xe = x[tok]
            he = F.silu(self.mm(xe, w[p + "moe.w_gate"][ex])) \
                * self.mm(xe, w[p + "moe.w_up"][ex])
            ye = self.mm(he, w[p + "moe.w_down"][ex])
            y = y.index_add(0, tok, ye * gates[tok, choice][:, None])
        return y.reshape(b, s, d), counts / (t * k)

    def block(self, layer: int, x, bias_row):
        p = f"blocks.{layer}."
        w = self.w
        x = x + self.attention(p, self.rms(x, w[p + "norm1.scale"]))
        h = self.rms(x, w[p + "norm2.scale"])
        if self.m.get("num_experts"):
            y, load = self.moe(p, h, bias_row)
            return x + y, load
        return x + self.mlp(p, h), None

    def hidden(self, tokens, bias=None, remat: bool = False):
        """The final-normed hidden states (B, S, D) and the per-layer expert
        loads (L, E) (None if dense)."""
        w = self.w
        x = w["embed"][tokens]
        loads = []
        for layer in range(self.m["num_layers"]):
            row = None if bias is None else bias[layer]
            if remat:
                x, load = checkpoint(self.block, layer, x, row,
                                     use_reentrant=False)
            else:
                x, load = self.block(layer, x, row)
            if load is not None:
                loads.append(load.detach())
        return self.rms(x, w["final_norm.scale"]), \
            (torch.stack(loads) if loads else None)

    def head(self, x):
        return self.mm(x, self.w["embed"].T)

    def loss(self, tokens, bias=None):
        """Mean next-token cross-entropy over (B, S-1) targets, and the
        loads."""
        x, loads = self.hidden(tokens, bias, remat=True)
        logits = self.head(x[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1))
        return loss, loads


# ---------------------------------------------------------------------------
# the optimizer and the router's regulation, as the configuration states them
# ---------------------------------------------------------------------------
def learning_rate(t: dict, step: int) -> float:
    """Linear warm-up, then cosine to zero over ``decay_steps``, or WSD (a
    stable plateau to ``stable_frac`` of ``decay_steps``, then a 1 - sqrt
    tail)."""
    warm = min(step / max(t["warmup_steps"], 1), 1.0)
    if t["schedule"] == "wsd":
        stable_end = t["stable_frac"] * t["decay_steps"]
        frac = min(max((step - stable_end)
                       / max(t["decay_steps"] - stable_end, 1), 0.0), 1.0)
        decay = 1.0 - math.sqrt(frac)
    else:
        frac = min(max(step / max(t["decay_steps"], 1), 0.0), 1.0)
        decay = 0.5 * (1.0 + math.cos(math.pi * frac))
    return t["learning_rate"] * warm * decay


def router_update(state: dict, load: torch.Tensor, r: dict) -> dict:
    """One immune regulation step per layer (rows of (L, E)): memory as an
    EMA of the load, a leaky suppressor integrating the remembered
    overload, the bias set from it and the overload, a revival for starved
    experts, centred and clipped."""
    e = load.shape[-1]
    target = 1.0 / e
    mem = r["mem_decay"] * state["mem"] + (1 - r["mem_decay"]) * load
    over = mem - target
    sup = (1 - r["leak"]) * state["suppressor"] + r["couple"] * over
    bias = -(r["gain"] * sup + r["prop"] * over)
    bias = bias + r["revival"] * (mem < r["starve_frac"] * target).float()
    bias = torch.clamp(bias - bias.mean(dim=-1, keepdim=True),
                       -r["bias_clip"], r["bias_clip"])
    return {"bias": bias, "mem": mem, "suppressor": sup}


def leaf_of(name: str) -> str:
    """The leaf a tensor belongs to: per-layer tensors stack over the
    layers (``blocks.3.mixer.wq`` -> ``mixer.wq``)."""
    if name.startswith("blocks."):
        return name.split(".", 2)[2]
    return name


def decayed(name: str) -> bool:
    """Weight decay falls on every leaf of two or more dimensions: the
    matrices, and the per-layer norm scales, which stack to (L, D); not on
    the final norm's (D,)."""
    return name.startswith("blocks.") or len(name.split(".")) == 1


def train(m: dict, t: dict, r: dict, weights: dict, batches: list,
          quant: str = None) -> dict:
    """Follow the program's first ``len(batches)`` optimizer steps from the
    same weights on the same batches. Returns each step's loss, each leaf's
    norm of the first clipped gradient, and each leaf's norm of the change
    of its weights over the steps (``weights`` are updated in place)."""
    ref = Reference(m, weights, quant)
    names = list(weights)
    params = [weights[n] for n in names]
    store = fp8 if quant == "float8" else None   # the weights' own storage
    with torch.no_grad():
        for p in params:
            if store:
                p.copy_(store(p))
            p.requires_grad_(True)
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    e = m.get("num_experts", 0)
    dev = params[0].device
    router = None
    if e:
        L = m["num_layers"]
        router = {"bias": torch.zeros(L, e, device=dev),
                  "mem": torch.full((L, e), 1.0 / e, device=dev),
                  "suppressor": torch.zeros(L, e, device=dev)}
    b1, b2 = t["beta1"], t["beta2"]
    losses, grad_norms = [], {}
    for step, tokens in enumerate(batches, start=1):
        loss, loads = ref.loss(tokens, None if router is None
                               else router["bias"])
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        scale = min(1.0, t["grad_clip"] / max(float(gnorm), 1e-9))
        lr = learning_rate(t, step)
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        sq = {}
        with torch.no_grad():
            for i, name in enumerate(names):
                g = grads[i] * scale
                if step == 1:
                    leaf = leaf_of(name)
                    sq[leaf] = sq.get(leaf, 0.0) + float(g.double()
                                                         .square().sum())
                mu[i].mul_(b1).add_(g, alpha=1 - b1)
                nu[i].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + t["eps"])
                if decayed(name):
                    u = u + t["weight_decay"] * params[i]
                params[i].sub_(lr * u)
                if store:
                    params[i].copy_(store(params[i]))
            del grads
            if router is not None:
                router = router_update(router, loads, r)
        if step == 1:
            grad_norms = {k: math.sqrt(v) for k, v in sq.items()}
    for p in params:
        p.requires_grad_(False)
    return {"losses": losses, "grad_norms": grad_norms}
