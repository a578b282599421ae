"""Model operations per token, from the configuration's shapes: the
per-token arithmetic of the port's analytic roofline, frozen here (its
original is listed in PERF.md), counting the useful work only: each of the
k chosen experts once, no capacity padding, no recomputation.

A forward pass of one token at attention context ``ctx`` (the positions it
attends to) costs, per layer, 2 D hd (2 H + 2 Hkv) for the q, k, v, o
projections, 4 H hd ctx for QK^T and PV, and the feed-forward: 6 D F dense,
or 2 D E for the router plus k * 6 D F for the chosen experts. The head
adds 2 D V where logits are taken."""


def layer_flops(m: dict, ctx: float) -> float:
    d, h, hk, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    fl = 2.0 * d * hd * (2 * h + 2 * hk) + 4.0 * h * hd * ctx
    e = m.get("num_experts", 0)
    if e:
        fl += 2.0 * d * e + m["experts_per_token"] * 6.0 * d * m["d_ff"]
    else:
        fl += 6.0 * d * m["d_ff"]
    return fl


def head_flops(m: dict) -> float:
    return 2.0 * m["d_model"] * m["vocab_size"]


def forward(m: dict, tokens: float, ctx_sum: float, head_tokens: float) -> float:
    """Forward operations of ``tokens`` tokens whose attention contexts sum
    to ``ctx_sum``, with logits at ``head_tokens`` of them."""
    L = m["num_layers"]
    return (L * (tokens * layer_flops(m, 0.0)
                 + 4.0 * m["num_heads"] * m["head_dim"] * ctx_sum)
            + head_tokens * head_flops(m))


def prefill(m: dict, seq: int) -> float:
    """A one-shot prefill of ``seq`` tokens (causal: position i attends to
    i + 1 keys), logits at the last."""
    return forward(m, seq, seq * (seq + 1) / 2.0, 1)


def train_step(m: dict, batch: int, seq: int) -> float:
    """Forward and backward (3x the forward) of a training step, logits at
    every position."""
    return 3.0 * batch * forward(m, seq, seq * (seq + 1) / 2.0, seq)
