"""Operations and bytes of one causal attention over a prompt, from its
shape alone (so any implementation of the same work is counted alike).

Operations: the two products QK^T and PV, 2 * D multiply-adds each per
(query, key) pair the causal mask keeps, S (S + 1) / 2 pairs per head.
Bytes: each input read once and the output written once."""


def flops(batch: int, heads: int, seq: int, head_dim: int,
          causal: bool = True) -> float:
    pairs = seq * (seq + 1) / 2.0 if causal else float(seq * seq)
    return 4.0 * batch * heads * head_dim * pairs


def nbytes(batch: int, heads: int, kv_heads: int, seq: int, head_dim: int,
           elem: int = 2) -> float:
    q = o = batch * heads * seq * head_dim
    kv = 2 * batch * kv_heads * seq * head_dim
    return float((q + o + kv) * elem)
