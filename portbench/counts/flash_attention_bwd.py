"""Operations and bytes of one causal attention backward, from its shape
alone (so any implementation of the same work is counted alike).

Operations: the four products of the backward, dP = dO V^T, dV = P^T dO,
dK = dS^T Q and dQ = dS K, 2 * D multiply-adds each per (query, key) pair
the causal mask keeps: 8 D a pair, S (S + 1) / 2 pairs per head.
Recomputing the scores (Q K^T) is not counted, so the share of the
roofline cannot pass 100% whatever a kernel recomputes.
Bytes: q, k, v, o and dO (the inputs' type) and the forward's log-sum-exp
(fp32, one a row) read once; dq, dk and dv written once."""


def flops(batch: int, heads: int, seq: int, head_dim: int) -> float:
    return 8.0 * batch * heads * head_dim * seq * (seq + 1) / 2.0


def nbytes(batch: int, heads: int, kv_heads: int, seq: int, head_dim: int,
           elem: int = 2) -> float:
    rows = batch * heads * seq
    q_like = 4 * rows * head_dim                      # q, o, dO, dq
    kv_like = 4 * batch * kv_heads * seq * head_dim   # k, v, dk, dv
    return float((q_like + kv_like) * elem + 4 * rows)
