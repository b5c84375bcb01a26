"""The work of one causal self-attention backward: (FLOPs, bytes).

FLOPs: the five products the backward needs (S = Q K^T again, dV = P^T dO,
dP = dO V^T, dQ = dS K, dK = dS^T Q), 2.5 times the forward's two, at
2 * hd FLOPs a product, (query, key) pair that causality leaves and head.
A kernel that recomputes S and dP in each of two passes does seven; the
two more are its own waste. Bytes: Q, K, V, O, dO and the float32
log-sum-exp read once, dQ, dK and dV written once, at 2 bytes an element
(bf16) and the model's own KV heads, whatever a kernel repeats or
re-reads."""


def work(b: int, s: int, h: int, hkv: int, hd: int) -> tuple[float, float]:
    flops = 2.5 * 4.0 * b * h * hd * (s * (s + 1) // 2)
    q = b * s * h * hd                 # q, o, do, dq: each this many
    kv = b * s * hkv * hd              # k, v, dk, dv: each this many
    return flops, 2.0 * (4 * q + 4 * kv) + 4.0 * b * h * s
