"""The work of one causal self-attention forward: (FLOPs, bytes).

FLOPs: the two products S = Q K^T and O = P V over the (query, key) pairs
that causality leaves, 2 * 2 * hd FLOPs a pair and head. Bytes: Q, K and V
read once, O and the float32 log-sum-exp written once, at 2 bytes an
element (bf16) and the model's own KV heads, whatever a kernel repeats or
re-reads."""


def work(b: int, s: int, h: int, hkv: int, hd: int) -> tuple[float, float]:
    flops = 4.0 * b * h * hd * (s * (s + 1) // 2)
    elems = b * s * (2 * h + 2 * hkv) * hd          # q, o; k, v
    return flops, 2.0 * elems + 4.0 * b * h * s
