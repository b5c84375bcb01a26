"""Model FLOPs of one training step of a dense decoder LM with tied
embeddings, by the 6 N D convention plus causal attention.

N counts the parameters each token multiplies: every layer's projections
and MLP, and the output head once (the tied table's lookup is no product).
The vocabulary is the model's own, not a padded one. Attention adds
6 * layers * heads * head_dim * s FLOPs a token over the causal half, three
times its forward (forward, and a backward of twice the forward). Remat's
recompute, padding and other waste are not counted: MFU is the share of
the peak that the model's own work would take."""


def matmul_params(cfg: dict) -> int:
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    ff, v = cfg["intermediate_size"], cfg["vocab_size"]
    per_layer = d * (h + 2 * hkv) * hd + h * hd * d + 3 * d * ff
    return L * per_layer + d * v


def flops(cfg: dict, rows: int, seq: int) -> float:
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    h = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // h
    tokens = rows * seq
    attn = 12.0 * L * h * hd * rows * seq * (seq + 1) / 2
    return 6.0 * matmul_params(cfg) * tokens + attn
