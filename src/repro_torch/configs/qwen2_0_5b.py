"""Qwen2-0.5B — dense GQA with QKV bias [arXiv:2407.10671; hf].

14 heads do not divide a 16-way model axis -> sequence-parallel attention.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    attn_impl="chunked",
    attn_sharding="sequence",
    kv_repeat=1,
)
