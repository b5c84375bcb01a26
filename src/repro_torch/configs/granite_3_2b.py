"""Granite-3.0-2B-base — dense GQA with granite scalar multipliers
[hf:ibm-granite/granite-3.0-2b-base; hf]. Vocab 49155 is padded to a
multiple of 256 for model-axis divisibility (masked logits)."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    rope_theta=10_000.0,
    mlp_act="silu",
    tie_embeddings=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.015625,
    logits_scaling=8.0,
    attn_impl="chunked",
    attn_sharding="heads",
    kv_repeat=2,
)
