"""Qwen3-4B — dense, qk-norm, GQA [hf:Qwen/Qwen3-8B family; hf]."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    attn_impl="chunked",
    attn_sharding="heads",
    kv_repeat=2,
)
