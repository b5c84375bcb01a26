"""Moonlight-16B-A3B (kimi/moonshot) — MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]. Expert-parallel: 64/16 = 4
experts per model-axis shard."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    num_experts_per_tok=6,
    rope_theta=50_000.0,
    mlp_act="silu",
    attn_impl="chunked",
    attn_sharding="heads",
    kv_repeat=1,
    moe_sharding="expert",
)
