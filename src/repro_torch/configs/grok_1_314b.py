"""Grok-1 314B — MoE 8 experts top-2, attention logit softcap
[hf:xai-org/grok-1; unverified].

8 experts do not divide the 16-way model axis -> TP-in-expert sharding
(d_ff 32768 sharded 16-way inside each expert, experts replicated).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    num_experts_per_tok=2,
    attn_softcap=30.0,
    rope_theta=10_000.0,
    mlp_act="gelu",
    attn_impl="chunked",
    attn_sharding="heads",
    kv_repeat=2,
    moe_sharding="ffn",
)
