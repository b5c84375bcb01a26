"""DeepSeek-67B — dense llama-arch [arXiv:2401.02954; hf]."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10_000.0,
    mlp_act="silu",
    attn_impl="chunked",
    attn_sharding="heads",
    kv_repeat=2,            # 8 KV heads -> 16 for the 16-way model axis
)
