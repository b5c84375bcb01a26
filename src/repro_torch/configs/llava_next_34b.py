"""LLaVA-NeXT-34B backbone — anyres tiling frontend is a STUB:
input_specs() provides precomputed patch embeddings (B, 2880, d_model)
[hf:llava-hf; unverified]. 56 heads do not divide the 16-way model axis
-> sequence-parallel attention."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    num_patches=2880,          # 5 anyres tiles x 576 patches
    rope_theta=5_000_000.0,
    mlp_act="silu",
    attn_impl="chunked",
    attn_sharding="sequence",
    kv_repeat=1,
)
