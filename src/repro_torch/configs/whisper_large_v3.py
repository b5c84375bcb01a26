"""Whisper-large-v3 backbone — enc-dec, conv frontend STUBbed with
precomputed frame embeddings (B, 1500, d_model) [arXiv:2212.04356;
unverified]. 20 heads do not divide the 16-way model axis ->
sequence-parallel attention. Vocab 51866 padded to a multiple of 256."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,             # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    num_frames=1500,
    qkv_bias=True,
    use_rope=False,
    tie_embeddings=True,
    norm_eps=1e-5,
    mlp_act="gelu",
    attn_impl="chunked",
    attn_sharding="sequence",
    kv_repeat=1,
)
