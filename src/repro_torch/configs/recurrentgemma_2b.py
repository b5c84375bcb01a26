"""RecurrentGemma-2B (Griffin) — RG-LRU + local attention, pattern 1:2
[arXiv:2402.19427; hf]. Sub-quadratic -> runs the long_500k cell.

10 heads do not divide the 16-way model axis -> sequence-parallel
attention; the RG-LRU width (2560) is TP-sharded."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"),
    local_window=2048,
    d_rnn=2560,
    conv_width=4,
    rope_theta=10_000.0,
    mlp_act="gelu",
    attn_impl="chunked",
    attn_sharding="sequence",
    kv_repeat=1,
)
