"""xLSTM-350M — sLSTM + mLSTM blocks, ratio 7:1 [arXiv:2405.04517;
unverified]. d_ff = 0: blocks carry internal projections, no separate FFN.
Linear recurrence -> runs the long_500k cell. 4 heads do not divide the
model axis -> inner/head-dim TP sharding."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    mlstm_proj_factor=2.0,
    slstm_conv_width=4,
    mlstm_chunk=128,
    use_rope=False,
    mlp_act="gelu",
    attn_impl="direct",
    attn_sharding="sequence",
    kv_repeat=1,
)
