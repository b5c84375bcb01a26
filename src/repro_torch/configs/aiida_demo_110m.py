"""The paper's own demo config: a ~110M-parameter dense LM used by the
end-to-end example workflows (examples/train_lm.py). Small enough to train
for a few hundred steps on modest hardware under the engine."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="aiida-demo-110m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
    rope_theta=10_000.0,
    mlp_act="silu",
    attn_impl="direct",
    attn_sharding="heads",
    kv_repeat=1,
)
