"""Assigned architecture configs, as data. ``get_config('<arch-id>')``
accepts the public ids with dashes (e.g. ``deepseek-67b``).

Counterpart of ``repro.configs``; the device and mesh helpers there wait
for the port's multi-device slice."""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = [
    "deepseek-67b",
    "qwen3-4b",
    "granite-3-2b",
    "qwen2-0.5b",
    "grok-1-314b",
    "moonshot-v1-16b-a3b",
    "recurrentgemma-2b",
    "llava-next-34b",
    "whisper-large-v3",
    "xlstm-350m",
    # the paper's own demo config (small LM used by examples/)
    "aiida-demo-110m",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def list_configs() -> list[str]:
    return list(ARCH_IDS)


# ---------------------------------------------------------------------------
# Reduced configs for CPU tests (same family/topology, tiny sizes)
# ---------------------------------------------------------------------------

def reduced_config(arch_id: str) -> ModelConfig:
    cfg = get_config(arch_id)
    kw: dict = dict(
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_layers=2,
        attn_impl="direct",
        kv_repeat=1,
        moe_group_size=64,
        mlstm_chunk=32,
    )
    if cfg.family == "moe":
        kw.update(num_experts=4, num_experts_per_tok=2)
    if cfg.family == "hybrid":
        kw.update(num_layers=3, d_rnn=128, local_window=32)
    if cfg.family == "ssm":
        # keep >= 8 layers so at least one sLSTM position exists
        kw.update(num_layers=8, num_kv_heads=4, d_ff=0)
    if cfg.family == "audio":
        kw.update(num_kv_heads=4, encoder_layers=2, num_frames=16)
    if cfg.family == "vlm":
        kw.update(num_patches=8)
    if cfg.name == "xlstm-350m":
        kw["head_dim"] = 0
    return cfg.replace(**kw)
