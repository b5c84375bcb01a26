"""Dense gated MLPs (SwiGLU / GeGLU).

Counterpart of ``repro.models.mlp``; the MoE layer waits for a later slice
of the port.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig, ParamSpec, act_fn


def make_mlp_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "ffn")),
        "w_up": ParamSpec((d, f), ("embed", "ffn")),
        "w_down": ParamSpec((f, d), ("ffn", "embed")),
    }


def mlp_forward(cfg: ModelConfig, p: dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    act = act_fn(cfg.mlp_act)
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    return (act(g) * u) @ p["w_down"].to(dt)
