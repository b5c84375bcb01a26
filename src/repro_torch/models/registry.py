"""Uniform model interface.

Counterpart of ``repro.models.registry``. A bundle exposes the serving
entry points the scheduler drives:

    prefill_fn(params, batch, cache)        -> (logits, cache)
    decode_fn(params, cache, tokens, pos)   -> (logits, cache)
    init_cache(batch_size, max_len, device) -> cache dict
    init_params(generator, device)          -> parameter dict
    loss_fn(params, batch)                  -> (loss, metrics)

The hybrid, ssm and audio families, MoE and the VLM prefix come with
their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import transformer
from repro_torch.models.common import (ModelConfig, init_params,
                                       resolve_device)

LM_FAMILIES = ("dense", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    specs: Any
    prefill_fn: Callable
    decode_fn: Callable
    loss_fn: Callable

    def init_params(self, generator: torch.Generator | int,
                    device: str | torch.device | None = None) -> Any:
        """fp32 master parameters by the reference's init rules, drawn from
        a CPU ``generator`` (or a seed) and placed on ``device`` (the card
        when None)."""
        dev = resolve_device(device)
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        return init_params(generator, self.specs, self.cfg.weight_dtype, dev)

    def init_cache(self, batch_size: int, max_len: int,
                   device: str | torch.device | None = None) -> Any:
        return transformer.init_lm_cache(self.cfg, batch_size, max_len,
                                         resolve_device(device))


def build(cfg: ModelConfig) -> ModelBundle:
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family waits for a later slice of the "
            "PyTorch port")
    return ModelBundle(
        cfg=cfg,
        specs=transformer.make_lm_specs(cfg),
        prefill_fn=lambda p, b, c: transformer.lm_prefill(cfg, p, b, c),
        decode_fn=lambda p, c, t, pos: transformer.lm_decode_step(
            cfg, p, c, t, pos),
        loss_fn=lambda p, b: transformer.lm_loss(cfg, p, b),
    )
