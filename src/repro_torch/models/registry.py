"""Uniform model interface.

Counterpart of ``repro.models.registry``. A bundle exposes the serving
entry points the scheduler drives:

    prefill_fn(params, batch, cache)        -> (logits, cache)
    decode_fn(params, cache, tokens, pos)   -> (logits, cache)
    init_cache(batch_size, max_len, device) -> cache (a dict; the hybrid's
                                               and the xLSTM's are lists of
                                               per-layer dicts)
    init_params(generator, device)          -> parameter dict
    loss_fn(params, batch)                  -> (loss, metrics)

Dense LMs, the hybrid (recurrentgemma / Griffin) and the ssm family
(xLSTM) are built here; the audio family, MoE and the VLM prefix come
with their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import rglru, transformer, xlstm
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
    cache_fn: Callable         # (batch_size, max_len, device) -> cache

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
        """The serving cache on ``device`` (the card when None): the
        stacked KV cache of an LM, the per-layer state list of the hybrid
        and of the xLSTM."""
        return self.cache_fn(batch_size, max_len, resolve_device(device))


def build(cfg: ModelConfig) -> ModelBundle:
    if cfg.family in LM_FAMILIES:
        return ModelBundle(
            cfg=cfg,
            specs=transformer.make_lm_specs(cfg),
            prefill_fn=lambda p, b, c: transformer.lm_prefill(cfg, p, b, c),
            decode_fn=lambda p, c, t, pos: transformer.lm_decode_step(
                cfg, p, c, t, pos),
            loss_fn=lambda p, b: transformer.lm_loss(cfg, p, b),
            cache_fn=lambda bsz, ml, dev: transformer.init_lm_cache(
                cfg, bsz, ml, dev),
        )
    if cfg.family == "hybrid":
        return ModelBundle(
            cfg=cfg,
            specs=rglru.make_griffin_specs(cfg),
            prefill_fn=lambda p, b, c: rglru.griffin_prefill(cfg, p, b, c),
            decode_fn=lambda p, c, t, pos: rglru.griffin_decode_step(
                cfg, p, c, t, pos),
            loss_fn=lambda p, b: rglru.griffin_loss(cfg, p, b),
            cache_fn=lambda bsz, ml, dev: rglru.init_griffin_state(
                cfg, bsz, ml, dev),
        )
    if cfg.family == "ssm":
        return ModelBundle(
            cfg=cfg,
            specs=xlstm.make_xlstm_specs(cfg),
            prefill_fn=lambda p, b, c: xlstm.xlstm_prefill(cfg, p, b, c),
            decode_fn=lambda p, c, t, pos: xlstm.xlstm_decode_step(
                cfg, p, c, t, pos),
            loss_fn=lambda p, b: xlstm.xlstm_loss(cfg, p, b),
            cache_fn=lambda bsz, ml, dev: xlstm.init_xlstm_state(
                cfg, bsz, ml, dev),
        )
    raise NotImplementedError(
        f"the {cfg.family!r} family waits for a later slice of the "
        "PyTorch port")
