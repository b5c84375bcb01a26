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

Every family of the reference is built here: the LM families (dense,
MoE, VLM), the hybrid (recurrentgemma / Griffin), the ssm family (xLSTM)
and the audio family (whisper's encoder-decoder). A VLM batch carries
``patches`` (B, num_patches, d_model) beside its tokens, an audio batch
``frames`` (B, num_frames, d_model) (``extra_inputs``, ``batch_shapes``;
``draw_extra_inputs`` fills them as the training job's recipe does).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models import encdec, rglru, transformer, xlstm
from repro_torch.models.common import (ModelConfig, init_params,
                                       init_params_on_device, resolve_device)

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

    def init_params_on_device(self, generator: torch.Generator) -> Any:
        """Parameters in the config's ``param_dtype``, each leaf drawn where
        ``generator`` lives (a ``torch.Generator(device="cuda")`` draws on
        the card): the route for full-width models, with no copy of the
        tree on the host and none in fp32 when the dtype is bf16. Same
        init rules, other numbers than :meth:`init_params`."""
        return init_params_on_device(generator, self.specs,
                                     self.cfg.weight_dtype)

    def extra_inputs(self, batch_size: int
                     ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """The family's inputs beside its tokens, name -> (shape, dtype): a
        VLM's ``patches`` (B, num_patches, d_model), an audio model's
        ``frames`` (B, num_frames, d_model); none for the others."""
        cfg = self.cfg
        if cfg.family == "vlm":
            return {"patches": ((batch_size, cfg.num_patches, cfg.d_model),
                                cfg.activation_dtype)}
        if cfg.family == "audio":
            return {"frames": ((batch_size, cfg.num_frames, cfg.d_model),
                               cfg.activation_dtype)}
        return {}

    def draw_extra_inputs(self, batch_size: int, rng: np.random.Generator,
                          device: str | torch.device
                          ) -> dict[str, torch.Tensor]:
        """The :meth:`extra_inputs` of one training batch as the reference's
        job recipe (``tpujob.py``) fills them, each step after its tokens:
        a VLM's patches are zeros, an audio model's frames are standard
        normal float32 draws from ``rng`` (the model casts them)."""
        out = {}
        for name, (shape, dtype) in self.extra_inputs(batch_size).items():
            if name == "frames":
                out[name] = torch.from_numpy(
                    rng.normal(0, 1, shape).astype(np.float32)).to(device)
            else:
                out[name] = torch.zeros(shape, dtype=dtype, device=device)
        return out

    def batch_shapes(self, batch_size: int, seq_len: int
                     ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """A training or prefill batch's inputs, name -> (shape, dtype), as
        the reference's ``batch_struct`` gives them: a VLM's ``seq_len``
        spans its patches and its text (at least 16 text tokens); an audio
        batch's tokens are ``seq_len`` long beside its frames."""
        extra = self.extra_inputs(batch_size)
        s = seq_len
        if "patches" in extra:
            s = max(s - self.cfg.num_patches, 16)
        return {"tokens": ((batch_size, s), torch.int32),
                "labels": ((batch_size, s), torch.int32), **extra}

    def init_cache(self, batch_size: int, max_len: int,
                   device: str | torch.device | None = None) -> Any:
        """The serving cache on ``device`` (the card when None): the
        stacked KV cache of an LM, the per-layer state list of the hybrid
        and of the xLSTM, whisper's self and cross caches."""
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
    if cfg.family == "audio":
        return ModelBundle(
            cfg=cfg,
            specs=encdec.make_whisper_specs(cfg),
            prefill_fn=lambda p, b, c: encdec.whisper_prefill(cfg, p, b, c),
            decode_fn=lambda p, c, t, pos: encdec.whisper_decode_step(
                cfg, p, c, t, pos),
            loss_fn=lambda p, b: encdec.whisper_loss(cfg, p, b),
            cache_fn=lambda bsz, ml, dev: encdec.init_whisper_cache(
                cfg, bsz, ml, dev),
        )
    raise NotImplementedError(f"unknown family {cfg.family!r}")
