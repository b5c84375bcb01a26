"""Decoder-only LM: the dense family.

Counterpart of ``repro.models.transformer``. The layer stack is a Python
loop over parameters stacked along a leading ``layers`` dimension (the
reference scans over it). The KV cache is updated in place. Training
(``lm_loss``), MoE layers and the VLM patch prefix wait for later slices
of the port.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (
    ModelConfig,
    ParamSpec,
    layer_slice,
    rms_norm,
    stack_specs,
)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family waits for a later slice of the "
            "PyTorch port; this one runs the dense LM")


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def make_layer_specs(cfg: ModelConfig) -> dict[str, Any]:
    _require_dense(cfg)
    return {
        "ln_attn": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln_mlp": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn.make_attn_specs(cfg),
        "mlp": mlp_mod.make_mlp_specs(cfg),
    }


def make_lm_specs(cfg: ModelConfig) -> dict[str, Any]:
    vp = cfg.padded_vocab
    specs: dict[str, Any] = {
        "embedding": ParamSpec((vp, cfg.d_model), ("vocab", "embed")),
        "layers": stack_specs(make_layer_specs(cfg), cfg.num_layers),
        "ln_final": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, vp), ("embed", "vocab"))
    return specs


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: dict[str, Any],
                 tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table in the activation dtype."""
    emb = params["embedding"].to(cfg.activation_dtype)
    return emb[tokens] * cfg.embedding_multiplier


def lm_logits(cfg: ModelConfig, params: dict[str, Any],
              x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    if cfg.tie_embeddings:
        w = params["embedding"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    logits = x @ w
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def _mlp_residual(cfg: ModelConfig, lp: dict[str, Any],
                  h: torch.Tensor) -> torch.Tensor:
    hn = rms_norm(h, lp["ln_mlp"], cfg.norm_eps)
    return h + cfg.residual_multiplier * mlp_mod.mlp_forward(cfg, lp["mlp"], hn)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

def lm_forward(cfg: ModelConfig, params: dict[str, Any],
               batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits over the whole sequence, (B, S, Vp)."""
    _require_dense(cfg)
    x = embed_tokens(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        hn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        x = x + cfg.residual_multiplier * attn.attn_forward(
            cfg, lp["attn"], hn, positions, causal=True)
        x = _mlp_residual(cfg, lp, x)
    return lm_logits(cfg, params, x)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device) -> dict[str, torch.Tensor]:
    return attn.init_kv_cache(cfg, batch, max_len, device,
                              layers=cfg.num_layers)


def lm_prefill(cfg: ModelConfig, params: dict[str, Any],
               batch: dict[str, torch.Tensor], cache: dict[str, Any]
               ) -> tuple[torch.Tensor, dict[str, Any]]:
    """Run the prompt through the stack, filling ``cache`` in place.

    Returns (last-position logits (B, 1, Vp), cache)."""
    _require_dense(cfg)
    x = embed_tokens(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        hn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        a, _ = attn.prefill_into_cache(cfg, lp["attn"], hn, positions,
                                       layer_slice(cache, i))
        x = _mlp_residual(cfg, lp, x + cfg.residual_multiplier * a)
    return lm_logits(cfg, params, x[:, -1:]), cache


def lm_decode_step(cfg: ModelConfig, params: dict[str, Any],
                   cache: dict[str, Any], tokens: torch.Tensor,
                   pos: torch.Tensor) -> tuple[torch.Tensor, dict[str, Any]]:
    """One decode step. tokens: (B, 1); pos: scalar or (B,) positions.
    Writes the new k/v into ``cache`` in place."""
    _require_dense(cfg)
    x = embed_tokens(cfg, params, tokens)
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        hn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        a, _ = attn.attn_decode(cfg, lp["attn"], hn, layer_slice(cache, i),
                                pos)
        x = _mlp_residual(cfg, lp, x + cfg.residual_multiplier * a)
    return lm_logits(cfg, params, x), cache
