"""Decoder-only LM: the dense family.

Counterpart of ``repro.models.transformer``. The layer stack is a Python
loop over parameters stacked along a leading ``layers`` dimension (the
reference scans over it), each layer under the config's remat policy.
The KV cache is updated in place. MoE layers and the VLM patch prefix wait
for later slices of the port.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (
    ModelConfig,
    ParamSpec,
    layer_slice,
    maybe_remat,
    mul_scalar,
    rms_norm,
    softmax_cross_entropy,
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
    return mul_scalar(emb[tokens], cfg.embedding_multiplier)


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
    return h + mul_scalar(mlp_mod.mlp_forward(cfg, lp["mlp"], hn),
                          cfg.residual_multiplier)


# ---------------------------------------------------------------------------
# Layer stack
# ---------------------------------------------------------------------------

def _layer_forward(cfg: ModelConfig, lp: dict[str, Any], x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """Pre-norm block."""
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    x = x + mul_scalar(attn.attn_forward(cfg, lp["attn"], h, positions,
                                         causal=True),
                       cfg.residual_multiplier)
    return _mlp_residual(cfg, lp, x)


def _stack_forward(cfg: ModelConfig, params: dict[str, Any], x: torch.Tensor,
                   positions: torch.Tensor) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Every layer, each under ``cfg.remat_policy``. Returns (x, aux_loss);
    dense layers add no auxiliary loss."""
    body = maybe_remat(
        lambda h, lp: _layer_forward(cfg, lp, h, positions),
        cfg.remat_policy)
    for i in range(cfg.num_layers):
        x = body(x, layer_slice(params["layers"], i))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Full forward / loss
# ---------------------------------------------------------------------------

def lm_forward(cfg: ModelConfig, params: dict[str, Any],
               batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits over the whole sequence, (B, S, Vp)."""
    _require_dense(cfg)
    x = embed_tokens(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _stack_forward(cfg, params, x, positions)
    return lm_logits(cfg, params, x)


def _chunked_ce(cfg: ModelConfig, params: dict[str, Any], x: torch.Tensor,
                labels: torch.Tensor, mask: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streamed CE: each sequence chunk's logits are computed under a
    checkpoint, so the (B, S, Vp) fp32 tensor never exists. The loss is
    the sum of the chunks' unnormalised sums over the sum of their
    denominators, as in the reference."""
    b, s, _ = x.shape
    c = min(cfg.ce_chunk, s)
    while s % c:
        c //= 2

    def chunk_loss(xi, li, mi):
        logits = lm_logits(cfg, params, xi)
        loss, denom = softmax_cross_entropy(logits, li, mi, cfg.vocab_size)
        return loss * denom, denom                       # un-normalised sum

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        mi = (mask[:, i:i + c] if mask is not None
              else torch.ones((b, c), dtype=torch.float32, device=x.device))
        ls, dn = checkpoint(chunk_loss, x[:, i:i + c], labels[:, i:i + c],
                            mi, use_reentrant=False)
        tot, den = tot + ls, den + dn
    return tot / torch.clamp_min(den, 1.0), den


def lm_loss(cfg: ModelConfig, params: dict[str, Any],
            batch: dict[str, torch.Tensor]
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(CE + 0.01 aux, {ce_loss, aux_loss, tokens}) over ``batch``'s
    tokens, labels and optional mask."""
    _require_dense(cfg)
    labels = batch["labels"]
    mask = batch.get("mask")
    x = embed_tokens(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _stack_forward(cfg, params, x, positions)
    if cfg.ce_chunk:
        loss, denom = _chunked_ce(cfg, params, x, labels, mask)
    else:
        loss, denom = softmax_cross_entropy(lm_logits(cfg, params, x),
                                            labels, mask, cfg.vocab_size)
    total = loss + 0.01 * aux
    return total, {"ce_loss": loss, "aux_loss": aux, "tokens": denom}


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
        x = _mlp_residual(cfg, lp, x + mul_scalar(a, cfg.residual_multiplier))
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
        x = _mlp_residual(cfg, lp, x + mul_scalar(a, cfg.residual_multiplier))
    return lm_logits(cfg, params, x), cache
