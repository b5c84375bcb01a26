"""Decoder-only LM covering the dense, MoE and VLM families.

Counterpart of ``repro.models.transformer``. The layer stack is a Python
loop over parameters stacked along a leading ``layers`` dimension (the
reference scans over it), each layer under the config's remat policy.
The KV cache is updated in place. A MoE layer adds its load-balancing
loss to the stack's aux loss; the VLM prepends its projected patch
embeddings to the text and takes logits on the text positions only.
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
    layer_slices,
    maybe_remat,
    embed_rows,
    mul_scalar,
    rms_norm,
    shard,
    softmax_cross_entropy,
    stack_specs,
)
from repro_torch.observability import trace


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def make_layer_specs(cfg: ModelConfig) -> dict[str, Any]:
    specs: dict[str, Any] = {
        "ln_attn": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln_mlp": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn.make_attn_specs(cfg),
    }
    if cfg.family == "moe":
        specs["moe"] = mlp_mod.make_moe_specs(cfg)
    else:
        specs["mlp"] = mlp_mod.make_mlp_specs(cfg)
    return specs


def make_lm_specs(cfg: ModelConfig) -> dict[str, Any]:
    vp = cfg.padded_vocab
    specs: dict[str, Any] = {
        "embedding": ParamSpec((vp, cfg.d_model), ("vocab", "embed")),
        "layers": stack_specs(make_layer_specs(cfg), cfg.num_layers),
        "ln_final": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, vp), ("embed", "vocab"))
    if cfg.family == "vlm":
        specs["mm_projector"] = ParamSpec(
            (cfg.d_model, cfg.d_model), ("embed", "embed_out"))
    return specs


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: dict[str, Any],
                 tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table in the activation dtype. Under a mesh
    the table is gathered whole and each rank looks up its own rows of the
    batch (:func:`~repro_torch.models.common.embed_rows`). The region
    ``model.embed``."""
    def embed(table):
        emb = table.to(cfg.activation_dtype)
        return mul_scalar(embed_rows(emb, tokens), cfg.embedding_multiplier)

    return trace.bwd_region("model.embed", params["embedding"], embed)


def lm_logits(cfg: ModelConfig, params: dict[str, Any],
              x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    if cfg.tie_embeddings:
        w = params["embedding"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    logits = shard(x @ w, "batch", "act_seq", "vocab_sharded")
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def _mlp_residual(cfg: ModelConfig, lp: dict[str, Any], h: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The MLP (or MoE) half of a block: (h + its residual, the MoE's aux
    loss, None for a dense MLP). The dense MLP with its residual scale is
    the region ``model.mlp``."""
    hn = rms_norm(h, lp["ln_mlp"], cfg.norm_eps)
    if cfg.family == "moe":
        m, aux = mlp_mod.moe_forward(cfg, lp["moe"], hn)
        return h + mul_scalar(m, cfg.residual_multiplier), aux
    m = trace.bwd_region(
        "model.mlp", hn,
        lambda t: mul_scalar(mlp_mod.mlp_forward(cfg, lp["mlp"], t),
                             cfg.residual_multiplier))
    return h + m, None


# ---------------------------------------------------------------------------
# Layer stack
# ---------------------------------------------------------------------------

def _layer_forward(cfg: ModelConfig, lp: dict[str, Any], x: torch.Tensor,
                   positions: torch.Tensor) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Pre-norm block. Returns (x, the MoE's aux loss, None for a dense
    MLP). Attention with its residual scale is the region ``model.attn``."""
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    x = x + trace.bwd_region(
        "model.attn", h,
        lambda t: mul_scalar(attn.attn_forward(cfg, lp["attn"], t, positions,
                                               causal=True),
                             cfg.residual_multiplier))
    x, aux = _mlp_residual(cfg, lp, x)
    return shard(x, "batch", "act_seq", None), aux


def _stack_forward(cfg: ModelConfig, params: dict[str, Any], x: torch.Tensor,
                   positions: torch.Tensor) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Every layer, each under ``cfg.remat_policy`` (a MoE layer's
    dispatch one-hots are recomputed, never kept, under the policies that
    save no activations). Returns (x, the layers' aux losses summed, zero
    for a dense stack, whose layers add nothing)."""
    body = maybe_remat(
        lambda h, lp: _layer_forward(cfg, lp, h, positions),
        cfg.remat_policy)
    aux = None
    for lp in layer_slices(params["layers"], cfg.num_layers):
        x, a = body(x, lp)
        if a is not None:
            aux = a if aux is None else aux + a
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


# ---------------------------------------------------------------------------
# Full forward / loss
# ---------------------------------------------------------------------------

def _maybe_prepend_patches(cfg: ModelConfig, params: dict[str, Any],
                           x: torch.Tensor, batch: dict[str, torch.Tensor]
                           ) -> torch.Tensor:
    """VLM family: prepend the projected patch embeddings (B, P, D) to the
    text's (the image frontend is the reference's stub: the batch carries
    precomputed patch embeddings)."""
    if cfg.family != "vlm":
        return x
    patches = batch["patches"].to(x.dtype)
    proj = patches @ params["mm_projector"].to(x.dtype)
    return torch.cat([proj, x], dim=1)


def _embed_and_stack(cfg: ModelConfig, params: dict[str, Any],
                     batch: dict[str, torch.Tensor]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Embeddings (the VLM's patches first) through every layer; returns
    the text positions' hidden states and the aux loss."""
    x = embed_tokens(cfg, params, batch["tokens"])
    x = shard(_maybe_prepend_patches(cfg, params, x, batch),
              "batch", "act_seq", None)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _stack_forward(cfg, params, x, positions)
    if cfg.family == "vlm":
        x = x[:, cfg.num_patches:]                       # loss on text only
    return x, aux


def lm_forward(cfg: ModelConfig, params: dict[str, Any],
               batch: dict[str, torch.Tensor]
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits over the text region (B, S, Vp), aux_loss)."""
    x, aux = _embed_and_stack(cfg, params, batch)
    return lm_logits(cfg, params, x), aux


def _chunked_ce(cfg: ModelConfig, params: dict[str, Any], x: torch.Tensor,
                labels: torch.Tensor, mask: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streamed CE: each sequence chunk's logits are computed under a
    checkpoint, so the (B, S, Vp) fp32 tensor never exists. The loss is
    the sum of the chunks' unnormalised sums over the sum of their
    denominators, as in the reference. Each chunk, head included, is the
    region ``model.ce``."""
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
        li = labels[:, i:i + c]
        ls, dn = trace.bwd_region(
            "model.ce", x[:, i:i + c],
            lambda xi: checkpoint(chunk_loss, xi, li, mi,
                                  use_reentrant=False))
        tot, den = tot + ls, den + dn
    return tot / torch.clamp_min(den, 1.0), den


def lm_loss(cfg: ModelConfig, params: dict[str, Any],
            batch: dict[str, torch.Tensor]
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(CE + 0.01 aux, {ce_loss, aux_loss, tokens}) over ``batch``'s
    tokens, labels and optional mask (and, for the VLM, patches). The
    head and the CE are the region ``model.ce`` (a chunk of it each,
    under ``ce_chunk``)."""
    labels = batch["labels"]
    mask = batch.get("mask")
    x, aux = _embed_and_stack(cfg, params, batch)
    if cfg.ce_chunk:
        loss, denom = _chunked_ce(cfg, params, x, labels, mask)
    else:
        loss, denom = trace.bwd_region(
            "model.ce", x,
            lambda t: softmax_cross_entropy(lm_logits(cfg, params, t),
                                            labels, mask, cfg.vocab_size))
    total = loss + 0.01 * aux
    return total, {"ce_loss": loss, "aux_loss": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device) -> dict[str, torch.Tensor]:
    return attn.init_kv_cache(cfg, batch, max_len, device,
                              layers=cfg.num_layers)


def lm_cache_axes(cfg: ModelConfig) -> dict[str, Any]:
    return attn.kv_cache_axes(cfg, layers=True)


def lm_prefill(cfg: ModelConfig, params: dict[str, Any],
               batch: dict[str, torch.Tensor], cache: dict[str, Any]
               ) -> tuple[torch.Tensor, dict[str, Any]]:
    """Run the prompt (after the VLM's patches) through the stack, filling
    ``cache`` in place: positions 0 .. P + S - 1 for a VLM, so its decode
    positions start at P + S.

    Returns (last-position logits (B, 1, Vp), cache)."""
    x = embed_tokens(cfg, params, batch["tokens"])
    x = shard(_maybe_prepend_patches(cfg, params, x, batch),
              "batch", "act_seq", None)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        hn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        a, _ = attn.prefill_into_cache(cfg, lp["attn"], hn, positions,
                                       layer_slice(cache, i))
        x, _ = _mlp_residual(cfg, lp,
                             x + mul_scalar(a, cfg.residual_multiplier))
        x = shard(x, "batch", "act_seq", None)
    return lm_logits(cfg, params, x[:, -1:]), cache


def lm_decode_step(cfg: ModelConfig, params: dict[str, Any],
                   cache: dict[str, Any], tokens: torch.Tensor,
                   pos: torch.Tensor) -> tuple[torch.Tensor, dict[str, Any]]:
    """One decode step. tokens: (B, 1); pos: scalar or (B,) positions.
    Writes the new k/v into ``cache`` in place."""
    x = shard(embed_tokens(cfg, params, tokens), "batch", None, None)
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        hn = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        a, _ = attn.attn_decode(cfg, lp["attn"], hn, layer_slice(cache, i),
                                pos)
        x, _ = _mlp_residual(cfg, lp,
                             x + mul_scalar(a, cfg.residual_multiplier))
    return lm_logits(cfg, params, x), cache
