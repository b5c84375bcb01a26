"""Whisper-large-v3 transformer backbone (encoder-decoder).

Counterpart of ``repro.models.encdec``. The conv/mel frontend is the
reference's stub: a batch carries precomputed frame embeddings ``frames``
(B, num_frames, d_model) as the encoder's input. Otherwise the backbone is
whisper's: LayerNorm with bias, plain GELU MLPs (not gated; the tanh form,
the reference's ``jax.nn.gelu`` default, whatever ``cfg.mlp_act`` says,
op by op as JAX computes it: :func:`gelu_tanh`), MHA with kv == heads, a tied decoder embedding, and sinusoidal
positions for both stacks (the reference's choice over whisper's learned
decoder positions).

Both stacks are Python loops over parameters stacked along a leading layer
dimension (the reference scans over them), each layer under the config's
remat policy. The encoder's self-attention and the decoder's
cross-attention are not causal, so under ``attn_impl="pallas"`` they stay
on the chunked path, as in the reference; the decoder's causal
self-attention takes the flash kernels, and a decode step's the decode
kernel. The caches are updated in place. ``whisper_cache_axes`` (the
logical sharding axes of the cache) waits for the multi-device slice.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (
    ModelConfig,
    ParamSpec,
    layer_norm,
    layer_slice,
    maybe_remat,
    mul_scalar,
    sinusoid,
    sinusoidal_positions,
    softmax_cross_entropy,
    stack_specs,
)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _ln_specs(d: int) -> dict[str, ParamSpec]:
    return {"w": ParamSpec((d,), ("embed",), init="ones"),
            "b": ParamSpec((d,), ("embed",), init="zeros")}


def _plain_mlp_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamSpec((d, f), ("embed", "ffn")),
        "b1": ParamSpec((f,), ("ffn",), init="zeros"),
        "w2": ParamSpec((f, d), ("ffn", "embed")),
        "b2": ParamSpec((d,), ("embed",), init="zeros"),
    }


def _enc_layer_specs(cfg: ModelConfig) -> dict[str, Any]:
    return {
        "ln1": _ln_specs(cfg.d_model),
        "attn": attn.make_attn_specs(cfg),
        "ln2": _ln_specs(cfg.d_model),
        "mlp": _plain_mlp_specs(cfg),
    }


def _dec_layer_specs(cfg: ModelConfig) -> dict[str, Any]:
    return {
        "ln1": _ln_specs(cfg.d_model),
        "self_attn": attn.make_attn_specs(cfg),
        "ln2": _ln_specs(cfg.d_model),
        "cross_attn": attn.make_attn_specs(cfg, cross=True),
        "ln3": _ln_specs(cfg.d_model),
        "mlp": _plain_mlp_specs(cfg),
    }


def _encoder_layers(cfg: ModelConfig) -> int:
    return cfg.encoder_layers or cfg.num_layers


def make_whisper_specs(cfg: ModelConfig) -> dict[str, Any]:
    return {
        "embedding": ParamSpec((cfg.padded_vocab, cfg.d_model),
                               ("vocab", "embed")),
        "enc_layers": stack_specs(_enc_layer_specs(cfg), _encoder_layers(cfg)),
        "enc_ln": _ln_specs(cfg.d_model),
        "dec_layers": stack_specs(_dec_layer_specs(cfg), cfg.num_layers),
        "dec_ln": _ln_specs(cfg.d_model),
    }


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (``approximate=True``) op for op: ``x * 0.5 *
    (1 + tanh(sqrt(2 / pi) * (x + 0.044715 * x**3)))`` with each constant
    rounded to ``x``'s dtype and each op rounded to it, as JAX computes
    it. ``F.gelu(x, approximate="tanh")`` rounds once at the end, which
    moves a bf16 result by one ulp in ~45% of the elements."""
    inner = x + mul_scalar(x ** 3, 0.044715)
    t = torch.tanh(mul_scalar(inner, math.sqrt(2.0 / math.pi)))
    return x * mul_scalar(1.0 + t, 0.5)


def _mlp(cfg: ModelConfig, p: dict[str, torch.Tensor],
         x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["w1"].to(dt) + p["b1"].to(dt)
    h = gelu_tanh(h)
    return h @ p["w2"].to(dt) + p["b2"].to(dt)


def _ln(cfg: ModelConfig, p: dict[str, torch.Tensor],
        x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, p["w"], p["b"], cfg.norm_eps)


def _embed(cfg: ModelConfig, params: dict[str, Any],
           tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus the sinusoid of positions 0 .. S - 1, in the
    activation dtype."""
    dt = cfg.activation_dtype
    x = params["embedding"].to(dt)[tokens]
    pos = sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(dt)
    return x + pos[None]


def _logits(cfg: ModelConfig, params: dict[str, Any],
            x: torch.Tensor) -> torch.Tensor:
    """The final LayerNorm, then the tied embedding: (B, S, Vp)."""
    x = _ln(cfg, params["dec_ln"], x)
    return x @ params["embedding"].to(x.dtype).T


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _enc_layer(cfg: ModelConfig, p: dict[str, Any], h: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    h = h + attn.attn_forward(cfg, p["attn"], _ln(cfg, p["ln1"], h),
                              positions, causal=False)
    return h + _mlp(cfg, p["mlp"], _ln(cfg, p["ln2"], h))


def encode(cfg: ModelConfig, params: dict[str, Any],
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, D) precomputed frame embeddings (the stub frontend).
    Returns the encoder's output (B, T, D) in the activation dtype."""
    dt = cfg.activation_dtype
    x = frames.to(dt)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(dt)[None]
    positions = torch.arange(x.shape[1], device=x.device)
    body = maybe_remat(lambda h, p: _enc_layer(cfg, p, h, positions),
                       cfg.remat_policy)
    for i in range(_encoder_layers(cfg)):
        x = body(x, layer_slice(params["enc_layers"], i))
    return _ln(cfg, params["enc_ln"], x)


# ---------------------------------------------------------------------------
# Decoder (training / teacher-forced)
# ---------------------------------------------------------------------------

def _dec_layer(cfg: ModelConfig, p: dict[str, Any], h: torch.Tensor,
               enc_out: torch.Tensor, positions: torch.Tensor,
               enc_positions: torch.Tensor) -> torch.Tensor:
    h = h + attn.attn_forward(cfg, p["self_attn"], _ln(cfg, p["ln1"], h),
                              positions, causal=True)
    h = h + attn.attn_forward(cfg, p["cross_attn"], _ln(cfg, p["ln2"], h),
                              positions, causal=False, kv_x=enc_out,
                              kv_positions=enc_positions)
    return h + _mlp(cfg, p["mlp"], _ln(cfg, p["ln3"], h))


def decode_train(cfg: ModelConfig, params: dict[str, Any],
                 tokens: torch.Tensor, enc_out: torch.Tensor
                 ) -> torch.Tensor:
    """Teacher-forced decoder over ``tokens`` (B, S) attending to
    ``enc_out``: logits (B, S, Vp)."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    enc_positions = torch.arange(enc_out.shape[1], device=x.device)
    body = maybe_remat(
        lambda h, p, e: _dec_layer(cfg, p, h, e, positions, enc_positions),
        cfg.remat_policy)
    for i in range(cfg.num_layers):
        x = body(x, layer_slice(params["dec_layers"], i), enc_out)
    return _logits(cfg, params, x)


def whisper_loss(cfg: ModelConfig, params: dict[str, Any],
                 batch: dict[str, torch.Tensor]
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(CE, {ce_loss, tokens, aux_loss = 0}) over ``batch``'s frames,
    tokens, labels and optional mask."""
    enc_out = encode(cfg, params, batch["frames"])
    logits = decode_train(cfg, params, batch["tokens"], enc_out)
    loss, denom = softmax_cross_entropy(logits, batch["labels"],
                                        batch.get("mask"), cfg.vocab_size)
    return loss, {"ce_loss": loss, "tokens": denom,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_whisper_cache(cfg: ModelConfig, batch: int, max_len: int,
                       device: torch.device) -> dict[str, Any]:
    """The decoder's stacked self-attention KV cache (``self``) and the
    cross-attention's K/V of the encoder output (``cross_k``,
    ``cross_v``: (L, B, num_frames, Hkv, hd) in the activation dtype,
    filled by the prefill)."""
    shape = (cfg.num_layers, batch, cfg.num_frames, cfg.kv_heads_eff, cfg.hd)
    return {
        "self": attn.init_kv_cache(cfg, batch, max_len, device,
                                   layers=cfg.num_layers),
        "cross_k": torch.zeros(shape, dtype=cfg.activation_dtype,
                               device=device),
        "cross_v": torch.zeros(shape, dtype=cfg.activation_dtype,
                               device=device),
    }


def _cross_kv(cfg: ModelConfig, p: dict[str, torch.Tensor],
              enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's K and V of ``enc_out`` (B, T, Hkv_eff, hd)."""
    dt = enc_out.dtype
    ck = torch.einsum("btd,dhk->bthk", enc_out, p["wk"].to(dt))
    cv = torch.einsum("btd,dhk->bthk", enc_out, p["wv"].to(dt))
    if cfg.qkv_bias:
        ck = ck + p["bk"].to(dt)
        cv = cv + p["bv"].to(dt)
    if cfg.kv_repeat > 1:
        ck = torch.repeat_interleave(ck, cfg.kv_repeat, dim=2)
        cv = torch.repeat_interleave(cv, cfg.kv_repeat, dim=2)
    return ck, cv


def whisper_prefill(cfg: ModelConfig, params: dict[str, Any],
                    batch: dict[str, torch.Tensor], cache: dict[str, Any]
                    ) -> tuple[torch.Tensor, dict[str, Any]]:
    """Encode the frames and run the teacher-forced prompt, filling both
    caches in place (the self cache at positions 0 .. S - 1, the cross
    K/V of every layer). Returns (last-position logits (B, 1, Vp),
    cache)."""
    enc_out = encode(cfg, params, batch["frames"])
    x = _embed(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    enc_positions = torch.arange(enc_out.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        p = layer_slice(params["dec_layers"], i)
        a, _ = attn.prefill_into_cache(cfg, p["self_attn"],
                                       _ln(cfg, p["ln1"], x), positions,
                                       layer_slice(cache["self"], i))
        x = x + a
        # the cross K/V go to the cache; attn_forward projects them again,
        # as the reference does
        ck, cv = _cross_kv(cfg, p["cross_attn"], enc_out)
        cache["cross_k"][i] = ck
        cache["cross_v"][i] = cv
        x = x + attn.attn_forward(cfg, p["cross_attn"], _ln(cfg, p["ln2"], x),
                                  positions, causal=False, kv_x=enc_out,
                                  kv_positions=enc_positions)
        x = x + _mlp(cfg, p["mlp"], _ln(cfg, p["ln3"], x))
    return _logits(cfg, params, x[:, -1:]), cache


def whisper_decode_step(cfg: ModelConfig, params: dict[str, Any],
                        cache: dict[str, Any], tokens: torch.Tensor,
                        pos: torch.Tensor
                        ) -> tuple[torch.Tensor, dict[str, Any]]:
    """One decode step. tokens: (B, 1); pos: a scalar, the position every
    row is at (the reference's step sinusoid takes a scalar only). Writes
    the new self-attention k/v into ``cache`` in place; the cross K/V are
    read as the prefill left them."""
    dt = cfg.activation_dtype
    x = params["embedding"].to(dt)[tokens]
    pos = torch.as_tensor(pos, device=x.device)
    if pos.dim() != 0:
        raise ValueError("whisper decodes every row at one position: pos "
                         f"must be a scalar, got shape {tuple(pos.shape)}")
    # the step's sinusoid, computed as the reference's step computes it
    x = x + sinusoid(pos, cfg.d_model).to(dt)[None, None, :]
    b, h_, hd = x.shape[0], cfg.num_heads, cfg.hd
    scale = 1.0 / float(hd) ** 0.5
    for i in range(cfg.num_layers):
        p = layer_slice(params["dec_layers"], i)
        a, _ = attn.attn_decode(cfg, p["self_attn"], _ln(cfg, p["ln1"], x),
                                layer_slice(cache["self"], i), pos)
        x = x + a
        hq = _ln(cfg, p["ln2"], x)
        cp = p["cross_attn"]
        q = torch.einsum("bsd,dhk->bshk", hq, cp["wq"].to(dt))
        if cfg.qkv_bias:
            q = q + cp["bq"].to(dt)
        ck, cv = cache["cross_k"][i], cache["cross_v"][i]
        hkv = ck.shape[2]
        qg = q.reshape(b, 1, hkv, h_ // hkv, hd)
        # logits in the activation dtype, widened, then scaled in fp32;
        # the probabilities rounded back before the product with V
        logits = torch.einsum("bskgh,btkh->bkgst", qg, ck).float() * scale
        probs = torch.softmax(logits, dim=-1).to(dt)
        o = torch.einsum("bkgst,btkh->bskgh", probs, cv).reshape(b, 1, h_, hd)
        x = x + torch.einsum("bshk,hkd->bsd", o, cp["wo"].to(dt))
        x = x + _mlp(cfg, p["mlp"], _ln(cfg, p["ln3"], x))
    return _logits(cfg, params, x), cache
