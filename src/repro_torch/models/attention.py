"""Multi-head / grouped-query attention.

Counterpart of ``repro.models.attention``. Implementations
(``cfg.attn_impl``):

* ``direct``  — one einsum; the right choice for short sequences.
* ``pallas``  — the hand-written flash-attention kernels
                (:mod:`repro_torch.kernels.flash_attention`): the forward,
                and the dq and dk/dv passes when autograd takes a
                gradient; the name is the reference's, so one config
                drives both packages.
* ``chunked`` — online-softmax loop over KV blocks of ``attn_kv_block``
                (flash-attention recurrence in plain PyTorch), whose
                temporaries are ``O(S * kv_block)`` instead of ``O(S^2)``.

The KV cache is updated in place: :func:`attn_decode` and
:func:`prefill_into_cache` write into the tensors of the cache dict they
are given (the reference returns a new pytree) and return that dict. With
``window > 0`` the cache is a ring buffer: position ``pos`` lives in slot
``pos % window``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import ModelConfig, ParamSpec, rms_norm, rope

NEG_INF = -2.0e30


# ---------------------------------------------------------------------------
# Parameter specification
# ---------------------------------------------------------------------------

def make_attn_specs(cfg: ModelConfig, *, cross: bool = False
                    ) -> dict[str, ParamSpec]:
    """The attention leaves. ``cross`` (whisper's cross-attention) keeps
    the reference's signature and changes no leaf."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    specs: dict[str, ParamSpec] = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, hkv, hd), ("embed", "kv_heads_w", "head_dim")),
        "wv": ParamSpec((d, hkv, hd), ("embed", "kv_heads_w", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        specs["bk"] = ParamSpec((hkv, hd), ("kv_heads_w", "head_dim"),
                                init="zeros")
        specs["bv"] = ParamSpec((hkv, hd), ("kv_heads_w", "head_dim"),
                                init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
    return specs


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def _project_qkv(cfg: ModelConfig, p: dict[str, torch.Tensor],
                 x: torch.Tensor, kv_x: torch.Tensor | None = None):
    """Project to q, k, v (B, S, heads, hd), k and v from ``kv_x`` when it
    is given (cross-attention); apply qk-norm; tile kv heads to
    kv_heads_eff."""
    dt = x.dtype
    kv_in = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", kv_in, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", kv_in, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.kv_repeat > 1:
        # physical tiling; consecutive-group semantics match the (Hkv, G)
        # query grouping
        k = torch.repeat_interleave(k, cfg.kv_repeat, dim=2)
        v = torch.repeat_interleave(v, cfg.kv_repeat, dim=2)
    return q, k, v


def _out_proj(p: dict[str, torch.Tensor], out: torch.Tensor,
              dt: torch.dtype) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# Masking helpers
# ---------------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int) -> torch.Tensor:
    """(Sq, Skv) additive bias in fp32."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(logits / cap)
    return logits


def _scale(cfg: ModelConfig, hd: int) -> float:
    return cfg.attention_multiplier or (1.0 / float(hd) ** 0.5)


# ---------------------------------------------------------------------------
# Core attention math (grouped)
# ---------------------------------------------------------------------------

def _direct_attention(cfg: ModelConfig, q, k, v, q_pos, k_pos, *, causal,
                      window) -> torch.Tensor:
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * _scale(cfg, hd)
    logits = _softcap(logits, cfg.attn_softcap)
    logits = logits + _mask_bias(q_pos, k_pos, causal=causal,
                                 window=window)[None, None, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, sq, h, hd)


def _chunked_attention(cfg: ModelConfig, q, k, v, q_pos, k_pos, *, causal,
                       window) -> torch.Tensor:
    """Online-softmax loop over KV blocks; O(Sq * kv_block) temporaries.
    The block is ``attn_kv_block``, halved until it divides Skv."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    blk = min(cfg.attn_kv_block, skv)
    while skv % blk:
        blk //= 2
    # the scale is folded into q in fp32, then q is rounded back
    qg = (q.float() * _scale(cfg, hd)).reshape(b, sq, hkv, g, hd).to(q.dtype)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    den = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(0, skv, blk):
        kb, vb = k[:, j:j + blk], v[:, j:j + blk]
        logits = torch.einsum("bskgh,btkh->bkgst", qg, kb).float()
        logits = _softcap(logits, cfg.attn_softcap)
        logits = logits + _mask_bias(q_pos, k_pos[j:j + blk], causal=causal,
                                     window=window)[None, None, None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        den = den * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkh->bkgsh", p.to(q.dtype), vb)
        acc = acc * alpha[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp_min(den[..., None], 1e-30)
    # (b, hkv, g, sq, hd) -> (b, sq, h, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def _kernel_attention(cfg: ModelConfig, q, k, v, q_pos, k_pos, *, causal,
                      window) -> torch.Tensor:
    """The flash-attention kernels (``attn_impl='pallas'``), differentiable
    through their autograd Function; only causal attention over the
    sequence itself takes them, as in the reference."""
    if not causal:
        return _chunked_attention(cfg, q, k, v, q_pos, k_pos, causal=causal,
                                  window=window)
    # The reference passes q_pos[0], an array, which its wrapper turns into
    # offset 0; the sequences here always start at position 0.
    return fa_ops.flash_attention(
        q, k.contiguous(), v.contiguous(), causal=True, window=window,
        scale=_scale(cfg, q.shape[-1]), softcap=cfg.attn_softcap, q_offset=0)


_IMPLS = {
    "direct": _direct_attention,
    "chunked": _chunked_attention,
    "pallas": _kernel_attention,
}


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def attn_forward(cfg: ModelConfig, p: dict[str, torch.Tensor],
                 x: torch.Tensor, positions: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 kv_x: torch.Tensor | None = None,
                 kv_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full (train/prefill) attention. x: (B, S, D). With ``kv_x`` (B, T,
    D) it is cross-attention: keys and values come from ``kv_x`` at
    ``kv_positions``, and no rotary embedding is applied."""
    q, k, v = _project_qkv(cfg, p, x, kv_x)
    if cfg.use_rope and kv_x is None:
        q, k = rope(q, k, positions, cfg.rope_theta)
    k_pos = positions if kv_positions is None else kv_positions
    out = _IMPLS[cfg.attn_impl](cfg, q, k, v, positions, k_pos,
                                causal=causal, window=window)
    return _out_proj(p, out, x.dtype)


# ---------------------------------------------------------------------------
# KV cache (decode path)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (token, head) int8 symmetric quantisation along head_dim."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device, *, layers: int | None = None
                  ) -> dict[str, torch.Tensor]:
    hkv, hd = cfg.kv_heads_eff, cfg.hd
    shape = (batch, max_len, hkv, hd)
    if layers is not None:
        shape = (layers, *shape)
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
    }


def _cache_write(cache: dict[str, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, pos: torch.Tensor, quantized: bool) -> None:
    """Write one new (B, 1, Hkv, hd) k/v at position ``pos`` in place.

    ``pos`` is a scalar (every row at the same depth) or a (B,) vector
    (continuous batching: each slot at its own depth). Like the
    reference's ``dynamic_update_slice``, an index past the end is
    clamped to the last position: nothing is ever written out of range."""
    smax = cache["k"].shape[1]
    idx = pos.long().clamp(0, smax - 1)
    if quantized:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        upd = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        upd = {"k": k, "v": v}
    if idx.dim() == 1:
        rows = torch.arange(idx.shape[0], device=idx.device)
        for name, u in upd.items():
            cache[name][rows, idx] = u[:, 0].to(cache[name].dtype)
    else:
        for name, u in upd.items():
            cache[name].index_copy_(1, idx.reshape(1),
                                    u.to(cache[name].dtype))


def _cache_read(cfg: ModelConfig, cache: dict[str, torch.Tensor]):
    if cfg.kv_cache_dtype == "int8":
        k = dequantize_kv(cache["k"], cache["k_scale"], cfg.activation_dtype)
        v = dequantize_kv(cache["v"], cache["v_scale"], cfg.activation_dtype)
        return k, v
    return cache["k"], cache["v"]


def attn_decode(cfg: ModelConfig, p: dict[str, torch.Tensor],
                x: torch.Tensor, cache: dict[str, torch.Tensor],
                pos: torch.Tensor, *, window: int = 0
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, D); pos: a scalar int tensor (current
    position), or a (B,) int vector of per-row positions (continuous
    batching: each slot writes its k/v at, and attends up to, its own
    depth). Writes the new k/v into ``cache`` in place.

    For ``window > 0`` the cache is a ring buffer of ``window`` slots: the
    new k/v goes to slot ``pos % window`` and keys are masked by recency.
    Ring buffers take a scalar ``pos`` only (every row in lockstep)."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device)
    per_row = pos.dim() == 1
    if per_row and window > 0:
        raise ValueError("per-row decode positions are incompatible with "
                         "ring-buffer (windowed) KV caches")
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.use_rope:
        posv = pos.reshape(-1, 1) if per_row else pos.reshape(1, 1)
        q, k = rope(q, k, posv, cfg.rope_theta)

    write_pos = pos % window if window > 0 else pos
    _cache_write(cache, k, v, write_pos, cfg.kv_cache_dtype == "int8")
    ck, cv = _cache_read(cfg, cache)
    max_len = ck.shape[1]
    hkv, h, hd = ck.shape[2], q.shape[2], q.shape[-1]
    g = h // hkv
    scale = _scale(cfg, hd)

    # Decode-kernel path: the ragged per-row lengths go straight to the
    # kernel. Ring buffers and soft-capping stay on the masked-einsum path
    # below.
    if cfg.decode_impl == "pallas" and window == 0 and not cfg.attn_softcap:
        kv_len = (pos if per_row else pos.expand(b)) + 1
        out = da_ops.decode_attention(q[:, 0], ck, cv, kv_len.int(),
                                      scale=float(scale))
        return _out_proj(p, out[:, None], x.dtype), cache

    slots = torch.arange(max_len, device=x.device)
    if window > 0:
        # slot -> absolute position of the entry it holds (the ring wraps)
        cycle = (pos // window) * window
        k_pos = torch.where(slots <= pos % window, cycle + slots,
                            cycle - window + slots)
        valid = (k_pos >= 0) & (k_pos > pos - window) & (k_pos <= pos)
    elif per_row:
        valid = slots[None, :] <= pos[:, None]               # (B, Smax)
    else:
        valid = slots <= pos
    qg = q.reshape(b, 1, hkv, g, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, ck).float() * scale
    logits = _softcap(logits, cfg.attn_softcap)
    bias = torch.where(valid, 0.0, NEG_INF).float()
    if per_row:
        logits = logits + bias[:, None, None, None, :]
    else:
        logits = logits + bias[None, None, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, cv).reshape(b, 1, h, hd)
    return _out_proj(p, out, x.dtype), cache


def prefill_into_cache(cfg: ModelConfig, p: dict[str, torch.Tensor],
                       x: torch.Tensor, positions: torch.Tensor,
                       cache: dict[str, torch.Tensor], *, window: int = 0
                       ) -> tuple[torch.Tensor, dict[str, Any]]:
    """Prefill attention that also writes the prompt's k/v into ``cache``
    in place: into positions [0, S), or with ``window > 0`` the last
    ``min(window, S)`` entries into their ring slots ``pos % window``."""
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.use_rope:
        q, k = rope(q, k, positions, cfg.rope_theta)
    s = x.shape[1]
    kc, vc, n = k, v, s
    if window > 0:
        # the last min(window, S) entries, put in slot order
        n = min(window, s)
        slot = (torch.arange(n, device=k.device) + (s - n)) % window
        order = torch.argsort(slot)
        kc, vc = k[:, s - n:][:, order], v[:, s - n:][:, order]
    if n > cache["k"].shape[1]:
        raise ValueError(f"a prompt of {n} tokens does not fit a cache of "
                         f"{cache['k'].shape[1]} positions")
    if cfg.kv_cache_dtype == "int8":
        kq, ksc = quantize_kv(kc)
        vq, vsc = quantize_kv(vc)
        upd = {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
    else:
        upd = {"k": kc, "v": vc}
    for name, u in upd.items():
        cache[name][:, :n] = u
    out = _IMPLS[cfg.attn_impl](cfg, q, k, v, positions, positions,
                                causal=True, window=window)
    return _out_proj(p, out, x.dtype), cache
