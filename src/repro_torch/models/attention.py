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

Under a mesh (:class:`~repro_torch.models.common.axis_rules`) the
activations and the cache are DTensors placed by the reference's
``shard`` sites (:func:`kv_cache_axes` for the cache). The kernels take
plain tensors, so each runs on every rank's local shards
(:func:`~repro_torch.models.common.on_local_shards`), as does every
route of the full attention (:func:`_attention`): under
``attn_sharding="heads"`` a rank holds H/model query and Hkv/model KV
heads, the group size unchanged (where model does not divide Hkv the KV
heads stay whole on every rank, and the kernel reads only those its
query heads map to: :func:`_kv_heads_read`); under ``"sequence"`` the kernel's
inputs are first gathered along the sequence dim, as GSPMD does for an
opaque custom call. A cache write lands on the rank that owns the
position, in its local shard.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import (ModelConfig, ParamSpec, as_dtensor,
                                       is_dtensor, local_offsets,
                                       on_local_shards, rms_norm, rope, shard)

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


def _shard_qkv(cfg: ModelConfig, q, k, v):
    if cfg.attn_sharding == "heads":
        q = shard(q, "batch", None, "heads_sharded", None)
        k = shard(k, "batch", None, "kv_heads_sharded", None)
        v = shard(v, "batch", None, "kv_heads_sharded", None)
    else:  # sequence/context parallel: shard q along seq, kv batch-only
        q = shard(q, "batch", "seq_sharded", None, None)
        k = shard(k, "batch", None, None, None)
        v = shard(v, "batch", None, None, None)
    return q, k, v


def _shard_out(cfg: ModelConfig, out: torch.Tensor) -> torch.Tensor:
    """The attention output before its projection: head-sharded under
    ``"heads"``; under ``"sequence"`` whole along the sequence (the
    reference shards it there), since DTensor (torch 2.11) cannot flatten
    a sharded sequence with the batch for the projection's product."""
    return shard(out, "batch", None, "heads_sharded", None)


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


def _kv_heads_read(q: torch.Tensor, k: torch.Tensor, qdim: int
                   ) -> torch.Tensor | None:
    """The KV heads that this rank's query heads read, where the rules
    split the query heads (dim ``qdim`` of ``q``) but not the KV heads
    (dim 2 of ``k``); else None.

    ``resolve_spec`` leaves the Hkv heads whole when model does not divide
    them, while H/model query heads stay on each rank, so the local group
    is no longer H/Hkv. Global query head i reads KV head i // (H/Hkv).
    The local heads fall into blocks of gcd(H/model, H/Hkv), each inside
    one KV group, and the kernel takes one KV head per block: the returned
    indices, in order."""
    if not (is_dtensor(q) and is_dtensor(k)):
        return None
    h, hkv = q.shape[qdim], k.shape[2]
    hl = q.to_local().shape[qdim]
    if hl == h or k.to_local().shape[2] != hkv:
        return None
    g = h // hkv
    first = local_offsets(q)[qdim]
    return torch.arange(first, first + hl, math.gcd(hl, g),
                        device=k.device) // g


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
        scale=_scale(cfg, q.shape[-1]), softcap=cfg.attn_softcap,
        q_offset=0)


_IMPLS = {
    "direct": _direct_attention,
    "chunked": _chunked_attention,
    "pallas": _kernel_attention,
}


def _attention(cfg: ModelConfig, q, k, v, q_pos, k_pos, *, causal,
               window) -> torch.Tensor:
    """``cfg.attn_impl``'s attention, under a mesh on each rank's local
    shards (:func:`~repro_torch.models.common.on_local_shards`): the
    kernels take ``data_ptr()``s, and DTensor's rules for the grouped
    einsums' reshapes differ across torch versions (2.11 refuses to
    flatten a sharded head dim with the batch). Under
    ``attn_sharding="heads"`` a rank takes its H/model query heads and the
    KV heads they read (:func:`_kv_heads_read`); under ``"sequence"`` the
    whole sequence, gathered first."""
    kv_heads = None
    if cfg.attn_sharding == "heads":
        q_axes = ("batch", None, "heads_sharded", None)
        kv_axes = ("batch", None, "kv_heads_sharded", None)
        kv_heads = _kv_heads_read(q, k, 2)
    else:   # the whole sequence on every rank
        q_axes = kv_axes = ("batch", None, None, None)
    impl = _IMPLS[cfg.attn_impl]

    def local(q, k, v):
        if kv_heads is not None:
            k, v = k.index_select(2, kv_heads), v.index_select(2, kv_heads)
        return impl(cfg, q, k, v, q_pos, k_pos, causal=causal, window=window)

    return on_local_shards(local, (q, k, v), (q_axes, kv_axes, kv_axes))


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
    q, k, v = _shard_qkv(cfg, q, k, v)
    k_pos = positions if kv_positions is None else kv_positions
    out = _attention(cfg, q, k, v, positions, k_pos, causal=causal,
                     window=window)
    return _out_proj(p, _shard_out(cfg, out), x.dtype)


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


def kv_cache_axes(cfg: ModelConfig, *, layers: bool = True
                  ) -> dict[str, tuple]:
    """Logical axes of the cache (leading 'layers' when stacked)."""
    lead = ("layers",) if layers else ()
    if cfg.attn_sharding == "heads":
        ax = lead + ("kv_batch", None, "kv_heads_sharded", None)
    else:
        ax = lead + ("kv_batch", "kv_seq_sharded", None, None)
    out = {"k": ax, "v": ax}
    if cfg.kv_cache_dtype == "int8":
        out["k_scale"] = ax[:-1] + (None,)
        out["v_scale"] = ax[:-1] + (None,)
    return out


def _write_local(buf: torch.Tensor, u: torch.Tensor, write) -> None:
    """``write(buf, u, row0, pos0)`` on the tensors this rank holds: for a
    DTensor ``buf`` (B, Smax, ...), its local shard, whose first row and
    position are ``row0`` and ``pos0`` of the whole, and ``u`` (B, n, ...)
    placed like it but whole along the position dim; else ``buf`` and
    ``u`` themselves at 0, 0."""
    if not is_dtensor(buf):
        write(buf, u.to(buf.dtype), 0, 0)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = buf.device_mesh
    pl = tuple(Replicate() if p == Shard(1) else p for p in buf.placements)
    u_local = as_dtensor(u, mesh).redistribute(mesh, pl).to_local()
    row0, pos0 = local_offsets(buf)[:2]
    write(buf.to_local(), u_local.to(buf.dtype), row0, pos0)


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
    # one row index for every tensor of the cache (a shard's rows are the
    # first b of them)
    rows = (torch.arange(k.shape[0], device=idx.device) if idx.dim() == 1
            else None)

    def write(buf, u, row0, pos0):
        b, n = buf.shape[0], buf.shape[1]
        i, r = idx, rows
        if b != k.shape[0] and idx.dim() == 1:       # a shard of the rows
            i, r = idx[row0:row0 + b], rows[:b]
        if pos0 == 0 and n == smax:
            if i.dim() == 1:
                buf[r, i] = u[:, 0]
            else:
                buf.index_copy_(1, i.reshape(1), u)
            return
        # a shard of the positions: the rank that holds position i writes
        # it; the others write back what their clamped slot held
        if r is None:
            r = torch.arange(b, device=i.device)
        local = (i - pos0).clamp(0, n - 1).expand(b)
        keep = ((i >= pos0) & (i < pos0 + n)).expand(b)
        keep = keep.reshape(b, *([1] * (u.dim() - 2)))
        buf[r, local] = torch.where(keep, u[:, 0], buf[r, local])

    for name, u in upd.items():
        _write_local(cache[name], u, write)


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
    # decode activations follow the cache's batch sharding (kv_batch)
    if cfg.attn_sharding == "heads":
        ck = shard(ck, "kv_batch", None, "kv_heads_sharded", None)
        cv = shard(cv, "kv_batch", None, "kv_heads_sharded", None)
        q = shard(q, "kv_batch", None, "heads_sharded", None)
    else:
        ck = shard(ck, "kv_batch", "kv_seq_sharded", None, None)
        cv = shard(cv, "kv_batch", "kv_seq_sharded", None, None)
        q = shard(q, "kv_batch", None, None, None)
    max_len, hd = ck.shape[1], q.shape[-1]
    scale = _scale(cfg, hd)
    # both routes run on each rank's local shards: its heads and the KV
    # heads they read, or under "sequence" every cache position
    kv_heads = None
    if cfg.attn_sharding == "heads":
        q_axes = ("kv_batch", None, "heads_sharded", None)
        kv_axes = ("kv_batch", None, "kv_heads_sharded", None)
        kv_heads = _kv_heads_read(q, ck, 2)
    else:
        q_axes = kv_axes = ("kv_batch", None, None, None)

    def heads_read(k, v):
        if kv_heads is None:
            return k, v
        return k.index_select(2, kv_heads), v.index_select(2, kv_heads)

    # Decode-kernel path: the ragged per-row lengths go straight to the
    # kernel. Ring buffers and soft-capping stay on the masked-einsum path
    # below.
    if cfg.decode_impl == "pallas" and window == 0 and not cfg.attn_softcap:
        kv_len = (pos if per_row else pos.expand(b)) + 1

        def decode(q, k, v, lens):
            k, v = heads_read(k, v)
            return da_ops.decode_attention(q[:, 0], k, v, lens,
                                           scale=float(scale))[:, None]

        out = on_local_shards(decode, (q, ck, cv, kv_len.int()),
                              (q_axes, kv_axes, kv_axes, ("kv_batch",)))
        out = shard(out, "kv_batch", None, "heads_sharded", None)
        return _out_proj(p, out, x.dtype), cache

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
    bias = torch.where(valid, 0.0, NEG_INF).float()

    def masked(q, k, v, bias):
        k, v = heads_read(k, v)
        rows, h, hkv = q.shape[0], q.shape[2], k.shape[2]
        qg = q.reshape(rows, 1, hkv, h // hkv, hd)
        logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
        logits = _softcap(logits, cfg.attn_softcap)
        if per_row:
            logits = logits + bias[:, None, None, None, :]
        else:
            logits = logits + bias[None, None, None, None, :]
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bkgst,btkh->bskgh", probs, v).reshape(
            rows, 1, h, hd)

    out = on_local_shards(masked, (q, ck, cv, bias),
                          (q_axes, kv_axes, kv_axes,
                           ("kv_batch", None) if per_row else (None,)))
    out = shard(out, "kv_batch", None, "heads_sharded", None)
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
    q, k, v = _shard_qkv(cfg, q, k, v)
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

    def write(buf, u, row0, pos0):
        lo, hi = max(pos0, 0), min(pos0 + buf.shape[1], n)
        if lo < hi:
            buf[:, lo - pos0:hi - pos0] = u[:, lo:hi]

    for name, u in upd.items():
        _write_local(cache[name], u, write)
    out = _attention(cfg, q, k, v, positions, positions, causal=True,
                     window=window)
    return _out_proj(p, _shard_out(cfg, out), x.dtype), cache
