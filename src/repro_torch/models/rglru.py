"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local
attention.

Counterpart of ``repro.models.rglru``. The layer pattern is the Griffin
``(recurrent, recurrent, local-attention)`` unit, and the stack is
unrolled over a **list** of per-layer parameter dicts, as in the
reference. The RG-LRU recurrence ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) *
(i_t * x_t)`` runs through the hand-written scan kernel
(:mod:`repro_torch.kernels.rglru_scan`) where ``cfg.use_pallas`` is set
and the whole sequence is at hand (prefill, loss); otherwise through the
reference's blocked plain scan.

Serving state (:func:`init_griffin_state`) is a list with one dict per
layer: ``{"h", "conv"}`` for a recurrent layer, a ring-buffer KV cache of
``min(local_window, max_len)`` slots for an attention layer. Prefill and
decode write it in place and return it; :func:`griffin_state_axes` gives
its logical sharding axes.

Under a mesh the reference's ``shard()`` sites place the embeddings, the
recurrence's input ``xr`` (its ``d_rnn`` channels over the model axis)
and the logits (the vocab over the model axis). Everything between
``xr`` and the output projection runs on each rank's own channels in one
:func:`~repro_torch.models.common.on_local_shards` call
(:func:`_rglru_core`): the causal conv is depthwise, the recurrence
elementwise, and a rank whose channels are whole gate blocks reads only
its blocks of ``w_a`` / ``w_i``. Where the model axis does not divide
``rnn_blocks`` the gate weights stay whole, a rank's channels cut
through blocks, and it reads the whole of the blocks they fall in
(:func:`_channel_plan`).
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (
    ModelConfig,
    ParamSpec,
    causal_conv,
    embed_rows,
    gelu_tanh,
    is_dtensor,
    local_offsets,
    maybe_remat,
    mul_scalar,
    on_local_shards,
    rms_norm,
    shard,
    sigmoid,
    softmax_cross_entropy,
    store_state,
)

RG_LRU_C = 8.0


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def make_rglru_block_specs(cfg: ModelConfig) -> dict[str, Any]:
    d, dr = cfg.d_model, cfg.d_rnn or cfg.d_model
    w = cfg.conv_width
    nb = cfg.rnn_blocks
    blk = dr // nb
    # block-diagonal gates (nb blocks), as in the reference
    return {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        "w_y": ParamSpec((d, dr), ("embed", "rnn_tp")),        # gate branch
        "w_x": ParamSpec((d, dr), ("embed", "rnn_tp")),        # recurrence
        "conv_w": ParamSpec((w, dr), (None, "rnn_tp")),
        "conv_b": ParamSpec((dr,), ("rnn_tp",), init="zeros"),
        "w_a": ParamSpec((nb, blk, blk), ("rnn_blocks", None, None)),
        "b_a": ParamSpec((dr,), ("rnn_tp",), init="zeros"),
        "w_i": ParamSpec((nb, blk, blk), ("rnn_blocks", None, None)),
        "b_i": ParamSpec((dr,), ("rnn_tp",), init="zeros"),
        "lam": ParamSpec((dr,), ("rnn_tp",), init="rglru_lambda"),
        "w_o": ParamSpec((dr, d), ("rnn_tp", "embed")),
    }


def make_attn_block_specs(cfg: ModelConfig) -> dict[str, Any]:
    return {
        "ln": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn.make_attn_specs(cfg),
    }


def make_mlp_block_specs(cfg: ModelConfig) -> dict[str, Any]:
    return {
        "ln": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "mlp": mlp_mod.make_mlp_specs(cfg),
    }


def layer_kinds(cfg: ModelConfig) -> list[str]:
    pattern = cfg.block_pattern or ("rglru", "rglru", "attn")
    return [pattern[i % len(pattern)] for i in range(cfg.num_layers)]


def make_griffin_specs(cfg: ModelConfig) -> dict[str, Any]:
    layers = []
    for kind in layer_kinds(cfg):
        if kind == "rglru":
            layers.append({"kind_rglru": make_rglru_block_specs(cfg),
                           "mlp_block": make_mlp_block_specs(cfg)})
        else:
            layers.append({"kind_attn": make_attn_block_specs(cfg),
                           "mlp_block": make_mlp_block_specs(cfg)})
    return {
        "embedding": ParamSpec((cfg.padded_vocab, cfg.d_model),
                               ("vocab", "embed")),
        "layers": layers,
        "ln_final": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def rglru_gates(p: dict[str, torch.Tensor], xr: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decay ``a`` and gated input ``sqrt(1 - a^2) * i * x``, both fp32,
    from the post-conv input ``xr (..., dr)``. The gates are
    block-diagonal: w_a/w_i are (nb, blk, blk)."""
    nb, blk, _ = p["w_a"].shape
    xb = xr.float().reshape(*xr.shape[:-1], nb, blk)
    ra = torch.einsum("...bk,bko->...bo", xb, p["w_a"].float())
    ia = torch.einsum("...bk,bko->...bo", xb, p["w_i"].float())
    ra = ra.reshape(xr.shape) + p["b_a"].float()
    ia = ia.reshape(xr.shape) + p["b_i"].float()
    r = sigmoid(ra)
    i = sigmoid(ia)
    log_a = -RG_LRU_C * r * F.softplus(p["lam"].float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * (i * xr.float())


def _associative_scan(fn: Callable, elems: tuple[torch.Tensor, ...]
                      ) -> tuple[torch.Tensor, ...]:
    """Inclusive scan of ``elems`` along dim 1 under the associative ``fn``,
    by the odd/even recursion of ``jax.lax.associative_scan``: the same
    pairs are combined in the same order."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _associative_scan(fn, fn(tuple(e[:, 0:-1:2] for e in elems),
                                   tuple(e[:, 1::2] for e in elems)))
    rest = tuple(e[:, 2::2] for e in elems)
    even = fn(tuple(e[:, :-1] for e in odd) if n % 2 == 0 else odd, rest)
    out = []
    for e, ev, od in zip(elems, even, odd):   # interleave even and odd slots
        t = e.new_empty(e.shape)
        t[:, 0::2] = torch.cat([e[:, :1], ev], dim=1)
        t[:, 1::2] = od
        out.append(t)
    return tuple(out)


def _combine(c1, c2):
    a1, x1 = c1
    a2, x2 = c2
    return a1 * a2, x2 + a2 * x1


def rglru_scan_ref(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor,
                   block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked plain scan (the reference's ``use_pallas=False`` route).
    a, bx: (B, S, dr) fp32; h0: (B, dr). A sequential loop over time
    blocks with an associative scan inside each block. Returns (h over all
    t, final h)."""
    b, s, dr = a.shape
    blk = min(block, s)
    while s % blk:
        blk //= 2
    h = h0
    hs = []
    for j in range(0, s, blk):
        a_acc, x_acc = _associative_scan(
            _combine, (a[:, j:j + blk], bx[:, j:j + blk]))
        hb = x_acc + a_acc * h[:, None, :]
        h = hb[:, -1, :]
        hs.append(hb)
    return torch.cat(hs, dim=1), h


def _causal_conv(p: dict[str, torch.Tensor], x: torch.Tensor,
                 state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. x: (B, S, dr); state: (B, w-1, dr).
    Taps are summed in fp32 in the reference's order."""
    return causal_conv(p["conv_w"], p["conv_b"], x, state)


#: the leaves of a recurrent block that :func:`_rglru_core` reads, in its
#: argument order
_CORE_LEAVES = ("conv_w", "conv_b", "w_a", "w_i", "b_a", "b_i", "lam")


def _channel_plan(p: dict[str, Any], xr: torch.Tensor
                  ) -> tuple[bool, int, int, int]:
    """How a rank's channels of ``xr (B, S, dr)`` meet the gate blocks:
    (whether its blocks are cut, so that the conv and the gates take the
    whole ``xr`` and their weights whole; the first and last + 1 channel
    of the blocks its channels fall in; its first channel). Without a
    mesh, or where each rank's channels are whole blocks (the model axis
    divides ``rnn_blocks``, and ``w_a`` / ``w_i`` are split with them),
    every tensor is the rank's own: (False, 0, its channels, 0)."""
    dl = xr.to_local().shape[-1] if is_dtensor(xr) else xr.shape[-1]
    w_a = p["w_a"]
    nbl = w_a.to_local().shape[0] if is_dtensor(w_a) else w_a.shape[0]
    blk = w_a.shape[1]
    if nbl * blk == dl:
        return False, 0, dl, 0
    first = local_offsets(xr)[-1]
    return True, first // blk * blk, -(-(first + dl) // blk) * blk, first


def _rglru_core(use_pallas: bool, cut: bool, lo: int, hi: int, first: int,
                xr: torch.Tensor, h0: torch.Tensor | None,
                conv_state: torch.Tensor | None, conv_w, conv_b, w_a, w_i,
                b_a, b_i, lam
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The causal conv, the gates and the scan on plain tensors: (h over
    all t (B, S, dr) fp32, the final h, the new conv state). Under a mesh
    a rank's own channels; with ``cut`` the conv and the gates run on
    channels ``lo:hi`` of the whole ``xr``, conv weights, conv state and
    per-channel leaves (the whole blocks that channels ``first`` ..
    ``first + dr_local`` fall in), and their results are cut to the
    rank's channels."""
    p = {"conv_w": conv_w, "conv_b": conv_b, "b_a": b_a, "b_i": b_i,
         "lam": lam}
    if cut:
        blk = w_a.shape[1]
        p = {k: v[..., lo:hi] for k, v in p.items()}
        xr = xr[..., lo:hi]
        if conv_state is not None:
            conv_state = conv_state[..., lo:hi]
        w_a, w_i = w_a[lo // blk:hi // blk], w_i[lo // blk:hi // blk]
    xr, new_conv = _causal_conv(p, xr, conv_state)
    a, bx = rglru_gates(dict(p, w_a=w_a, w_i=w_i), xr)
    if cut:
        own = slice(first - lo, first - lo + h0.shape[-1])
        a, bx = a[..., own], bx[..., own]
        new_conv = new_conv[..., own]
    if h0 is None:
        h0 = a.new_zeros((a.shape[0], a.shape[-1]))
    if use_pallas:
        return (*rg_ops.rglru_scan(a, bx, h0), new_conv)
    return (*rglru_scan_ref(a, bx, h0), new_conv)


def rglru_block_forward(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
                        state: dict[str, torch.Tensor] | None = None,
                        use_pallas: bool = False
                        ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full-sequence recurrent block. Returns (out, new_state)."""
    dt = x.dtype
    bsz, s = x.shape[:2]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    y = gelu_tanh(h @ p["w_y"].to(dt))
    xr = shard(h @ p["w_x"].to(dt), "batch", "act_seq_rnn", "rnn_sharded")
    dr = xr.shape[-1]
    cut, lo, hi, first = _channel_plan(p, xr)
    h0 = conv_state = None
    if state is not None:
        h0, conv_state = state["h"].float(), state["conv"]
    elif cut:       # the rank's own channels of the zero state
        h0 = shard(torch.zeros((bsz, dr), dtype=torch.float32,
                               device=x.device), "batch", "rnn_sharded")
    # the whole sequence on every rank; with cut blocks every channel of
    # the conv's and the gates' inputs and weights
    own = "rnn_sharded"
    act, wt, blocks = ((None, None, None) if cut
                       else (own, "rnn_tp", "rnn_blocks"))
    hs, h_last, new_conv = on_local_shards(
        functools.partial(_rglru_core, use_pallas, cut, lo, hi, first),
        (xr, h0, conv_state, *(p[k] for k in _CORE_LEAVES)),
        (("batch", None, act),
         None if h0 is None else ("batch", own),
         None if conv_state is None else ("batch", None, act),
         (None, wt), (wt,), (blocks, None, None), (blocks, None, None),
         (wt,), (wt,), (wt,)),
        outs=(((bsz, s, dr), ("batch", None, own)),
              ((bsz, dr), ("batch", own)),
              ((bsz, cfg.conv_width - 1, dr), ("batch", None, own))))
    hs = hs.to(dt) * y
    out = hs @ p["w_o"].to(dt)
    return out, {"h": h_last, "conv": new_conv}


def rglru_block_decode(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
                       state: dict[str, torch.Tensor]
                       ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Single-token step. x: (B, 1, D). As in the reference, a decode step
    runs the plain one-step scan and never the kernel: that is the
    reference's route (``use_pallas`` is not passed), not a fallback."""
    return rglru_block_forward(cfg, p, x, state)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: dict[str, Any],
           tokens: torch.Tensor) -> torch.Tensor:
    """Gemma-style scaled embedding rows in the activation dtype."""
    x = embed_rows(params["embedding"].to(cfg.activation_dtype), tokens)
    return shard(mul_scalar(x, cfg.d_model ** 0.5), "batch", "act_seq", None)


def _logits(params: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Tied head: (B, S, D) @ embedding^T."""
    return shard(x @ params["embedding"].to(x.dtype).T,
                 "batch", "act_seq", "vocab_sharded")


def _mlp_sub(cfg: ModelConfig, p: dict[str, Any],
             x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + mlp_mod.mlp_forward(cfg, p["mlp"], h)


def griffin_forward(cfg: ModelConfig, params: dict[str, Any],
                    batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits over the whole sequence, (B, S, Vp)."""
    x = _embed(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(x, p, kind):
        if kind == "rglru":
            out, _ = rglru_block_forward(cfg, p["kind_rglru"], x,
                                         use_pallas=cfg.use_pallas)
            x = x + out
        else:
            h = rms_norm(x, p["kind_attn"]["ln"], cfg.norm_eps)
            x = x + attn.attn_forward(cfg, p["kind_attn"]["attn"], h,
                                      positions, causal=True,
                                      window=cfg.local_window)
        return _mlp_sub(cfg, p["mlp_block"], x)

    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        fn = maybe_remat(lambda x, p, k=kind: layer(x, p, k),
                         cfg.remat_policy)
        x = fn(x, p)
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    return _logits(params, x)


def griffin_loss(cfg: ModelConfig, params: dict[str, Any],
                 batch: dict[str, torch.Tensor]
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    logits = griffin_forward(cfg, params, batch)
    loss, denom = softmax_cross_entropy(logits, batch["labels"],
                                        batch.get("mask"), cfg.vocab_size)
    return loss, {"ce_loss": loss, "tokens": denom,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_griffin_state(cfg: ModelConfig, batch: int, max_len: int,
                       device: torch.device) -> list[dict[str, torch.Tensor]]:
    dr = cfg.d_rnn or cfg.d_model
    states: list[dict[str, torch.Tensor]] = []
    for kind in layer_kinds(cfg):
        if kind == "rglru":
            states.append({
                "h": torch.zeros((batch, dr), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1, dr),
                                    dtype=cfg.activation_dtype,
                                    device=device),
            })
        else:
            w = min(cfg.local_window or max_len, max_len)
            states.append(attn.init_kv_cache(cfg, batch, w, device))
    return states


def griffin_state_axes(cfg: ModelConfig) -> list[dict]:
    axes: list[dict] = []
    for kind in layer_kinds(cfg):
        if kind == "rglru":
            axes.append({"h": ("batch", "rnn_sharded"),
                         "conv": ("batch", None, "rnn_sharded")})
        else:
            axes.append(attn.kv_cache_axes(cfg, layers=False))
    return axes


def griffin_prefill(cfg: ModelConfig, params: dict[str, Any],
                    batch: dict[str, torch.Tensor],
                    states: list[dict[str, torch.Tensor]]
                    ) -> tuple[torch.Tensor, list[dict[str, torch.Tensor]]]:
    """Run the prompt through the stack, writing every layer's state in
    place. Returns (last-position logits (B, 1, Vp), states)."""
    x = _embed(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for p, kind, st in zip(params["layers"], layer_kinds(cfg), states):
        if kind == "rglru":
            out, ns = rglru_block_forward(cfg, p["kind_rglru"], x,
                                          use_pallas=cfg.use_pallas)
            store_state(st, ns)
            x = x + out
        else:
            h = rms_norm(x, p["kind_attn"]["ln"], cfg.norm_eps)
            a, _ = attn.prefill_into_cache(cfg, p["kind_attn"]["attn"], h,
                                           positions, st,
                                           window=cfg.local_window)
            x = x + a
        x = _mlp_sub(cfg, p["mlp_block"], x)
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    return _logits(params, x[:, -1:]), states


def griffin_decode_step(cfg: ModelConfig, params: dict[str, Any],
                        states: list[dict[str, torch.Tensor]],
                        tokens: torch.Tensor, pos: torch.Tensor
                        ) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """One decode step. tokens: (B, 1); pos: a scalar position (the ring
    buffers take no per-row positions). Writes the states in place."""
    x = _embed(cfg, params, tokens)
    for p, kind, st in zip(params["layers"], layer_kinds(cfg), states):
        if kind == "rglru":
            out, ns = rglru_block_decode(cfg, p["kind_rglru"], x, st)
            store_state(st, ns)
            x = x + out
        else:
            h = rms_norm(x, p["kind_attn"]["ln"], cfg.norm_eps)
            a, _ = attn.attn_decode(cfg, p["kind_attn"]["attn"], h, st, pos,
                                    window=cfg.local_window)
            x = x + a
        x = _mlp_sub(cfg, p["mlp_block"], x)
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    return _logits(params, x), states
