"""xLSTM (arXiv:2405.04517): mLSTM (matrix memory) + sLSTM (scalar memory).

Counterpart of ``repro.models.xlstm``. Every 8th block is an sLSTM, the
rest are mLSTM; blocks carry their own up/down projections (``d_ff = 0``).
The stack is unrolled over a **list** of per-layer parameter dicts
(``{"mlstm": ...}`` or ``{"slstm": ...}``), as in the reference.

* The mLSTM cell takes the reference's routes: the hand-written
  chunkwise kernel (:mod:`repro_torch.kernels.mlstm_chunk`) where
  ``cfg.use_pallas`` is set and S > 1, the exact one-step recurrence where
  S == 1 (a decode step), the plain chunkwise form otherwise (also the
  training path: the kernel, like the reference's, has no backward).
* The sLSTM has a recurrent dependency on h_{t-1}: a Python loop over time
  (the reference's ``lax.scan``).

Serving state (:func:`init_xlstm_state`) is a list with one dict per
layer: ``{"C", "n", "m", "conv"}`` for an mLSTM layer, ``{"c", "n", "m",
"h", "conv"}`` for an sLSTM layer. Prefill and decode write it in place
and return it; :func:`xlstm_state_axes` gives its logical sharding axes.

Under a mesh the reference's ``shard()`` sites place the embeddings and
each block's residual output (batch over the data axes) and the logits
(the vocab over the model axis). The inner activations stay whole on the
model axis, as the reference's site leaves them: the up-projection is
gathered there, and each block's cell (the mLSTM's conv, gates, kernel
or recurrence and group norm; the sLSTM's conv, gates, whole per-step
loop and group norm) runs in one
:func:`~repro_torch.models.common.on_local_shards` call on each rank's
rows, with its weights whole. The projections around the cells stay
split over the model axis.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_chunk import ops as ml_ops
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunkwise_ref,
                                                 mlstm_recurrent_ref)
from repro_torch.models.common import (
    ModelConfig,
    ParamSpec,
    causal_conv,
    embed_rows,
    gelu_tanh,
    layer_norm,
    maybe_remat,
    on_local_shards,
    shard,
    sigmoid,
    silu,
    softmax_cross_entropy,
    store_state,
)

NEG_INIT = -1e30                      # the stabilisers' initial m


def d_inner(cfg: ModelConfig) -> int:
    return int(cfg.d_model * cfg.mlstm_proj_factor)


def head_dim(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.num_heads


def slstm_positions(cfg: ModelConfig) -> set[int]:
    return {i for i in range(cfg.num_layers) if i % 8 == 7}


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def make_mlstm_block_specs(cfg: ModelConfig) -> dict[str, Any]:
    d, di, h = cfg.d_model, d_inner(cfg), cfg.num_heads
    hd = di // h
    w = cfg.slstm_conv_width
    return {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        "ln_b": ParamSpec((d,), ("embed",), init="zeros"),
        "w_up": ParamSpec((d, 2 * di), ("embed", "xlstm_inner")),
        "conv_w": ParamSpec((w, di), (None, "xlstm_inner")),
        "conv_b": ParamSpec((di,), ("xlstm_inner",), init="zeros"),
        "w_q": ParamSpec((h, hd, hd), (None, "xlstm_hd", "xlstm_hd_out")),
        "w_k": ParamSpec((h, hd, hd), (None, "xlstm_hd", "xlstm_hd_out")),
        "w_v": ParamSpec((h, hd, hd), (None, "xlstm_hd", "xlstm_hd_out")),
        "w_i": ParamSpec((di, h), ("xlstm_inner", None)),
        "b_i": ParamSpec((h,), (None,), init="zeros"),
        "w_f": ParamSpec((di, h), ("xlstm_inner", None)),
        "b_f": ParamSpec((h,), (None,), init="ones"),
        "gn_scale": ParamSpec((di,), ("xlstm_inner",), init="ones"),
        "w_down": ParamSpec((di, d), ("xlstm_inner", "embed")),
    }


def make_slstm_block_specs(cfg: ModelConfig) -> dict[str, Any]:
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    w = cfg.slstm_conv_width
    dff = int(d * 4 / 3)
    blk = ParamSpec((h, hd, hd), (None, "xlstm_hd", "xlstm_hd_out"))
    return {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        "ln_b": ParamSpec((d,), ("embed",), init="zeros"),
        "conv_w": ParamSpec((w, d), (None, "embed")),
        "conv_b": ParamSpec((d,), ("embed",), init="zeros"),
        # gate input weights (block-diagonal per head) + recurrent weights
        "w_i": blk, "w_f": blk, "w_z": blk, "w_o": blk,
        "r_i": blk, "r_f": blk, "r_z": blk, "r_o": blk,
        "b_i": ParamSpec((d,), ("embed",), init="zeros"),
        "b_f": ParamSpec((d,), ("embed",), init="ones"),
        "b_z": ParamSpec((d,), ("embed",), init="zeros"),
        "b_o": ParamSpec((d,), ("embed",), init="zeros"),
        "gn_scale": ParamSpec((d,), ("embed",), init="ones"),
        "w_up1": ParamSpec((d, dff), ("embed", "ffn")),
        "w_up2": ParamSpec((d, dff), ("embed", "ffn")),
        "w_down": ParamSpec((dff, d), ("ffn", "embed")),
    }


def make_xlstm_specs(cfg: ModelConfig) -> dict[str, Any]:
    slstm = slstm_positions(cfg)
    layers = [{"slstm": make_slstm_block_specs(cfg)} if i in slstm
              else {"mlstm": make_mlstm_block_specs(cfg)}
              for i in range(cfg.num_layers)]
    return {
        "embedding": ParamSpec((cfg.padded_vocab, cfg.d_model),
                               ("vocab", "embed")),
        "layers": layers,
        "ln_final": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln_final_b": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "lm_head": ParamSpec((cfg.d_model, cfg.padded_vocab),
                             ("embed", "vocab")),
    }


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

#: depthwise causal conv, ``(w, b, x, state) -> (out, new state)``
_causal_conv = causal_conv


def _group_norm(x: torch.Tensor, scale: torch.Tensor, heads: int,
                eps: float = 1e-6) -> torch.Tensor:
    """Per-head group norm over the head dim, x: (..., heads * hd), with the
    population variance (``jnp.var``)."""
    dt = x.dtype
    shp = x.shape
    xh = x.reshape(*shp[:-1], heads, shp[-1] // heads).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = (xh - mu).square().mean(dim=-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(shp) * scale.float()).to(dt)


def _blockdiag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-head linear. x: (..., H, hd); w: (H, hd, hd_out)."""
    return torch.einsum("...hk,hko->...ho", x, w.to(x.dtype))


#: the stabilised chunkwise mLSTM, differentiable: ``(q, k, v, li, lf, C0,
#: n0, m0, *, chunk) -> (h, (C, n, m))``. It is the kernel body's plain
#: version; the reference's model function masks D with -inf and does not
#: clamp m0, which gives the same numbers for every state the model
#: carries (m0 >= -1e30, and a masked entry is never a row's maximum)
mlstm_chunkwise = mlstm_chunkwise_ref


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def _mlstm_up(cfg: ModelConfig, p: dict[str, Any],
              x: torch.Tensor) -> torch.Tensor:
    """The block's norm and up-projection (B, S, 2 * di), whole on the
    model axis: the reference's site on ``xm`` (inner activations
    replicated on the model axis: the (B, S, di) -> (B, S, H, hd) head
    reshape does not commute with a di-sharding), taken before the split
    so that ``z`` is whole too (``w_up``'s columns are split over it)."""
    h = layer_norm(x, p["ln"], p["ln_b"], cfg.norm_eps)
    return shard(h @ p["w_up"].to(x.dtype), "batch", "act_seq_rnn", None)


def _mlstm_qkv_gates(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
                     conv_state: torch.Tensor | None = None):
    """x: (B, S, D) -> q, k, v (B, H, S, hd) (transposed views with a unit
    stride on hd), gates li, lf (B, H, S) fp32, z, new conv state."""
    return _split_qkv_gates(cfg, p, _mlstm_up(cfg, p, x), conv_state)


def _split_qkv_gates(cfg: ModelConfig, p: dict[str, Any], up: torch.Tensor,
                     conv_state: torch.Tensor | None):
    """:func:`_mlstm_qkv_gates` from the up-projection ``up``."""
    di = up.shape[-1] // 2
    xm, z = up[..., :di], up[..., di:]
    xc, new_conv = _causal_conv(p["conv_w"], p["conv_b"], xm, conv_state)
    xc = silu(xc)
    nh = cfg.num_heads
    hd = di // nh
    xch = xc.reshape(*xc.shape[:-1], nh, hd)
    xmh = xm.reshape(*xm.shape[:-1], nh, hd)
    q = _blockdiag(xch, p["w_q"]).transpose(1, 2)          # (B,H,S,hd)
    k = _blockdiag(xch, p["w_k"]).transpose(1, 2)
    v = _blockdiag(xmh, p["w_v"]).transpose(1, 2)
    ig = xc.float() @ p["w_i"].float() + p["b_i"].float()
    fg = xc.float() @ p["w_f"].float() + p["b_f"].float()
    li = ig.transpose(1, 2)                                 # (B,H,S)
    lf = F.logsigmoid(fg).transpose(1, 2)                   # -softplus(-fg)
    return q, k, v, li, lf, z, new_conv


#: the leaves of an mLSTM block that its cell reads, in argument order
_MLSTM_CELL = ("conv_w", "conv_b", "w_q", "w_k", "w_v", "w_i", "b_i", "w_f",
               "b_f", "gn_scale")
#: the leaves of an sLSTM block that its cell reads, in argument order
_SLSTM_CELL = ("conv_w", "conv_b", "w_i", "w_f", "w_z", "w_o", "r_i", "r_f",
               "r_z", "r_o", "b_i", "b_f", "b_z", "b_o", "gn_scale")


def _whole(t: torch.Tensor) -> tuple[None, ...]:
    return (None,) * t.dim()


def _cell_on_local_shards(cfg: ModelConfig, cell, names: tuple[str, ...],
                          p: dict[str, Any], inp: torch.Tensor,
                          state: dict[str, torch.Tensor] | None,
                          state_names: tuple[str, ...], out_dim: int):
    """``cell(cfg, inp, *weights, *state)`` on each rank's rows, its
    weights whole (:func:`~repro_torch.models.common.on_local_shards`);
    returns (its output (B, S, out_dim), its new state by
    ``state_names``), placed by :func:`xlstm_state_axes`."""
    bsz, s = inp.shape[:2]
    axes = _block_state_axes("C" in state_names)
    st = [None] * len(state_names) if state is None else [
        state[n] for n in state_names]
    shapes = _block_state_shapes(cfg, bsz, "C" in state_names)
    outs = on_local_shards(
        functools.partial(cell, cfg),
        (inp, *(p[n] for n in names), *st),
        (("batch", None, None), *(_whole(p[n]) for n in names),
         *(None if t is None else axes[n] for n, t in zip(state_names, st))),
        outs=(((bsz, s, out_dim), ("batch", None, None)),
              *((shapes[n], axes[n]) for n in state_names)))
    return outs[0], dict(zip(state_names, outs[1:]))


def _mlstm_cell(cfg: ModelConfig, up: torch.Tensor, conv_w, conv_b, w_q, w_k,
                w_v, w_i, b_i, w_f, b_f, gn_scale, conv_state, C0, n0, m0):
    """The mLSTM cell on plain tensors, from the up-projection to the
    gated, normed output before the down-projection: (out (B, S, di),
    conv state, C, n, m)."""
    p = dict(zip(_MLSTM_CELL, (conv_w, conv_b, w_q, w_k, w_v, w_i, b_i, w_f,
                               b_f, gn_scale)))
    bsz, s = up.shape[:2]
    di = up.shape[-1] // 2
    nh = cfg.num_heads
    hd = di // nh
    q, k, v, li, lf, z, new_conv = _split_qkv_gates(cfg, p, up, conv_state)
    if C0 is None:
        f32 = dict(dtype=torch.float32, device=up.device)
        C0 = torch.zeros((bsz, nh, hd, hd), **f32)
        n0 = torch.zeros((bsz, nh, hd), **f32)
        m0 = torch.full((bsz, nh), NEG_INIT, **f32)
    if cfg.use_pallas and s > 1:
        hs, (C, n, m) = ml_ops.mlstm_chunk(q, k, v, li, lf, C0, n0, m0,
                                           chunk=cfg.mlstm_chunk)
    elif s == 1:
        hs, (C, n, m) = mlstm_recurrent_ref(q, k, v, li, lf, C0, n0, m0)
    else:
        hs, (C, n, m) = mlstm_chunkwise(q, k, v, li, lf, C0, n0, m0,
                                        chunk=cfg.mlstm_chunk)
    hflat = hs.transpose(1, 2).reshape(bsz, s, di)
    hflat = _group_norm(hflat, p["gn_scale"], nh, cfg.norm_eps)
    return hflat * silu(z), new_conv, C, n, m


def mlstm_block_forward(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
                        state: dict[str, torch.Tensor] | None = None):
    out, new = _cell_on_local_shards(
        cfg, _mlstm_cell, _MLSTM_CELL, p, _mlstm_up(cfg, p, x), state,
        ("conv", "C", "n", "m"), d_inner(cfg))
    return out @ p["w_down"].to(x.dtype), new


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def slstm_cell_scan(p: dict[str, Any], xi, xf, xz, xo,
                    state: dict[str, torch.Tensor], nh: int):
    """Sequential sLSTM. x*: (B, S, D) fp32 gate pre-activations (input
    part). state: dict c, n, m, h of (B, D) fp32. Returns hs (B, S, D) and
    the new state."""
    bsz, s, d = xi.shape
    hd = d // nh
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    hs = []
    for t in range(s):
        hh = h.reshape(bsz, nh, hd)
        ri = _blockdiag(hh, p["r_i"]).reshape(bsz, d)
        rf = _blockdiag(hh, p["r_f"]).reshape(bsz, d)
        rz = _blockdiag(hh, p["r_z"]).reshape(bsz, d)
        ro = _blockdiag(hh, p["r_o"]).reshape(bsz, d)
        li = xi[:, t] + ri
        lf = F.logsigmoid(xf[:, t] + rf)          # log sigmoid forget
        z = torch.tanh(xz[:, t] + rz)
        o = sigmoid(xo[:, t] + ro)
        m_new = torch.maximum(lf + m, li)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(li - m_new)
        c = fp * c + ip * z
        n = fp * n + ip
        h = o * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), {"c": c, "n": n, "m": m, "h": h}


def _slstm_cell(cfg: ModelConfig, h: torch.Tensor, conv_w, conv_b, w_i, w_f,
                w_z, w_o, r_i, r_f, r_z, r_o, b_i, b_f, b_z, b_o, gn_scale,
                conv_state, c0, n0, m0, h0):
    """The sLSTM cell on plain tensors, from the normed input to the group
    norm, the whole sequence's per-step loop in one call: (hs (B, S, D),
    conv state, c, n, m, h)."""
    p = dict(zip(_SLSTM_CELL, (conv_w, conv_b, w_i, w_f, w_z, w_o, r_i, r_f,
                               r_z, r_o, b_i, b_f, b_z, b_o, gn_scale)))
    dt = h.dtype
    bsz, s, d = h.shape
    nh = cfg.num_heads
    hd = d // nh
    hc, new_conv = _causal_conv(p["conv_w"], p["conv_b"], h, conv_state)
    hc = silu(hc)
    hh = h.reshape(bsz, s, nh, hd)
    hch = hc.reshape(bsz, s, nh, hd)

    def gate(inp, w, b):
        return _blockdiag(inp, w).reshape(bsz, s, d).float() + b.float()

    xi = gate(hch, p["w_i"], p["b_i"])
    xf = gate(hch, p["w_f"], p["b_f"])
    xz = gate(hh, p["w_z"], p["b_z"])
    xo = gate(hh, p["w_o"], p["b_o"])
    if c0 is None:
        zero = torch.zeros((bsz, d), dtype=torch.float32, device=h.device)
        cell = {"c": zero, "n": zero, "m": torch.full_like(zero, NEG_INIT),
                "h": zero}
    else:
        cell = {"c": c0, "n": n0, "m": m0, "h": h0}
    hs, new = slstm_cell_scan(p, xi, xf, xz, xo, cell, nh)
    hs = _group_norm(hs.to(dt), p["gn_scale"], nh, cfg.norm_eps)
    return hs, new_conv, new["c"], new["n"], new["m"], new["h"]


def slstm_block_forward(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
                        state: dict[str, torch.Tensor] | None = None):
    dt = x.dtype
    h = layer_norm(x, p["ln"], p["ln_b"], cfg.norm_eps)
    hs, new = _cell_on_local_shards(cfg, _slstm_cell, _SLSTM_CELL, p, h,
                                    state, ("conv", "c", "n", "m", "h"),
                                    cfg.d_model)
    # post up-projection (PF = 4/3), gated GeLU (jax.nn.gelu: tanh form)
    u1 = hs @ p["w_up1"].to(dt)
    u2 = hs @ p["w_up2"].to(dt)
    out = gelu_tanh(u1) * u2
    return out @ p["w_down"].to(dt), new


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def _block(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
           state: dict[str, torch.Tensor] | None):
    if "slstm" in p:
        return slstm_block_forward(cfg, p["slstm"], x, state)
    return mlstm_block_forward(cfg, p["mlstm"], x, state)


def _embed(cfg: ModelConfig, params: dict[str, Any],
           tokens: torch.Tensor) -> torch.Tensor:
    return shard(embed_rows(params["embedding"], tokens).to(
        cfg.activation_dtype), "batch", "act_seq", None)


def _logits(cfg: ModelConfig, params: dict[str, Any],
            x: torch.Tensor) -> torch.Tensor:
    x = layer_norm(x, params["ln_final"], params["ln_final_b"], cfg.norm_eps)
    return shard(x @ params["lm_head"].to(x.dtype),
                 "batch", "act_seq", "vocab_sharded")


def xlstm_forward(cfg: ModelConfig, params: dict[str, Any],
                  batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits over the whole sequence, (B, S, Vp)."""
    x = _embed(cfg, params, batch["tokens"])
    fn = maybe_remat(lambda x, p: _block(cfg, p, x, None)[0],
                     cfg.remat_policy)
    for p in params["layers"]:
        x = shard(x + fn(x, p), "batch", "act_seq", None)
    return _logits(cfg, params, x)


def xlstm_loss(cfg: ModelConfig, params: dict[str, Any],
               batch: dict[str, torch.Tensor]
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    logits = xlstm_forward(cfg, params, batch)
    loss, denom = softmax_cross_entropy(logits, batch["labels"],
                                        batch.get("mask"), cfg.vocab_size)
    return loss, {"ce_loss": loss, "tokens": denom,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_xlstm_state(cfg: ModelConfig, batch: int, max_len: int,
                     device: torch.device) -> list[dict[str, torch.Tensor]]:
    """Zero state (stabilisers at -1e30) for every layer; ``max_len`` does
    not size a recurrent state."""
    del max_len
    slstm = slstm_positions(cfg)

    def leaf(name, shape):
        dt = cfg.activation_dtype if name == "conv" else torch.float32
        return torch.full(shape, NEG_INIT if name == "m" else 0.0, dtype=dt,
                          device=device)

    return [{n: leaf(n, shape) for n, shape in _block_state_shapes(
        cfg, batch, i not in slstm).items()} for i in range(cfg.num_layers)]


def _serve_stack(cfg: ModelConfig, params: dict[str, Any], x: torch.Tensor,
                 states: list[dict[str, torch.Tensor]]) -> torch.Tensor:
    """Every layer from its state, writing the new state in place."""
    for p, st in zip(params["layers"], states):
        out, ns = _block(cfg, p, x, st)
        store_state(st, ns)
        x = shard(x + out, "batch", "act_seq", None)
    return x


def _block_state_axes(mlstm: bool) -> dict[str, tuple]:
    if mlstm:
        return {"C": ("batch", None, "xlstm_hd_sharded", None),
                "n": ("batch", None, "xlstm_hd_sharded"),
                "m": ("batch", None),
                "conv": ("batch", None, "xlstm_inner_sharded")}
    return {"c": ("batch", None), "n": ("batch", None),
            "m": ("batch", None), "h": ("batch", None),
            "conv": ("batch", None, None)}


def _block_state_shapes(cfg: ModelConfig, batch: int,
                        mlstm: bool) -> dict[str, tuple[int, ...]]:
    d, di, nh = cfg.d_model, d_inner(cfg), cfg.num_heads
    w = cfg.slstm_conv_width - 1
    if mlstm:
        hd = di // nh
        return {"C": (batch, nh, hd, hd), "n": (batch, nh, hd),
                "m": (batch, nh), "conv": (batch, w, di)}
    return {"c": (batch, d), "n": (batch, d), "m": (batch, d),
            "h": (batch, d), "conv": (batch, w, d)}


def xlstm_state_axes(cfg: ModelConfig) -> list[dict]:
    slstm = slstm_positions(cfg)
    return [_block_state_axes(i not in slstm) for i in range(cfg.num_layers)]


def xlstm_prefill(cfg: ModelConfig, params: dict[str, Any],
                  batch: dict[str, torch.Tensor],
                  states: list[dict[str, torch.Tensor]]
                  ) -> tuple[torch.Tensor, list[dict[str, torch.Tensor]]]:
    """Run the prompt through the stack from ``states``, writing every
    layer's state in place. Returns (last-position logits (B, 1, Vp),
    states)."""
    x = _serve_stack(cfg, params, _embed(cfg, params, batch["tokens"]),
                     states)
    return _logits(cfg, params, x[:, -1:]), states


def xlstm_decode_step(cfg: ModelConfig, params: dict[str, Any],
                      states: list[dict[str, torch.Tensor]],
                      tokens: torch.Tensor, pos: torch.Tensor
                      ) -> tuple[torch.Tensor, list[dict[str, torch.Tensor]]]:
    """One decode step. tokens: (B, 1); ``pos`` is unused (the recurrent
    state carries position). Writes the states in place."""
    del pos
    x = _serve_stack(cfg, params, _embed(cfg, params, tokens), states)
    return _logits(cfg, params, x), states
