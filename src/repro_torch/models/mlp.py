"""Dense gated MLPs (SwiGLU / GeGLU) and Mixture-of-Experts layers.

Counterpart of ``repro.models.mlp``. The MoE layer is the reference's
GShard/Switch grouped dispatch:

* tokens are reshaped into groups of ``moe_group_size`` (halved until it
  divides the tokens);
* per group, each expert has capacity ``C = ceil(g·k/E · capacity_factor)``
  (at least 4, at most g); a token's choices beyond it are dropped;
* dispatch/combine tensors are (G, g, E, C) one-hots that take no
  gradient: the router learns through the top-k weights and the aux loss.

Every expert runs over its whole capacity buffer, as in the reference.
``moe_sharding`` names the reference's two sharding strategies; on one
device both are the same arithmetic. Under a mesh:

* ``expert`` (EP): the expert dim of the weights and of the capacity
  buffers takes the model axis (moonshot: 64 experts);
* ``ffn`` (TP-in-expert): experts replicated, each expert's d_ff sharded
  (grok: 8 experts do not divide a 16-way axis, but d_ff=32768 does).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.common import (ModelConfig, ParamSpec, act_fn,
                                       shard, splits_evenly)


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def make_mlp_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "ffn")),
        "w_up": ParamSpec((d, f), ("embed", "ffn")),
        "w_down": ParamSpec((f, d), ("ffn", "embed")),
    }


def mlp_forward(cfg: ModelConfig, p: dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    act = act_fn(cfg.mlp_act)
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    h = shard(act(g) * u, "batch", None, "ffn_sharded")
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def make_moe_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    if cfg.moe_sharding == "expert":
        # EP: the expert dim takes the model axis; per-expert ffn replicated.
        ax = ("expert_sharded", "embed", "moe_ffn")
        ax_down = ("expert_sharded", "moe_ffn", "embed")
    else:  # TP-in-expert: experts replicated, per-expert ffn takes model axis
        ax = ("expert", "embed", "moe_ffn")
        ax_down = ("expert", "moe_ffn", "embed")
    return {
        "router": ParamSpec((d, e), ("embed", None)),
        "w_gate": ParamSpec((e, d, f), ax),
        "w_up": ParamSpec((e, d, f), ax),
        "w_down": ParamSpec((e, f, d), ax_down),
    }


def _capacity(cfg: ModelConfig, group: int) -> int:
    c = int(math.ceil(group * cfg.num_experts_per_tok / cfg.num_experts
                      * cfg.moe_capacity_factor))
    return max(4, min(group, c))


def _group_size(cfg: ModelConfig, tokens: int) -> int:
    g = min(cfg.moe_group_size, tokens)
    while tokens % g:
        g //= 2
    return g


def top_k_stable(probs: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices,
    the lower index first among equal values, as ``lax.top_k`` orders
    them (``torch.topk`` promises no order among ties on the card)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``index`` over ``n`` classes; an index outside
    [0, n) gives a row of zeros, as ``jax.nn.one_hot`` does."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


def moe_forward(cfg: ModelConfig, p: dict[str, torch.Tensor],
                x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_load_balance_loss). x: (B, S, D)."""
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    tokens = b * s
    g = _group_size(cfg, tokens)
    n_groups = tokens // g
    cap = _capacity(cfg, g)

    # groups that the data axes do not divide straddle two ranks' rows,
    # which DTensor cannot reshape into (the reference's GSPMD pads them):
    # there every rank takes the whole batch, and the output goes back to
    # the batch's rows after the combine. One group (a decode step) holds
    # every row already and reshapes as it is.
    whole_groups = n_groups > 1 and not splits_evenly(n_groups, "moe_groups")
    if whole_groups:
        x = shard(x, None, None, None)
    xt = shard(x.reshape(n_groups, g, d), "moe_groups", None, None)
    # fp32 router (no TF32: a near-tie must stay a tie on every device)
    router_logits = torch.einsum("gtd,de->gte", xt.float(),
                                 p["router"].float())
    probs = torch.softmax(router_logits, dim=-1)              # (G, g, E)

    # --- aux loss (Switch-style load balancing) ---------------------------
    density = probs.mean(dim=1)                                # (G, E)
    frac = _one_hot(probs.argmax(dim=-1), e).mean(dim=1)       # (G, E)
    # replicated at once: a mean over groups sharded over data is a
    # Partial(avg), which DTensor (torch 2.11) cannot turn into the CE's
    # Partial(sum) when the two are added
    aux_loss = shard((density * frac).sum(dim=-1).mean() * e)

    # --- top-k selection ---------------------------------------------------
    topw, topi = top_k_stable(probs, k)                        # (G, g, k)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    # position of each (token, choice) inside its expert's capacity buffer,
    # ranked token-major
    sel = _one_hot(topi, e)                                    # (G, g, k, E)
    sel_flat = sel.reshape(n_groups, g * k, e)
    pos_in_expert = (torch.cumsum(sel_flat, dim=1) - sel_flat).reshape(
        n_groups, g, k, e)
    within_cap = pos_in_expert < cap
    cap_slot = _one_hot((pos_in_expert * sel).sum(-1).long(), cap)
    # the one-hots are piecewise constant: no gradient through them (the
    # reference's stop_gradient). The router learns through topw only.
    sel_live = (sel * within_cap).detach()                     # (G, g, k, E)
    cap_slot = cap_slot.detach()                               # (G, g, k, C)
    dispatch = torch.einsum("gtke,gtkc->gtec", sel_live, cap_slot)
    # a token picks an expert at most once, so one k term per (t, e):
    # weighting sel first is the reference's three-way product exactly
    combine = torch.einsum("gtke,gtkc->gtec", sel_live * topw[..., None],
                           cap_slot)

    expert_in = torch.einsum("gtec,gtd->egcd", dispatch.to(dt), xt)
    expert_in = shard(expert_in, "expert_sharded", "moe_groups", None, None)
    act = act_fn(cfg.mlp_act)
    # each expert weight gathered along its embed dim (FSDP's all-gather):
    # left to DTensor, an embed-sharded weight lets it split the capacity
    # dim over the model axis for the combine, which a capacity that
    # model does not divide cannot take
    e_ax = "expert_sharded" if cfg.moe_sharding == "expert" else "expert"
    w_gate, w_up = (shard(p[n], e_ax, None, "moe_ffn").to(dt)
                    for n in ("w_gate", "w_up"))
    w_down = shard(p["w_down"], e_ax, "moe_ffn", None).to(dt)
    hg = torch.einsum("egcd,edf->egcf", expert_in, w_gate)
    hu = torch.einsum("egcd,edf->egcf", expert_in, w_up)
    h = shard(act(hg) * hu, "expert_sharded", "moe_groups", None,
              "moe_ffn_act")
    # under TP-in-expert no constraint on expert_out: it holds per-shard
    # partial sums, reduced on the (G, g, D) token tensor below instead of
    # the fat (E, G, C, D) capacity tensor. Under expert parallelism every
    # expert's output is gathered on every rank first: DTensor (torch
    # 2.11) cannot reshape the capacity tensor for the combine while its
    # expert dim is sharded.
    expert_out = torch.einsum("egcf,efd->egcd", h, w_down)
    if cfg.moe_sharding == "expert":
        expert_out = shard(expert_out, "expert", "moe_groups", None, None)
    out = torch.einsum("gtec,egcd->gtd", combine.to(dt), expert_out)
    out = shard(out, "moe_groups", None, None).reshape(b, s, d)
    if whole_groups:
        out = shard(out, "batch", None, None)
    return out, aux_loss.float()
