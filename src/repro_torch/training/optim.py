"""Optimizers as functional updates on nested dicts of tensors: AdamW
(default) and Adafactor (factored second moment, memory-lean).

Counterpart of ``repro.training.optim``, formula for formula, with every
update in fp32 (the bias corrections ``b1**t`` and ``b2**t`` too) and the
result cast back to each leaf's dtype. Nothing is updated in place: each
update returns new parameter and state trees.

Under a mesh the leaves are DTensors and the state is placed like the
parameters (:func:`opt_state_axes`). A norm reduces each leaf's sum of
squares to a replicated scalar before it sums the leaves, so it is one
device's norm on every rank, and the scalars of an update (learning
rate, bias corrections, clip scale) are replicated DTensors beside them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.common import is_dtensor, map_tree, tree_leaves


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """The fp32 scalar ``x`` placed like the scalar ``like`` (replicated
    when ``like`` is a DTensor)."""
    return torch.full_like(like, x, dtype=torch.float32)


def lr_schedule(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio. Warmup counts from 1
    so the very first step has a non-zero learning rate."""
    step = torch.as_tensor(step).float() + 1.0
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """sum(x ** 2) in fp32. Of a sharded DTensor the sum is a partial
    value on each rank; it is reduced here to a replicated scalar."""
    s = x.float().square().sum()
    if is_dtensor(s):
        from torch.distributed.tensor import Replicate

        s = s.redistribute(s.device_mesh, [Replicate()] * s.device_mesh.ndim)
    return s


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, leaves summed in
    sorted-key order as JAX flattens a dict."""
    sq = [_sum_sq(x) for _, x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return map_tree(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _zip_map(fn, params, *trees):
    """``fn(p, *others)`` at every leaf ``p`` of ``params``, with the
    matching subtree of each other tree; returns one tree per output of
    ``fn`` (a tuple)."""
    if isinstance(params, dict):
        outs = {k: _zip_map(fn, params[k], *(t[k] for t in trees))
                for k in params}
        n = len(next(iter(outs.values()))) if outs else 0
        return tuple({k: v[i] for k, v in outs.items()} for i in range(n))
    if isinstance(params, list):          # the hybrid's and xLSTM's layers
        outs = [_zip_map(fn, p, *(t[i] for t in trees))
                for i, p in enumerate(params)]
        n = len(outs[0]) if outs else 0
        return tuple([o[i] for o in outs] for i in range(n))
    return fn(params, *trees)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: Any) -> dict[str, Any]:
    return {"mu": map_tree(torch.zeros_like, params),
            "nu": map_tree(torch.zeros_like, params)}


def adamw_update(cfg: OptimConfig, grads: Any, opt_state: dict[str, Any],
                 params: Any, step: torch.Tensor):
    step = torch.as_tensor(step)
    lr = lr_schedule(cfg, step)
    t = step.float() + 1.0
    bc1 = 1.0 - _f32(cfg.b1, t) ** t
    bc2 = 1.0 - _f32(cfg.b2, t) ** t

    def upd(p, g, mu, nu):
        g32 = g.float()
        mu_n = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
        nu_n = cfg.b2 * nu.float() + (1 - cfg.b2) * g32.square()
        mu_hat = mu_n / bc1
        nu_hat = nu_n / bc2
        delta = mu_hat / (torch.sqrt(nu_hat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p_n = p.float() - lr * delta
        return p_n.to(p.dtype), mu_n.to(mu.dtype), nu_n.to(nu.dtype)

    new_params, new_mu, new_nu = _zip_map(upd, params, grads,
                                          opt_state["mu"], opt_state["nu"])
    return new_params, {"mu": new_mu, "nu": new_nu}, lr


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

def adafactor_init(params: Any) -> dict[str, Any]:
    def row_col(p):
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros_like(p, dtype=torch.float32)}

    return {"fac": map_tree(row_col, params)}


def adafactor_update(cfg: OptimConfig, grads: Any, opt_state: dict[str, Any],
                     params: Any, step: torch.Tensor):
    step = torch.as_tensor(step)
    lr = lr_schedule(cfg, step)
    beta2 = 1.0 - (step.float() + 1.0) ** -0.8

    def upd(p, g, st):
        g32 = g.float()
        sq = g32.square() + 1e-30
        if p.dim() >= 2:
            vr = beta2 * st["vr"] + (1 - beta2) * sq.mean(dim=-1)
            vc = beta2 * st["vc"] + (1 - beta2) * sq.mean(dim=-2)
            denom = torch.sqrt(
                vr[..., :, None] * vc[..., None, :]
                / torch.clamp_min(vr.mean(dim=-1, keepdim=True)[..., None],
                                  1e-30))
            new_st = {"vr": vr, "vc": vc}
        else:
            v = beta2 * st["v"] + (1 - beta2) * sq
            denom = torch.sqrt(v)
            new_st = {"v": v}
        update = g32 / torch.clamp_min(denom, 1e-30)
        update = update / torch.clamp_min(
            global_norm(update) / (update.numel() ** 0.5), 1.0)
        p_n = p.float() - lr * (update + cfg.weight_decay * p.float())
        return p_n.to(p.dtype), new_st

    new_params, new_fac = _zip_map(upd, params, grads, opt_state["fac"])
    return new_params, {"fac": new_fac}, lr


def opt_init(cfg: OptimConfig, params: Any) -> dict[str, Any]:
    return adamw_init(params) if cfg.name == "adamw" else adafactor_init(params)


def opt_update(cfg: OptimConfig, grads, opt_state, params, step):
    if cfg.name == "adamw":
        return adamw_update(cfg, grads, opt_state, params, step)
    return adafactor_update(cfg, grads, opt_state, params, step)


def opt_state_axes(cfg: OptimConfig, param_axes: Any) -> dict[str, Any]:
    """Logical axes of the optimizer state: AdamW's moments mirror the
    parameters; Adafactor's factored ``vr`` drops the last dim and ``vc``
    the second-to-last, and a rank-1 leaf's ``v`` keeps its axes."""
    if cfg.name == "adamw":
        return {"mu": param_axes, "nu": param_axes}

    def fac_axes(ax: tuple) -> dict[str, tuple]:
        if len(ax) >= 2:
            return {"vr": tuple(ax[:-1]), "vc": tuple(ax[:-2] + ax[-1:])}
        return {"v": tuple(ax)}

    return {"fac": map_tree(fac_axes, param_axes)}
