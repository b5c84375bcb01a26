"""Optimizers as functional updates on nested dicts of tensors: AdamW
(default) and Adafactor (factored second moment, memory-lean).

Counterpart of ``repro.training.optim``, formula for formula, with every
update in fp32 (the bias corrections ``b1**t`` and ``b2**t`` too) and the
result cast back to each leaf's dtype. Each update returns new parameter
and state trees; its counterpart with a trailing underscore
(:func:`adamw_update_`, :func:`adafactor_update_`,
:func:`clip_by_global_norm_`, :func:`opt_update_`) writes them into the
trees it is given instead, leaf by leaf, the same ops in the same order
on the same dtypes, so that its results are the functional update's bit
for bit (the donated train step's update).

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


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return map_tree(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _f32_of(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when it is fp32 (an in-place op then writes ``x``),
    else its fp32 copy."""
    return x if x.dtype == torch.float32 else x.float()


def _store(dst: torch.Tensor, src32: torch.Tensor) -> None:
    """Write the fp32 result ``src32`` into ``dst``, rounded to its dtype
    as ``.to(dst.dtype)`` rounds (nothing to do where it is ``dst``)."""
    if src32 is not dst:
        dst.copy_(src32)


def clip_by_global_norm_(tree: Any, max_norm: float) -> torch.Tensor:
    """:func:`clip_by_global_norm` written into ``tree``'s leaves, which
    the caller owns (no view, no storage shared with another leaf or a
    parameter); returns the norm."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    for _, g in tree_leaves(tree):
        _store(g, _f32_of(g).mul_(scale))
    return norm


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


def _for_each(fn, params, *trees) -> None:
    """``fn(p, *others)`` at every leaf ``p`` of ``params``, as
    :func:`_zip_map` walks them, for its effects."""
    if isinstance(params, dict):
        for k in params:
            _for_each(fn, params[k], *(t[k] for t in trees))
    elif isinstance(params, list):
        for i, p in enumerate(params):
            _for_each(fn, p, *(t[i] for t in trees))
    else:
        fn(params, *trees)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: Any) -> dict[str, Any]:
    return {"mu": map_tree(torch.zeros_like, params),
            "nu": map_tree(torch.zeros_like, params)}


def _adamw_scalars(cfg: OptimConfig, step: torch.Tensor):
    """The learning rate and the two bias corrections of ``step``."""
    step = torch.as_tensor(step)
    t = step.float() + 1.0
    return (lr_schedule(cfg, step), 1.0 - _f32(cfg.b1, t) ** t,
            1.0 - _f32(cfg.b2, t) ** t)


def adamw_update(cfg: OptimConfig, grads: Any, opt_state: dict[str, Any],
                 params: Any, step: torch.Tensor):
    lr, bc1, bc2 = _adamw_scalars(cfg, step)

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


def adamw_update_(cfg: OptimConfig, grads: Any, opt_state: dict[str, Any],
                  params: Any, step: torch.Tensor) -> torch.Tensor:
    """:func:`adamw_update` written into ``params`` and ``opt_state``;
    returns the learning rate."""
    lr, bc1, bc2 = _adamw_scalars(cfg, step)

    def upd(p, g, mu, nu):
        g32 = g.float()
        mu32, nu32 = _f32_of(mu), _f32_of(nu)
        mu32.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        nu32.mul_(cfg.b2).add_(g32.square().mul_(1 - cfg.b2))
        del g32
        delta = mu32 / bc1
        delta.div_((nu32 / bc2).sqrt_().add_(cfg.eps))
        _store(mu, mu32)
        _store(nu, nu32)
        del mu32, nu32
        p32 = _f32_of(p)
        delta.add_(cfg.weight_decay * p32)
        _store(p, p32.sub_(delta.mul_(lr)))

    _for_each(upd, params, grads, opt_state["mu"], opt_state["nu"])
    return lr


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


def _adafactor_moments(st: dict[str, torch.Tensor], g32: torch.Tensor,
                       beta2: torch.Tensor
                       ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """The new second moments of one leaf (row and column means of a
    matrix's, or a vector's whole) and the update's denominator."""
    sq = g32.square() + 1e-30
    if g32.dim() >= 2:
        vr = beta2 * st["vr"] + (1 - beta2) * sq.mean(dim=-1)
        vc = beta2 * st["vc"] + (1 - beta2) * sq.mean(dim=-2)
        del sq
        denom = torch.sqrt(
            vr[..., :, None] * vc[..., None, :]
            / torch.clamp_min(vr.mean(dim=-1, keepdim=True)[..., None],
                              1e-30))
        return {"vr": vr, "vc": vc}, denom
    v = beta2 * st["v"] + (1 - beta2) * sq
    return {"v": v}, torch.sqrt(v)


def _adafactor_scalars(cfg: OptimConfig, step: torch.Tensor):
    """The learning rate and the second moment's decay of ``step``."""
    step = torch.as_tensor(step)
    return lr_schedule(cfg, step), 1.0 - (step.float() + 1.0) ** -0.8


def adafactor_update(cfg: OptimConfig, grads: Any, opt_state: dict[str, Any],
                     params: Any, step: torch.Tensor):
    lr, beta2 = _adafactor_scalars(cfg, step)

    def upd(p, g, st):
        g32 = g.float()
        new_st, denom = _adafactor_moments(st, g32, beta2)
        update = g32 / torch.clamp_min(denom, 1e-30)
        update = update / torch.clamp_min(
            global_norm(update) / (update.numel() ** 0.5), 1.0)
        p_n = p.float() - lr * (update + cfg.weight_decay * p.float())
        return p_n.to(p.dtype), new_st

    new_params, new_fac = _zip_map(upd, params, grads, opt_state["fac"])
    return new_params, {"fac": new_fac}, lr


def adafactor_update_(cfg: OptimConfig, grads: Any,
                      opt_state: dict[str, Any], params: Any,
                      step: torch.Tensor) -> torch.Tensor:
    """:func:`adafactor_update` written into ``params`` and ``opt_state``;
    returns the learning rate. The factored moments are a matrix's row
    and column sizes: they are made as the functional update makes them
    (on a mesh, placed as DTensor places that update's) and copied into
    the state; the parameter is updated in place."""
    lr, beta2 = _adafactor_scalars(cfg, step)

    def upd(p, g, st):
        g32 = g.float()
        new_st, denom = _adafactor_moments(st, g32, beta2)
        for k, t in new_st.items():
            st[k].copy_(t)
        del new_st
        update = g32 / denom.clamp_min_(1e-30)
        del g32, denom
        update.div_(torch.clamp_min(
            global_norm(update) / (update.numel() ** 0.5), 1.0))
        p32 = _f32_of(p)
        update.add_(cfg.weight_decay * p32)
        _store(p, p32.sub_(update.mul_(lr)))

    _for_each(upd, params, grads, opt_state["fac"])
    return lr


def opt_init(cfg: OptimConfig, params: Any) -> dict[str, Any]:
    return adamw_init(params) if cfg.name == "adamw" else adafactor_init(params)


def opt_update(cfg: OptimConfig, grads, opt_state, params, step):
    if cfg.name == "adamw":
        return adamw_update(cfg, grads, opt_state, params, step)
    return adafactor_update(cfg, grads, opt_state, params, step)


def opt_update_(cfg: OptimConfig, grads, opt_state, params, step
                ) -> torch.Tensor:
    """:func:`opt_update` written into ``params`` and ``opt_state``;
    returns the learning rate."""
    if cfg.name == "adamw":
        return adamw_update_(cfg, grads, opt_state, params, step)
    return adafactor_update_(cfg, grads, opt_state, params, step)


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
