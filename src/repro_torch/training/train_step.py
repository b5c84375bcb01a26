"""The training step: microbatched gradient accumulation, global-norm
clipping, AdamW/Adafactor update.

Counterpart of ``repro.training.train_step``. The state is a dict
``{"step": int32 scalar tensor, "params": tree, "opt": tree}``; a step
returns a new state (the reference's is pure) and the metrics
``{loss, grad_norm, lr, ce_loss, aux_loss, tokens}`` as fp32 scalar
tensors, left on the device so that a step never waits for the card.
A donated step (``make_train_step(..., donate=True)``, the reference's
``jax.jit(..., donate_argnums=(0,))``) writes the new state into the
tensors of the state it is given, as XLA writes into a donated buffer:
it holds the parameters, the optimizer's moments and one gradient (16
bytes a parameter under AdamW in fp32) where a functional step holds the
old and the new state beside the gradients (28).

On a mesh (under :class:`~repro_torch.models.common.axis_rules`) the
state's leaves are DTensors placed by :func:`train_state_axes` and the
batch is sharded over the data axes
(:func:`~repro_torch.distributed.sharding.shard_batch`); the metrics come
back as plain tensors that every rank holds whole.

Under a torch profiler a step's phases are named regions
(:func:`~repro_torch.observability.trace.region`): ``train.step``,
``train.forward``, ``train.backward``, ``train.own``, ``train.clip`` and
``train.optimizer``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.distributed.sharding import conform_tree
from repro_torch.models.common import (ShapeDtype, is_dtensor, map_tree,
                                       resolve_device, tree_leaves, whole)
from repro_torch.models.registry import ModelBundle
from repro_torch.observability import trace
from repro_torch.training import optim as optim_mod
from repro_torch.training.optim import OptimConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optim: OptimConfig = OptimConfig()
    microbatches: int = 1
    seed: int = 0


def init_train_state(bundle: ModelBundle, tcfg: TrainConfig,
                     generator: torch.Generator | int,
                     device: str | torch.device | None = None
                     ) -> dict[str, Any]:
    """Parameters drawn from ``generator`` (a CPU generator or a seed) by
    the reference's init rules, on ``device`` (the card when None)."""
    dev = resolve_device(device)
    params = bundle.init_params(generator, dev)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "params": params,
        "opt": optim_mod.opt_init(tcfg.optim, params),
    }


def train_state_shapes(bundle: ModelBundle, tcfg: TrainConfig
                       ) -> dict[str, Any]:
    """:class:`ShapeDtype` tree of the train state, allocating nothing (the
    optimizer's init runs on meta tensors)."""
    pshapes = bundle.param_shapes()
    meta = map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), pshapes)
    opt = map_tree(lambda t: ShapeDtype(tuple(t.shape), t.dtype),
                   optim_mod.opt_init(tcfg.optim, meta))
    return {"step": ShapeDtype((), torch.int32), "params": pshapes,
            "opt": opt}


def train_state_axes(bundle: ModelBundle, tcfg: TrainConfig
                     ) -> dict[str, Any]:
    """Logical axes of every leaf of the train state."""
    paxes = bundle.param_axes()
    return {"step": (), "params": paxes,
            "opt": optim_mod.opt_state_axes(tcfg.optim, paxes)}


def _split_microbatches(batch: dict[str, torch.Tensor], n: int
                        ) -> list[dict[str, torch.Tensor]]:
    """``n`` microbatches of consecutive rows. A batch of DTensors sharded
    over the data axes is split on each rank's own rows, so microbatch i
    holds the i-th share of every data group's rows and no row moves."""
    first = next(iter(batch.values()))
    if is_dtensor(first):
        from torch.distributed.tensor import DTensor

        local = _split_microbatches({k: v.to_local()
                                     for k, v in batch.items()}, n)
        return [{k: DTensor.from_local(v, batch[k].device_mesh,
                                       batch[k].placements, run_check=False)
                 for k, v in mb.items()} for mb in local]
    b = first.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def value_and_grad(bundle: ModelBundle, params: Any,
                   batch: dict[str, torch.Tensor]):
    """((loss, metrics), grads) of ``bundle.loss_fn`` in ``params``; grads
    has ``params``' structure (zeros for a leaf the loss does not use).
    On a mesh each gradient is placed as its parameter is, as the
    reference's ``jax.grad`` returns it: a partial sum (a replicated
    parameter's, summed over the ranks that read it) is reduced here, once,
    rather than wherever the optimizer's first op needs it."""
    live = map_tree(lambda t: t.detach().requires_grad_(True), params)
    with trace.region("train.forward"):
        loss, metrics = bundle.loss_fn(live, batch)
    leaves = [t for _, t in tree_leaves(live)]
    with trace.region("train.backward"):
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    grad_of = dict(zip(map(id, leaves), grads))

    def placed(t):
        g = grad_of[id(t)]
        if is_dtensor(g) and tuple(g.placements) != tuple(t.placements):
            return g.redistribute(t.device_mesh, t.placements)
        return g

    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            map_tree(placed, live))


def _accumulate(acc: Any, grads: Any, n: int) -> Any:
    """acc + grads / n, leaf by leaf, in fp32."""
    if isinstance(acc, dict):
        return {k: _accumulate(acc[k], grads[k], n) for k in acc}
    if isinstance(acc, list):
        return [_accumulate(a, g, n) for a, g in zip(acc, grads)]
    return acc + grads.float() / n


def _accumulate_(acc: Any, grads: Any, n: int) -> None:
    """:func:`_accumulate` written into ``acc``."""
    for (_, a), (_, g) in zip(tree_leaves(acc), tree_leaves(grads)):
        a.add_(g.float() / n)


def _storage_key(t: torch.Tensor):
    from torch.multiprocessing.reductions import StorageWeakRef

    return StorageWeakRef((t.to_local() if is_dtensor(t) else t)
                          .untyped_storage())


def _owned(grads: Any, params: Any) -> Any:
    """``grads`` with every leaf that the in-place clip and update could
    not write alone replaced by its copy: a tensor whose elements overlap
    (autograd may hand back an expanded one) or whose storage a parameter
    or an earlier gradient holds (an add's backward gives both operands
    one tensor)."""
    seen = {_storage_key(p) for _, p in tree_leaves(params)}

    def own(g):
        local = g.to_local() if is_dtensor(g) else g
        key = _storage_key(g)
        if key in seen or any(st == 0 and n > 1 for st, n in
                              zip(local.stride(), local.shape)):
            g = g.clone()
            key = _storage_key(g)
        seen.add(key)
        return g

    return map_tree(own, grads)


def _unmoved(state: Any, placements: Any) -> None:
    """Raise unless every DTensor leaf of ``state`` is placed as
    ``placements`` says: a donated step's leaves keep their input's
    placements, so there is nothing for :func:`conform_tree` to move."""
    want = dict(tree_leaves(placements))
    moved = [k for k, t in tree_leaves(state)
             if tuple(t.placements) != tuple(want[k])]
    if moved:
        raise RuntimeError(f"a donated step left leaves placed otherwise "
                           f"than the state's placements: {moved}")


def make_train_step(bundle: ModelBundle, tcfg: TrainConfig,
                    state_placements: Any = None, *, donate: bool = False):
    """``train_step(state, batch) -> (new_state, metrics)``. With
    ``state_placements`` (a mesh's, :func:`~repro_torch.distributed.
    sharding.tree_placements` of :func:`train_state_axes`) the new state
    is redistributed to them wherever an op left a leaf placed otherwise,
    as the reference's jitted step fixes its ``out_shardings``.

    With ``donate`` the step consumes its state, as a JAX step jitted
    with ``donate_argnums=(0,)`` does: it writes the new step counter,
    parameters and optimizer state into the given state's own tensors, one
    leaf at a time, and returns that same dict, each leaf's storage its
    input leaf's. The caller must not read the old state afterwards
    expecting the values it had; to keep them, clone it first. The
    results equal the functional step's bit for bit."""
    ocfg = tcfg.optim
    n = tcfg.microbatches

    def train_step(state: dict[str, Any], batch: dict[str, torch.Tensor]):
        with trace.region("train.step"):
            return _train_step(state, batch)

    def _train_step(state: dict[str, Any], batch: dict[str, torch.Tensor]):
        params = state["params"]
        if n > 1:
            grads = map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state["step"].device)
            for mb in _split_microbatches(batch, n):
                (mb_loss, metrics), g = value_and_grad(bundle, params, mb)
                if donate:
                    _accumulate_(grads, g, n)
                else:
                    grads = _accumulate(grads, g, n)
                loss = loss + mb_loss / n   # metrics: the last microbatch's
        else:
            (loss, metrics), grads = value_and_grad(bundle, params, batch)

        if donate:
            with torch.no_grad():
                if n == 1:
                    with trace.region("train.own"):
                        grads = _owned(grads, params)
                with trace.region("train.clip"):
                    grad_norm = optim_mod.clip_by_global_norm_(
                        grads, ocfg.grad_clip)
                with trace.region("train.optimizer"):
                    lr = optim_mod.opt_update_(ocfg, grads, state["opt"],
                                               params, state["step"])
                    del grads
                    state["step"].add_(1)
            if state_placements is not None:
                _unmoved(state, state_placements)
            new_state = state
        else:
            with trace.region("train.clip"):
                grads, grad_norm = optim_mod.clip_by_global_norm(
                    grads, ocfg.grad_clip)
            with trace.region("train.optimizer"):
                new_params, new_opt, lr = optim_mod.opt_update(
                    ocfg, grads, state["opt"], params, state["step"])
                new_state = {"step": state["step"] + 1, "params": new_params,
                             "opt": new_opt}
            if state_placements is not None:
                new_state = conform_tree(new_state, state_placements)
        out_metrics = {
            "loss": loss.float(),
            "grad_norm": grad_norm,
            "lr": lr,
            **{k: v.float() for k, v in metrics.items()},
        }
        return new_state, map_tree(whole, out_metrics)

    return train_step
