"""The training step: microbatched gradient accumulation, global-norm
clipping, AdamW/Adafactor update.

Counterpart of ``repro.training.train_step``. The state is a dict
``{"step": int32 scalar tensor, "params": tree, "opt": tree}``; a step
returns a new state (the reference's is pure) and the metrics
``{loss, grad_norm, lr, ce_loss, aux_loss, tokens}`` as fp32 scalar
tensors, left on the device so that a step never waits for the card.

On a mesh (under :class:`~repro_torch.models.common.axis_rules`) the
state's leaves are DTensors placed by :func:`train_state_axes` and the
batch is sharded over the data axes
(:func:`~repro_torch.distributed.sharding.shard_batch`); the metrics come
back as plain tensors that every rank holds whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.distributed.sharding import conform_tree
from repro_torch.models.common import (ShapeDtype, is_dtensor, map_tree,
                                       resolve_device, tree_leaves, whole)
from repro_torch.models.registry import ModelBundle
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
    has ``params``' structure (zeros for a leaf the loss does not use)."""
    live = map_tree(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = bundle.loss_fn(live, batch)
    leaves = [t for _, t in tree_leaves(live)]
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    grad_of = dict(zip(map(id, leaves), grads))
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            map_tree(lambda t: grad_of[id(t)], live))


def _accumulate(acc: Any, grads: Any, n: int) -> Any:
    """acc + grads / n, leaf by leaf, in fp32."""
    if isinstance(acc, dict):
        return {k: _accumulate(acc[k], grads[k], n) for k in acc}
    return acc + grads.float() / n


def make_train_step(bundle: ModelBundle, tcfg: TrainConfig,
                    state_placements: Any = None):
    """``train_step(state, batch) -> (new_state, metrics)``. With
    ``state_placements`` (a mesh's, :func:`~repro_torch.distributed.
    sharding.tree_placements` of :func:`train_state_axes`) the new state
    is redistributed to them wherever an op left a leaf placed otherwise,
    as the reference's jitted step fixes its ``out_shardings``."""
    ocfg = tcfg.optim
    n = tcfg.microbatches

    def train_step(state: dict[str, Any], batch: dict[str, torch.Tensor]):
        params = state["params"]
        if n > 1:
            grads = map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state["step"].device)
            for mb in _split_microbatches(batch, n):
                (mb_loss, metrics), g = value_and_grad(bundle, params, mb)
                grads = _accumulate(grads, g, n)
                loss = loss + mb_loss / n   # metrics: the last microbatch's
        else:
            (loss, metrics), grads = value_and_grad(bundle, params, batch)

        grads, grad_norm = optim_mod.clip_by_global_norm(grads,
                                                         ocfg.grad_clip)
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
