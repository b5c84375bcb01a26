"""Layer slices of stacked parameters (``models/common.py::layer_slices``)
on the CPU.

Where a stacked leaf takes a gradient, each layer's slice writes its
gradient into its slice of one buffer of the stack's shape, which the
stacked leaf then gets whole. The gradients must be bit-equal to those of
a plain select ``t[i]`` (the oracle here, put in place of the program's
slicer), on the reduced dense, MoE and encoder-decoder models with and
without remat and microbatches, and on a toy stack whose layers are used
twice, never, or passed through twice in one graph. Without a gradient a
slice is a view, and a DTensor leaf keeps the select. The donated step's
gradients for the stacked leaves are storages of their own, so its copy
of shared gradients (``train.own``) copies none of them.
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.models import common
from repro_torch.models.common import (layer_slice, layer_slices, map_tree,
                                       tree_leaves)
from repro_torch.models.registry import build
from repro_torch.training.train_step import (_owned, _split_microbatches,
                                             _storage_key, value_and_grad)

HERE = os.path.dirname(os.path.abspath(__file__))

#: the stacked groups of each model's parameters
STACKS = {"granite-3-2b": ("layers",), "moonshot-v1-16b-a3b": ("layers",),
          "whisper-large-v3": ("enc_layers", "dec_layers")}


def _select(t):
    """The oracle: layer ``i`` of ``t`` by a plain select."""
    return lambda i: t[i]


def _batch(cfg, bundle, rows=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(r[:, :-1].copy()),
             "labels": torch.from_numpy(r[:, 1:].copy())}
    batch.update(bundle.draw_extra_inputs(rows, rng, "cpu"))
    return batch


def _slices_per_pass(params, groups, passes=1):
    return passes * sum(t.shape[0] for g in groups
                        for _, t in tree_leaves(params[g]))


def _model_case(arch, remat, micro):
    cfg = reduced_config(arch).replace(dtype="float32", remat_policy=remat)
    bundle = build(cfg)
    params = bundle.init_params(0, "cpu")
    batches = _split_microbatches(_batch(cfg, bundle), micro)
    return (bundle, params, batches,
            _slices_per_pass(params, STACKS[arch]), {})


def _toy_params():
    gen = torch.Generator().manual_seed(0)
    return {"stack": {"w": torch.randn(3, 4, 4, generator=gen) / 2,
                      "b": torch.randn(3, 4, generator=gen)},
            "head": torch.randn(4, generator=gen)}


def _toy_case(kind):
    """A stack of three tanh layers. ``twice``: layer 1's slices are used
    twice and layer 2's never (its slices stay alive through the
    backward); ``two_passes``: the stack runs twice in one graph, so each
    stacked leaf has two gathers whose buffers autograd adds."""
    alive = []

    def loss_fn(p, batch):
        x, n = batch["x"], 0
        for _ in range(2 if kind == "two_passes" else 1):
            for i, lp in enumerate(layer_slices(p["stack"], 3)):
                alive.append(lp)
                if kind == "twice" and i == 2:
                    continue
                x = torch.tanh(x @ lp["w"] + lp["b"])
                if kind == "twice" and i == 1:
                    x = x + torch.sin(x @ lp["w"] - lp["b"])
                n += 2
        return (x @ p["head"]).square().mean(), {"slices": torch.tensor(n)}

    gen = torch.Generator().manual_seed(1)
    batches = [{"x": torch.randn(5, 4, generator=gen)}]
    zero = {"twice": {"stack/w": 2, "stack/b": 2}}.get(kind, {})
    used = {"twice": 4, "two_passes": 12}[kind]
    return (types.SimpleNamespace(loss_fn=loss_fn), _toy_params(), batches,
            used, zero)


CASES = {f"{a}-{r}-micro{m}": (lambda a=a, r=r, m=m: _model_case(a, r, m))
         for a in STACKS for r in ("nothing_saveable", "off") for m in (1, 2)}
CASES.update({f"toy-{k}": (lambda k=k: _toy_case(k))
              for k in ("twice", "two_passes")})


@pytest.mark.parametrize("case", list(CASES))
def test_gathered_gradients_equal_the_selects(case, monkeypatch):
    """Loss and every gradient leaf ``torch.equal`` to the select's, one
    backward per microbatch; each backward writes one slice gradient per
    used (leaf, layer) into a buffer and selects none; a layer that no
    computation uses reads exactly zero."""
    bundle, params, batches, per_pass, zero = CASES[case]()
    got = []
    for batch in batches:
        gathered, selected = layer_slice.gathered, layer_slice.selected
        got.append(value_and_grad(bundle, params, batch))
        assert layer_slice.gathered - gathered == per_pass
        assert layer_slice.selected == selected
    monkeypatch.setattr(common, "_slicer", _select)
    for batch, ((loss, _), grads) in zip(batches, got):
        (want_loss, _), want = value_and_grad(bundle, params, batch)
        assert torch.equal(loss, want_loss)
        want = dict(tree_leaves(want))
        assert [k for k, g in tree_leaves(grads)
                if not torch.equal(g, want[k])] == []
        for k, i in zero.items():
            assert not dict(tree_leaves(grads))[k][i].any()


def test_without_a_gradient_slices_are_views_of_the_stack():
    """Under ``no_grad`` (serving) a slice is a view: a write through a
    sliced cache lands in the stack, and no gradient is gathered."""
    cache = {"k": torch.zeros(3, 2, 4), "v": torch.zeros(3, 2, 4)}
    params = map_tree(lambda t: t.requires_grad_(True), _toy_params())
    gathered = layer_slice.gathered
    with torch.no_grad():
        layer_slice(cache, 1)["k"][0].fill_(7.0)
        layers = list(layer_slices(params["stack"], 3))
        sliced = layer_slice(params["stack"], 2)
    assert (cache["k"][1, 0] == 7.0).all() and cache["k"].sum() == 28.0
    for i, lp in enumerate(layers):
        assert lp["w"]._base is params["stack"]["w"]
        assert torch.equal(lp["w"], params["stack"]["w"][i])
    assert sliced["b"].data_ptr() == params["stack"]["b"][2].data_ptr()
    assert layer_slice.gathered == gathered


def _toy_stack_loss(stack, x):
    for lp in layer_slices(stack, 3):
        x = torch.tanh(x @ lp["w"] + lp["b"])
    return x.square().sum()


def dtensor_rank(rank: int) -> dict:
    """One rank of a 2 x 1 gloo mesh: the toy stack's leaves as replicated
    DTensors, sliced and differentiated; what the counters moved by, and
    whether the gradient equals the plain stack's."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(2, 1)
    stack, x = _toy_params()["stack"], torch.ones(2, 4)
    plain = map_tree(lambda t: t.clone().requires_grad_(True), stack)
    want = torch.autograd.grad(_toy_stack_loss(plain, x),
                               [plain["w"], plain["b"]])
    placed = map_tree(lambda t: distribute_tensor(
        t, mesh, [Replicate(), Replicate()]).requires_grad_(True), stack)
    gathered, selected = layer_slice.gathered, layer_slice.selected
    loss = _toy_stack_loss(placed, distribute_tensor(
        x, mesh, [Replicate(), Replicate()]))
    got = torch.autograd.grad(loss, [placed["w"], placed["b"]])
    return {"gathered": layer_slice.gathered - gathered,
            "selected": layer_slice.selected - selected,
            "equal": all(torch.equal(g.full_tensor(), w)
                         for g, w in zip(got, want))}


def test_dtensor_leaves_keep_the_select():
    """On a 2 x 1 gloo mesh, DTensor leaves that take a gradient are
    sliced by the select and counted as ``selected``; their gradient
    equals the gathered one of the same stack held whole."""
    from repro_torch.configs import spawn_ranks

    sys.path.insert(0, HERE)
    for found in spawn_ranks(dtensor_rank, 2, "cpu"):
        assert found == {"gathered": 0, "selected": 6, "equal": True}


def test_donated_steps_stacked_gradients_are_their_own_storages():
    """The stacked leaves' gradients share no storage with each other or
    with any parameter, so the donated step's copy of shared gradients
    (``train.own``) hands every one of them on as it is."""
    cfg = reduced_config("granite-3-2b")
    bundle = build(cfg)
    params = bundle.init_params(0, "cpu")
    _, grads = value_and_grad(bundle, params, _batch(cfg, bundle))
    stacked = [g for _, g in tree_leaves(grads["layers"])]
    keys = [_storage_key(g) for g in stacked]
    assert len(stacked) == 9 and len(set(keys)) == len(keys)
    assert not set(keys) & {_storage_key(p) for _, p in tree_leaves(params)}
    owned = _owned(grads, params)
    assert all(o is g for o, (_, g) in
               zip([o for _, o in tree_leaves(owned["layers"])],
                   tree_leaves(grads["layers"])))
