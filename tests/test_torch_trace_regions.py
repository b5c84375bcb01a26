"""Regions of the port's tracer on the CPU: named ranges on a torch
profiler's trace around the train step's phases and the model's parts,
their ``.bwd`` ranges, and what they leave alone (no graph change without
a profiler, bit-equal steps with one, nothing in a Timeline). The model is
the benchmark's reduced granite (``cardbench/tests/conftest.py``)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cardbench import bench, inputs  # noqa: E402
from cardbench.tests.conftest import REDUCED  # noqa: E402
from repro_torch.models.common import map_tree, tree_leaves  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.observability import trace  # noqa: E402
from repro_torch.training import optim  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    TrainConfig, make_train_step)

MODEL = ("model.embed", "model.norm", "model.attn", "model.mlp", "model.ce",
         "model.layer_slice")
STEP = ("train.step", "train.forward", "train.backward", "train.own",
        "train.clip", "train.optimizer")
IDENTITY = "RegionEdgeBackward"
SEED = 2**31 + 34


@pytest.fixture(autouse=True)
def _trace_reset():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def cell():
    """The reduced granite's bundle, optimizer config, a warm train state
    (one step taken) and a batch."""
    spec = bench.spec()
    cfg = dict(bench.config(spec, "granite-3-2b"), **REDUCED)
    drv = bench.driver("train")
    bundle = build(drv.port_config(cfg))
    ocfg = optim.OptimConfig(**cfg["optimizer"])
    params = drv.program_params(cfg, bundle, SEED, torch.device("cpu"))
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
             "opt": optim.opt_init(ocfg, params)}
    step = make_train_step(bundle, TrainConfig(optim=ocfg), donate=True)
    feed = inputs.Feed(SEED, 2, 64, cfg["vocab_size"], torch.device("cpu"))
    state, _ = step(state, feed.next())
    return bundle, step, state, feed.next()


def _clone(state):
    return map_tree(lambda t: t.clone(), state)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [e for e in prof.events() if e.is_user_annotation]
    return out, ranges


def _span(name: str) -> None:
    with trace.span(name):
        pass


def _node_names(t: torch.Tensor) -> list[str]:
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


def test_a_profile_block_sets_torchs_profiler_flag():
    """The one flag a region reads."""
    assert not torch.autograd.profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
    assert not torch.autograd.profiler._is_profiler_enabled


def test_region_is_the_noop_singleton_without_a_profiler():
    assert trace.region("model.norm") is trace.region("train.step")
    with trace.region("x") as r:
        assert r is trace.region("y")
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.region("x") is not trace.region("y")


def test_without_a_profiler_the_graph_has_no_identity_nodes(cell):
    bundle, _, state, batch = cell

    def loss(profiled: bool):
        live = map_tree(lambda t: t.detach().requires_grad_(True),
                        state["params"])
        if not profiled:
            return bundle.loss_fn(live, batch)[0]
        with profile(activities=[ProfilerActivity.CPU]):
            return bundle.loss_fn(live, batch)[0]

    plain, traced = _node_names(loss(False)), _node_names(loss(True))
    assert IDENTITY not in plain and IDENTITY in traced
    assert sorted(plain) == sorted(n for n in traced if n != IDENTITY)


def test_a_profiled_donated_step_is_bit_equal(cell):
    _, step, state, batch = cell
    plain, m_plain = step(_clone(state), batch)
    (traced, m_traced), _ = _profiled(lambda: step(_clone(state), batch))
    a, b = dict(tree_leaves(plain)), dict(tree_leaves(traced))
    assert a.keys() == b.keys() and len(a) > 30
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    assert [k for k in m_plain
            if not torch.equal(m_plain[k], m_traced[k])] == []


def test_every_region_and_its_bwd_range_is_in_the_profile(cell):
    _, step, state, batch = cell
    layers = REDUCED["num_hidden_layers"]
    _, ranges = _profiled(lambda: step(_clone(state), batch))
    count: dict[str, int] = {}
    for r in ranges:
        count[r.name] = count.get(r.name, 0) + 1
    assert set(count) == set(STEP) | set(MODEL) | {
        f"{m}.bwd" for m in MODEL}, count
    assert {k: count[k] for k in STEP} == dict.fromkeys(STEP, 1)
    leaves = len(tree_leaves(state["params"]["layers"]))
    # the layers run twice, forward and recomputed (remat nothing_saveable)
    assert count["model.attn"] == count["model.mlp"] == 2 * layers
    assert count["model.norm"] == 4 * layers + 1
    assert count["model.layer_slice"] == \
        count["model.layer_slice.bwd"] == leaves * layers
    assert count["model.norm.bwd"] == 2 * layers + 1
    assert count["model.attn.bwd"] == count["model.mlp.bwd"] == layers
    assert count["model.embed.bwd"] == count["model.ce.bwd"] == 1


def test_recomputed_forward_regions_nest_inside_bwd_ranges(cell):
    _, step, state, batch = cell
    _, ranges = _profiled(lambda: step(_clone(state), batch))
    backward = next(r for r in ranges if r.name == "train.backward")
    bwd = [r for r in ranges if r.name.endswith(".bwd")]
    assert bwd and all(backward.time_range.start <= r.time_range.start
                       and r.time_range.end <= backward.time_range.end
                       for r in bwd)
    recomputed = [r for r in ranges if r.name in ("model.attn", "model.mlp")
                  and r.time_range.start > backward.time_range.start]
    assert len(recomputed) == 2 * REDUCED["num_hidden_layers"]
    for r in recomputed:
        assert any(b.time_range.start <= r.time_range.start
                   and r.time_range.end <= b.time_range.end
                   and b.thread == r.thread for b in bwd), r.name


def test_a_span_enters_a_range_only_under_a_profiler():
    trace.enable()
    with trace.capture() as tl:
        _span("engine.submit")
        _, ranges = _profiled(lambda: _span("engine.wait"))
    assert [s.name for s in tl.spans] == ["engine.submit", "engine.wait"]
    assert [r.name for r in ranges] == ["engine.wait"]
    trace.disable()
    assert trace.span("engine.submit") is trace.region("engine.submit")
    with trace.capture() as tl:
        _, ranges = _profiled(lambda: _span("cache.hash"))
    assert tl.spans == [] and [r.name for r in ranges] == ["cache.hash"]


def test_regions_never_reach_a_timeline(cell):
    _, step, state, batch = cell
    trace.enable()
    with trace.capture() as tl:
        _, ranges = _profiled(lambda: step(_clone(state), batch))
    assert len(ranges) > 50
    assert tl.spans == []


def test_a_chunked_ce_is_one_region_a_chunk_and_bit_equal(cell):
    """Under ``ce_chunk`` each chunk's head and CE, recomputed under its
    checkpoint, is one ``model.ce`` range with its ``.bwd``."""
    from repro_torch.training.train_step import value_and_grad

    bundle, _, state, batch = cell
    chunked = build(bundle.cfg.replace(ce_chunk=16))
    plain = value_and_grad(chunked, state["params"], batch)
    traced, ranges = _profiled(
        lambda: value_and_grad(chunked, state["params"], batch))
    (l0, m0), g0 = plain
    (l1, m1), g1 = traced
    assert torch.equal(l0, l1) and all(torch.equal(m0[k], m1[k]) for k in m0)
    a, b = dict(tree_leaves(g0)), dict(tree_leaves(g1))
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    names = [r.name for r in ranges]
    chunks = batch["tokens"].shape[1] // 16
    assert names.count("model.ce") == names.count("model.ce.bwd") == chunks
