"""The reference agrees with the port at reduced sizes on the CPU, in
float32: the loss and its gradients, and the first training steps' readings
through the train driver itself. (This test imports both; the reference
imports nothing of the port.)"""

from __future__ import annotations

import pytest
import torch
from conftest import REDUCED, TRAIN_CELLS, reduced_cell

from cardbench import bench, compare, harness, inputs
from cardbench.reference.dense_lm import DenseLM


def _cfg() -> dict:
    return dict(bench.config(bench.spec(), "granite-3-2b"), **REDUCED)


def test_loss_and_gradients_match_the_port_in_float32():
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import build

    cfg = _cfg()
    train = bench.driver("train")
    port = build(train.port_config(cfg).replace(dtype="float32"))
    seed = 7
    params = train.program_params(cfg, port, seed, "cpu")
    feed = inputs.Feed(seed, 2, 64, cfg["vocab_size"], "cpu")
    batch = feed.next()

    live = {p: t.requires_grad_(True) for p, t in tree_leaves(params)}
    loss_port, _ = port.loss_fn(params, batch)
    g_port = dict(zip(live, torch.autograd.grad(loss_port,
                                                list(live.values()))))

    w = {p: t.requires_grad_(True)
         for p, t in inputs.raw_weights(cfg, seed, "cpu").items()}
    loss_ref = DenseLM(cfg).loss(w, batch["tokens"], batch["labels"])
    g_ref = dict(zip(w, torch.autograd.grad(loss_ref, list(w.values()))))

    assert float(loss_port.detach()) == pytest.approx(
        float(loss_ref.detach()), abs=1e-5)
    for path, g in g_ref.items():
        got = g_port[path][:g.shape[0]] if path == "embedding" else \
            g_port[path]
        assert torch.allclose(got, g, rtol=1e-4, atol=1e-7), path


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_first_steps_through_the_driver_match_in_float32(workload):
    cell = reduced_cell(workload)
    cell.cfg["port"] = dict(cell.cfg["port"], options=dict(
        cell.cfg["port"]["options"], dtype="float32"))
    out = bench.driver("train").run(cell)
    assert out["numbers"]["loss_gap"] < 1e-5
    assert out["numbers"]["grad_norm_gap"] < 1e-4
    assert out["numbers"]["grad_leaf_gap"] < 1e-4
    assert out["numbers"]["change_leaf_gap"] < 1e-4
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_a_sound_bf16_run_reads_its_numbers():
    cell = reduced_cell(TRAIN_CELLS[0])
    result = harness.run_cell(bench.spec(), cell)
    assert set(result["checks"]) == set(cell.limits["numbers"])
    assert set(result["checks"]) | set(result["uncompared"]) == \
        set(compare.NUMBERS)
    assert list(result)[-1] == "checks"
    assert all(v["value"] < 0.01 for v in result["checks"].values())
