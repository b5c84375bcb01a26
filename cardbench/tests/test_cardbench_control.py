"""The control and the faults at a size a test run holds (the chip runs
the control at the cells' own: ``cardbench/control.py``).

* The control, the reference in the program's place with every product in
  float8, reads at least three times what a sound bf16 run of the program
  reads on some number.
* A run whose timed step is broken underneath comes out not correct under
  the cell's limits: a step that returns its state unchanged, and one that
  leaves out half of each batch and takes the mean over the rest.
"""

from __future__ import annotations

import pytest
from conftest import TRAIN_CELLS, reduced_cell

from cardbench import bench, compare, control, harness

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.parametrize("seed", SEEDS)
def test_control_reads_far_above_a_sound_run(seed):
    cell = reduced_cell(TRAIN_CELLS[0], seed=seed)
    sound = bench.driver("train").run(cell)["numbers"]
    ctl = control.readings(cell.cfg, cell.traffic, seed, "cpu")
    assert any(ctl["control_fp8"][n] >= 3 * sound[n]
               for n in compare.NUMBERS), (ctl["control_fp8"], sound)
    assert ctl["half_batch"]["grad_norm_gap"] > 0.2


def _unchanged(make):
    """A step that computes its loss and returns its state as it was."""
    def factory(*args, **kw):
        real = make(*args, **kw)

        def step(state, batch):
            import torch

            saved = {k: [t.clone() for t in v] for k, v in
                     (("p", _flat(state)),)}
            new, metrics = real(state, batch)
            with torch.no_grad():
                for t, s in zip(_flat(new), saved["p"]):
                    t.copy_(s)
            return new, metrics
        return step
    return factory


def _half_batch(make):
    """A step that trains on the first half of each batch's rows."""
    def factory(*args, **kw):
        real = make(*args, **kw)

        def step(state, batch):
            half = next(iter(batch.values())).shape[0] // 2
            return real(state, {k: v[:half] for k, v in batch.items()})
        return step
    return factory


def _flat(state):
    from repro_torch.models.common import tree_leaves

    return [t for _, t in tree_leaves(state)]


@pytest.mark.parametrize("workload", TRAIN_CELLS)
@pytest.mark.parametrize("fault,caught_by", [
    (_unchanged, "change_leaf_gap"), (_half_batch, "grad_norm_gap")])
def test_a_broken_step_is_not_correct(monkeypatch, workload, fault,
                                      caught_by):
    from repro_torch.training import train_step

    monkeypatch.setattr(train_step, "make_train_step",
                        fault(train_step.make_train_step))
    result = harness.run_cell(bench.spec(), reduced_cell(workload))
    assert result["correct"] is False
    check = result["checks"][caught_by]
    assert check["value"] > check["limit"]
