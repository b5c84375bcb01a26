"""Shared pieces of the benchmark's CPU tests: a reduced cell of each
training workload (the configuration's widths cut to a size the CPU runs
in seconds; every other key as the file has it).

    PYTHONPATH=src:. python -m pytest cardbench/tests -q
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from cardbench import bench, harness  # noqa: E402

REDUCED = dict(hidden_size=128, num_attention_heads=4, num_key_value_heads=2,
               head_dim=32, intermediate_size=256, vocab_size=500,
               num_hidden_layers=2)
TRAIN_CELLS = [w["name"] for w in bench.spec()["workloads"]
               if bench.traffic(w["traffic"])["driver"] == "train"]


def reduced_cell(workload: str, seed: int = 2**31 + 11, trace: bool = False,
                 seconds: float = 0.5) -> harness.Cell:
    cell = harness.make_cell(bench.spec(), workload, seed, seconds, trace,
                             "cpu", time.perf_counter())
    cell.cfg = dict(cell.cfg, **REDUCED)
    cell.traffic = dict(cell.traffic, rows=2, seq_len=64)
    return cell


@pytest.fixture
def spec() -> dict:
    return bench.spec()
