"""``cardbench/run.py`` prints a result only where it finds the cell's
cards and the program beside it; on the card, a short run of a cell prints
its whole result line."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cardbench import bench

ROOT = Path(__file__).resolve().parents[2]
WORKLOAD = bench.spec()["workloads"][0]["name"]


def _run(cwd: Path, env: dict | None = None, seconds: str = "1",
         workload: str = WORKLOAD, timeout: int = 300):
    cmd = [sys.executable, "cardbench/run.py", "--workload", workload,
           "--seed", str(2**31 + 5), "--seconds", seconds, "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory with ``BENCHMARK.json`` and ``cardbench/`` only: no
    program, so no result, card or none."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_an_unknown_workload_is_refused():
    out = _run(ROOT, workload="no-such-cell")
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")


@pytest.mark.cuda
def test_a_short_run_on_the_card_prints_a_correct_result(card):
    out = _run(ROOT, seconds="2", workload=bench.spec()["workloads"][-1][
        "name"], timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {
        m["name"] for m in bench.end_to_end(bench.spec(),
                                            bench.spec()["workloads"][-1][
                                                "name"])}
