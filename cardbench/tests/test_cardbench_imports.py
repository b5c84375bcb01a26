"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level module names are compared
whole: ``repro_torch`` is not ``repro``."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from cardbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((HERE / "reference").rglob("*.py"))


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in imported_tops(path)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("repro_torch.fake", "reprox", "jaxy"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = harness.forbidden_modules()
    assert not {"repro_torch.fake", "reprox", "jaxy"} & set(found)
    for name in ("jaxlib.fake", "repro.fake", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"jaxlib.fake", "repro.fake", "flax"} <= set(
        harness.forbidden_modules())


def test_a_cell_run_loads_no_forbidden_module():
    """Everything the harness and its driver import, in a fresh process."""
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "from cardbench import harness, bench, control\n"
            "from cardbench.reference import train\n"
            "for w in bench.spec()['workloads']:\n"
            "    bench.driver(bench.traffic(w['traffic'])['driver'])\n"
            "import repro_torch.training.train_step\n"
            "import repro_torch.kernels.flash_attention.ops\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
