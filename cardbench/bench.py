"""The benchmark's specification and the files it finds by name.

``BENCHMARK.json`` names the cells and metrics; each configuration, traffic
mix, limit set, driver, per-layer reader, kernel kind and work function is
a file of its own under this directory. A later change adds a cell, a mix,
a kernel kind or a metric by adding files and entries, and edits none.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(SPEC)


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module of its own (the names of
    readers carry dots, so they are loaded by path, not imported)."""
    name = "cardbench_file_" + hashlib.sha1(str(path).encode()).hexdigest()[:12]
    mod_spec = importlib.util.spec_from_file_location(name, path)
    if mod_spec is None or mod_spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {SPEC.name}; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in {SPEC.name}")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return load_json(HERE / "limits" / f"{workload_name}.json")


def driver(name: str) -> ModuleType:
    return load_module(HERE / "drivers" / f"{name}.py")


def work(name: str) -> ModuleType:
    return load_module(HERE / "work" / f"{name}.py")


def peaks() -> dict:
    return load_json(HERE / "peaks.json")


def kinds() -> list[dict]:
    """Every kernel kind, highest ``priority`` first: a kernel takes the
    first kind one of whose patterns its lower-cased name contains."""
    out = [load_json(p) for p in sorted((HERE / "kinds").glob("*.json"))]
    return sorted(out, key=lambda k: (-k["priority"], k["kind"]))


def end_to_end(bench: dict, workload_name: str) -> list[dict]:
    """The end-to-end metrics the cell reports: those without a
    ``workloads`` key, and those whose key lists it."""
    return [m for m in bench["end_to_end"]
            if workload_name in m.get("workloads", [workload_name])]


def per_layer(bench: dict, workload_name: str) -> list[dict]:
    """The per-layer metrics the cell reports: those whose ``workloads``
    list it, and those without the key whose ``moves`` metric it reports."""
    reported = {m["name"] for m in end_to_end(bench, workload_name)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if workload_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out


def reader(metric_name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{metric_name}.py")
