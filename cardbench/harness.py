"""One run of one cell: the driver the cell's traffic names, the per-layer
readers, the check of ``correct``, and the result line.

The result is the last line of standard output, one JSON object::

    {"correct", "attempted", "failed", "metrics", "device", ["breakdown"],
     "checks"}

``checks`` (last) holds each number that decides ``correct`` beside its
limit; the same numbers are the last lines of standard error. A run that
finds no card, finds JAX or the JAX package loaded once the window has
closed, or fails, prints no result and exits with another code than 0.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any

from cardbench import bench, compare

#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4


@dataclasses.dataclass
class Cell:
    workload: str
    seed: int
    seconds: float
    trace: bool
    cfg: dict
    traffic: dict
    limits: dict
    device: str
    t0: float                      # process start, on time.perf_counter
    kinds: list[dict]
    peaks: dict


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def make_cell(spec: dict, workload: str, seed: int, seconds: float,
              trace: bool, device: str, t0: float) -> Cell:
    w = bench.workload(spec, workload)
    return Cell(workload=workload, seed=seed, seconds=seconds, trace=trace,
                cfg=bench.config(spec, w["config"]),
                traffic=bench.traffic(w["traffic"]),
                limits=bench.limits(workload), device=device, t0=t0,
                kinds=bench.kinds(), peaks=bench.peaks())


def run_cell(spec: dict, cell: Cell) -> dict:
    """Run ``cell`` on its device and build its result (no card check: the
    caller makes it)."""
    out = bench.driver(cell.traffic["driver"]).run(cell)
    correct, checks = compare.judge(out["numbers"], cell.limits)
    result: dict[str, Any] = {
        "correct": bool(correct and out["failed"] == 0),
        "attempted": out["attempted"], "failed": out["failed"]}
    metrics: dict[str, dict] = {}
    if cell.trace:
        ctx = out["reader_ctx"]
        for m in bench.per_layer(spec, cell.workload):
            value = bench.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench.end_to_end(spec, cell.workload):
            metrics[m["name"]] = {"value": out[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info(cell.device, out)
    if cell.trace:
        result["breakdown"] = out["trace"].breakdown()
    result["seconds"] = {k: out[k] for k in ("setup_s", "window_s",
                                             "reference_s") if k in out}
    result["uncompared"] = {k: v for k, v in out["numbers"].items()
                            if k not in checks}
    result["worst_at"] = out["worst_at"]
    result["readings"] = out["readings"]
    result["checks"] = checks          # last on the line
    return result


def device_info(device: str, out: dict) -> dict:
    import torch

    info: dict[str, Any] = {"platform": "gpu" if device == "cuda" else device,
                            "count": 1,
                            "memory_peak_bytes": out["memory_peak_bytes"]}
    info["kind"] = (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu")
    if "trace" in out:
        info["busy_s"] = out["trace"].busy_s
        info["window_s"] = out["trace"].window_s
    return info


def report_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)


def main(workload: str, seed: int, seconds: float, trace: bool,
         t0: float) -> int:
    import torch

    spec = bench.spec()
    w = bench.workload(spec, workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"cardbench: {workload} needs {w['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return EXIT_NO_CARD
    cell = make_cell(spec, workload, seed, seconds, trace, "cuda", t0)
    result = run_cell(spec, cell)
    found = forbidden_modules()
    if found:
        print(f"cardbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return EXIT_FORBIDDEN
    report_checks(result["checks"])
    print(json.dumps(result))
    return 0
