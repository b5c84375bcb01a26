#!/usr/bin/env python3
"""The dry run's cells as one markdown table.

    python3 scripts/dryrun_table.py experiments/dryrun

Reads the JSON files that ``python -m repro_torch.launch.dryrun`` wrote
into a directory and prints one row per (arch, shape), one column per
(variant, mesh) found there: ``skip``, ``ERR`` (with the error's last
line listed under the table), or ``M GB · F TF · W GB · T s``: a rank's
peak memory (arguments + temporaries), its TFLOPs, its total wire bytes
under the ring model, and the trace's wall on the host that ran it.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

MESHES = ("single", "multi")


def cell_text(res: dict | None) -> str:
    if res is None:
        return "—"
    if res.get("skipped"):
        return "skip"
    if "error" in res:
        return "ERR"
    mem = res["memory_analysis"]
    peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    return (f"{peak / 1e9:.1f} GB · "
            f"{res['cost_analysis']['flops'] / 1e12:.1f} TF · "
            f"{res['collectives']['total_wire_bytes'] / 1e9:.2f} GB · "
            f"{res['trace_s']:.0f} s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    args = ap.parse_args(argv)
    cells: dict[tuple, dict] = {}
    for path in sorted(Path(args.directory).glob("*.json")):
        res = json.loads(path.read_text())
        cells[(res["arch"], res["shape"], res["mesh"], res["variant"])] = res
    rows = sorted({(a, s) for a, s, _, _ in cells})
    variants = sorted({v for *_, v in cells},
                      key=lambda v: (v != "baseline", v))
    cols = [(m, v) for v in variants for m in MESHES]
    print("| arch | shape | " + " | ".join(f"{m} {v}" for m, v in cols)
          + " |")
    print("| --- | --- | " + " | ".join("---" for _ in cols) + " |")
    errors = []
    for arch, shape in rows:
        texts = []
        for mesh, var in cols:
            res = cells.get((arch, shape, mesh, var))
            texts.append(cell_text(res))
            if res is not None and "error" in res:
                last = res["error"].strip().splitlines()[-1]
                errors.append(f"{arch} {shape} {mesh} {var}: {last}")
        print(f"| {arch} | {shape} | " + " | ".join(texts) + " |")
    for line in errors:
        print(f"- {line}")


if __name__ == "__main__":
    main()
