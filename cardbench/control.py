"""Readings of the control and of a planted fault, each in the program's
place against the reference, for setting the limits of ``correct``.

    python3 cardbench/control.py --workload <name> --seeds 11 12 13

For each seed: the reference's first steps in float32 (the truth), then
the same steps with every matrix product in float8 (the control: the
nearest precision below the bf16 the configuration states) and with half
of each batch left out (a fault), each compared with the truth by the
numbers of ``cardbench.compare``. One JSON line per seed on standard
output. The benchmark's own runs never run this; it runs on the card at
the cell's size (``tests/test_cardbench_control.py`` runs it on the CPU at
a reduced one).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

RUNS = {"control_fp8": {"precision": "fp8"},
        "half_batch": {"half_batch": True}}


def readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    from cardbench import compare
    from cardbench.reference import train as reference

    steps = traffic["check_steps"]
    t = time.perf_counter()
    truth = reference.run(cfg, traffic, seed, device, steps=steps)
    out: dict = {"seed": seed, "reference_s": time.perf_counter() - t,
                 "loss": truth["loss"], "grad_norm": truth["grad_norm"]}
    for name, kw in RUNS.items():
        got = reference.run(cfg, traffic, seed, device, steps=steps, **kw)
        out[name], out[name + "_worst_at"] = compare.gaps(got, truth)
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    root = Path(__file__).resolve().parent.parent
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != root / "cardbench"]
    sys.path.insert(0, str(root))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from cardbench import bench

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    spec = bench.spec()
    w = bench.workload(spec, args.workload)
    cfg, traffic = bench.config(spec, w["config"]), bench.traffic(w["traffic"])
    for seed in args.seeds:
        line = readings(cfg, traffic, seed, "cuda")
        line["workload"] = args.workload
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
