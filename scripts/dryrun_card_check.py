#!/usr/bin/env python3
"""The dry run held against the card (``chip_smoke.py`` phase 26).

    python3 scripts/dryrun_card_check.py --part card [--out chiprun_out/dryrun_card.json]
    python3 scripts/dryrun_card_check.py --part production --out chiprun_out/dryrun_production.json

Joins a fake process group of 256 ranks
(:func:`repro_torch.configs.setup_fake_devices`), so it runs as its own
process, and prints one ``RESULT:`` JSON line:

(a) world 1 against the card: the dry run's trace of two cells of
    ``aiida-demo-110m`` (its config under the ``baseline`` variant: AdamW,
    ``nothing_saveable``, no kernels) on a fake 1 x 1 mesh, a train cell
    of 8 x 1024 (the state donated) and a decode cell of batch 4 with a
    cache of 1024, both added to ``SHAPES``, and the same config and step
    run for real on the card on zeros: the same counter's per-rank FLOPs
    and argument bytes, the fake trace's aliased bytes against the
    donated argument's (state or cache), the predicted arguments + temp
    against ``max_memory_allocated`` over the step (reset just before it
    with only the arguments resident), and the collectives (none) both
    ways;
(b) one full-width production cell, ``qwen3-4b`` ``train_4k`` on the
    16 x 16 mesh under ``optimized`` (FSDP on): its per-rank memory
    against the card's 80 GB and its wall;
(c) a fake mesh of device type ``cuda`` (2 x 4): the reduced
    ``aiida-demo-110m``'s small train cell under ``optimized`` and one
    Shard(0) -> Shard(1) redistribution (an all-to-all, which a CPU-type
    mesh replaces by a gather), traced on it and on a CPU-type mesh of
    the same shape; the per-kind counts and wire bytes of the two.

``--part card`` runs (a) and (c), ``--part production`` (b), so that a
caller can run the two at once (two fake groups); each writes ``--out``. The checks
themselves are the caller's (``chip_smoke.py``); this script reports.
Without a card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

N_RANKS = 256
ARCH = "aiida-demo-110m"
#: (name, kind, seq_len, global_batch) of (a)'s cells and (c)'s
CARD_CELLS = (("card_train", "train", 1024, 8),
              ("card_decode", "decode", 1024, 4))
SMALL_CELL = ("small_train", "train", 32, 8)
HBM_BYTES = 80 * 10**9


def world_one(torch, dr, mesh, cell) -> dict:
    """(a) for one cell: the fake trace on the 1 x 1 mesh and the real
    step on the card."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.models.registry import build

    var = dr.BASELINE
    bundle = build(dr._apply_variant(get_config(ARCH), var))
    fake = dr.cell_stats(bundle, cell, var, mesh,
                         make_rules(bundle.cfg, mesh, fsdp=var.fsdp))

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device="cuda")

    step, args = dr.cell_inputs(bundle, cell, var, None, None, zeros)
    torch.cuda.synchronize()
    # only the arguments resident: an earlier step's cuBLAS workspaces
    # (allocated on its first product and kept) are freed
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t = time.perf_counter()
    out, counter = dr.trace_step(step, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    del out
    mem = fake["memory_analysis"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    return {
        "fake_flops": fake["cost_analysis"]["flops"],
        "real_flops": float(counter.flops),
        "fake_argument_bytes": mem["argument_size_in_bytes"],
        "real_argument_bytes": dr.local_bytes(args),
        "fake_alias_bytes": mem["alias_size_in_bytes"],
        "donated_bytes": dr.local_bytes(args[dr.DONATED_ARG[cell.kind]]),
        "resident_before_step": resident,
        "predicted_peak_bytes": predicted,
        "max_memory_allocated": peak,
        "peak_rel_err": abs(predicted - peak) / peak,
        "fake_collectives": fake["collectives"]["counts"],
        "real_collectives": counter.collectives()["counts"],
        "fake_trace_s": fake["trace_s"], "real_step_s": wall,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("card", "production"), required=True,
                    help="card: (a) and (c); production: (b)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "dryrun_card.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("dryrun_card_check: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import setup_fake_devices
    from repro_torch.launch import dryrun as dr
    from repro_torch.models.registry import SHAPES, ShapeCell

    setup_fake_devices(N_RANKS)
    for name, kind, seq, batch in (*CARD_CELLS, SMALL_CELL):
        SHAPES[name] = ShapeCell(name, kind, seq, batch)
    out: dict = {"torch": torch.__version__, "fake_ranks": N_RANKS}

    if args.part == "card":
        # (a) world 1 against the card
        t = time.perf_counter()
        one = init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
        out["world1"] = {name: world_one(torch, dr, one, SHAPES[name])
                         for name, *_ in CARD_CELLS}
        out["world1_s"] = time.perf_counter() - t
        # (c) a CUDA-type fake mesh against a CPU-type one
        t = time.perf_counter()
        out["mesh_types"] = mesh_types(dr, SHAPES[SMALL_CELL[0]])
        out["mesh_types_s"] = time.perf_counter() - t
    else:
        t = time.perf_counter()
        out["production"] = production(dr)
        out["production_s"] = time.perf_counter() - t
    out["wall_s"] = time.perf_counter() - t_start
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print("RESULT:" + json.dumps(out))
    return 0


def production(dr) -> dict:
    """(b): the full-width production cell."""
    res = dr.lower_cell("qwen3-4b", "train_4k", multi_pod=False,
                        var=dr.OPTIMIZED)
    mem = res["memory_analysis"]
    per_rank = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    return {"n_devices": res["n_devices"], "trace_s": res["trace_s"],
            "flops": res["cost_analysis"]["flops"], "memory_analysis": mem,
            "per_rank_bytes": per_rank, "hbm_bytes": HBM_BYTES,
            "fits": per_rank <= HBM_BYTES,
            "collectives": res["collectives"]["counts"],
            "total_wire_bytes": res["collectives"]["total_wire_bytes"],
            "local_ops": res["local_ops"]}


def mesh_types(dr, cell) -> dict:
    """(c): one small cell traced on a CPU-type and a CUDA-type fake
    mesh of 2 x 4."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import reduced_config
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.models.registry import build

    var = dr.OPTIMIZED
    bundle = build(dr._apply_variant(reduced_config(ARCH), var))
    out = {}
    for kind in ("cpu", "cuda"):
        mesh = init_device_mesh(kind, (2, 4),
                                mesh_dim_names=("data", "model"))
        stats = dr.cell_stats(bundle, cell, var, mesh,
                              make_rules(bundle.cfg, mesh, fsdp=var.fsdp))
        # and one Shard(0) -> Shard(1) redistribution over model, the
        # all-to-all that a CPU-type mesh replaces
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            local = torch.empty((8, 32), device=kind)
        x = DTensor.from_local(local, mesh, (Replicate(), Shard(0)),
                               run_check=False, shape=torch.Size((32, 32)),
                               stride=(32, 1))
        _, moved = dr.trace_step(lambda t: t.redistribute(
            mesh, (Replicate(), Shard(1))), (x,), mesh, fake)
        coll = moved.collectives()
        out[kind] = {
            "counts": stats["collectives"]["counts"],
            "wire_bytes": stats["collectives"]["wire_bytes"],
            "flops": stats["cost_analysis"]["flops"],
            "non_fake_tensors": stats["local_ops"]["non_fake_tensors"],
            "shard_to_shard": coll["counts"],
            "shard_to_shard_wire_bytes": coll["wire_bytes"]}
    return out


if __name__ == "__main__":
    sys.exit(main())
