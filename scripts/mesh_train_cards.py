#!/usr/bin/env python3
"""Sharded training across cards: the launcher's mesh path on NCCL.

    python3 scripts/mesh_train_cards.py                  # 2 x 2, four cards
    python3 scripts/mesh_train_cards.py --data 2 --model 1

Trains full-width, full-depth ``aiida-demo-110m`` with phase 7's recipe
(fp32 parameters, AdamW, remat ``nothing_saveable``, the flash kernels;
the attention projections fan-in scaled as phase 8 scales them,
``chip_smoke.fan_in_scaled``: at the
reference's init the full-width softmax is nearly an argmax and two
correct summation orders differ by ~1e-3 in the loss;
``--batch`` rows of 1024 tokens per data group, 8 in all on 2 x 2) for
``--steps`` steps through the launcher's per-rank body
(``launch.train.train_rank``, recorded as phase 25 records it:
``chip_smoke.mesh_train_run``) on ``data * model`` NCCL ranks, one card
each (FSDP over ``data`` when it is above 1, heads over ``model``), once
with float32 activations and once with bf16. Then, in this process on
card 0, the same steps without a mesh on the same global batches (each
data group's stream, concatenated in mesh order) from the same seed.

Requires, per rank: every step's flash launches (forward 2 per layer
with the remat recompute, dq and dk/dv 1 per layer), each kernel seeing
H/model query and Hkv/model KV heads and B/data rows, every state shard
on its card; in float32 every step's loss and the first step's
grad_norm (the same parameters on both sides) within 1e-4 relative of
one card's (phase 8's bar; a later step's grad_norm follows AdamW's
first updates, whose signs flip on rounding where a gradient is near
zero, and is printed); bf16 losses finite (their distance from one
card's is printed: the row-parallel products sum bf16 partials). Prints
one JSON line with the losses, the host ms per step (median of steps 2
on), peak memory per rank and the ``nvidia-smi`` lines, and writes it to
``chiprun_out/mesh_train_cards.json``. Exits 1 if a requirement fails.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402  (its per-step recorder and init scaling)

ARCH = "aiida-demo-110m"
SEQ = 1024


def scaled_init(launch) -> None:
    """The launcher's initial state, its attention projections fan-in
    scaled (``chip_smoke.fan_in_scaled``)."""
    init = launch.init_train_state

    def scaled(bundle, tcfg, generator, device=None):
        state = init(bundle, tcfg, generator, device)
        state["params"] = chip_smoke.fan_in_scaled(bundle.cfg,
                                                   state["params"])
        return state

    launch.init_train_state = scaled


def launcher_argv(args, ranks: bool) -> list[str]:
    argv = ["--arch", ARCH, "--steps", str(args.steps), "--batch",
            str(args.batch), "--seq", str(SEQ), "--log-every",
            str(args.steps), "--device", "cuda"]
    if ranks:
        argv += ["--data-mesh", str(args.data), "--model-mesh",
                 str(args.model)]
    return argv


def rank_run(rank: int, argv: list[str], dtype: str) -> dict:
    """One rank's training (a spawned rank of the NCCL group), recorded by
    ``chip_smoke.mesh_train_run``, with the shapes and device of every
    flash forward's inputs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as launch

    counters = (fa_ops.flash_attention_fwd, fa_ops.flash_attention_bwd_dq,
                fa_ops.flash_attention_bwd_dkv)
    seen: set = set()
    plain_fwd = fa_ops._fwd

    def recording_fwd(q, k, v, opts):
        seen.add((tuple(q.shape), tuple(k.shape), q.device.type))
        return plain_fwd(q, k, v, opts)

    fa_ops._fwd = recording_fwd
    scaled_init(launch)
    cfg = get_config(ARCH).replace(attn_impl="pallas", dtype=dtype)
    out = chip_smoke.mesh_train_run(torch, launch, launch.parse_args(argv),
                                    cfg, counters, mesh=True)
    out.update(flash_inputs=sorted(seen),
               device=str(torch.cuda.current_device()))
    return out


def one_card(args, dtype: str) -> dict:
    """The same steps on card 0 without a mesh, on the global batches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.models.registry import build
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    cfg = get_config(ARCH).replace(attn_impl="pallas", dtype=dtype)
    largs = launch.parse_args(launcher_argv(args, True))
    bundle, tcfg = build(cfg), launch.train_config(largs)
    streams = [TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, batch_size=args.batch,
        seed=largs.seed, host_id=g, num_hosts=args.data))
        for g in range(args.data)]
    state = init_train_state(bundle, tcfg, largs.seed, "cuda")
    state["params"] = chip_smoke.fan_in_scaled(cfg, state["params"])
    step_fn = make_train_step(bundle, tcfg)
    out = {"loss": [], "grad_norm": [], "step_ms": []}
    for _ in range(args.steps):
        rows = [s.next_batch() for s in streams]
        batch = {k: torch.from_numpy(np.concatenate([r[k] for r in rows]))
                 .cuda() for k in rows[0]}
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t) * 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4,
                    help="rows per data group")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    import torch

    from repro_torch.configs import get_config, spawn_ranks
    from repro_torch.kernels import _build

    n = args.data * args.model
    if torch.cuda.device_count() < n:
        print(f"needs {n} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    t = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    import mesh_train_cards as me     # importable by the spawned ranks

    cfg = get_config(ARCH)
    layers, h, hkv, hd = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                          cfg.hd)
    want_launches = [2 * layers, layers, layers]
    want_inputs = [((args.batch, SEQ, h // args.model, hd),
                    (args.batch, SEQ, hkv // args.model, hd), "cuda")]
    failures, result = [], {"mesh": [args.data, args.model],
                            "nvidia_smi": smi.strip().splitlines()}
    for dtype in ("float32", "bfloat16"):
        t = time.perf_counter()
        ranks = spawn_ranks(me.rank_run, n, "cuda",
                            (launcher_argv(args, True), dtype))
        wall = time.perf_counter() - t
        single = one_card(args, dtype)
        for r, found in enumerate(ranks):
            if not found["on_card"]:
                failures.append(f"{dtype} rank {r}: a state shard is not "
                                f"on its card")
            if any(l != want_launches for l in found["launches"]):
                failures.append(f"{dtype} rank {r}: launches "
                                f"{found['launches']} != {want_launches}")
            if found["flash_inputs"] != want_inputs:
                failures.append(f"{dtype} rank {r}: flash inputs "
                                f"{found['flash_inputs']}")
        base = ranks[0]
        rel = {what: max(abs(a - b) / abs(b) for a, b in
                         zip(base[what], single[what]))
               for what in ("loss", "grad_norm")}
        if not all(math.isfinite(x) for x in base["loss"]):
            failures.append(f"{dtype}: non-finite loss {base['loss']}")
        first_norm = (abs(base["grad_norm"][0] - single["grad_norm"][0])
                      / abs(single["grad_norm"][0]))
        if dtype == "float32" and max(rel["loss"], first_norm) > 1e-4:
            failures.append(f"float32: mesh vs one card {rel}, first "
                            f"grad_norm {first_norm}")
        result[dtype] = {
            "mesh_loss": base["loss"], "one_card_loss": single["loss"],
            "mesh_grad_norm": base["grad_norm"],
            "one_card_grad_norm": single["grad_norm"],
            "max_rel_diff": rel, "first_grad_norm_rel_diff": first_norm,
            "mesh_step_ms": base["step_ms"],
            "mesh_step_ms_median": base["step_ms_median"],
            "one_card_step_ms": single["step_ms"],
            "one_card_step_ms_median": sorted(single["step_ms"][1:])[
                (len(single["step_ms"]) - 1) // 2],
            "launches_per_step": base["launches"],
            "flash_inputs": base["flash_inputs"],
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
            "ranks_wall_s": wall}
    result["failures"] = failures
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_train_cards.json").write_text(json.dumps(result, indent=1))
    print("mesh train cards: " + json.dumps(result))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main())
