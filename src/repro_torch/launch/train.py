"""Single-device training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch aiida-demo-110m \
        --steps 50 --batch 2 --seq 64 --reduced --device cpu \
        --ckpt-dir "$(mktemp -d)"

Counterpart of ``repro.launch.train`` with the same flags, plus
``--device`` (``cuda`` unless given): config -> data pipeline -> train
step -> checkpoints in the reference's format, with resume from the
latest. As in the reference, a resume restores the train state and
starts the data stream afresh from its seed. A NaN loss exits with code
310, the engine's code for it. Meshes above one device wait for the
multi-device slice that shards training (sharded serving runs through
:mod:`repro_torch.serving.serve` under a mesh).
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models.registry import build
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optim import OptimConfig
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             make_train_step)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    if args.data_mesh > 1 or args.model_mesh > 1:
        raise NotImplementedError(
            "training on a data/model mesh above one device waits for the "
            "multi-device slice that shards training (ROADMAP queue 1, "
            "item 2.1: optimizer-state axes, per-shard checkpoints, data "
            "by rank)")
    device = torch.device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    bundle = build(cfg)
    tcfg = TrainConfig(
        optim=OptimConfig(name=args.optimizer, lr=args.lr,
                          warmup_steps=max(1, args.steps // 20),
                          total_steps=args.steps),
        microbatches=args.microbatches,
        seed=args.seed)
    data = TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
        seed=args.seed))
    step_fn = make_train_step(bundle, tcfg)

    state = init_train_state(bundle, tcfg, args.seed, device)
    start_step = 0
    if args.ckpt_dir and ckpt_mod.latest_step(args.ckpt_dir) is not None:
        state = ckpt_mod.restore_checkpoint(args.ckpt_dir, target=state,
                                            device=device)
        start_step = int(state["step"])
        print(f"[train] resumed from step {start_step}")
    checkpointer = (ckpt_mod.AsyncCheckpointer(args.ckpt_dir)
                    if args.ckpt_dir else None)

    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.next_batch().items()}
        state, metrics = step_fn(state, batch)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss = float(metrics["loss"])
            if math.isnan(loss):
                raise SystemExit(310)   # NaN -> exit code for the engine
            dt = time.time() - t0
            tput = args.log_every * args.batch * args.seq / max(dt, 1e-9)
            print(f"[train] step {step+1}/{args.steps} "
                  f"loss={loss:.4f} lr={float(metrics['lr']):.2e} "
                  f"grad_norm={float(metrics['grad_norm']):.2f} "
                  f"({tput:.0f} tok/s)", flush=True)
            t0 = time.time()
        if checkpointer and (step + 1) % args.ckpt_every == 0:
            checkpointer.save(step + 1, state)
    if checkpointer:
        checkpointer.save(args.steps, state)
        checkpointer.wait()
        print(f"[train] final checkpoint at {checkpointer.last_path}")


if __name__ == "__main__":
    main()
