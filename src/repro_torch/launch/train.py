"""Training launcher, on one device or on a data x model mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch aiida-demo-110m \
        --steps 50 --batch 2 --seq 64 --reduced --device cpu \
        --ckpt-dir "$(mktemp -d)"
    # four gloo ranks, FSDP over data and heads over model:
    PYTHONPATH=src python -m repro_torch.launch.train --arch aiida-demo-110m \
        --steps 4 --reduced --device cpu --data-mesh 2 --model-mesh 2 \
        --ckpt-dir "$(mktemp -d)"

Counterpart of ``repro.launch.train`` with the same flags, plus
``--device`` (``cuda`` unless given): config -> mesh + sharding rules ->
data pipeline -> train step -> checkpoints in the reference's format,
with resume from the latest. As in the reference, a resume restores the
train state and starts the data stream afresh from its seed. A NaN loss
exits with code 310, the engine's code for it.

On one device without a process group the step runs on plain tensors.
Otherwise each rank runs :func:`train_rank`: a process started with
``RANK`` and ``WORLD_SIZE`` set (``torchrun``, or
:func:`~repro_torch.configs.devices.spawn_ranks`) joins the process group
itself; without them :func:`main` spawns ``data * model`` local ranks,
gloo for ``--device cpu`` and NCCL for the card, and waits for them with
no deadline (it fails when a rank raises or exits without a result). On the mesh the state
is placed by :func:`~repro_torch.training.train_step.train_state_axes`
(FSDP over ``data`` when ``--data-mesh`` > 1), each data group reads its
own stream (``host_id`` / ``num_hosts`` are its index and count) of
``--batch`` rows, every rank writes its shards of each checkpoint, a
restore places the state on whatever mesh resumes, and rank 0 alone
prints.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs import (get_config, reduced_config, setup_devices,
                                 spawn_ranks)
from repro_torch.distributed.sharding import (batch_coordinate, make_rules,
                                              place_tree, shard_batch,
                                              tree_placements)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.common import ModelConfig, axis_rules, whole
from repro_torch.models.registry import build
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optim import OptimConfig
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             make_train_step,
                                             train_state_axes,
                                             train_state_shapes)


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


def model_config(args: argparse.Namespace) -> ModelConfig:
    return reduced_config(args.arch) if args.reduced else get_config(args.arch)


def train_config(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        optim=OptimConfig(name=args.optimizer, lr=args.lr,
                          warmup_steps=max(1, args.steps // 20),
                          total_steps=args.steps),
        microbatches=args.microbatches,
        seed=args.seed)


def run(args: argparse.Namespace, *, cfg: ModelConfig | None = None,
        mesh=None, on_step: Callable[[int, Any, dict], None] | None = None
        ) -> int:
    """Train as ``args`` say, on ``mesh`` (every rank of its process group
    calls this) or, without one, on ``args.device``; returns the exit
    code, 0 or 310 for a NaN loss, the same on every rank. ``cfg``
    replaces the arch's config (a route such as ``attn_impl``);
    ``on_step(step, state, metrics)`` sees every step's result."""
    cfg = cfg or model_config(args)
    bundle = build(cfg)
    tcfg = train_config(args)
    rules = state_pl = None
    host_id, num_hosts, rank0 = 0, 1, True
    if mesh is None:
        device = torch.device(args.device)
    else:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device("cpu"))
        rules = make_rules(cfg, mesh, fsdp=args.data_mesh > 1)
        state_pl = tree_placements(train_state_shapes(bundle, tcfg),
                                   train_state_axes(bundle, tcfg), rules,
                                   mesh)
        host_id, num_hosts = batch_coordinate(mesh, rules)
        rank0 = dist.get_rank() == 0
    data = TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
        seed=args.seed, host_id=host_id, num_hosts=num_hosts))
    step_fn = make_train_step(bundle, tcfg, state_pl)

    start_step = 0
    if args.ckpt_dir and ckpt_mod.latest_step(args.ckpt_dir) is not None:
        state = ckpt_mod.restore_checkpoint(
            args.ckpt_dir, target=train_state_shapes(bundle, tcfg),
            device=device, mesh=mesh, placements=state_pl)
        start_step = int(whole(state["step"]))
        if rank0:
            print(f"[train] resumed from step {start_step}")
    else:
        state = init_train_state(bundle, tcfg, args.seed, device)
        if mesh is not None:
            state = place_tree(state, state_pl, mesh)
    checkpointer = (ckpt_mod.AsyncCheckpointer(args.ckpt_dir)
                    if args.ckpt_dir else None)

    t0 = time.time()
    with (contextlib.nullcontext() if mesh is None
          else axis_rules(mesh, rules)):
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in data.next_batch().items()}
            if mesh is not None:
                batch = shard_batch(batch, bundle.batch_axes(), rules, mesh)
            state, metrics = step_fn(state, batch)
            if on_step is not None:
                on_step(step + 1, state, metrics)
            if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
                loss = float(metrics["loss"]) if rank0 else 0.0
                if _nan_on_rank0(loss, mesh, device):
                    return 310      # NaN -> exit code for the engine
                dt = time.time() - t0
                tput = (args.log_every * args.batch * num_hosts * args.seq
                        / max(dt, 1e-9))
                if rank0:
                    print(f"[train] step {step+1}/{args.steps} "
                          f"loss={loss:.4f} lr={float(metrics['lr']):.2e} "
                          f"grad_norm={float(metrics['grad_norm']):.2f} "
                          f"({tput:.0f} tok/s)", flush=True)
                t0 = time.time()
            if checkpointer and (step + 1) % args.ckpt_every == 0:
                checkpointer.save(step + 1, state)
        if checkpointer:
            if checkpointer.last_step != args.steps:
                checkpointer.save(args.steps, state)
            checkpointer.wait()
            if rank0:
                print(f"[train] final checkpoint at {checkpointer.last_path}")
    return 0


def _nan_on_rank0(loss: float, mesh, device: torch.device) -> bool:
    """Whether rank 0's loss is NaN, on every rank (rank 0 alone reads the
    loss; a one-element broadcast tells the others)."""
    if mesh is None:
        return math.isnan(loss)
    flag = torch.tensor([float(math.isnan(loss))], device=device)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def train_rank(args: argparse.Namespace, *, cfg: ModelConfig | None = None,
               on_step: Callable[[int, Any, dict], None] | None = None
               ) -> int:
    """One rank's training on the ``(--data-mesh, --model-mesh)`` mesh over
    the process group this process has joined
    (:func:`~repro_torch.configs.devices.setup_devices`); returns the exit
    code. See :func:`run` for ``cfg`` and ``on_step``."""
    mesh = make_local_mesh(args.data_mesh, args.model_mesh)
    return run(args, cfg=cfg, mesh=mesh, on_step=on_step)


def _spawned_rank(rank: int, argv: list[str]) -> int:
    return train_rank(parse_args(argv))


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    ranks = args.data_mesh * args.model_mesh
    platform = "cpu" if args.device == "cpu" else "cuda"
    if "WORLD_SIZE" in os.environ:          # one rank of a started group
        setup_devices(platform, ranks)
        code = train_rank(args)
    elif ranks > 1:
        argv = sys.argv[1:] if argv is None else list(argv)
        codes = spawn_ranks(_spawned_rank, ranks, platform, (argv,),
                            timeout=None)
        if len(set(codes)) != 1:
            raise RuntimeError(f"the ranks' exit codes differ: {codes}")
        code = codes[0]
    else:
        code = run(args)
    if code:
        raise SystemExit(code)


if __name__ == "__main__":
    main()
