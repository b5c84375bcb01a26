#!/usr/bin/env python3
"""Two gloo ranks sharing one CUDA card: where, if anywhere, they die.

    python3 scripts/gloo_two_ranks_one_card.py

NCCL refuses two ranks on one device, so a sharding mesh over one card
could only run on gloo with CUDA tensors. The script starts two rank
processes (``--rank``), each with ``faulthandler`` enabled and its
standard error in ``chiprun_out/gloo_rank<r>.err``. Each joins a gloo
group through a file rendezvous, builds a 1 x 2 ``(data, model)`` device
mesh of type ``cuda`` and runs four stages, announcing each on standard
error before it starts: a gloo all-reduce of a CUDA tensor; a DTensor
placed on the mesh and gathered; a prefill and 4 decode steps of the
reduced ``aiida-demo-110m`` (float32, the flash and decode kernels on
each rank's heads) against the same on one device; the gradients of its
loss against one device's. The parent waits for both (240 s), then
prints one JSON line per rank (exit code, the last stage begun, the
stages finished, the tail of standard error: the Python stack of a fatal
signal) and exits 0: nothing depends on the outcome.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STAGES = ("allreduce", "dtensor", "serve", "grad")


def stage(name: str) -> None:
    print(f"STAGE {name}", file=sys.stderr, flush=True)


def rank_main(rank: int, world: int, rendezvous: str) -> None:
    import faulthandler

    faulthandler.enable()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank)
    try:
        stage("allreduce")
        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        assert t.tolist() == [3.0] * 4, t
        print("DONE allreduce", file=sys.stderr, flush=True)

        stage("dtensor")
        from torch.distributed.tensor import Shard, distribute_tensor

        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        x = torch.arange(8.0, device="cuda").reshape(2, 4)
        d = distribute_tensor(x, mesh, [Shard(0), Shard(1)])
        assert torch.equal(d.full_tensor(), x)
        print("DONE dtensor", file=sys.stderr, flush=True)

        from repro_torch.configs import reduced_config
        from repro_torch.distributed.sharding import (distribute_tree,
                                                      make_rules)
        from repro_torch.models.common import axis_rules, tree_leaves
        from repro_torch.models.registry import build
        from repro_torch.serving.serve import (make_decode_step,
                                               make_prefill_step)
        from repro_torch.training.train_step import value_and_grad

        stage("serve")
        cfg = reduced_config("aiida-demo-110m").replace(
            dtype="float32", kv_cache_dtype="float32", attn_impl="pallas",
            decode_impl="pallas")
        bundle = build(cfg)
        params = bundle.init_params(0, "cuda")
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            1, cfg.vocab_size, (2, 8)).astype(np.int32)).cuda()
        rules = make_rules(cfg, mesh, fsdp=False)

        def greedy(p, cache):
            tok, cache = make_prefill_step(bundle)(p, {"tokens": prompt},
                                                   cache)
            toks, pos = [tok], torch.full((2,), 8, dtype=torch.int32,
                                          device="cuda")
            for _ in range(4):
                tok, cache = make_decode_step(bundle)(p, cache, tok, pos)
                toks.append(tok)
                pos = pos + 1
            return torch.cat(toks, dim=1).cpu()

        single = greedy(params, bundle.init_cache(2, 32, "cuda"))
        sp = distribute_tree(params, bundle.param_axes(), rules, mesh)
        sc = distribute_tree(bundle.init_cache(2, 32, "cuda"),
                             bundle.cache_axes(), rules, mesh)
        with axis_rules(mesh, rules):
            sharded = greedy(sp, sc)
        assert torch.equal(single, sharded), (single, sharded)
        print("DONE serve", file=sys.stderr, flush=True)

        stage("grad")
        batch = {"tokens": prompt, "labels": prompt}
        (l1, _), g1 = value_and_grad(bundle, params, batch)
        with axis_rules(mesh, rules):
            (l2, _), g2 = value_and_grad(bundle, sp, batch)
        assert abs(float(l1) - float(l2.full_tensor())) <= 1e-5 * float(l1)
        want = dict(tree_leaves(g1))
        worst = max(float((g.full_tensor() - want[k]).norm()
                          / want[k].norm().clamp_min(1e-30))
                    for k, g in tree_leaves(g2))
        assert worst <= 1e-4, worst
        print("DONE grad", file=sys.stderr, flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--rendezvous")
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.world, args.rendezvous)
        return 0
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "rendezvous")
        errs = [out / f"gloo_rank{r}.err" for r in range(args.world)]
        procs = []
        for r, err in enumerate(errs):
            with open(err, "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, "--rank", str(r), "--world",
                     str(args.world), "--rendezvous", rdv],
                    stdout=subprocess.DEVNULL, stderr=fh))
        deadline = time.monotonic() + 240
        for p in procs:
            try:
                p.wait(max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        text = err.read_text()
        begun = [l.split()[1] for l in text.splitlines()
                 if l.startswith("STAGE ")]
        done = [l.split()[1] for l in text.splitlines()
                if l.startswith("DONE ")]
        print(json.dumps({"rank": r, "exit_code": p.returncode,
                          "last_stage_begun": begun[-1] if begun else None,
                          "stages_done": done,
                          "stderr_tail": text[-3000:]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
