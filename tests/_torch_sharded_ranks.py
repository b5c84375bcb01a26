"""Ranks of the sharded-serving tests (``tests/test_torch_sharded_serving.py``).

Run as a script, it spawns ``data * model`` local gloo ranks with a file
rendezvous under ``--rendezvous-dir``; each rank serves every ``--archs``
config twice, on its own and through the (data, model) mesh, and the
script prints one ``RESULT:`` JSON line with each rank's findings:

    python tests/_torch_sharded_ranks.py --data 1 --model 2 \\
        --archs aiida-demo-110m,qwen2-0.5b,aiida-demo-110m:12/3 \\
        --rendezvous-dir /tmp/rdv

(``arch:H/Hkv`` serves the reduced config with H query and Hkv KV heads.)

The recipe is the reference's ``test_sharded_decode_matches_single_device``:
the reduced config in float32 with the decode kernel's route, prompts (2, 8)
from numpy seed 0, a cache of 32, a prefill and 4 decode steps. Here the
prefill also takes the flash kernel's route (``attn_impl="pallas"``), so
both kernels' plain versions run on each rank's local shards, and the
mesh serves twice more into a cache of 12 (per-row and scalar decode
positions), so that a sequence-sharded cache is written on every rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _serve(bundle, params, cache, prompt, logits_out, scalar_pos=False):
    """Prefill + 4 decode steps through the serving steps; the tokens
    (2, 5), each step's logits appended to ``logits_out``. The decode
    position is a (B,) vector, as the reference's test passes it, or with
    ``scalar_pos`` one scalar for every row."""
    from repro_torch.serving.serve import make_decode_step, make_prefill_step

    def keep(fn):
        def wrapped(*args):
            logits, c = fn(*args)
            full = logits.full_tensor() if hasattr(logits, "full_tensor") \
                else logits
            logits_out.append(full[:, -1].clone())
            return logits, c
        return wrapped

    rec = dataclasses.replace(bundle, prefill_fn=keep(bundle.prefill_fn),
                              decode_fn=keep(bundle.decode_fn))
    prefill, decode = make_prefill_step(rec), make_decode_step(rec)
    tok, cache = prefill(params, {"tokens": prompt}, cache)
    toks = [tok]
    pos = torch.tensor(8 if scalar_pos else [8, 8], dtype=torch.int32)
    for _ in range(4):
        tok, cache = decode(params, cache, tok, pos)
        toks.append(tok)
        pos = pos + 1
    return torch.cat(toks, dim=1)


def serve_cases(rank: int, archs: list[str], data: int, model: int) -> dict:
    from repro_torch.configs import make_serving_mesh, reduced_config
    from repro_torch.distributed.sharding import distribute_tree, make_rules
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import axis_rules
    from repro_torch.models.registry import build

    mesh = make_serving_mesh(data=data, model=model)
    local = make_local_mesh(data, model)
    plain_decode = da_ops.decode_attention_ref
    seen: list[tuple] = []

    def recording_decode(q, k, v, lens, **kw):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return plain_decode(q, k, v, lens, **kw)

    da_ops.decode_attention_ref = recording_decode
    out = {}
    for case in archs:
        # "arch" or "arch:H/Hkv", the reduced config with H query and Hkv
        # KV heads
        arch, _, heads = case.partition(":")
        cfg = reduced_config(arch).replace(
            dtype="float32", kv_cache_dtype="float32", decode_impl="pallas",
            attn_impl="pallas")
        if heads:
            h, hkv = map(int, heads.split("/"))
            cfg = cfg.replace(num_heads=h, num_kv_heads=hkv)
        bundle = build(cfg)
        params = bundle.init_params(0, "cpu")
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            1, cfg.vocab_size, (2, 8)).astype(np.int32))
        single_logits, sharded_logits = [], []
        single = _serve(bundle, params, bundle.init_cache(2, 32, "cpu"),
                        prompt, single_logits)
        rules = make_rules(cfg, mesh, fsdp=False)
        notes: list[str] = []
        sp = distribute_tree(params, bundle.param_axes(), rules, mesh, notes)
        sc = distribute_tree(bundle.init_cache(2, 32, "cpu"),
                             bundle.cache_axes(), rules, mesh, notes)
        seen.clear()
        with axis_rules(mesh, rules):
            sharded = _serve(bundle, sp, sc, prompt, sharded_logits)
            # a cache of 12 = 8 + 4 positions: under sequence sharding the
            # prefill and the decode steps write into every rank's shard
            tight = {scalar: _serve(bundle, sp, distribute_tree(
                bundle.init_cache(2, 12, "cpu"), bundle.cache_axes(), rules,
                mesh), prompt, [], scalar_pos=scalar).tolist()
                for scalar in (False, True)}
        attn = sp["layers"]["attn"]
        out[case] = {
            "single": single.tolist(), "sharded": sharded.tolist(),
            "sharded_cache12": tight[False],
            "sharded_cache12_scalar_pos": tight[True],
            "max_logit_diff": max(float((a - b).abs().max()) for a, b in
                                  zip(single_logits, sharded_logits)),
            "max_logit": max(float(a.abs().max()) for a in single_logits),
            "decode_inputs": sorted(set(seen)),
            "wq_local": list(attn["wq"].to_local().shape),
            "wo_local": list(attn["wo"].to_local().shape),
            "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "heads_rule": str(rules["heads"]), "notes": notes,
            "local_mesh": [list(local.mesh_dim_names), list(local.shape),
                           local.device_type],
        }
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--archs", required=True)
    ap.add_argument("--rendezvous-dir", required=True)
    args = ap.parse_args(argv)
    from repro_torch.configs import spawn_ranks

    import _torch_sharded_ranks as me     # importable by the spawned ranks
    per_rank = spawn_ranks(me.serve_cases, args.data * args.model, "cpu",
                           (args.archs.split(","), args.data, args.model),
                           rendezvous_dir=args.rendezvous_dir)
    print("RESULT:" + json.dumps(per_rank))


if __name__ == "__main__":
    main()
