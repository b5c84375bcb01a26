"""Ranks of the sharded-training tests (``tests/test_torch_sharded_training.py``).

Run as a script, it spawns ``data * model`` local gloo ranks with a file
rendezvous under ``--rendezvous-dir``; each rank runs every case of
``--spec`` (JSON) on its own and through the (data, model) mesh, and the
script prints one ``RESULT:`` JSON line with each rank's findings:

    python tests/_torch_sharded_train_ranks.py --data 2 --model 1 \\
        --spec '{"cases": ["adamw"]}' --rendezvous-dir /tmp/rdv

With ``--all`` it runs every mesh of the tests (``mesh_specs``) and the
launcher on 2 x 2, 1 x 2 and 2 x 1 (``LAUNCH_CASES``: the LM families,
the hybrid, whisper with its frames by data group), holds each case to the
tests' bars (``case_failures``, ``probe_failures``, checkpoints restored
bit-equal), prints one line per case and exits 1 if one failed. It needs
no JAX, so it checks the port's meshes under whatever torch a machine
has (DTensor's rules differ across versions):

    python tests/_torch_sharded_train_ranks.py --all --rendezvous-dir "$(mktemp -d)"

A training case (``adamw``, ``adamw_chunked_ce``, ``adafactor``,
``micro2``, ``moe``, ``moe_uneven``, ``odd_rows``, ``moe_odd_rows``,
``vlm``, ``kv_whole``,
``kv_whole_fsdp``, ``heads_whole_fsdp``, and the hybrid's, the ssm
family's and whisper's ``hybrid``, ``ssm``, ``whisper``: the table
``CASES``) takes a reduced config
in float32 on the flash kernel's route (its plain versions
run on each rank's local shards; the hybrid's scan on its wrapper's),
the reference's init from seed 0 with
the attention projections fan-in scaled, and a global batch from numpy
(whisper's frames too):
the gradients at the initial state, then two train steps, one device's
and the mesh's (each rank feeds its data group's rows). It reports the
loss and grad_norm both ways, each gradient and each state leaf's
distance over its norm, and each leaf's local shape. ``save`` writes the
mesh's state after the two steps of the first case as a checkpoint,
``save_lists`` a list-of-layers state per case (a training case's after
its two steps, else its initial state placed on the mesh);
``restore`` places a checkpoint on the mesh; ``"fsdp": false`` trains
without FSDP on a mesh with data > 1; ``probe`` records what the
mesh's sites hand on (``probe_local_shards``). Every mesh also reports
each rank's share of a whisper batch (``frames_by_rank``). Leaves are
compared across processes by the SHA-256 of their bytes.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

#: case -> (arch, optimizer, microbatches, global batch rows, ce_chunk,
#: config overrides)
CASES = {
    "adamw": ("aiida-demo-110m", "adamw", 1, 4, 0),
    # one KV head: on 1 x 2 it stays whole on both ranks, which read it
    "kv_whole": ("aiida-demo-110m", "adamw", 1, 4, 0, {"num_kv_heads": 1}),
    # 12/3 heads under FSDP on 2 x 2: the three KV heads stay whole on
    # both model ranks while the projections' embed dim is over data
    "kv_whole_fsdp": ("aiida-demo-110m", "adamw", 1, 4, 0,
                      {"num_heads": 12, "num_kv_heads": 3}),
    # 3/1 heads under FSDP on 2 x 2: the query heads whole too
    "heads_whole_fsdp": ("aiida-demo-110m", "adamw", 1, 4, 0,
                         {"num_heads": 3, "num_kv_heads": 1}),
    "adamw_chunked_ce": ("aiida-demo-110m", "adamw", 1, 4, 8),
    "adafactor": ("aiida-demo-110m", "adafactor", 1, 4, 0),
    "micro2": ("aiida-demo-110m", "adamw", 2, 8, 0),
    "moe": ("moonshot-v1-16b-a3b", "adamw", 1, 4, 0),
    # 12 x 16 tokens in 3 groups of 64 under FSDP on 2 x 2: the 2 data
    # groups cannot split them (each rank's 96 tokens end inside a group),
    # so the groups stay whole on every rank
    "moe_uneven": ("moonshot-v1-16b-a3b", "adamw", 1, 12, 0),
    # 6 x 16 tokens on 2 x 2 under FSDP: 3 rows per data group, which the
    # model axis cannot split evenly
    "odd_rows": ("aiida-demo-110m", "adamw", 1, 6, 0),
    "moe_odd_rows": ("moonshot-v1-16b-a3b", "adamw", 1, 6, 0),
    "vlm": ("llava-next-34b", "adamw", 1, 4, 0),
    # the list-of-layers families and the encoder-decoder, each at its
    # published attention sharding ("sequence"); the hybrid's scan on its
    # wrapper (forward and reversed scan), the xLSTM on the plain
    # chunkwise form (the mLSTM kernel has no backward)
    "hybrid": ("recurrentgemma-2b", "adamw", 1, 4, 0, {"use_pallas": True}),
    "ssm": ("xlstm-350m", "adamw", 1, 4, 0),
    "whisper": ("whisper-large-v3", "adamw", 1, 4, 0),
}
SEQ = 16
#: (data, model) -> the training cases that mesh runs
MESH_CASES = {(2, 1): ("adamw", "adafactor", "micro2", "ssm"),
              (1, 2): ("adamw", "kv_whole", "moe", "vlm", "hybrid",
                       "whisper"),
              (2, 2): ("adamw_chunked_ce", "kv_whole_fsdp",
                       "heads_whole_fsdp", "moe_uneven", "odd_rows",
                       "moe_odd_rows")}
#: cases held row for row: the mesh splits the rows over ``data`` without
#: FSDP (no parameter dim is split, so no product is summed in another
#: order), and the one-device side runs the global batch in the mesh's
#: data-group row blocks (as microbatches: the same step, the same sums),
#: so that each row meets the ops at the batch size the mesh's ranks do.
#: The reduced xLSTM amplifies float32 rounding ~400x at the reference's
#: init (the group norm of a near-zero mLSTM head output: its float32
#: gradients are 1.6e-3 of their norm from float64's), so a product's
#: rounding in another order would swamp what the bars hold; row for row
#: the mesh's gradients and states are one device's, bit for bit
ROW_BLOCKED = ("ssm",)
#: the list-of-layers states that 1 x 2 saves per rank
LIST_CASES = ("hybrid", "ssm")
#: (data, model) -> the cases whose sites that mesh probes
PROBE_CASES = {(1, 2): ("adamw", "moe", "vlm"), (2, 2): ("adamw_chunked_ce",)}
#: loss (and grad_norm) rtol; each leaf's distance over its norm
LOSS_RTOL, LEAF_TOL = 1e-5, 1e-4
#: a leaf whose gradient is zero but for rounding (whisper's key biases:
#: softmax is shift-invariant along the keys, and with no rotary
#: embedding q . bk is the same for every key) has no norm to hold it to:
#: its gradient and AdamW moments are held absolutely, at
#: ``tests/test_torch_encdec.py``'s ``ZERO_GRAD_TOL``, and the parameter
#: to within twice the sum of the steps' learning rates (AdamW turns a
#: rounding-sized gradient into a step of up to ~lr in either direction)
ZERO_GRAD_TOL = 1e-5
#: the launcher's runs of ``--all``: reduced, 2 steps on CPU ranks
LAUNCH_CASES = (("--arch", "aiida-demo-110m", "--data-mesh", "2",
                 "--model-mesh", "2"),
                ("--arch", "qwen2-0.5b", "--data-mesh", "2", "--model-mesh",
                 "2"),
                ("--arch", "moonshot-v1-16b-a3b", "--model-mesh", "2"),
                ("--arch", "recurrentgemma-2b", "--model-mesh", "2"),
                ("--arch", "whisper-large-v3", "--data-mesh", "2"))


def case_config(case: str):
    from repro_torch.configs import reduced_config

    arch, _, _, _, ce_chunk, *overrides = CASES[case]
    return reduced_config(arch).replace(**{
        "dtype": "float32", "kv_cache_dtype": "float32",
        "attn_impl": "pallas", "ce_chunk": ce_chunk,
        **(overrides or [{}])[0]})


def train_config(case: str):
    from repro_torch.training.optim import OptimConfig
    from repro_torch.training.train_step import TrainConfig

    _, opt, micro, *_ = CASES[case]
    return TrainConfig(optim=OptimConfig(name=opt, warmup_steps=1,
                                         total_steps=10),
                       microbatches=micro)


def fan_in_scaled(cfg, params):
    """Every attention's projections (each dict with a ``wq``: the LM's
    stacked layers, the hybrid's attention layers, whisper's three)
    rescaled to std 1/sqrt(the fan-in they contract over), as
    ``tests/test_torch_training.py::_fan_in_scaled`` does (float32
    rounding then stays ~1e-6 of the gradients)."""
    if isinstance(params, list):
        return [fan_in_scaled(cfg, p) for p in params]
    if not isinstance(params, dict):
        return params
    if "wq" in params:
        attn = params
        for name in ("wq", "wk", "wv"):
            attn[name] = attn[name] * np.float32(
                (attn[name].shape[-2] / cfg.d_model) ** 0.5)
        attn["wo"] = attn["wo"] * np.float32(
            (attn["wo"].shape[-2] / (cfg.num_heads * cfg.hd)) ** 0.5)
        return attn
    return {k: fan_in_scaled(cfg, v) for k, v in params.items()}


def initial_state(case: str):
    """The train state every rank starts from (one device's, whole)."""
    from repro_torch.models.registry import build
    from repro_torch.training.train_step import init_train_state

    cfg = case_config(case)
    state = init_train_state(build(cfg), train_config(case), 0, "cpu")
    state["params"] = fan_in_scaled(cfg, state["params"])
    return state


def global_batches(case: str, n: int = 2) -> list[dict]:
    cfg = case_config(case)
    rows = CASES[case][3]
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        r = rng.integers(1, cfg.vocab_size, (rows, SEQ + 1)).astype(np.int32)
        out.append({"tokens": torch.from_numpy(r[:, :-1].copy()),
                    "labels": torch.from_numpy(r[:, 1:].copy())})
        if cfg.family == "vlm":
            out[-1]["patches"] = torch.from_numpy(rng.normal(
                0, 1, (rows, cfg.num_patches, cfg.d_model)).astype(np.float32))
        if cfg.family == "audio":
            out[-1]["frames"] = torch.from_numpy(rng.normal(
                0, 1, (rows, cfg.num_frames, cfg.d_model)).astype(np.float32))
    return out


def digest(tree) -> dict[str, str]:
    """Path -> SHA-256 of the whole leaf's dtype, shape and bytes (a
    DTensor's gathered first)."""
    from repro_torch.models.common import is_dtensor, tree_leaves

    out = {}
    for key, t in tree_leaves(tree):
        t = t.full_tensor() if is_dtensor(t) else t
        a = np.ascontiguousarray(t.detach().cpu().numpy() if
                                 isinstance(t, torch.Tensor) else t)
        out[key] = hashlib.sha256(
            f"{a.dtype}{a.shape}".encode() + a.tobytes()).hexdigest()
    return out


def _rel(got, want) -> float:
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp_min(1e-30))


def _local_batch(batch, bundle, rules, mesh):
    from repro_torch.distributed.sharding import batch_coordinate, shard_batch

    idx, n = batch_coordinate(mesh, rules)
    rows = next(iter(batch.values())).shape[0] // n
    own = {k: v[idx * rows:(idx + 1) * rows] for k, v in batch.items()}
    return shard_batch(own, bundle.batch_axes(), rules, mesh)


def train_case(case: str, mesh, data: int, on_mesh: list, fsdp: bool = True
               ) -> tuple[dict, dict]:
    """One device against the mesh: (findings, the mesh's state after two
    steps). ``on_mesh[0]`` is set while the mesh runs. ``fsdp=False``
    keeps every parameter dim off the data axes."""
    from repro_torch.distributed.sharding import (make_rules, place_tree,
                                                  tree_placements)
    from repro_torch.models.common import axis_rules, tree_leaves
    from repro_torch.models.registry import build
    from repro_torch.training.optim import global_norm
    from repro_torch.models.common import map_tree
    from repro_torch.training.train_step import (_accumulate,
                                                 _split_microbatches,
                                                 make_train_step,
                                                 train_state_axes,
                                                 train_state_shapes,
                                                 value_and_grad)

    cfg, tcfg = case_config(case), train_config(case)
    bundle = build(cfg)
    rules = make_rules(cfg, mesh, fsdp=fsdp and data > 1
                       and case not in ROW_BLOCKED)
    pl = tree_placements(train_state_shapes(bundle, tcfg),
                         train_state_axes(bundle, tcfg), rules, mesh)
    state0 = initial_state(case)
    batches = global_batches(case)
    out: dict = {"arch": cfg.name}

    mesh_state = place_tree(state0, pl, mesh)
    if tcfg.microbatches > 1:
        # each microbatch holds this rank's own rows, split in order
        sharded = _local_batch(batches[0], bundle, rules, mesh)
        own = {k: v.to_local() for k, v in sharded.items()}
        rows = own["tokens"].shape[0] // tcfg.microbatches
        out["microbatches_keep_local_rows"] = all(
            torch.equal(mb[k].to_local(), own[k][i * rows:(i + 1) * rows])
            and tuple(mb[k].placements) == tuple(sharded[k].placements)
            for i, mb in enumerate(_split_microbatches(sharded,
                                                       tcfg.microbatches))
            for k in own)
    else:
        blocks = data if case in ROW_BLOCKED else 1
        parts = [value_and_grad(bundle, state0["params"], mb)
                 for mb in _split_microbatches(batches[0], blocks)]
        l1 = sum(l for (l, _), _ in parts) / blocks
        g1 = parts[0][1]
        for _, g in parts[1:]:
            g1 = _accumulate(g1, g, 1)
        g1 = map_tree(lambda t: t / blocks, g1) if blocks > 1 else g1
        on_mesh[0] = True
        with axis_rules(mesh, rules):
            (l2, _), g2 = value_and_grad(
                bundle, mesh_state["params"],
                _local_batch(batches[0], bundle, rules, mesh))
            n2 = global_norm(g2)
        on_mesh[0] = False
        out["grad_loss"] = [float(l1), float(l2.full_tensor())]
        out["grad_norm"] = [float(global_norm(g1)), float(n2.full_tensor())]
        want = dict(tree_leaves(g1))
        zero = {k for k, g in want.items()
                if float(g.abs().max()) < ZERO_GRAD_TOL}
        out["grad_err"] = {k: _rel(g, want[k]) for k, g in tree_leaves(g2)
                           if k not in zero}
        out["zero_grad"] = {k: [float(want[k].abs().max()),
                                float(g.full_tensor().abs().max())]
                            for k, g in tree_leaves(g2) if k in zero}

    single, mesh_step = (make_train_step(bundle, dataclasses.replace(
        tcfg, microbatches=data if case in ROW_BLOCKED else
        tcfg.microbatches)), make_train_step(bundle, tcfg, pl))
    s1, s2 = state0, mesh_state
    out["loss"], out["step_grad_norm"] = [], []
    lr_sum = 0.0
    for b in batches:
        s1, m1 = single(s1, b)
        lr_sum += float(m1["lr"])
        with axis_rules(mesh, rules):
            s2, m2 = mesh_step(s2, _local_batch(b, bundle, rules, mesh))
        out["loss"].append([float(m1["loss"]), float(m2["loss"])])
        out["step_grad_norm"].append([float(m1["grad_norm"]),
                                      float(m2["grad_norm"])])
        assert not hasattr(m2["loss"], "full_tensor"), "metrics whole"
    want = dict(tree_leaves(s1))
    zero = set(out.get("zero_grad", ()))

    def zero_leaf(k):
        return next((z for z in zero if k == f"params/{z}" or (
            k.startswith("opt/") and (k.endswith(f"/{z}") or f"/{z}/" in k))),
            None)

    out["state_err"] = {k: _rel(t, want[k]) for k, t in tree_leaves(s2)
                        if k != "step" and zero_leaf(k) is None}
    out["zero_state"] = {
        k: [float((t.full_tensor() - want[k]).abs().max()),
            2 * lr_sum if k.startswith("params/") else ZERO_GRAD_TOL]
        for k, t in tree_leaves(s2) if zero_leaf(k) is not None}
    out["step"] = int(s2["step"].full_tensor())
    pls = dict(tree_leaves(pl))
    out["placed_as_axes"] = all(tuple(t.placements) == pls[k]
                                for k, t in tree_leaves(s2))
    out["local_shapes"] = {k: list(t.to_local().shape)
                           for k, t in tree_leaves(s2["params"])}
    return out, s2


def probe_local_shards(case: str, mesh, data: int) -> dict:
    """What the mesh's sites hand on, from one loss of ``case`` under the
    mesh's rules with each attention route (``direct``, ``chunked``,
    ``pallas``): whether every route got plain local tensors, and their
    query rows and heads; the placements of the attention output that
    meets the projection; whether the embedding's row lookup got plain
    ids of this rank's rows; the placements of the MoE's expert outputs
    at the combine (none without experts). Every site records only
    while the mesh runs."""
    from repro_torch.distributed.sharding import make_rules, place_tree, \
        tree_placements
    from repro_torch.models import attention, common
    from repro_torch.models.common import axis_rules, is_dtensor
    from repro_torch.models.registry import build

    seen: dict = {"impl": [], "shard_out": [], "rows": [], "combine": []}
    impls, shard_out, rows = (dict(attention._IMPLS), attention._shard_out,
                              common._rows)
    einsum = torch.einsum

    def impl_probe(name):
        def probe(cfg, q, k, v, *args, **kw):
            seen["impl"].append((name, not any(map(is_dtensor, (q, k, v))),
                                 list(q.shape)))
            return impls[name](cfg, q, k, v, *args, **kw)
        return probe

    def shard_out_probe(cfg, out):
        out = shard_out(cfg, out)
        seen["shard_out"].append([str(p) for p in out.placements])
        return out

    def rows_probe(ids, table):
        seen["rows"].append((not is_dtensor(ids) and not is_dtensor(table),
                             list(ids.shape)))
        return rows(ids, table)

    def einsum_probe(eq, *ops):
        if eq == "gtec,egcd->gtd":
            seen["combine"].append([str(p) for p in ops[1].placements])
        return einsum(eq, *ops)

    out: dict = {}
    try:
        attention._IMPLS.update({n: impl_probe(n) for n in impls})
        attention._shard_out, common._rows = shard_out_probe, rows_probe
        torch.einsum = einsum_probe
        for impl in impls:
            cfg = case_config(case).replace(attn_impl=impl)
            bundle = build(cfg)
            rules = make_rules(cfg, mesh, fsdp=data > 1)
            params = place_tree(initial_state(case)["params"],
                                tree_placements(bundle.param_shapes(),
                                                bundle.param_axes(), rules,
                                                mesh), mesh)
            with axis_rules(mesh, rules):
                bundle.loss_fn(params, _local_batch(
                    global_batches(case, 1)[0], bundle, rules, mesh))
    finally:
        attention._IMPLS.update(impls)
        attention._shard_out, common._rows = shard_out, rows
        torch.einsum = einsum
    out.update(seen)
    return out


def rank_cases(rank: int, data: int, model: int, spec: dict) -> dict:
    from repro_torch.distributed.sharding import (batch_coordinate,
                                                  make_rules, place_tree,
                                                  tree_placements)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import build
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.train_step import (train_state_axes,
                                                 train_state_shapes)

    from repro_torch.kernels.flash_attention import ops as fa_ops

    torch.manual_seed(0)
    mesh = make_local_mesh(data, model)
    out: dict = {"coordinate": list(mesh.get_coordinate())}
    # the flash backward's plain version, as the dq and dk/dv kernels see
    # it: the shapes of q and k at each call under the mesh
    plain_bwd, seen = fa_ops.flash_attention_bwd_ref, []

    def recording_bwd(q, k, *args, **kw):
        if is_dtensor_input[0]:
            seen.append((tuple(q.shape), tuple(k.shape)))
        return plain_bwd(q, k, *args, **kw)

    is_dtensor_input = [False]
    fa_ops.flash_attention_bwd_ref = recording_bwd
    # the scan's plain version under the mesh, forward and reversed: (the
    # shape of a, reverse) at each call
    from repro_torch.kernels.rglru_scan import ops as rg_ops

    plain_scan, scans = rg_ops.rglru_scan_ref, []

    def recording_scan(a, x, h0, reverse=False):
        if is_dtensor_input[0]:
            scans.append((tuple(a.shape), reverse))
        return plain_scan(a, x, h0, reverse=reverse)

    rg_ops.rglru_scan_ref = recording_scan
    saved, lists = None, {}
    for case in spec.get("cases", []):
        seen.clear()
        scans.clear()
        out[case], state = train_case(case, mesh, data, is_dtensor_input,
                                      spec.get("fsdp", True))
        out[case]["mesh_bwd_inputs"] = sorted(set(seen))
        out[case]["mesh_bwd_calls"] = len(seen)
        out[case]["mesh_scan_inputs"] = sorted(set(scans))
        out[case]["mesh_scan_calls"] = len(scans)
        saved = saved or state
        if case in spec.get("save_lists", {}):
            lists[case] = state
    for case in spec.get("probe", []):
        out[f"probe:{case}"] = probe_local_shards(case, mesh, data)
    if "save" in spec:
        ckpt.save_checkpoint(spec["save"], 2, saved)
        out["saved"] = digest(saved)
    for case, directory in spec.get("save_lists", {}).items():
        state = lists.get(case)
        if state is None:        # not trained here: its initial state
            cfg, tcfg = case_config(case), train_config(case)
            bundle = build(cfg)
            state = place_tree(initial_state(case), tree_placements(
                train_state_shapes(bundle, tcfg),
                train_state_axes(bundle, tcfg),
                make_rules(cfg, mesh, fsdp=data > 1), mesh), mesh)
        ckpt.save_checkpoint(directory, 2, state)
        out[f"saved:{case}"] = digest(state)
    # restores: name -> (directory, the arch its state belongs to)
    for name, (directory, case) in spec.get("restore", {}).items():
        cfg, tcfg = case_config(case), train_config(case)
        bundle = build(cfg)
        rules = make_rules(cfg, mesh, fsdp=data > 1)
        pl = tree_placements(train_state_shapes(bundle, tcfg),
                             train_state_axes(bundle, tcfg), rules, mesh)
        got = ckpt.restore_checkpoint(
            directory, target=train_state_shapes(bundle, tcfg),
            device="cpu", mesh=mesh, placements=pl)
        out[f"restore:{name}"] = digest(got)
        pls = dict(tree_leaves(pl))
        out[f"restore:{name}:placed_as_axes"] = all(
            tuple(t.placements) == pls[k] for k, t in tree_leaves(got))
    # data by rank: the rank's data group and its first batch
    cfg = case_config("adamw")
    rules = make_rules(cfg, mesh, fsdp=data > 1)
    host_id, num_hosts = batch_coordinate(mesh, rules)
    first = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                   batch_size=2, seed=3, host_id=host_id,
                                   num_hosts=num_hosts)).next_batch()
    out["data_group"] = [host_id, num_hosts]
    out["first_batch"] = digest(first)
    # whisper's frames by rank: this data group's rows, sharded as the
    # tokens are
    bundle = build(case_config("whisper"))
    batch = global_batches("whisper", 1)[0]
    local = _local_batch(batch, bundle, make_rules(bundle.cfg, mesh,
                                                   fsdp=data > 1), mesh)
    rows = batch["frames"].shape[0] // num_hosts
    out["frames_by_rank"] = {
        "own_rows": torch.equal(local["frames"].to_local(), batch["frames"][
            host_id * rows:(host_id + 1) * rows]),
        "whole": torch.equal(local["frames"].full_tensor(), batch["frames"]),
        "placements": [str(p) for p in local["frames"].placements],
        "same_as_tokens": (tuple(local["frames"].placements)
                           == tuple(local["tokens"].placements))}
    return out


def nap(rank: int, seconds: float, exit_rank: int | None = None) -> int:
    """A rank that sleeps ``seconds`` and returns its rank; ``exit_rank``
    exits at once with code 3 and no result."""
    import time

    if rank == exit_rank:
        os._exit(3)
    time.sleep(seconds)
    return rank


def prepare(root: str) -> dict[str, str]:
    """The checkpoints the meshes start from, under ``root``: one device's
    initial ``adamw`` state (``single``), and where 2 x 1 saves
    (``saved``), which already holds rank 1's partial manifest of a
    crashed save of the same step (a stale token that rank 0 must not
    merge)."""
    from repro_torch.training import checkpoint as ckpt

    dirs = {"single": os.path.join(root, "single"),
            "saved": os.path.join(root, "from_2x1"),
            **{c: os.path.join(root, f"{c}_from_1x2") for c in LIST_CASES}}
    ckpt.save_checkpoint(dirs["single"], 0, initial_state("adamw"))
    tmp = os.path.join(dirs["saved"], "step_2.tmp")
    os.makedirs(tmp)
    with open(os.path.join(tmp, ckpt.PARTIAL_MANIFEST.format(1)), "w") as fh:
        json.dump({"token": "stale", "leaves": {}}, fh)
    return dirs


def mesh_specs(dirs: dict[str, str], reference: str | None = None
               ) -> dict[tuple[int, int], dict]:
    """Each mesh's spec, in the order they run: 2 x 1 restores one
    device's checkpoint and saves its state after two steps, which 1 x 2
    and 2 x 2 restore; 1 x 2 also restores the reference package's
    checkpoint ``reference`` when one is given."""
    from_2x1 = {"from_2x1": [dirs["saved"], "adamw"]}
    return {(2, 1): {"cases": MESH_CASES[(2, 1)], "save": dirs["saved"],
                     "restore": {"single": [dirs["single"], "adamw"]}},
            (1, 2): {"cases": MESH_CASES[(1, 2)],
                     "probe": PROBE_CASES[(1, 2)],
                     "save_lists": {c: dirs[c] for c in LIST_CASES},
                     "restore": {**from_2x1, **({"reference": [
                         reference, "adamw"]} if reference else {})}},
            (2, 2): {"cases": MESH_CASES[(2, 2)],
                     "probe": PROBE_CASES[(2, 2)], "restore": from_2x1}}


def case_failures(case: str, found: list[dict]) -> list[str]:
    """The bars a training case misses on some rank: the loss and
    grad_norm within :data:`LOSS_RTOL` of one device's at the initial
    state and at each step, every gradient and state leaf within
    :data:`LEAF_TOL` of its norm (a leaf with a zero gradient as
    :data:`ZERO_GRAD_TOL` says), two steps taken and the state placed by
    its axes."""
    out = []

    def close(what, got, want):
        if not abs(got - want) <= LOSS_RTOL * abs(want):
            out.append(f"rank {rank} {case} {what}: {got} vs {want}")

    for rank, r in enumerate(found):
        c = r[case]
        pairs = [("loss", *c["grad_loss"][::-1]),
                 ("grad_norm", *c["grad_norm"][::-1])] \
            if "grad_err" in c else []
        for i, ((want, got), (nw, ng)) in enumerate(
                zip(c["loss"], c["step_grad_norm"])):
            pairs += [(f"step {i + 1} loss", got, want),
                      (f"step {i + 1} grad_norm", ng, nw)]
        for what, got, want in pairs:
            close(what, got, want)
        for what in ("grad_err", "state_err"):
            worst = max(c.get(what, {"-": 0.0}).items(), key=lambda kv: kv[1])
            if not worst[1] <= LEAF_TOL:
                out.append(f"rank {rank} {case} {what}: {worst}")
        out += [f"rank {rank} {case} zero gradient {k}: {v}"
                for k, v in c.get("zero_grad", {}).items()
                if not max(v) < ZERO_GRAD_TOL]
        out += [f"rank {rank} {case} zero-gradient state {k}: {v}"
                for k, v in c.get("zero_state", {}).items()
                if not v[0] <= v[1]]
        if not (c["step"] == 2 and c["placed_as_axes"]):
            out.append(f"rank {rank} {case}: step {c['step']}, placed as "
                       f"its axes {c['placed_as_axes']}")
    return out


def probe_failures(case: str, found: list[dict], data: int, model: int
                   ) -> list[str]:
    """What :func:`probe_local_shards` found that the mesh's sites must not
    do: a route given DTensors, or other rows or query heads than this
    rank's (under ``"sequence"`` every position); an attention output
    sharded over the sequence, or (under ``"heads"``) not over the heads,
    where it meets its projection; the embedding's lookup given DTensors
    or other rows than this rank's; the MoE's combine reading a
    sharded expert dim."""
    cfg = case_config(case)
    rows = CASES[case][3] // data
    seq = SEQ + (cfg.num_patches if cfg.family == "vlm" else 0)
    heads = cfg.num_heads // (model if cfg.attn_sharding == "heads" else 1)
    out_on_model = "S(2)" if cfg.attn_sharding == "heads" else "R"
    out = []
    for rank, r in enumerate(found):
        p = r[f"probe:{case}"]
        if sorted(n for n, _, _ in p["impl"]) != sorted(
                ["chunked", "direct", "pallas"] * cfg.num_layers):
            out.append(f"rank {rank} {case}: routes {p['impl']}")
        out += [f"rank {rank} {case}: route {n} got {plain=} {shape}"
                for n, plain, shape in p["impl"]
                if not (plain and shape == [rows, seq, heads, cfg.hd])]
        if not p["shard_out"] or any("S(1)" in pl or pl[1] != out_on_model
                                     for pl in p["shard_out"]):
            out.append(f"rank {rank} {case}: attention output placed "
                       f"{p['shard_out']}")
        if not p["rows"] or any(not (plain and shape == [rows, SEQ])
                                for plain, shape in p["rows"]):
            out.append(f"rank {rank} {case}: embedding lookup {p['rows']}")
        if bool(cfg.num_experts) != bool(p["combine"]) or any(
                "S(0)" in pl for pl in p["combine"]):
            out.append(f"rank {rank} {case}: combine reads {p['combine']}")
    return out


def run_all(root: str) -> int:
    """Every mesh of :func:`mesh_specs` and the launcher's
    :data:`LAUNCH_CASES`, each held to its bars (the checkpoints restored
    bit-equal); prints one line per case and returns the number of
    failed cases."""
    import traceback

    from repro_torch.configs import spawn_ranks
    from repro_torch.launch import train as launch
    from repro_torch.models.registry import build
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.train_step import train_state_shapes

    import _torch_sharded_train_ranks as me   # importable by the ranks
    print(sys.version.split()[0], torch.__version__, flush=True)
    dirs = prepare(root)
    want = {"single": digest(initial_state("adamw"))}
    failed = 0

    def report(name: str, fails: list[str], note: str = "") -> None:
        nonlocal failed
        failed += bool(fails)
        print(f"{name}: {'FAILED' if fails else 'ok'}{note}", flush=True)
        for f in fails:
            print(f"  {f}", flush=True)

    for (data, model), spec in mesh_specs(dirs).items():
        mesh = f"{data}x{model}"
        try:
            found = spawn_ranks(me.rank_cases, data * model, "cpu",
                                (data, model, spec), rendezvous_dir=root)
        except Exception:
            report(mesh, [traceback.format_exc()[-3000:]])
            continue
        for case in spec["cases"]:
            c = found[0][case]
            report(f"train {mesh} {case}", case_failures(case, found),
                   f" (loss {c['loss'][0]}, worst state leaf "
                   f"{max(c['state_err'].values()):.2e})")
        for case in spec.get("probe", []):
            report(f"probe {mesh} {case}",
                   probe_failures(case, found, data, model))
        if "save" in spec:
            want["from_2x1"] = found[0]["saved"]
        for name in spec["restore"]:
            report(f"restore {mesh} {name}", [
                f"rank {rank}" for rank, r in enumerate(found)
                if r[f"restore:{name}"] != want.get(name)
                or not r[f"restore:{name}:placed_as_axes"]])
        for case, directory in spec.get("save_lists", {}).items():
            got = ckpt.restore_checkpoint(directory, target=train_state_shapes(
                build(case_config(case)), train_config(case)), device="cpu")
            report(f"restore {mesh} {case} list of layers on one device",
                   [] if digest(got) == found[0][f"saved:{case}"]
                   and isinstance(got["params"]["layers"], list)
                   else ["restored leaves differ"])
    for i, argv in enumerate(LAUNCH_CASES):
        try:
            launch.main(["--reduced", "--device", "cpu", "--steps", "2",
                         "--log-every", "1", "--ckpt-dir",
                         os.path.join(root, f"launch{i}"), *argv])
            fails = []
        except SystemExit as exc:
            fails = [f"exit {exc.code}"]
        except Exception:
            fails = [traceback.format_exc()[-3000:]]
        report("launch " + " ".join(argv), fails)
    print(f"failed cases: {failed}")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--spec", default="{}")
    ap.add_argument("--all", action="store_true",
                    help="run every mesh and launcher case (run_all)")
    ap.add_argument("--rendezvous-dir", required=True)
    args = ap.parse_args(argv)
    if args.all:
        return min(run_all(args.rendezvous_dir), 1)
    from repro_torch.configs import spawn_ranks

    import _torch_sharded_train_ranks as me   # importable by the ranks
    per_rank = spawn_ranks(me.rank_cases, args.data * args.model, "cpu",
                           (args.data, args.model, json.loads(args.spec)),
                           rendezvous_dir=args.rendezvous_dir)
    print("RESULT:" + json.dumps(per_rank))
    return 0


if __name__ == "__main__":
    sys.exit(main())
