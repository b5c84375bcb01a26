"""Processes of the dry run's tests (``tests/test_torch_dryrun.py``).

Each job joins its own process group, so each runs as its own process
and prints one ``RESULT:`` JSON line:

    python tests/_torch_dryrun_ranks.py cells2d     # 8 fake ranks, (2, 4)
    python tests/_torch_dryrun_ranks.py cells3d     # 8 fake ranks, (2, 2, 2)
    python tests/_torch_dryrun_ranks.py units       # 8 fake ranks
    python tests/_torch_dryrun_ranks.py production  # 256 fake ranks, (16, 16)
    python tests/_torch_dryrun_ranks.py real --rendezvous-dir /tmp/rdv

``cells2d`` and ``cells3d`` trace the reference's three lowering cases
(``tests/test_sharding.py::test_real_lowering_on_8_fake_devices``) with
reduced configs on the shrunken production meshes, as that test does,
under ``baseline`` and ``optimized``. ``units`` holds the counter's
per-rank FLOPs and collectives on single ops, the fake group's refusal
of another size, the depth linearity of a dense cell and the CLI's
files, and traces :data:`REAL_CASES` on a fake 2 x 2 mesh, which
``real`` runs for real on 4 gloo ranks (zeros for every input).
``production`` traces one layer of ``qwen3-4b``'s ``train_4k`` at full
width on the production mesh.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

#: the reference test's cells: (arch, shape, multi_pod)
LOWERING_CASES = (("qwen3-4b", "train_4k", False),
                  ("moonshot-v1-16b-a3b", "train_4k", True),
                  ("recurrentgemma-2b", "decode_32k", False))
VARIANTS = ("baseline", "optimized")
#: small cells traced fake and run for real on 2 x 2: (name, kind, seq,
#: batch)
SMALL_CELLS = (("train_small", "train", 32, 4),
               ("decode_small", "decode", 32, 4))
#: (arch, cell, variant) of the fake-against-real comparison
REAL_CASES = (("aiida-demo-110m", "train_small", "optimized"),
              ("aiida-demo-110m", "train_small", "baseline"),
              ("aiida-demo-110m", "decode_small", "optimized"),
              ("moonshot-v1-16b-a3b", "train_small", "optimized"))
#: the dense arch and depth of the linearity check
LINEAR_ARCH, LINEAR_LAYERS = "qwen3-4b", 6


def _shrink(dr, init_device_mesh, reduced_config, layers=None):
    """The reference test's patches: the production mesh shrunk to 8
    ranks, every arch's reduced config (``layers`` deep when given)."""
    def small_mesh(*, multi_pod=False):
        if multi_pod:
            return init_device_mesh("cpu", (2, 2, 2),
                                    mesh_dim_names=("pod", "data", "model"))
        return init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))

    dr.make_production_mesh = small_mesh
    dr.get_config = (reduced_config if layers is None else
                     lambda a: reduced_config(a).replace(num_layers=layers))


def _add_small_cells():
    from repro_torch.models.registry import SHAPES, ShapeCell

    for name, kind, seq, batch in SMALL_CELLS:
        SHAPES[name] = ShapeCell(name, kind, seq, batch)


def _summary(stats: dict) -> dict:
    return {"ok": "error" not in stats and not stats.get("skipped"),
            **{k: stats.get(k) for k in (
                "skipped", "reason", "n_devices", "trace_s", "cost_analysis",
                "memory_analysis", "collectives", "local_ops")}}


def cells(multi: bool) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import reduced_config, setup_fake_devices
    from repro_torch.launch import dryrun as dr

    setup_fake_devices(8)
    _shrink(dr, init_device_mesh, reduced_config)
    return {f"{arch}/{shape}/{var}": _summary(dr.lower_cell(
                arch, shape, multi_pod=m, var=dr.VARIANTS[var]))
            for arch, shape, m in LOWERING_CASES if m == multi
            for var in VARIANTS}


def _small_stats(dr, arch: str, cell: str, var: str, mesh, device=None):
    from repro_torch.configs import reduced_config
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.models.registry import SHAPES, build

    v = dr.VARIANTS[var]
    bundle = build(dr._apply_variant(reduced_config(arch), v))
    rules = make_rules(bundle.cfg, mesh, fsdp=v.fsdp,
                       parallelism=v.parallelism)
    return dr.cell_stats(bundle, SHAPES[cell], v, mesh, rules,
                         device=device)


def units() -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.configs import reduced_config, setup_fake_devices
    from repro_torch.launch import dryrun as dr
    from repro_torch.models.common import axis_rules, on_local_shards

    setup_fake_devices(8)
    out: dict = {}
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    pods = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    fake = torch._subclasses.fake_tensor.FakeTensorMode(
        allow_non_fake_inputs=True)

    def dt(shape, pls, m=mesh):
        local = [n for n in shape]
        for i, p in enumerate(pls):
            if isinstance(p, Shard):
                local[p.dim] //= m.size(i)
        with fake:
            t = torch.empty(local)
        return DTensor.from_local(t, m, pls, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=dr._contiguous_strides(shape))

    def count(fn, args, m=mesh):
        _, c = dr.trace_step(fn, args, m, fake)
        return {"flops": c.flops, "collectives": c.collectives(),
                "ops": c.local_ops}

    b, d, f = 8, 16, 32
    rep = (Replicate(), Replicate())
    out["column_parallel"] = count(lambda x, w: x @ w, (
        dt((b, d), rep), dt((d, f), (Replicate(), Shard(1)))))
    out["replicated"] = count(lambda x, w: x @ w, (
        dt((b, d), rep), dt((d, f), rep)))
    with axis_rules(mesh, {"f": "model"}):
        out["on_local_shards"] = count(
            lambda x, w: on_local_shards(lambda a, c: a @ c, (x, w),
                                         ((None, None), (None, "f"))),
            (dt((b, d), rep), dt((d, f), (Replicate(), Shard(1)))))
    out["product_flops"] = 2 * b * d * f
    out["model"] = mesh.size(1)
    # Shard(0) -> Shard(1) over model: one all-to-all of the local output
    out["alltoall"] = count(lambda x: x.redistribute(
        mesh, (Replicate(), Shard(1))), (dt((b, f), (Replicate(),
                                                     Shard(0))),))
    out["alltoall_bytes"] = b * (f // 4) * 4
    # an all-reduce over pod (ranks 0 and 4) and one over data (0 and 2)
    out["over_pod"] = count(lambda x: x.redistribute(
        pods, (Replicate(),) * 3), (dt((b, f), (Partial(), Replicate(),
                                                Replicate()), pods),), pods)
    out["over_data"] = count(lambda x: x.redistribute(
        pods, (Replicate(),) * 3), (dt((b, f), (Replicate(), Partial(),
                                                Replicate()), pods),), pods)
    out["reduce_bytes"] = b * f * 4
    # the fake group: joined again it is kept, another size is refused
    setup_fake_devices(8)
    try:
        setup_fake_devices(4)
        out["refused_other_size"] = False
    except RuntimeError:
        out["refused_other_size"] = True
    _add_small_cells()
    # depth linearity of a dense cell: L2, L4 and the full depth
    _shrink(dr, init_device_mesh, reduced_config, LINEAR_LAYERS)
    out["linear"] = {str(layers): dr.lower_cell(
        LINEAR_ARCH, "train_small", multi_pod=False, layers=layers)[
            "cost_analysis"]["flops"] for layers in (2, 4, None)}
    out["linear_layers"] = LINEAR_LAYERS
    # the CLI's files: a dense and a hybrid arch, a small train cell and
    # long_500k (skipped on the dense one), with the slope cells
    _shrink(dr, init_device_mesh, reduced_config)
    dr.N_FAKE_RANKS = 8
    with tempfile.TemporaryDirectory() as tmp:
        dr.main(["--arch", "qwen3-4b,recurrentgemma-2b", "--shape",
                 "train_small,long_500k", "--mesh", "single", "--slope",
                 "--out", tmp])
        out["files"] = {f: json.loads(pathlib.Path(tmp, f).read_text())
                        for f in sorted(os.listdir(tmp))}
    # the small cells, fake on 2 x 2 (the real ranks' mesh)
    small = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out["moe_aux_placements"] = _moe_aux_placements(dr, small, fake)
    # a TP-in-expert MoE (grok) decoding 10 rows under FSDP on 2 x 4: its
    # capacity of 7 that model does not divide
    from repro_torch.models.registry import SHAPES, ShapeCell

    SHAPES["decode_10"] = ShapeCell("decode_10", "decode", 32, 10)
    try:
        out["moe_ffn_fsdp_decode"] = _summary(_small_stats(
            dr, "grok-1-314b", "decode_10", "optimized", mesh))
    except RuntimeError as exc:
        out["moe_ffn_fsdp_decode"] = {"ok": False, "error": str(exc)[:400]}
    out["fake"] = {f"{a}/{c}/{v}": _small_stats(dr, a, c, v, small)
                   for a, c, v in REAL_CASES}
    return out


def _moe_aux_placements(dr, mesh, fake) -> list[str]:
    """The placements of the MoE layer's aux loss on ``mesh`` under FSDP
    (its groups sharded over data): replicated, not a Partial(avg) that
    torch 2.11 cannot add to the CE's Partial(sum)."""
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.distributed.sharding import make_rules, tree_placements
    from repro_torch.models import mlp
    from repro_torch.models.common import (ShapeDtype, axis_rules, spec_axes,
                                           spec_shapes)

    cfg = reduced_config("moonshot-v1-16b-a3b")
    rules = make_rules(cfg, mesh, fsdp=True)
    specs = mlp.make_moe_specs(cfg)
    shapes = {"p": spec_shapes(specs, torch.float32),
              "x": ShapeDtype((4, 32, cfg.d_model), torch.float32)}
    axes = {"p": spec_axes(specs), "x": ("batch", None, None)}

    def make_local(shape, dtype):
        with fake:
            return torch.empty(shape, dtype=dtype)

    got = dr._placed(shapes, tree_placements(shapes, axes, rules, mesh),
                     mesh, make_local)
    with axis_rules(mesh, rules), fake:
        _, aux = mlp.moe_forward(cfg, got["p"], got["x"])
    return [str(p) for p in aux.placements]


def production() -> dict:
    """``qwen3-4b`` ``train_4k`` at full width and one layer on the
    production mesh (16 x 16 of a 256-rank fake group) under
    ``optimized``: the CE's memory and the rows of its logits."""
    from repro_torch.configs import get_config, setup_fake_devices
    from repro_torch.launch import dryrun as dr

    setup_fake_devices(256)
    res = dr.lower_cell("qwen3-4b", "train_4k", multi_pod=False,
                        var=dr.OPTIMIZED, layers=1)
    cfg, cell = get_config("qwen3-4b"), dr.SHAPES["train_4k"]
    rows = cell.global_batch // 16
    return {**_summary(res), "local_logits_fp32_bytes":
            rows * cell.seq_len * cfg.padded_vocab * 4}


def real_rank(rank: int) -> dict:
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_local_mesh

    _add_small_cells()
    mesh = make_local_mesh(2, 2)
    return {f"{a}/{c}/{v}": _small_stats(dr, a, c, v, mesh, device="cpu")
            for a, c, v in REAL_CASES}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("job", choices=["cells2d", "cells3d", "units", "real",
                                    "production"])
    ap.add_argument("--rendezvous-dir")
    args = ap.parse_args(argv)
    if args.job == "real":
        from repro_torch.configs import spawn_ranks

        import _torch_dryrun_ranks as me     # importable by the spawned ranks
        result = spawn_ranks(me.real_rank, 4, "cpu",
                             rendezvous_dir=args.rendezvous_dir)
    elif args.job == "units":
        result = units()
    elif args.job == "production":
        result = production()
    else:
        result = cells(args.job == "cells3d")
    print("RESULT:" + json.dumps(result))


if __name__ == "__main__":
    main()
