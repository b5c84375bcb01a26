"""The dry run (``repro_torch.launch.dryrun``) on fake ranks (CPU).

Every fake process group lives in its own subprocess
(``tests/_torch_dryrun_ranks.py``), as the reference's lowering test
(``tests/test_sharding.py``) forces its placeholder devices in one; the
jobs start together and each writes its findings to a file:

* the twins of the reference's three lowering cases, reduced configs on
  8 fake ranks as (2, 4) and (2, 2, 2), under ``baseline`` and
  ``optimized`` (FSDP on: the KV heads stay whole where model does not
  divide them);
* the counter's per-rank FLOPs (a column-parallel product counts its
  global FLOPs over model, a replicated one whole, an op inside
  ``on_local_shards`` once) and collectives (the ring formulas, a
  Shard -> Shard redistribution on a CPU-type mesh as one all-to-all,
  DCN bytes only for groups that span ``pod``);
* fake against real: the same counter around the reduced train and
  decode steps on 4 gloo ranks (2 x 2) gives the per-kind counts, wire
  bytes, per-rank FLOPs and argument bytes of the fake trace at 4 ranks;
* one full-width layer of ``qwen3-4b``'s ``train_4k`` on the 16 x 16
  production mesh, whose CE holds only each rank's rows;
* FLOPs linear in depth, the CLI's files with the reference's keys,
  ``long_500k`` skipped on a dense arch, no JAX and no reference module
  loaded by the import, and only fake tensors in a traced step.
"""

import json
import os
import subprocess
import sys

import pytest

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import registry as j_registry
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as dr
from repro_torch.models import registry

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_dryrun_ranks as jobs  # noqa: E402

JOBS = ("cells3d", "cells2d", "units", "real", "production")
CELLS = [(a, s, m, v) for a, s, m in jobs.LOWERING_CASES
         for v in jobs.VARIANTS]
#: the keys of a cell's JSON in the reference (``dryrun.py:328-347``),
#: ``lower_s`` and ``compile_s`` replaced by ``trace_s``
CELL_KEYS = {"arch", "shape", "mesh", "variant", "layers_override",
             "variant_detail", "skipped", "n_devices", "params_total",
             "params_active", "tokens_per_step", "kind", "trace_s",
             "cost_analysis", "memory_analysis", "collectives",
             "sharding_notes"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "generated_code_size_in_bytes"}


@pytest.fixture(scope="module")
def found(tmp_path_factory):
    """Each job's RESULT, all run at once (output through files: a
    full pipe would stall a job while another is read)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {}
    for job in JOBS:
        log = open(tmp / f"{job}.out", "w+")
        procs[job] = (subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_dryrun_ranks.py"),
             job, "--rendezvous-dir", str(tmp)],
            stdout=log, stderr=subprocess.STDOUT, text=True), log)
    out = {}
    for job, (proc, log) in procs.items():
        try:
            proc.wait(timeout=400)
        finally:
            if proc.poll() is None:
                proc.kill()
        log.seek(0)
        text = log.read()
        log.close()
        line = [l for l in text.splitlines() if l.startswith("RESULT:")]
        out[job] = (json.loads(line[0][len("RESULT:"):]) if line
                    and proc.returncode == 0 else text[-4000:])
    return out


def _job(found, name):
    got = found[name]
    assert isinstance(got, (dict, list)), got
    return got


@pytest.mark.parametrize("arch,shape,multi,var", CELLS,
                         ids=[f"{a}-{s}-{'multi' if m else 'single'}-{v}"
                              for a, s, m, v in CELLS])
def test_lowering_twins_on_8_fake_ranks(found, arch, shape, multi, var):
    """The reference's three lowering cases, reduced, on (2, 4) or
    (2, 2, 2): ok, every rank's collectives counted, every tensor that
    the step touched fake."""
    r = _job(found, "cells3d" if multi else "cells2d")[
        f"{arch}/{shape}/{var}"]
    assert r["ok"], r
    assert r["n_devices"] == 8
    assert sum(r["collectives"]["counts"].values()) > 0, r
    assert r["cost_analysis"]["flops"] > 0
    assert r["memory_analysis"]["temp_size_in_bytes"] > 0
    assert r["local_ops"]["count"] > 0
    assert r["local_ops"]["non_fake_tensors"] == 0, r["local_ops"]
    assert (r["collectives"]["dcn_wire_bytes"] > 0) == multi


def test_flops_are_per_rank(found):
    """A column-parallel product counts its global FLOPs over model; a
    replicated one counts whole; a product inside ``on_local_shards``
    (local already) once, on its local shapes."""
    u = _job(found, "units")
    whole, model = u["product_flops"], u["model"]
    assert u["column_parallel"]["flops"] == whole // model
    assert u["replicated"]["flops"] == whole
    assert u["on_local_shards"]["flops"] == whole // model
    for k in ("column_parallel", "replicated", "on_local_shards"):
        assert u[k]["collectives"]["total_wire_bytes"] == 0


def test_ring_formulas():
    """The reference's ring model, S a rank's output bytes, n the group."""
    s, n = 1024, 4
    assert dr.ring_wire_bytes("all-gather", s, n) == s * 3 / 4
    assert dr.ring_wire_bytes("all-reduce", s, n) == 2 * s * 3 / 4
    assert dr.ring_wire_bytes("reduce-scatter", s, n) == s * 3
    assert dr.ring_wire_bytes("all-to-all", s, n) == s * 3 / 4
    assert dr.ring_wire_bytes("collective-permute", s, n) == s
    stats = dr.collective_stats([("all-gather", s, n, False),
                                 ("all-reduce", s, 1, True),
                                 ("reduce-scatter", s, 2, True)])
    assert stats["counts"] == {"all-gather": 1, "all-reduce": 0,
                               "reduce-scatter": 1, "all-to-all": 0,
                               "collective-permute": 0}
    assert stats["total_wire_bytes"] == s * 3 / 4 + s
    assert stats["dcn_wire_bytes"] == s


def test_shard_to_shard_is_one_all_to_all(found):
    """On a CPU-type fake mesh DTensor gathers and chunks; the counter
    counts the one all-to-all that NCCL issues, of the local output."""
    u = _job(found, "units")
    c = u["alltoall"]["collectives"]
    assert c["counts"]["all-to-all"] == 1
    assert c["counts"]["all-gather"] == 0
    assert c["wire_bytes"]["all-to-all"] == u["alltoall_bytes"] * 3 / 4


def test_dcn_bytes_only_for_groups_across_pods(found):
    u = _job(found, "units")
    pod, data = u["over_pod"]["collectives"], u["over_data"]["collectives"]
    assert pod["counts"]["all-reduce"] == data["counts"]["all-reduce"] == 1
    assert pod["wire_bytes"]["all-reduce"] == u["reduce_bytes"]   # 2(n-1)/n
    assert pod["dcn_wire_bytes"] == pod["wire_bytes"]["all-reduce"]
    assert data["dcn_wire_bytes"] == 0


@pytest.mark.parametrize("case", [f"{a}/{c}/{v}" for a, c, v in
                                  jobs.REAL_CASES])
def test_fake_trace_matches_real_ranks(found, case):
    """The counter around the real steps on 4 gloo ranks (2 x 2) and
    around the fake trace of the same cell at 4 ranks: the same per-kind
    counts, wire bytes, per-rank FLOPs and argument bytes on every
    rank."""
    fake = _job(found, "units")["fake"][case]
    for rank, r in enumerate(_job(found, "real")):
        real = r[case]
        assert real["collectives"] == fake["collectives"], rank
        assert real["cost_analysis"]["flops"] == \
            fake["cost_analysis"]["flops"], rank
        assert real["memory_analysis"]["argument_size_in_bytes"] == \
            fake["memory_analysis"]["argument_size_in_bytes"], rank
    assert sum(fake["collectives"]["counts"].values()) > 0


def test_flops_linear_in_depth(found):
    """Eager tracing counts every layer: full depth = L2 + (L - 2) / 2 *
    (L4 - L2) for a dense cell."""
    u = _job(found, "units")
    lin, depth = u["linear"], u["linear_layers"]
    assert lin["None"] == lin["2"] + (depth - 2) // 2 * (lin["4"] - lin["2"])
    assert lin["4"] > lin["2"] > 0


def test_cli_writes_the_reference_keys(found):
    """``main()``'s files: one per cell and slope cell under the
    reference's names, each with the reference's keys (``trace_s`` for
    ``lower_s`` and ``compile_s``); long_500k skipped on the dense arch
    with the reference's reason, run on the hybrid."""
    files = _job(found, "units")["files"]
    names = {dr.cell_filename(a, s, "single", v)
             for a, s, v in [("qwen3-4b", "train_small", "baseline"),
                             ("qwen3-4b", "train_small", "baseline_L2"),
                             ("qwen3-4b", "train_small", "baseline_L4"),
                             ("qwen3-4b", "long_500k", "baseline"),
                             ("qwen3-4b", "long_500k", "baseline_L2"),
                             ("qwen3-4b", "long_500k", "baseline_L4"),
                             ("recurrentgemma-2b", "train_small",
                              "baseline"),
                             ("recurrentgemma-2b", "long_500k", "baseline")]}
    assert set(files) == names
    for name, res in files.items():
        assert "error" not in res, res
        if res["skipped"]:
            assert res["shape"] == "long_500k" and res["arch"] == "qwen3-4b"
            assert res["reason"].startswith("full attention is O(S^2)")
            continue
        assert CELL_KEYS <= set(res), name
        assert "lower_s" not in res and "compile_s" not in res
        assert set(res["memory_analysis"]) == MEMORY_KEYS
        # the outputs alias the donated train state, or the cache a
        # decode step writes in place (tests/test_torch_donation.py holds
        # the bytes)
        mem = res["memory_analysis"]
        assert 0 < mem["alias_size_in_bytes"] < \
            mem["argument_size_in_bytes"], mem
        assert {"flops", "bytes accessed"} <= set(res["cost_analysis"])
        assert set(res["collectives"]) == {"wire_bytes", "counts",
                                           "total_wire_bytes",
                                           "dcn_wire_bytes"}


def test_cross_entropy_keeps_each_ranks_rows(found):
    """One full-width ``qwen3-4b`` layer of ``train_4k`` on 16 x 16 under
    ``optimized``: the step's peak holds a few fp32 copies of this rank's
    16 rows of logits (the CE gathers the vocab), never a zero gradient
    of all 256 rows (638 GB per rank, when DTensor ran the gold logit's
    read)."""
    r = _job(found, "production")
    assert r["ok"] and r["n_devices"] == 256, r
    local = r["local_logits_fp32_bytes"]
    assert r["memory_analysis"]["temp_size_in_bytes"] < 8 * local, r


def test_moe_aux_loss_is_replicated(found):
    """Under FSDP the MoE's groups are sharded over data; its aux loss
    comes back replicated (a Partial(avg) from the groups' mean met the
    CE's Partial(sum), which torch 2.11 cannot convert)."""
    assert _job(found, "units")["moe_aux_placements"] == ["R", "R"]


def test_moe_ffn_decodes_under_fsdp(found):
    """A TP-in-expert MoE (reduced grok) decoding 10 rows under FSDP on
    2 x 4: its capacity of 7 is not split over model (the expert weights
    are gathered along their embed dim first)."""
    r = _job(found, "units")["moe_ffn_fsdp_decode"]
    assert r["ok"], r
    assert sum(r["collectives"]["counts"].values()) > 0


def test_fake_group_refuses_another_size(found):
    assert _job(found, "units")["refused_other_size"]


def test_long_500k_skipped_on_dense_arch():
    """Skipped before any mesh is built, with the reference's reason."""
    res = dr.lower_cell("qwen3-4b", "long_500k", multi_pod=False)
    assert res["skipped"] and res["variant"] == "baseline"
    want = j_registry.build(j_get_config("qwen3-4b")).supports_cell(
        j_registry.SHAPES["long_500k"])
    assert (False, res["reason"]) == tuple(want)


def test_registry_cells_match_reference():
    """``SHAPES``, ``SUBQUADRATIC_FAMILIES``, every arch's
    ``batch_struct`` (shapes and dtypes) and ``supports_cell`` as the
    reference's."""
    assert registry.SUBQUADRATIC_FAMILIES == j_registry.SUBQUADRATIC_FAMILIES
    assert {k: (c.name, c.kind, c.seq_len, c.global_batch)
            for k, c in registry.SHAPES.items()} == \
        {k: (c.name, c.kind, c.seq_len, c.global_batch)
         for k, c in j_registry.SHAPES.items()}
    for arch in J_ARCH_IDS:
        b, jb = (registry.build(get_config(arch)),
                 j_registry.build(j_get_config(arch)))
        for name, cell in registry.SHAPES.items():
            jcell = j_registry.SHAPES[name]
            got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                   for k, v in b.batch_struct(cell).items()}
            want = {k: (tuple(v.shape), str(v.dtype))
                    for k, v in jb.batch_struct(jcell).items()}
            assert got == want, (arch, name)
            assert b.supports_cell(cell) == tuple(jb.supports_cell(jcell))
            assert b.cfg.family not in registry.SUBQUADRATIC_FAMILIES or \
                b.supports_cell(cell)[0]


def test_import_joins_no_group_and_loads_no_jax():
    """Importing the dry run loads no ``jax`` and no ``repro`` module and
    joins no process group; only ``main()`` does."""
    prog = ("import sys, json\n"
            "import repro_torch.launch.dryrun\n"
            "import torch.distributed as dist\n"
            "mods = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print('RESULT:' + json.dumps([mods, dist.is_initialized()]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT:")]
    assert json.loads(line[0][len("RESULT:"):]) == [[], False]
