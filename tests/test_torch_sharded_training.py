"""Sharded training on 2 and 4 local gloo ranks (CPU, float32).

Each mesh runs in one subprocess that spawns its ranks with its own file
rendezvous under a temporary directory
(``tests/_torch_sharded_train_ranks.py``), every check of that mesh in
it: 2 x 1 (FSDP: the ``embed`` dim over ``data``) with AdamW, Adafactor
and two microbatches, then 1 x 2 (heads, the MoE's experts and the
vocab over ``model``; the VLM backbone's sequence-sharded attention) and
2 x 2 (both, with the chunked CE, and under FSDP with 12/3 heads, the
KV heads whole on both model ranks, and 3/1 heads, the query heads whole
too; the dense LM and the MoE with 3 rows per data group, which the model
axis does not divide); the xLSTM on 2 x 1, the hybrid (its
``d_rnn`` channels over ``model``) and whisper on 1 x 2. Against one
device on
the same global batch: the loss, grad_norm and every gradient leaf, and
every parameter and optimizer-state leaf after two steps, at the bars
``tests/test_torch_training.py`` holds the port to the reference with
(loss rtol 1e-5, each leaf 1e-4 of its norm). Checkpoints: 2 x 1 saves
its state after two steps, which restores bit-equal on 1 x 2, 2 x 2, one
device and through the reference's ``restore_checkpoint``; one device's
and the reference's checkpoints restore onto a mesh; the hybrid's and the
xLSTM's list-of-layers states, saved per rank on 1 x 2 and on one
device, restore bit-equal on one device in both packages. Leaves cross
processes as SHA-256 digests of their bytes.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.training import checkpoint as j_ckpt
from repro.training import optim as J
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import TokenStream as JTokenStream
from repro.training.train_step import TrainConfig as JTrainConfig
from repro.training.train_step import make_train_step as j_make_step
from repro.training.train_step import train_state_axes as j_state_axes
from repro.training.train_step import train_state_shapes as j_state_shapes
from repro.configs import reduced_config as j_reduced
from repro.models.registry import build as j_build
from repro_torch.configs import reduced_config
from repro_torch.models import rglru as rg
from repro_torch.models.registry import build
from repro_torch.models.common import tree_leaves
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optim as O
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.train_step import (TrainConfig, train_state_axes,
                                             train_state_shapes)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_sharded_train_ranks as ranks  # noqa: E402

MESH_CASES, PROBE_CASES = ranks.MESH_CASES, ranks.PROBE_CASES
TRAIN_CASES = [(d, m, c) for (d, m), cs in MESH_CASES.items() for c in cs]
DONATED = [(d, m, c) for d, m, c in TRAIN_CASES if c in ranks.DONATED_CASES]
NORM_PROBES = [(d, m, c) for (d, m), cs in ranks.LAYER_NORM_PROBES.items()
               for c in cs]


def _run(tmp, data: int, model: int, spec: dict) -> list[dict]:
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_sharded_train_ranks.py"),
         "--data", str(data), "--model", str(model), "--spec",
         json.dumps(spec), "--rendezvous-dir", str(tmp)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT:")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[0][len("RESULT:"):])


def _np_digest(tree) -> dict[str, str]:
    return ranks.digest(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Each mesh's per-rank findings, and the checkpoints they crossed."""
    root = tmp_path_factory.mktemp("sharded_train")
    state = ranks.initial_state("adamw")
    dirs = ranks.prepare(str(root))
    dirs["reference"] = str(root / "reference")
    j_ckpt.save_checkpoint(dirs["reference"], 0, jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), state))
    out = {"dirs": dirs, "single_state": state}
    for (data, model), spec in ranks.mesh_specs(dirs,
                                                dirs["reference"]).items():
        out[(data, model)] = _run(root, data, model, spec)
    return out


@pytest.mark.parametrize("data,model,case", TRAIN_CASES,
                         ids=[f"{d}x{m}-{c}" for d, m, c in TRAIN_CASES])
def test_mesh_training_matches_one_device(meshes, data, model, case):
    """Loss, grad_norm and every gradient leaf at the initial state; the
    loss and grad_norm of two train steps and every state leaf after
    them, the state still placed by its axes."""
    found = meshes[(data, model)]
    assert len(found) == data * model
    assert not ranks.case_failures(case, found)
    for rank, r in enumerate(found):
        c = r[case]
        print(f"{data}x{model} {case} rank {rank}: worst gradient leaf "
              f"{max(c.get('grad_err', {'-': 0.0}).values()):.2e}, worst "
              f"state leaf {max(c['state_err'].values()):.2e}")


@pytest.mark.parametrize("data,model,case", DONATED,
                         ids=[f"{d}x{m}-{c}" for d, m, c in DONATED])
def test_donated_mesh_step_equals_functional(meshes, data, model, case):
    """The mesh's two steps taken donated (``make_train_step(...,
    donate=True)``) from a copy of the state the functional steps start
    from: every local shard bit-equal to the functional steps', each leaf
    in its own storage and placements, the same dict returned."""
    for r in meshes[(data, model)]:
        assert r[case]["donated"] == {"unequal": [], "moved": [],
                                      "same_dict": True}


@pytest.mark.parametrize("data,model,case", NORM_PROBES,
                         ids=[f"{d}x{m}-{c}" for d, m, c in NORM_PROBES])
def test_layer_norm_on_odd_rows_matches_one_device(meshes, data, model,
                                                   case):
    """``common.layer_norm`` at the xLSTM's and whisper's widths on 6 rows
    (3 per data group) under FSDP on 2 x 2, its output's gradient a
    partial sum over model: the output and the gradients of its input,
    weight and bias within 1e-5 of their norm of one device's."""
    assert not ranks.layer_norm_failures(case, meshes[(data, model)])


def test_microbatches_split_each_ranks_own_rows(meshes):
    """On 2 x 1 with two microbatches, microbatch i is the i-th half of
    each rank's own rows, sharded as the batch was: no row moves."""
    for r in meshes[(2, 1)]:
        assert r["micro2"]["microbatches_keep_local_rows"]


def test_mesh_shards_the_state(meshes):
    """FSDP splits the ``embed`` dim over data; heads, the vocab and the
    MoE's experts split over model; 2 x 2 does both."""
    cfg = reduced_config("aiida-demo-110m")
    moe = reduced_config("moonshot-v1-16b-a3b")
    d, h = cfg.d_model, cfg.num_heads
    for r in meshes[(2, 1)]:
        shapes = r["adamw"]["local_shapes"]
        assert shapes["layers/attn/wq"][1:3] == [d // 2, h]
        assert shapes["embedding"][1] == d // 2
    for r in meshes[(1, 2)]:
        assert r["adamw"]["local_shapes"]["layers/attn/wq"][1:3] == [d, h // 2]
        assert r["adamw"]["local_shapes"]["embedding"] == [
            cfg.padded_vocab // 2, d]
        assert r["moe"]["local_shapes"]["layers/moe/w_gate"][1] == \
            moe.num_experts // 2
    for r in meshes[(2, 2)]:
        assert r["adamw_chunked_ce"]["local_shapes"]["layers/attn/wq"][1:3] \
            == [d // 2, h // 2]


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
def test_flash_backward_runs_on_local_shards(meshes, mesh):
    """``local_map`` carries the flash kernel's autograd Function: its
    backward (the dq and dk/dv kernels' plain versions here) runs once per
    layer on each rank's rows and heads."""
    cfg = reduced_config("aiida-demo-110m")
    data, model = mesh
    for r in meshes[mesh]:
        c = r[MESH_CASES[mesh][0]]
        assert c["mesh_bwd_calls"] == cfg.num_layers, c["mesh_bwd_inputs"]
        want_q = [4 // data, ranks.SEQ, cfg.num_heads // model, cfg.hd]
        want_k = [4 // data, ranks.SEQ, cfg.num_kv_heads // model, cfg.hd]
        assert c["mesh_bwd_inputs"] == [[want_q, want_k]], c


@pytest.mark.parametrize("mesh,case", [(m, c) for m, cs in
                                       PROBE_CASES.items() for c in cs],
                         ids=[f"{d}x{m}-{c}" for (d, m), cs in
                              PROBE_CASES.items() for c in cs])
def test_mesh_sites_hand_on_local_shards(meshes, mesh, case):
    """Under the mesh's rules, in one loss with each attention route: every
    route gets plain tensors, this rank's rows and query heads (under
    ``"sequence"`` every position); the attention output meets its
    projection sharded over the heads, never over the sequence; the
    embedding looks up this rank's rows of the batch with plain ids (the
    table whole); the MoE's combine reads every expert's output."""
    assert not ranks.probe_failures(case, meshes[mesh], *mesh)


def test_mesh_loss_matches_reference(meshes):
    """The 2 x 1 mesh's first loss is the reference's ``make_train_step``
    loss on the same parameters (bridged through numpy) and batch."""
    state = meshes["single_state"]
    jcfg = j_reduced("aiida-demo-110m").replace(
        dtype="float32", kv_cache_dtype="float32", attn_impl="pallas")
    jstate = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state)
    batch = {k: jnp.asarray(v.numpy())
             for k, v in ranks.global_batches("adamw")[0].items()}
    tcfg = JTrainConfig(optim=J.OptimConfig(warmup_steps=1, total_steps=10))
    _, jm = jax.jit(j_make_step(j_build(jcfg), tcfg))(jstate, batch)
    for r in meshes[(2, 1)]:
        np.testing.assert_allclose(r["adamw"]["loss"][0][1], float(jm["loss"]),
                                   rtol=ranks.LOSS_RTOL)
        np.testing.assert_allclose(r["adamw"]["step_grad_norm"][0][1],
                                   float(jm["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("where", ["one-device", "1x2", "2x2"])
def test_checkpoint_restores_bit_equal_across_meshes(meshes, where):
    """2 x 1's state after two steps, saved by its ranks, restores leaf for
    leaf bit-equal on one device, on 1 x 2 and on 2 x 2."""
    saved = meshes[(2, 1)][0]["saved"]
    assert all(r["saved"] == saved for r in meshes[(2, 1)])
    if where == "one-device":
        got = [ranks.digest(ckpt.restore_checkpoint(
            meshes["dirs"]["saved"], device="cpu"))]
    else:
        mesh = tuple(int(n) for n in where.split("x"))
        got = [r["restore:from_2x1"] for r in meshes[mesh]]
        assert all(r["restore:from_2x1:placed_as_axes"]
                   for r in meshes[mesh])
    for g in got:
        assert g == saved


def test_partial_manifests_never_survive_a_publish(meshes):
    """The published step holds one manifest and the shards it names; no
    ``.tmp`` directory and no partial manifest is left (a stale one from a
    crashed save was not merged)."""
    directory = meshes["dirs"]["saved"]
    assert os.listdir(directory) == ["step_2"]
    files = set(os.listdir(os.path.join(directory, "step_2")))
    with open(os.path.join(directory, "step_2", "manifest.json")) as fh:
        manifest = json.load(fh)
    named = {s["file"] for e in manifest["leaves"].values()
             for s in e["shards"]}
    assert files == named | {"manifest.json"}
    emb = manifest["leaves"]["params/embedding"]
    assert [s["index"] for s in emb["shards"]] == [[None, [0, 64]],
                                                   [None, [64, 128]]]
    assert manifest["leaves"]["step"]["shards"] == [
        {"file": "step.npy", "index": None}]


def test_port_sharded_checkpoint_restores_in_reference(meshes):
    got = j_ckpt.restore_checkpoint(meshes["dirs"]["saved"])
    assert _np_digest(got) == meshes[(2, 1)][0]["saved"]


def test_reference_checkpoint_restores_on_a_port_mesh(meshes):
    want = _np_digest(j_ckpt.restore_checkpoint(meshes["dirs"]["reference"]))
    for r in meshes[(1, 2)]:
        assert r["restore:reference"] == want
        assert r["restore:reference:placed_as_axes"]


def test_elastic_restore_resharding(meshes):
    """Twin of ``tests/test_checkpoint_data.py::test_elastic_restore_resharding``:
    a checkpoint saved unsharded (one device) restores onto a 2 x 1 mesh's
    placements with the same values."""
    want = ranks.digest(meshes["single_state"])
    for r in meshes[(2, 1)]:
        assert r["restore:single"] == want
        assert r["restore:single:placed_as_axes"]


def test_data_by_rank(meshes):
    """On 2 x 2 each rank's data group is its ``data`` coordinate; the
    ranks of one group read the same rows, the two groups disjoint ones."""
    found = meshes[(2, 2)]
    for r in found:
        assert r["data_group"] == [r["coordinate"][0], 2]
    by_group = {}
    for r in found:
        by_group.setdefault(r["data_group"][0], []).append(r["first_batch"])
    assert all(b == g[0] for g in by_group.values() for b in g)
    assert by_group[0][0] != by_group[1][0]


def test_data_pipeline_host_sharding_disjoint():
    """Twin of ``tests/test_checkpoint_data.py::test_data_pipeline_host_sharding_disjoint``:
    different hosts consume disjoint document streams, each the
    reference's for the same host."""
    kw = dict(vocab_size=500, seq_len=32, batch_size=2, seed=1, num_hosts=2)
    h0 = TokenStream(DataConfig(host_id=0, **kw))
    h1 = TokenStream(DataConfig(host_id=1, **kw))
    b0, b1 = h0.next_batch(), h1.next_batch()
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    for host, got in ((0, b0), (1, b1)):
        want = JTokenStream(JDataConfig(host_id=host, **kw)).next_batch()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("arch", ["aiida-demo-110m", "moonshot-v1-16b-a3b",
                                  "recurrentgemma-2b", "xlstm-350m",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_state_shapes_and_axes_match_reference(arch, optimizer):
    """``train_state_shapes`` (meta tensors, nothing allocated),
    ``train_state_axes`` and ``opt_state_axes`` leaf for leaf against the
    reference's."""
    tcfg = TrainConfig(optim=O.OptimConfig(name=optimizer))
    jt = JTrainConfig(optim=J.OptimConfig(name=optimizer))
    bundle, jbundle = build(reduced_config(arch)), j_build(j_reduced(arch))
    shapes = dict(tree_leaves(train_state_shapes(bundle, tcfg)))
    jshapes = dict(tree_leaves(jax.tree.map(
        lambda s: (tuple(s.shape), str(s.dtype)),
        j_state_shapes(jbundle, jt))))
    assert shapes.keys() == jshapes.keys()
    for key, s in shapes.items():
        assert (s.shape, str(s.dtype).removeprefix("torch.")) == jshapes[key]
    axes = dict(tree_leaves(train_state_axes(bundle, tcfg)))
    jaxes = j_state_axes(jbundle, jt)
    flat = {}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], f"{prefix}{k}/")
        elif isinstance(tree, list):        # the hybrid's, the xLSTM's layers
            for i, t in enumerate(tree):
                walk(t, f"{prefix}{i}/")
        else:
            flat[prefix.rstrip("/")] = tuple(tree)

    walk(jaxes)
    assert axes == flat


def test_hybrid_training_ranks_scan_their_own_channels(meshes):
    """1 x 2: each rank's scan (its wrapper's plain versions, forward and
    reversed in the backward) sees its d_rnn / 2 channels and all of its
    rows and steps, once per recurrent layer and pass (forward, the remat
    recompute, the backward's reversed scan)."""
    cfg = ranks.case_config("hybrid")
    rglru_layers = sum(k == "rglru" for k in rg.layer_kinds(cfg))
    for r in meshes[(1, 2)]:
        c = r["hybrid"]
        want = [[[4, ranks.SEQ, cfg.d_rnn // 2], rev] for rev in (False,
                                                                  True)]
        assert c["mesh_scan_inputs"] == want, c["mesh_scan_inputs"]
        assert c["mesh_scan_calls"] == 3 * rglru_layers, c


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
def test_shard_batch_splits_frames_by_rank(meshes, mesh):
    """Whisper's frames go to each data group as its tokens do: its own
    rows, sharded over ``data`` like the tokens, the whole batch when
    gathered."""
    data, _ = mesh
    for r in meshes[mesh]:
        f = r["frames_by_rank"]
        assert f["own_rows"] and f["whole"] and f["same_as_tokens"], f
        assert f["placements"][0] == ("S(0)" if data > 1 else "R"), f


def _list_target(case: str, package: str):
    """The train-state shapes of ``case``'s config in either package."""
    if package == "port":
        return train_state_shapes(build(ranks.case_config(case)),
                                  ranks.train_config(case))
    arch, opt = ranks.CASES[case][:2]
    return j_state_shapes(j_build(j_reduced(arch)),
                          JTrainConfig(optim=J.OptimConfig(name=opt)))


@pytest.mark.parametrize("case", ranks.LIST_CASES)
@pytest.mark.parametrize("where", ["one-device", "1x2"])
def test_list_of_layers_checkpoint_restores_bit_equal(meshes, tmp_path,
                                                      case, where):
    """A list-of-layers train state (the hybrid's after 1 x 2's two steps,
    the xLSTM's initial one placed on 1 x 2), saved per rank on 1 x 2 or
    whole on one device, restores on one device bit-equal with its lists
    (keys ``params/layers/<i>/...``) in the port, and bit-equal in the
    reference's ``restore_checkpoint`` given its own target."""
    if where == "one-device":
        state = ranks.initial_state(case)
        directory = str(tmp_path / case)
        ckpt.save_checkpoint(directory, 2, state)
        want = ranks.digest(state)
    else:
        directory = meshes["dirs"][case]
        want = meshes[(1, 2)][0][f"saved:{case}"]
        assert all(r[f"saved:{case}"] == want for r in meshes[(1, 2)])
    got = ckpt.restore_checkpoint(directory, target=_list_target(case, "port"),
                                  device="cpu")
    assert isinstance(got["params"]["layers"], list)
    assert isinstance(got["opt"]["mu"]["layers"], list)
    assert any(k.startswith("params/layers/1/") for k in want)
    assert ranks.digest(got) == want
    ref = j_ckpt.restore_checkpoint(directory,
                                    target=_list_target(case, "reference"))
    assert isinstance(ref["params"]["layers"], list)
    assert _np_digest(ref) == want


def _partial(tmp, rank: int, token: str, leaves: dict) -> None:
    with open(os.path.join(tmp, ckpt.PARTIAL_MANIFEST.format(rank)),
              "w") as fh:
        json.dump({"token": token, "leaves": leaves}, fh)


def _entry(index):
    return {"shape": [4], "dtype": "float32",
            "shards": [{"file": f"w.shard{index[0] // 2}.npy",
                        "index": [index]}]}


def test_merge_waits_for_this_saves_partial_manifests(tmp_path):
    """Rank 0 merges only partial manifests of its own save: a stale one
    (another token) is waited past until its rank writes the fresh one,
    and the merged shards cover the leaf; the partials are then gone."""
    import threading

    _partial(tmp_path, 0, "now", {"w": _entry([0, 2])})
    _partial(tmp_path, 1, "stale", {"w": _entry([0, 2])})
    late = threading.Timer(0.3, _partial,
                           (tmp_path, 1, "now", {"w": _entry([2, 4])}))
    late.start()
    try:
        merged = ckpt._merge_partials(str(tmp_path), 2, "now")
    finally:
        late.join()
    assert [s["index"] for s in merged["w"]["shards"]] == [[[0, 2]],
                                                           [[2, 4]]]
    assert not [f for f in os.listdir(tmp_path) if f.startswith("manifest")]


def test_merge_raises_on_a_missing_rank_or_a_gap(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "SHARD_TIMEOUT_S", 0.2)
    _partial(tmp_path, 0, "now", {"w": _entry([0, 2])})
    with pytest.raises(TimeoutError, match=r"ranks \[1\]"):
        ckpt._merge_partials(str(tmp_path), 2, "now")
    _partial(tmp_path, 1, "now", {})
    with pytest.raises(RuntimeError, match="cover 2 of 4"):
        ckpt._merge_partials(str(tmp_path), 2, "now")


def test_spawn_ranks_waits_without_a_deadline_when_told_to():
    """Ranks that outlive a deadline fail the call under it and finish
    without one (the training launcher's wait); with no deadline a rank
    that exits without a result still fails the call, at once, while
    the other sleeps on."""
    from repro_torch.configs import spawn_ranks

    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\]"):
        spawn_ranks(ranks.nap, 2, "cpu", (3.0,), timeout=0.5)
    assert spawn_ranks(ranks.nap, 2, "cpu", (3.0,), timeout=None) == [0, 1]
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1:\nexited with code 3"):
        spawn_ranks(ranks.nap, 2, "cpu", (120.0, 1), timeout=None)
    assert time.monotonic() - t < 60
