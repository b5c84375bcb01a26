"""Sharded serving on 2 and 4 local gloo ranks (CPU, float32).

Each mesh shape's cases run in one subprocess that spawns its ranks with
its own file rendezvous under ``tmp_path`` (``tests/_torch_sharded_ranks.py``),
so parallel test workers never share a port or a rendezvous. Every case
serves a reduced config on one device and through the mesh, and the
greedy tokens must be equal; the largest logit difference is printed.
The 1x2 head-sharded case must really be sharded: each rank's decode
kernel's plain version sees half the heads, and each rank holds half of
``wq``'s and ``wo``'s heads. Where model does not divide the KV heads
(4/2 heads on 1x4, 12/3 on 1x2) they stay whole on every rank, and each
rank's kernels read only the KV heads its query heads map to.
"""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))

#: case -> (arch, data, model); "arch:H/Hkv" overrides the head counts
CASES = {
    "aiida-heads-1x2": ("aiida-demo-110m", 1, 2),
    "aiida-heads-2x2": ("aiida-demo-110m", 2, 2),
    "aiida-heads-1x4-kv-whole": ("aiida-demo-110m", 1, 4),
    "aiida-12q3kv-heads-1x2-kv-whole": ("aiida-demo-110m:12/3", 1, 2),
    "qwen2-sequence-1x2": ("qwen2-0.5b", 1, 2),
    "moonshot-expert-1x2": ("moonshot-v1-16b-a3b", 1, 2),
    "grok-ffn-1x2": ("grok-1-314b", 1, 2),
}


def _run_mesh(tmp_path_factory, data: int, model: int) -> list[dict]:
    archs = [a for a, d, m in CASES.values() if (d, m) == (data, model)]
    tmp = tmp_path_factory.mktemp(f"mesh{data}x{model}")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_sharded_ranks.py"),
         "--data", str(data), "--model", str(model), "--archs",
         ",".join(archs), "--rendezvous-dir", str(tmp)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT:")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[0][len("RESULT:"):])


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    return {(d, m): _run_mesh(tmp_path_factory, d, m)
            for d, m in sorted({(d, m) for _, d, m in CASES.values()})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_tokens_equal_single_device_tokens(meshes, case):
    arch, data, model = CASES[case]
    ranks = meshes[(data, model)]
    assert len(ranks) == data * model
    for rank, found in enumerate(ranks):
        r = found[arch]
        print(f"{case} rank {rank}: largest logit difference "
              f"{r['max_logit_diff']:.3e}")
        assert r["sharded"] == r["single"], (rank, r)
        assert r["local_mesh"] == [["data", "model"], [data, model], "cpu"]
        # a cache that the prompt and the new tokens fill: each rank of a
        # sequence-sharded cache holds written positions; every row at one
        # depth, a scalar position writes what the (B,) vector does
        assert r["sharded_cache12"] == r["single"], (rank, r)
        assert r["sharded_cache12_scalar_pos"] == r["single"], (rank, r)
        # the reference's float32 bar, 5e-5 absolute and relative
        assert r["max_logit_diff"] <= 5e-5 * (1 + r["max_logit"]), r


def test_head_sharded_ranks_hold_half_the_heads(meshes):
    """1x2, ``attn_sharding="heads"``: no rank gathers the heads."""
    for found in meshes[(1, 2)]:
        r = found["aiida-demo-110m"]
        h, hkv = r["heads"], r["kv_heads"]
        assert r["heads_rule"] == "model"
        assert r["wq_local"][2] == h // 2 and r["wo_local"][1] == h // 2
        # (q (B, H, hd), cache (B, Smax, Hkv, hd)) at every decode call
        assert r["decode_inputs"], r
        for q_shape, k_shape in r["decode_inputs"]:
            assert q_shape[1] == h // 2 and k_shape[2] == hkv // 2, r


def test_sequence_sharded_decode_sees_the_whole_cache(meshes):
    """1x2, ``attn_sharding="sequence"``: the cache is split along its
    positions, and gathered whole (32 or 12 positions, never half) for the
    decode kernel."""
    for found in meshes[(1, 2)]:
        r = found["qwen2-0.5b"]
        assert r["heads_rule"] == "None"
        assert {k[1] for _, k in r["decode_inputs"]} == {32, 12}, r
        assert all(q[1] == r["heads"] for q, _ in r["decode_inputs"]), r


def test_masked_decode_runs_on_local_shards(meshes):
    """1x2, grok's soft-capped attention takes the masked decode route:
    it runs on each rank's plain shard, H/2 query heads and the Hkv/2 KV
    heads they read, at every decode step of each cache."""
    for found in meshes[(1, 2)]:
        r = found["grok-1-314b"]
        logits = r["masked_decode_logits"]
        assert {shape[-1] for _, shape in logits} == {32, 12}, r
        for plain, (_, hkv, g, _, _) in logits:
            assert plain and (hkv, hkv * g) == (r["kv_heads"] // 2,
                                                 r["heads"] // 2), r


@pytest.mark.parametrize("mesh,arch,q_heads,kv_heads", [
    ((1, 4), "aiida-demo-110m", 1, 1),        # 4/2 heads: one KV head each
    ((1, 2), "aiida-demo-110m:12/3", 6, 3),   # 6 query heads read KV 0,0,1
])                                            # and 1,2,2: blocks of 2
def test_whole_kv_heads_are_read_by_their_query_heads(meshes, mesh, arch,
                                                       q_heads, kv_heads):
    """``attn_sharding="heads"`` where model does not divide Hkv: the
    query heads are split, the KV heads stay whole on every rank (the
    rules' fallback), and each rank's decode kernel gets its H/model
    query heads with one KV head per block of gcd(H/model, H/Hkv) of them
    (global query head i reads KV head i // (H/Hkv))."""
    for found in meshes[mesh]:
        r = found[arch]
        assert r["wq_local"][2] == q_heads, r
        assert any(n.startswith("k: ") and "replicated" in n
                   for n in r["notes"]), r
        assert r["decode_inputs"], r
        for q_shape, k_shape in r["decode_inputs"]:
            assert (q_shape[1], k_shape[2]) == (q_heads, kv_heads), r
