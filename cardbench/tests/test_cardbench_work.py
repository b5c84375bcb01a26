"""The work functions against hand counts at small shapes, the model FLOPs
against the port's own parameter tree, and the reduction of a trace."""

from __future__ import annotations

import math

import pytest
from conftest import REDUCED

from cardbench import bench, devtrace


def test_attention_forward_by_hand():
    # B=1, S=3, H=2, Hkv=1, hd=4: 6 causal pairs a head
    flops, nbytes = bench.work("attn_fwd").work(1, 3, 2, 1, 4)
    assert flops == 2 * 2 * 4 * 2 * 6                    # 2 products
    # q and o: 3 x 2 x 4 each; k and v: 3 x 1 x 4 each; bf16; lse fp32
    assert nbytes == 2 * (24 + 24 + 12 + 12) + 4 * 2 * 3


def test_attention_backward_by_hand():
    flops, nbytes = bench.work("attn_bwd").work(1, 3, 2, 1, 4)
    assert flops == 2.5 * 192
    # q, o, do, dq: 24 each; k, v, dk, dv: 12 each; lse
    assert nbytes == 2 * (4 * 24 + 4 * 12) + 4 * 2 * 3


def test_attention_bounds_at_the_cells_shapes():
    """4 x 4096 is bound by FLOPs; 32 x 512 by bytes (its 512-key rows
    do 1/8 of the pairs for the same bytes)."""
    peaks = bench.peaks()
    for (b, s), by_flops in (((4, 4096), True), ((32, 512), False)):
        for name in ("attn_fwd", "attn_bwd"):
            flops, nbytes = bench.work(name).work(b, s, 32, 8, 64)
            t_flops = flops / peaks["flops_per_s"]["bfloat16"]
            t_bytes = nbytes / peaks["bytes_per_s"]
            assert (t_flops > t_bytes) == by_flops, (b, s, name)


def test_model_flops_by_hand():
    work = bench.work("dense_lm_train")
    cfg = dict(hidden_size=8, num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=1, head_dim=4, intermediate_size=16,
               vocab_size=10)
    per_layer = 8 * 2 * 4 + 2 * (8 * 1 * 4) + 2 * 4 * 8 + 3 * 8 * 16
    assert work.matmul_params(cfg) == 2 * per_layer + 8 * 10
    # 1 row of 3 tokens: 6 causal pairs, 12 L H hd FLOPs a pair
    assert work.flops(cfg, 1, 3) == 6 * (2 * per_layer + 80) * 3 + \
        12 * 2 * 2 * 4 * 6


def test_granite_parameters_and_attention_share():
    spec = bench.spec()
    cfg = bench.config(spec, "granite-3-2b")
    work = bench.work(cfg["train_flops"])
    assert work.matmul_params(cfg) == pytest.approx(2.533e9, rel=1e-3)
    full = work.flops(cfg, 4, 4096)
    short = work.flops(cfg, 32, 512)
    dense = 6 * work.matmul_params(cfg) * 16384
    assert (full - dense) / full == pytest.approx(0.117, abs=0.005)
    assert (short - dense) / short == pytest.approx(0.016, abs=0.002)


def test_model_parameters_match_the_ports_tree():
    """N is the port's parameter count less its padded table, plus the
    output head over the model's own vocabulary."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import build

    spec = bench.spec()
    for cfg in (bench.config(spec, "granite-3-2b"),
                dict(bench.config(spec, "granite-3-2b"), **REDUCED)):
        port = build(bench.driver("train").port_config(cfg))
        leaves = dict(tree_leaves(port.param_shapes()))
        total = sum(math.prod(s.shape) for s in leaves.values())
        norms = sum(math.prod(s.shape) for p, s in leaves.items()
                    if p.rsplit("/", 1)[-1].startswith("ln_"))
        table = math.prod(leaves["embedding"].shape)
        want = total - norms - table + cfg["vocab_size"] * cfg["hidden_size"]
        assert bench.work(cfg["train_flops"]).matmul_params(cfg) == want


KINDS = [{"kind": "attn_fwd", "priority": 100, "patterns": ["flash_fwd"]},
         {"kind": "matmul", "priority": 50, "patterns": ["gemm"]},
         {"kind": "copy", "priority": 40, "patterns": ["memcpy"]}]


def test_trace_union_gaps_and_host_labels():
    device = [("flash_fwd_wgmma_kernel", 0.0, 10.0),
              ("sm90_gemm_bf16", 5.0, 15.0),          # overlaps: counted once
              ("Memcpy DtoD (Device -> Device)", 20.0, 25.0),
              ("elementwise_kernel", 40.0, 50.0)]     # outside the window
    host = [(14.0, 22.0, "aten::mm"), (16.0, 18.0, "aten::copy_"),
            (26.0, 29.0, "aten::add"), (-5.0, 35.0, devtrace.WINDOW_RANGE)]
    tr = devtrace.reduce(device, host, (0.0, 30.0), KINDS)
    assert tr.window_s == pytest.approx(30e-6)
    assert tr.busy_s == pytest.approx(20e-6)
    assert tr.launches == 2                           # the copy is no launch
    assert tr.device_s_by_kind == pytest.approx(
        {"attn_fwd": 10e-6, "matmul": 10e-6, "copy": 5e-6})
    # the gap 15..20 falls under aten::copy_ (innermost at 17.5), 25..30
    # under aten::add
    assert tr.idle_by_host == pytest.approx({"aten::copy_": 5e-6,
                                             "aten::add": 5e-6})
    b = tr.breakdown()
    assert b["device_ops"][0][1] == pytest.approx(10e-6)
    assert len(b["device_ops"]) == 3 and len(b["idle_gaps"]) == 2


def test_host_activity_sweep_matches_the_plain_search():
    import random

    rng = random.Random(0)
    host = []
    for _ in range(300):
        a = rng.uniform(0, 1000)
        host.append((a, a + rng.uniform(0, 50), f"op{len(host)}"))
    times = sorted(rng.uniform(0, 1100) for _ in range(200))

    def plain(t):
        best = None
        for a, b, name in host:
            if a <= t <= b and (best is None or a > best[0]):
                best = (a, name)
        return best[1] if best else "python"

    assert devtrace.host_activity(host, times) == [plain(t) for t in times]
