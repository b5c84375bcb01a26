"""The port's CUDA kernels on the card (marked ``cuda``; they skip where
``torch.cuda.is_available()`` is false, as on a CPU-only machine).

Run on a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Imports neither JAX nor ``repro``: the machine with the card has no JAX.
Each kernel is held against its plain version on the same CUDA inputs at
the reference's tolerances (bf16 2e-2, f32 5e-5; the backward passes at
f32 1e-4, given the same out, lse and do). The flash kernels' outputs are
also held as a share of their norm (NORM_TOL) and the forward's lse at
1e-4 absolute (LSE_TOL). The RG-LRU scan returns fp32
whatever its inputs, so its forward is held at 5e-5 for bf16 inputs too;
its gradients come back in the inputs' dtype and are held at BWD_TOL.
The chunkwise mLSTM kernel's hs (in q's dtype) is held at TOL, its fp32
state at 5e-5, and, in fp32, both against the sequential oracle at the
reference's bars (hs 1e-4, C 1e-3, m 1e-5).
"""

import pytest
import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.mlstm_chunk import ops as ml_ops
from repro_torch.kernels.mlstm_chunk.ref import (chunk_len,
                                                 mlstm_chunkwise_ref,
                                                 mlstm_recurrent_ref)
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.models.common import tree_leaves

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
NORM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LSE_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("h,hkv,hd", [(12, 4, 64), (4, 2, 32), (8, 1, 128),
                                      (16, 2, 64), (10, 1, 256), (4, 2, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_version(cuda, h, hkv, hd, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, smax = 5, 300
    q = _randn(gen, (b, h, hd), dtype, cuda)
    k = _randn(gen, (b, smax, hkv, hd), dtype, cuda)
    v = _randn(gen, (b, smax, hkv, hd), dtype, cuda)
    lens = torch.tensor([0, 1, 33, smax - 1, smax], dtype=torch.int32,
                        device=cuda)
    before = da_ops.decode_attention.launches
    out = da_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before + 1
    ref = decode_attention_ref(q, k, v, lens, scale=hd ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert bool((out[0] == 0).all())


def test_decode_kernel_reads_a_strided_cache_view(cuda):
    """A layer slice of a stacked cache, read through its strides."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    cache = _randn(gen, (3, 2, 128, 4, 64), torch.bfloat16, cuda)
    q = _randn(gen, (2, 12, 64), torch.bfloat16, cuda)
    lens = torch.tensor([100, 128], dtype=torch.int32, device=cuda)
    k, v = cache[1], cache[2]
    out = da_ops.decode_attention(q, k, v, lens)
    ref = decode_attention_ref(q, k, v, lens, scale=0.125)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("b,h,hkv,hd,smax", [
    (4, 12, 4, 64, 1024),     # the serving shape: splits of 64
    (16, 12, 4, 64, 1024),    # B * Hkv = 64: splits of 128
    (1, 8, 4, 128, 4096),     # B * Hkv = 4, a long cache
    (3, 8, 1, 32, 200),       # G = 8, hd 32
    (4, 10, 1, 256, 2048),    # recurrentgemma-2b's heads and window
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_kv_matches_plain_version_at_split_edges(cuda, b, h,
                                                              hkv, hd, smax,
                                                              dtype):
    """The split-KV kernel with kv_len at and around every split edge of
    its plan, one launch per call, the same output from a second launch
    (the merge's tickets are back at zero)."""
    gen = torch.Generator(device=cuda).manual_seed(b + hd)
    _, _, per = da_ops.split_plan(
        b, hkv, h // hkv, smax,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    edges = [0, 1, per - 1, per, per + 1, smax - 1, smax, 2 * per + 1]
    lens = torch.tensor([min(edges[i % len(edges)], smax) for i in range(b)],
                        dtype=torch.int32, device=cuda)
    q = _randn(gen, (b, h, hd), dtype, cuda)
    k = _randn(gen, (b, smax, hkv, hd), dtype, cuda)
    v = _randn(gen, (b, smax, hkv, hd), dtype, cuda)
    before = da_ops.decode_attention.launches
    out = da_ops.decode_attention(q, k, v, lens)
    again = da_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before + 2
    ref = decode_attention_ref(q, k, v, lens, scale=hd ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.equal(out, again)
    for row in range(b):
        if int(lens[row]) == 0:
            assert bool((out[row] == 0).all())


def test_decode_workspace_serves_shapes_in_turn(cuda):
    """Calls of two shapes in turn share the kept workspace and tickets and
    stay right: every launch leaves the tickets at zero."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    shapes = [(4, 12, 4, 64, 1024), (2, 4, 2, 128, 512)]
    ins = []
    for b, h, hkv, hd, smax in shapes:
        ins.append((_randn(gen, (b, h, hd), torch.bfloat16, cuda),
                    _randn(gen, (b, smax, hkv, hd), torch.bfloat16, cuda),
                    _randn(gen, (b, smax, hkv, hd), torch.bfloat16, cuda),
                    torch.randint(0, smax + 1, (b,), generator=gen,
                                  device=cuda, dtype=torch.int32)))
    first = [da_ops.decode_attention(*a) for a in ins]
    for _ in range(3):
        for a, want in zip(ins, first):
            assert torch.equal(da_ops.decode_attention(*a), want)
    for (q, k, v, lens), got in zip(ins, first):
        ref = decode_attention_ref(q, k, v, lens, scale=q.shape[-1] ** -0.5)
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("hd", [48, 96, 160])
def test_kernels_refuse_a_head_dim_they_do_not_take(cuda, hd):
    """A head_dim outside (32, 64, 128, 256) raises on a CUDA tensor: no
    call falls back to a plain version."""
    q = torch.zeros(1, 8, 2, hd, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        da_ops.decode_attention(q[:, 0], q, q, 8)


# (b, sq, skv, h, hkv, hd, options): lengths at the tensor-core body's tile
# edges (64-row query tiles, 128-key tiles) and the serving path's prompts
# (96, 250, 511, 700), hd 32/64/128/256, non-causal, more
# keys than queries with q_offset = skv - sq, no keys, windows, softcap
# with a window, G = 1/3/4/10, and q, k, v as views of one fused
# projection
FLASH_CASES = (
    [(1, s, s, 12, 4, 64, {}) for s in (1, 63, 64, 65, 96, 127, 128, 129,
                                         250, 511, 700, 1024)]
    + [(1, s, s, 12, 4, hd, {}) for hd in (32, 128) for s in (65, 129, 700)]
    + [(1, s, s, 12, 4, hd, {"causal": False})
       for hd, s in ((64, 1), (64, 64), (64, 129), (64, 700), (32, 129),
                     (128, 129))]
    + [(1, 65, 200, 12, 4, 64, {"q_offset": 135}),
       (1, 129, 1024, 12, 4, 64, {"q_offset": 895}),
       (1, 64, 1024, 12, 4, 128, {"q_offset": 960}),
       (1, 37, 300, 12, 4, 64, {"causal": False}),
       (1, 65, 0, 12, 4, 64, {"q_offset": -65}),
       (1, 65, 0, 12, 4, 64, {"causal": False})]
    + [(1, 700, 700, 12, 4, 64, {"window": w}) for w in (1, 64, 127)]
    + [(1, 129, 129, 12, 4, 128, {"window": 64}),
       (1, 511, 511, 12, 4, 64, {"softcap": 30.0, "window": 127}),
       (1, 129, 129, 12, 4, 32, {"softcap": 30.0})]
    + [(2, 257, 257, h, 4, 64, {}) for h in (4, 12, 16)]
    + [(2, 300, 300, 12, 4, 64, {"strided": True}),
       (1, 129, 129, 12, 4, 128, {"strided": True})]
    # the earlier sweep's cases, at batch 2
    + [(2, 1, 1, 12, 4, 64, {}), (2, 37, 37, 12, 4, 64, {}),
       (2, 700, 700, 12, 4, 64, {}), (2, 200, 200, 12, 4, 64, {"window": 64}),
       (2, 130, 130, 12, 4, 64, {"softcap": 30.0}),
       (2, 37, 42, 12, 4, 64, {"q_offset": 5})]
    # hd 256: recurrentgemma-2b's 10 query heads on one KV head and its
    # window of 2048 (past S, then within it), an odd length, G = 2
    + [(1, s, s, 10, 1, 256, {"window": 2048}) for s in (333, 4096)]
    + [(2, 37, 37, 2, 1, 256, {"window": 16, "softcap": 30.0}),
       (1, 129, 129, 4, 2, 256, {"causal": False}),
       (1, 65, 200, 4, 2, 256, {"q_offset": 135}),
       (1, 129, 129, 10, 1, 256, {"strided": True})])


def _flash_case(cuda, b, sq, skv, h, hkv, hd, opts, dtype):
    """q, k, v and the forward's options of one FLASH_CASES entry."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    opts = dict(opts)
    if opts.pop("strided", False):
        qkv = _randn(gen, (b, sq, h + 2 * hkv, hd), dtype, cuda)
        q, k, v = qkv.split([h, hkv, hkv], dim=2)
    else:
        q = _randn(gen, (b, sq, h, hd), dtype, cuda)
        k = _randn(gen, (b, skv, hkv, hd), dtype, cuda)
        v = _randn(gen, (b, skv, hkv, hd), dtype, cuda)
    full = dict(causal=True, window=0, scale=hd ** -0.5, softcap=0.0,
                q_offset=0) | opts
    return q, k, v, full


def _assert_fwd_close(out, lse, rout, rlse, dtype):
    """out at TOL and within NORM_TOL of its norm; lse at LSE_TOL
    absolute where a row has a live key, -inf where it has none."""
    torch.testing.assert_close(out.float(), rout.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    share = ((out.float() - rout.float()).norm()
             / rout.float().norm().clamp_min(1e-30))
    assert share <= NORM_TOL[dtype], float(share)
    torch.testing.assert_close(lse, rlse, atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("b,sq,skv,h,hkv,hd,opts", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, b, sq, skv, h, hkv, hd,
                                            opts, dtype):
    """The forward against ``flash_attention_ref`` (out, and lse where a
    row has a live key; -inf where it has none), one launch per call, on
    the tensor-core body for bfloat16 and the CUDA-core body for float32."""
    q, k, v, full = _flash_case(cuda, b, sq, skv, h, hkv, hd, opts, dtype)
    fwd = fa_ops.flash_attention_fwd
    before = (fwd.launches, fwd.tensor_core_launches)
    out, lse = fwd(q, k, v, **full)
    torch.cuda.synchronize()
    assert fwd.launches == before[0] + 1
    assert fwd.tensor_core_launches == before[1] + (dtype == torch.bfloat16)
    _assert_fwd_close(out, lse, *flash_attention_ref(q, k, v, **full), dtype)


@pytest.mark.parametrize("odd_q,odd_kv", [(True, True), (True, False),
                                          (False, True)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_views_at_an_odd_offset(cuda, odd_q, odd_kv, hd,
                                                   dtype):
    """q, k or v one element into their storage (rows not 16-byte aligned):
    the wrapper copies them contiguous, and out and lse match the plain
    version at the forward's bars."""
    gen = torch.Generator(device=cuda).manual_seed(4)

    def make(shape, odd):
        n = shape[0] * shape[1] * shape[2] * shape[3]
        flat = _randn(gen, (n + odd,), dtype, cuda)
        return flat[int(odd):].view(shape)

    q = make((2, 129, 12, hd), odd_q)
    k, v = (make((2, 129, 4, hd), odd_kv) for _ in range(2))
    assert (q.data_ptr() % 16 != 0) == odd_q
    full = dict(causal=True, window=0, scale=hd ** -0.5, softcap=0.0,
                q_offset=0)
    out, lse = fa_ops.flash_attention_fwd(q, k, v, **full)
    torch.cuda.synchronize()
    _assert_fwd_close(out, lse, *flash_attention_ref(q, k, v, **full), dtype)


@pytest.mark.parametrize("b,sq,skv,h,hkv,hd,opts", [
    (2, 96, 96, 4, 4, 32, {}),                         # MHA
    (1, 250, 250, 8, 2, 64, {}),                       # GQA 4x, ragged
    (2, 250, 250, 12, 4, 64, {"window": 64}),          # G = 3
    (1, 130, 130, 12, 4, 128, {"softcap": 30.0}),
    (2, 37, 42, 12, 4, 64, {"q_offset": 5}),
    (1, 40, 70, 4, 2, 64, {"q_offset": 30, "window": 16}),
    (1, 1024, 1024, 12, 4, 64, {}),
    # the tensor-core bodies' tile edges (64 queries; 128 keys, 64 at
    # hd = 128) and what they treat specially
    (2, 65, 65, 12, 4, 32, {}),
    (2, 129, 129, 12, 4, 128, {}),
    (1, 127, 127, 12, 4, 64, {"causal": False}),
    (1, 129, 129, 12, 4, 128, {"causal": False}),
    (1, 65, 200, 12, 4, 128, {"q_offset": 135}),
    (1, 100, 100, 4, 4, 64, {"q_offset": 9, "window": 33}),  # G = 1
    (2, 40, 40, 12, 4, 32, {"q_offset": -10}),             # keyless rows
    (1, 250, 250, 16, 4, 64, {"softcap": 30.0, "window": 64}),
    # hd 256 (two warpgroups in the dk/dv pass): recurrentgemma-2b's heads
    # and window, an odd length, softcap, a query offset
    (1, 333, 333, 10, 1, 256, {"window": 2048}),
    (2, 1024, 1024, 10, 1, 256, {"window": 2048}),
    (2, 37, 37, 2, 1, 256, {"softcap": 30.0, "window": 16}),
    (1, 65, 200, 4, 2, 256, {"q_offset": 135}),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain_version(cuda, b, sq, skv, h, hkv, hd,
                                               opts, dtype):
    """Both backward passes against ``flash_attention_bwd_ref`` given the
    same out, lse and do (fp32 1e-4, bf16 2e-2 abs+rel), and each output's
    error as a share of its norm (fp32 1e-4, bf16 1e-2); one launch of
    each pass, on its tensor-core body for bfloat16."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, (b, sq, h, hd), dtype, cuda)
    k = _randn(gen, (b, skv, hkv, hd), dtype, cuda)
    v = _randn(gen, (b, skv, hkv, hd), dtype, cuda)
    do = _randn(gen, (b, sq, h, hd), dtype, cuda)
    full = dict(causal=True, window=0, scale=hd ** -0.5, softcap=0.0,
                q_offset=0) | opts
    out, lse = fa_ops.flash_attention_fwd(q, k, v, **full)
    passes = (fa_ops.flash_attention_bwd_dq, fa_ops.flash_attention_bwd_dkv)
    before = [(p.launches, p.tensor_core_launches) for p in passes]
    got = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, **full)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert [(p.launches - n, p.tensor_core_launches - t)
            for p, (n, t) in zip(passes, before)] == [(1, tc), (1, tc)]
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, **full)
    tol = BWD_TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{name}: {m}")
        share = (g.float() - w.float()).norm() / w.float().norm()
        assert share <= NORM_TOL[dtype], (name, float(share))


def test_train_step_on_card_matches_cpu(cuda):
    """Reduced aiida-demo-110m in float32 through the kernels (card) and
    the plain versions (CPU): a train step's loss and gradients from the
    same parameters and batch agree (loss 1e-4, each leaf 1e-3 of its
    norm)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.registry import build
    from repro_torch.training.train_step import value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("aiida-demo-110m").replace(
        dtype="float32", attn_impl="pallas")
    bundle = build(cfg)
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(1, cfg.vocab_size, (2, 65), generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    runs = []
    for dev in (cuda, torch.device("cpu")):
        params = bundle.init_params(0, dev)
        fwd = fa_ops.flash_attention_fwd.launches
        (loss, _), grads = value_and_grad(
            bundle, params, {k: t.to(dev) for k, t in batch.items()})
        if dev.type == "cuda":
            assert fa_ops.flash_attention_fwd.launches - fwd == \
                2 * cfg.num_layers   # forward + remat recompute
        runs.append((loss.cpu(), {k: g.cpu() for k, g in
                                  tree_leaves(grads)}))
    (l_card, g_card), (l_cpu, g_cpu) = runs
    torch.testing.assert_close(l_card, l_cpu, atol=0, rtol=1e-4)
    for key, g in g_card.items():
        err = float((g - g_cpu[key]).norm() / g_cpu[key].norm().clamp_min(
            1e-30))
        assert err < 1e-3, f"{key}: relative error {err}"


def test_served_tokens_match_the_cpu(cuda):
    """Reduced aiida-demo-110m in float32: greedy tokens on the card (both
    kernels) equal those on the CPU (plain versions)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.registry import build
    from repro_torch.serving.serve import BatchScheduler, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("aiida-demo-110m").replace(
        dtype="float32", kv_cache_dtype="float32", attn_impl="pallas",
        decode_impl="pallas")
    bundle = build(cfg)
    prompts = [[5, 9, 2, 77, 31], list(range(3, 40)), [11] * 17]
    runs = []
    for dev in (cuda, "cpu"):
        sched = BatchScheduler(bundle, bundle.init_params(0, dev),
                               batch_size=2, max_len=64, device=dev)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        sched.run()
        runs.append([r.generated for r in reqs])
    assert runs[0] == runs[1]


def _scan_inputs(gen, b, s, d, dtype, device):
    a = 0.5 + 0.5 * torch.rand(b, s, d, generator=gen, device=device)
    x = torch.randn(b, s, d, generator=gen, device=device)
    h0 = torch.randn(b, d, generator=gen, device=device)
    return a.to(dtype), x.to(dtype), h0


@pytest.mark.parametrize("b,s,d", [(1, 1, 1), (2, 37, 48), (3, 17, 33),
                                   (1, 300, 100), (2, 1000, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_matches_plain_version(cuda, b, s, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    a, x, h0 = _scan_inputs(gen, b, s, d, dtype, cuda)
    before = rg_ops.rglru_scan.launches
    hs, h_last = rg_ops.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert rg_ops.rglru_scan.launches == before + 1
    want_hs, want_last = rglru_scan_ref(a, x, h0)
    assert hs.dtype == h_last.dtype == torch.float32
    torch.testing.assert_close(hs, want_hs, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(h_last, want_last, atol=5e-5, rtol=5e-5)
    # the reverse flag the backward uses
    rhs, rlast = rg_ops._scan(a, x, h0, reverse=True)
    want_hs, want_last = rglru_scan_ref(a, x, h0, reverse=True)
    torch.testing.assert_close(rhs, want_hs, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(rlast, want_last, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("b,s,d", [(2, 37, 48), (1, 300, 100),
                                   (2, 1000, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_backward_matches_plain_autograd(cuda, b, s, d, dtype):
    """The autograd Function (forward kernel, reversed-scan kernel) against
    autograd through the plain loop, for random cotangents."""
    gen = torch.Generator(device=cuda).manual_seed(b * s)
    a, x, h0 = _scan_inputs(gen, b, s, d, dtype, cuda)
    ghs = torch.randn(b, s, d, generator=gen, device=cuda)
    ghl = torch.randn(b, d, generator=gen, device=cuda)
    grads = []
    for fn in (rg_ops.rglru_scan, rglru_scan_ref):
        ins = [t.clone().requires_grad_(True) for t in (a, x, h0)]
        hs, h_last = fn(*ins)
        grads.append(torch.autograd.grad(
            (hs * ghs).sum() + (h_last * ghl).sum(), ins))
    tol = BWD_TOL[dtype]
    for name, g, w in zip(("da", "dx", "dh0"), *grads):
        assert g.dtype == w.dtype, name
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{name}: {m}")


def _scan_twice_close(a, x, h0, reverse=False):
    """The kernel twice (forward through the public wrapper, reversed
    directly): the same bits both times, within 5e-5 of the plain
    version, h_last equal to the last step of hs."""
    fn = ((lambda: rg_ops._scan(a, x, h0, reverse=True)) if reverse
          else (lambda: rg_ops.rglru_scan(a, x, h0)))
    before = rg_ops.rglru_scan.launches
    hs, h_last = fn()
    hs2, h_last2 = fn()
    torch.cuda.synchronize()
    assert rg_ops.rglru_scan.launches == before + 2
    assert torch.equal(hs, hs2) and torch.equal(h_last, h_last2)
    assert torch.equal(h_last, hs[:, 0] if reverse else hs[:, -1])
    want_hs, want_last = rglru_scan_ref(a, x, h0, reverse=reverse)
    torch.testing.assert_close(hs, want_hs, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(h_last, want_last, atol=5e-5, rtol=5e-5)
    return hs, h_last


@pytest.mark.parametrize("edge", ["T-1", "T", "T+1"])
@pytest.mark.parametrize("b,d", [(2, 31), (1, 32), (3, 33), (2, 63),
                                 (1, 64), (2, 65), (1, 2560)])
@pytest.mark.parametrize("reverse", [False, True])
def test_rglru_kernel_at_the_tile_edges(cuda, b, d, edge, reverse):
    """S one step short of, at and past the tile length of the plan; D
    around the channels of a tile (32, or 64 for an even D); B = 1 with
    D = 2560, where the plan splits time hardest."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    t = rg_ops.tile_plan(b, 4096, d, sms).tile_t
    s = {"T-1": t - 1, "T": t, "T+1": t + 1}[edge]
    gen = torch.Generator(device=cuda).manual_seed(s * d)
    a, x, h0 = _scan_inputs(gen, b, s, d, torch.float32, cuda)
    _scan_twice_close(a, x, h0, reverse)


def test_rglru_kernel_time_split_across_blocks_at_b1(cuda):
    """B = 1 at the hybrid's width and prompt: 40 chains of 32 tiles."""
    gen = torch.Generator(device=cuda).manual_seed(41)
    a, x, h0 = _scan_inputs(gen, 1, 4096, 2560, torch.float32, cuda)
    for reverse in (False, True):
        _scan_twice_close(a, x, h0, reverse)


def test_rglru_kernel_on_two_streams(cuda):
    """Two calls in flight on two streams at once, each with its own kept
    workspace, give the bits of the same calls on one stream."""
    gen = torch.Generator(device=cuda).manual_seed(42)
    ins = [_scan_inputs(gen, 2, 2000, 2560, torch.float32, cuda)
           for _ in range(2)]
    want = [rg_ops.rglru_scan(*i) for i in ins]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    got = []
    for st, i in zip(streams, ins):
        st.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(st):
            got.append(rg_ops.rglru_scan(*i))
    torch.cuda.synchronize()
    for (hs, hl), (whs, whl) in zip(got, want):
        assert torch.equal(hs, whs) and torch.equal(hl, whl)


def test_rglru_kernel_reuses_its_workspace_for_a_smaller_call(cuda):
    """A large call, then a small one on the same kept workspace (status
    words of the large call's generation left behind), then the large one
    again: every result right and repeatable."""
    gen = torch.Generator(device=cuda).manual_seed(43)
    large = _scan_inputs(gen, 4, 4096, 2560, torch.float32, cuda)
    small = _scan_inputs(gen, 1, 77, 130, torch.bfloat16, cuda)
    first, _ = _scan_twice_close(*large)
    _scan_twice_close(*small)
    _scan_twice_close(*small, reverse=True)
    again, _ = _scan_twice_close(*large)
    assert torch.equal(first, again)


def test_rglru_kernel_takes_a_view_at_an_odd_offset(cuda):
    """a and x one element into their storage (not aligned to the
    kernel's 8-byte copies): the wrapper copies them, never raises."""
    gen = torch.Generator(device=cuda).manual_seed(44)
    base = torch.randn(2 * 300 * 96 + 1, generator=gen, device=cuda)
    a = (0.5 + 0.5 * torch.sigmoid(base))[1:].view(2, 300, 96)
    x = base[1:].view(2, 300, 96)
    h0 = torch.randn(2, 96, generator=gen, device=cuda)
    assert a.data_ptr() % 8 != 0
    for reverse in (False, True):
        _scan_twice_close(a, x, h0, reverse)


def test_hybrid_served_tokens_match_the_cpu(cuda):
    """Reduced recurrentgemma-2b in float32 with the scan kernel, a prompt
    past the window: greedy tokens on the card equal those on the CPU,
    and the card's prefill launched the kernel once per RG-LRU layer."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.registry import build
    from repro_torch.serving.serve import make_decode_step, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("recurrentgemma-2b").replace(
        dtype="float32", kv_cache_dtype="float32", use_pallas=True,
        attn_impl="chunked", attn_kv_block=16)
    bundle = build(cfg)
    prefill, decode = make_prefill_step(bundle), make_decode_step(bundle)
    prompt = torch.randint(1, cfg.vocab_size, (2, 45),
                           generator=torch.Generator().manual_seed(3))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        params = bundle.init_params(0, dev)
        before = rg_ops.rglru_scan.launches
        tok, state = prefill(params, {"tokens": prompt.to(dev)},
                             bundle.init_cache(2, 64, dev))
        if dev.type == "cuda":
            assert rg_ops.rglru_scan.launches - before == 2
        seq = [tok.cpu()]
        for i in range(5):
            tok, state = decode(params, state, tok.long(),
                                torch.tensor(45 + i, device=dev))
            seq.append(tok.cpu())
        runs.append(torch.cat(seq, dim=1).tolist())
    assert runs[0] == runs[1]


def _mlstm_inputs(gen, b, h, s, hd, dtype, device, state):
    """The reference's sweep inputs (``tests/test_kernels.py:258-265``);
    with ``state``, a nonzero finite (C0, n0, m0)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, k, v = (randn(b, h, s, hd).to(dtype) for _ in range(3))
    li = randn(b, h, s)
    lf = -(1 + 0.5 * randn(b, h, s)).abs()
    if state:
        C0, n0, m0 = 0.5 * randn(b, h, hd, hd), 0.5 * randn(b, h, hd), \
            randn(b, h)
    else:
        C0 = torch.zeros((b, h, hd, hd), device=device)
        n0 = torch.zeros((b, h, hd), device=device)
        m0 = torch.full((b, h), -1e30, device=device)
    return q, k, v, li, lf, C0, n0, m0


@pytest.mark.parametrize("b,h,s,hd,chunk", [
    (1, 2, 64, 32, 16),
    (2, 3, 37, 64, 128),      # L = 37, one chunk
    (1, 4, 96, 64, 64),       # L = 32
    (2, 2, 129, 32, 128),     # odd S past the chunk: L = 1
    (2, 1, 300, 96, 128),     # L = 4
    (1, 4, 256, 512, 128),    # the full head dim, L = 128
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state", [False, True])
def test_mlstm_kernel_matches_plain_version(cuda, b, h, s, hd, chunk, dtype,
                                            state):
    gen = torch.Generator(device=cuda).manual_seed(s + hd)
    ins = _mlstm_inputs(gen, b, h, s, hd, dtype, cuda, state)
    before = ml_ops.mlstm_chunk.launches
    hs, (C, n, m) = ml_ops.mlstm_chunk(*ins, chunk=chunk)
    torch.cuda.synchronize()
    assert ml_ops.mlstm_chunk.launches == before + 1
    assert hs.dtype == dtype and hs.shape == (b, h, s, hd)
    want_hs, want_state = mlstm_chunkwise_ref(*ins, chunk=chunk)
    tol = TOL[dtype]
    torch.testing.assert_close(hs.float(), want_hs.float(), atol=tol,
                               rtol=tol)
    for got, want in zip((C, n, m), want_state):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)
    if dtype == torch.float32:
        ohs, (oC, _, om) = mlstm_recurrent_ref(*ins)
        torch.testing.assert_close(hs, ohs, atol=1e-4, rtol=0)
        torch.testing.assert_close(C, oC, atol=1e-3, rtol=0)
        torch.testing.assert_close(m, om, atol=1e-5, rtol=0)


def test_mlstm_kernel_reads_transposed_views(cuda):
    """q, k, v as the model hands them over: (B, S, H, hd) transposed to
    (B, H, S, hd), read through their strides."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    ins = list(_mlstm_inputs(gen, 2, 4, 96, 64, torch.bfloat16, cuda, True))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in ins[:3]]
    assert not views[0].is_contiguous()
    hs, state = ml_ops.mlstm_chunk(*views, *ins[3:], chunk=32)
    want_hs, want_state = ml_ops.mlstm_chunk(*ins, chunk=32)
    torch.cuda.synchronize()
    assert torch.equal(hs, want_hs)
    for got, want in zip(state, want_state):
        assert torch.equal(got, want)


def test_mlstm_kernel_rejects_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(8)
    ins = list(_mlstm_inputs(gen, 1, 2, 256, 64, torch.float32, cuda,
                             False))
    with pytest.raises(ValueError, match="at most 128"):
        ml_ops.mlstm_chunk(*ins, chunk=256)
    odd = list(_mlstm_inputs(gen, 1, 2, 16, 48, torch.float32, cuda, False))
    with pytest.raises(ValueError, match="multiple of 32"):
        ml_ops.mlstm_chunk(*odd, chunk=16)
    strided = [torch.stack([t, t], dim=-1)[..., 0] for t in ins[:3]]
    assert strided[0].stride(-1) == 2
    with pytest.raises(ValueError, match="unit stride"):
        ml_ops.mlstm_chunk(*strided, *ins[3:], chunk=128)
    with pytest.raises(ValueError, match="one device"):
        ml_ops.mlstm_chunk(*ins[:7], ins[7].cpu(), chunk=128)


@pytest.mark.parametrize("dtype,s,chunk,hd,tensor_cores", [
    (torch.bfloat16, 256, 128, 512, True),
    (torch.bfloat16, 256, 128, 64, True),
    (torch.bfloat16, 384, 128, 192, True),
    (torch.bfloat16, 256, 64, 512, False),     # L = 64
    (torch.bfloat16, 96, 128, 64, False),      # L = 96
    (torch.bfloat16, 256, 128, 96, False),     # hd not a multiple of 64
    (torch.float32, 256, 128, 512, False),
])
def test_mlstm_route_table(cuda, dtype, s, chunk, hd, tensor_cores):
    """Which body a call runs, by ``tensor_core_launches``, and that either
    body matches the plain version there (hs also within 1e-2 / 1e-4 of
    its norm)."""
    gen = torch.Generator(device=cuda).manual_seed(hd)
    ins = _mlstm_inputs(gen, 1, 2, s, hd, dtype, cuda, True)
    assert ml_ops.takes_tensor_cores(dtype, chunk_len(s, chunk),
                                     hd) == tensor_cores
    before = (ml_ops.mlstm_chunk.launches,
              ml_ops.mlstm_chunk.tensor_core_launches)
    hs, state = ml_ops.mlstm_chunk(*ins, chunk=chunk)
    torch.cuda.synchronize()
    assert ml_ops.mlstm_chunk.launches == before[0] + 1
    assert ml_ops.mlstm_chunk.tensor_core_launches == \
        before[1] + int(tensor_cores)
    want_hs, want_state = mlstm_chunkwise_ref(*ins, chunk=chunk)
    torch.testing.assert_close(hs.float(), want_hs.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    share = (hs.float() - want_hs.float()).norm() / want_hs.float().norm()
    assert float(share) <= NORM_TOL[dtype]
    for got, want in zip(state, want_state):
        torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)


def test_mlstm_tensor_core_body_reads_transposed_and_unaligned_views(cuda):
    """The tensor-core body reads q, k, v through TMA: transposed (B, S, H,
    hd) views as the model hands them over, and views at an odd element
    offset, which the wrapper copies contiguous first; both give exactly
    the contiguous call's result."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    ins = list(_mlstm_inputs(gen, 2, 4, 256, 512, torch.bfloat16, cuda,
                             True))
    want_hs, want_state = ml_ops.mlstm_chunk(*ins, chunk=128)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in ins[:3]]
    odd = [torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:]
           .view_as(t).copy_(t) for t in ins[:3]]
    assert odd[0].data_ptr() % 16
    before = ml_ops.mlstm_chunk.tensor_core_launches
    for qkv in (views, odd):
        hs, state = ml_ops.mlstm_chunk(*qkv, *ins[3:], chunk=128)
        torch.cuda.synchronize()
        assert torch.equal(hs, want_hs)
        for got, want in zip(state, want_state):
            assert torch.equal(got, want)
    assert ml_ops.mlstm_chunk.tensor_core_launches == before + 2


def test_mlstm_tensor_core_body_rejects_what_it_does_not_take(cuda):
    """A bf16 call the tensor-core body would take raises on what no body
    reads (a non-unit stride on hd, inputs on two devices) instead of
    falling back to anything."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    ins = list(_mlstm_inputs(gen, 1, 2, 256, 128, torch.bfloat16, cuda,
                             False))
    strided = [torch.stack([t, t], dim=-1)[..., 0] for t in ins[:3]]
    before = (ml_ops.mlstm_chunk.launches,
              ml_ops.mlstm_chunk.tensor_core_launches)
    with pytest.raises(ValueError, match="unit stride"):
        ml_ops.mlstm_chunk(*strided, *ins[3:], chunk=128)
    with pytest.raises(ValueError, match="one device"):
        ml_ops.mlstm_chunk(*ins[:3], ins[3].cpu(), *ins[4:], chunk=128)
    with pytest.raises(RuntimeError, match="forward only"):
        ml_ops.mlstm_chunk(ins[0].requires_grad_(), *ins[1:], chunk=128)
    assert (ml_ops.mlstm_chunk.launches,
            ml_ops.mlstm_chunk.tensor_core_launches) == before


def test_xlstm_served_tokens_match_the_cpu(cuda):
    """Reduced xlstm-350m in float32 with the mLSTM kernel: greedy tokens
    on the card equal those on the CPU, and the card's prefill launched
    the kernel once per mLSTM layer and its decode steps never."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.registry import build
    from repro_torch.serving.serve import make_decode_step, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("xlstm-350m").replace(dtype="float32",
                                               use_pallas=True)
    bundle = build(cfg)
    prefill, decode = make_prefill_step(bundle), make_decode_step(bundle)
    prompt = torch.randint(1, cfg.vocab_size, (2, 96),
                           generator=torch.Generator().manual_seed(3))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        params = bundle.init_params(0, dev)
        before = ml_ops.mlstm_chunk.launches
        tok, state = prefill(params, {"tokens": prompt.to(dev)},
                             bundle.init_cache(2, 128, dev))
        mid = ml_ops.mlstm_chunk.launches
        seq = [tok.cpu()]
        for i in range(5):
            tok, state = decode(params, state, tok.long(),
                                torch.tensor(96 + i, device=dev))
            seq.append(tok.cpu())
        if dev.type == "cuda":
            assert (mid - before, ml_ops.mlstm_chunk.launches - mid) == (7, 0)
        runs.append(torch.cat(seq, dim=1).tolist())
    assert runs[0] == runs[1]


def test_generate_on_the_card_then_a_hit(cuda, tmp_path):
    """The generate calcfunction on the card (its default device): a cold
    call decodes through the decode kernel, once per layer and decode
    step; the same call again is a cache hit with the same tokens and no
    decode step or launch."""
    from repro_torch.caching import enable_caching
    from repro_torch.core.datatypes import ArrayData, Int, Str
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.observability.metrics import get_registry
    from repro_torch.provenance.store import configure_store
    from repro_torch.serving import inference

    store = configure_store(str(tmp_path / "profile.db"))
    set_default_runner(Runner(store=store))
    inference.reset_engines()
    steps = get_registry().counter("serving.decode_steps")
    prompt = torch.tensor([3, 5, 7, 11, 13], dtype=torch.int32)
    args = (Str("aiida-demo-110m"), ArrayData(prompt), Int(8), Int(0),
            Int(-1))
    try:
        with enable_caching():
            s0, l0 = steps.value, da_ops.decode_attention.launches
            cold = inference.generate(*args)
            s1, l1 = steps.value, da_ops.decode_attention.launches
            hot = inference.generate(*args)
            s2, l2 = steps.value, da_ops.decode_attention.launches
    finally:
        set_default_runner(None)
        configure_store(":memory:")
        inference.reset_engines()
    layers = inference._serving_config("aiida-demo-110m", "pallas").num_layers
    assert s1 - s0 > 0 and l1 - l0 == (s1 - s0) * layers
    assert (s2, l2) == (s1, l1)
    assert cold["tokens"].value.tolist() == hot["tokens"].value.tolist()
    assert len(cold["tokens"].value) == 8


def test_gpu_train_job_on_the_card_launches_the_flash_kernels(cuda):
    """GPUTrainJob at the reduced config on the card (its default device,
    no "device" key) with the flash kernels: it finishes ok with finite
    losses, and every step launched the forward and both backward
    passes."""
    import math

    from repro_torch.calcjobs import GPUTrainJob
    from repro_torch.core import Dict
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.provenance.store import configure_store

    counters = (fa_ops.flash_attention_fwd, fa_ops.flash_attention_bwd_dq,
                fa_ops.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    runner = Runner(store=configure_store(":memory:"))
    set_default_runner(runner)
    try:
        outputs, proc = runner.run(GPUTrainJob, {"config": Dict({
            "arch": "aiida-demo-110m", "steps": 2, "batch": 2, "seq": 64,
            "overrides": {"attn_impl": "pallas"}})})
    finally:
        set_default_runner(None)
        configure_store(":memory:")
    assert proc.is_finished_ok, proc.exit_code
    metrics = outputs["metrics"].value
    assert metrics["steps"] == 2
    assert all(math.isfinite(x) for x in metrics["losses"])
    assert all(c.launches > n for c, n in zip(counters, before))


def _whisper_on(cfg_over: dict, seed: int):
    """The reduced whisper in float32 with ``cfg_over``, its parameters
    from ``seed`` on the host with the attention projections fan-in
    scaled, and a batch of 2 rows of 16 frames.

    The reference's init takes a projection's fan-in from its shape[-2]
    (the head count), which makes the softmax nearly an argmax and
    amplifies float32 rounding: at that init the card's gradients and
    the CPU's differ by more than 1e-3 of a leaf's norm, as the port's
    CPU gradients differ from the reference's by up to 6e-4. Scaled,
    those agree to 1e-6 (``tests/test_torch_encdec.py``)."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models.registry import build

    cfg = reduced_config("whisper-large-v3").replace(
        dtype="float32", kv_cache_dtype="float32", **cfg_over)
    bundle = build(cfg)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (2, 13)).astype(np.int64)
    batch = {"frames": torch.from_numpy(rng.normal(0, 1, (
                 2, cfg.num_frames, cfg.d_model)).astype(np.float32)),
             "tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:])}
    params = bundle.init_params(seed, "cpu")
    for stack, names in (("enc_layers", ("attn",)),
                         ("dec_layers", ("self_attn", "cross_attn"))):
        for name in names:
            a = params[stack][name]
            for w in ("wq", "wk", "wv"):
                a[w] = a[w] * (a[w].shape[-2] / cfg.d_model) ** 0.5
            a["wo"] = a["wo"] * (a["wo"].shape[-2]
                                 / (cfg.num_heads * cfg.hd)) ** 0.5
    return cfg, bundle, params, batch


def test_whisper_card_greedy_tokens_equal_the_cpus(cuda):
    """The reduced whisper's float32 greedy tokens (a 4-token prompt, 7
    new tokens) with the flash and decode kernels on the card equal the
    plain versions' on the CPU, from the same parameters; the decode
    kernel launches once per decoder layer and step."""
    from repro_torch.models.common import map_tree
    from repro_torch.serving.serve import make_decode_step, make_prefill_step

    cfg, bundle, params, batch = _whisper_on(
        {"attn_impl": "pallas", "decode_impl": "pallas"}, 8)
    batch = {"frames": batch["frames"], "tokens": batch["tokens"][:, :4]}
    prefill, decode = make_prefill_step(bundle), make_decode_step(bundle)
    runs = {}
    before = da_ops.decode_attention.launches
    for dev in ("cpu", cuda):
        p = map_tree(lambda t: t.to(dev), params)
        tok, cache = prefill(p, {k: v.to(dev) for k, v in batch.items()},
                             bundle.init_cache(2, 16, dev))
        seq = [tok.cpu()]
        for i in range(6):
            tok, cache = decode(p, cache, tok.long(),
                                torch.tensor(4 + i, device=dev))
            seq.append(tok.cpu())
        runs[str(dev)] = torch.cat(seq, dim=1)
    assert da_ops.decode_attention.launches - before == 6 * cfg.num_layers
    assert torch.equal(runs["cpu"], runs[str(cuda)])


def test_whisper_card_loss_and_grads_equal_the_cpus(cuda):
    """The reduced whisper's float32 loss (1e-4 relative) and every
    gradient leaf (1e-3 of its norm) on the card, where the decoder's
    self-attention runs the flash forward and both backward passes,
    against the CPU's plain versions."""
    import numpy as np

    from repro_torch.models.common import map_tree, tree_leaves

    cfg, bundle, params, batch = _whisper_on({"attn_impl": "pallas"}, 9)
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = (fa_ops.flash_attention_fwd, fa_ops.flash_attention_bwd_dq,
                fa_ops.flash_attention_bwd_dkv)
    out = {}
    for dev in ("cpu", cuda):
        before = [c.launches for c in counters]
        live = map_tree(lambda t: t.detach().to(dev).requires_grad_(True),
                        params)
        loss, _ = bundle.loss_fn(live, {k: v.to(dev)
                                        for k, v in batch.items()})
        loss.backward()
        out[str(dev)] = (loss.item(), {k: t.grad.cpu().double().numpy()
                                       for k, t in tree_leaves(live)},
                         [c.launches - n for c, n in zip(counters, before)])
    (l_cpu, g_cpu, n_cpu), (l_card, g_card, n_card) = out["cpu"], \
        out[str(cuda)]
    assert n_cpu == [0, 0, 0] and all(n >= cfg.num_layers for n in n_card)
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4)
    errs = {}
    for key, want in g_cpu.items():
        if key.endswith("/bk"):       # no gradient: rounding on both sides
            assert np.abs(g_card[key]).max() < 1e-5, key
            continue
        errs[key] = np.linalg.norm(g_card[key] - want) / np.linalg.norm(want)
    assert max(errs.values()) < 1e-3, errs
