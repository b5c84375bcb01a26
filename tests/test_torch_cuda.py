"""The port's CUDA kernels on the card (marked ``cuda``; they skip where
``torch.cuda.is_available()`` is false, as on a CPU-only machine).

Run on a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Imports neither JAX nor ``repro``: the machine with the card has no JAX.
Each kernel is held against its plain version on the same CUDA inputs at
the reference's tolerances (bf16 2e-2, f32 5e-5; the backward passes at
f32 1e-4, given the same out, lse and do). The RG-LRU scan returns fp32
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
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunkwise_ref,
                                                 mlstm_recurrent_ref)
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.models.common import tree_leaves

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_NORM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("h,hkv,hd", [(12, 4, 64), (4, 2, 32), (8, 1, 128),
                                      (16, 2, 64)])
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


@pytest.mark.parametrize("sq,skv,opts", [
    (1, 1, {}), (37, 37, {}), (700, 700, {}),
    (200, 200, {"window": 64}), (130, 130, {"softcap": 30.0}),
    (37, 42, {"q_offset": 5}),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, sq, skv, opts, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    h, hkv, hd = 12, 4, 64
    q = _randn(gen, (2, sq, h, hd), dtype, cuda)
    k = _randn(gen, (2, skv, hkv, hd), dtype, cuda)
    v = _randn(gen, (2, skv, hkv, hd), dtype, cuda)
    full = dict(causal=True, window=0, scale=hd ** -0.5, softcap=0.0,
                q_offset=0) | opts
    before = fa_ops.flash_attention_fwd.launches
    out, lse = fa_ops.flash_attention_fwd(q, k, v, **full)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_fwd.launches == before + 1
    rout, rlse = flash_attention_ref(q, k, v, **full)
    torch.testing.assert_close(out.float(), rout.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, rlse, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("b,sq,skv,h,hkv,hd,opts", [
    (2, 96, 96, 4, 4, 32, {}),                         # MHA
    (1, 250, 250, 8, 2, 64, {}),                       # GQA 4x, ragged
    (2, 250, 250, 12, 4, 64, {"window": 64}),          # G = 3
    (1, 130, 130, 12, 4, 128, {"softcap": 30.0}),
    (2, 37, 42, 12, 4, 64, {"q_offset": 5}),
    (1, 40, 70, 4, 2, 64, {"q_offset": 30, "window": 16}),
    (1, 1024, 1024, 12, 4, 64, {}),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain_version(cuda, b, sq, skv, h, hkv, hd,
                                               opts, dtype):
    """Both backward passes against ``flash_attention_bwd_ref`` given the
    same out, lse and do (fp32 1e-4, bf16 2e-2 abs+rel), and each output's
    error as a share of its norm (fp32 1e-4, bf16 1e-2)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, (b, sq, h, hd), dtype, cuda)
    k = _randn(gen, (b, skv, hkv, hd), dtype, cuda)
    v = _randn(gen, (b, skv, hkv, hd), dtype, cuda)
    do = _randn(gen, (b, sq, h, hd), dtype, cuda)
    full = dict(causal=True, window=0, scale=hd ** -0.5, softcap=0.0,
                q_offset=0) | opts
    out, lse = fa_ops.flash_attention_fwd(q, k, v, **full)
    before = (fa_ops.flash_attention_bwd_dq.launches,
              fa_ops.flash_attention_bwd_dkv.launches)
    got = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, **full)
    torch.cuda.synchronize()
    assert (fa_ops.flash_attention_bwd_dq.launches,
            fa_ops.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                         before[1] + 1)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, **full)
    tol = BWD_TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{name}: {m}")
        share = (g.float() - w.float()).norm() / w.float().norm()
        assert share <= BWD_NORM_TOL[dtype], (name, float(share))


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
