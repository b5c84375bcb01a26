"""The port's CUDA kernels on the card (marked ``cuda``; they skip where
``torch.cuda.is_available()`` is false, as on a CPU-only machine).

Run on a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Imports neither JAX nor ``repro``: the machine with the card has no JAX.
Each kernel is held against its plain version on the same CUDA inputs at
the reference's tolerances (bf16 2e-2, f32 5e-5).
"""

import pytest
import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


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


def test_flash_kernel_refuses_a_gradient(cuda):
    q = torch.zeros(1, 8, 4, 32, device=cuda, requires_grad=True)
    k = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(NotImplementedError, match="training slice"):
        fa_ops.flash_attention(q, k, k)


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
