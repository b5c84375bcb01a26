"""The port's kernels against the reference's, on the CPU.

Inputs are made with numpy from a fixed seed and go through both
packages: the reference's Pallas kernels run in interpret mode (as its own
tests run them), and the port's wrappers, given CPU tensors, run their
plain PyTorch versions. Tolerances are the reference's own
(``tests/test_kernels.py``): 5e-5 in float32, 2e-2 in bfloat16.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as j_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as j_dref
from repro.kernels.flash_attention import kernel as j_flash_kernel
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_fref
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TOL = {"float32": 5e-5, "bfloat16": 2e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (both round float32 to bfloat16 to nearest even)."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, J_DT[dtype]), torch.from_numpy(a).to(T_DT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _decode_inputs(rng, b, h, hkv, hd, smax, dtype):
    jq, tq = _pair(rng.normal(0, 1, (b, h, hd)), dtype)
    jk, tk = _pair(rng.normal(0, 1, (b, smax, hkv, hd)), dtype)
    jv, tv = _pair(rng.normal(0, 1, (b, smax, hkv, hd)), dtype)
    return (jq, jk, jv), (tq, tk, tv)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,hkv,hd,smax", [
    (2, 4, 4, 32, 128),
    (3, 8, 2, 64, 256),
    (1, 4, 1, 128, 512),
    (2, 12, 4, 64, 256),     # G = 3, the full-width aiida-demo-110m grouping
    # recurrentgemma-2b's hd 256 and 10 query heads on one KV head; G = 2
    pytest.param(3, 10, 1, 256, 128, id="hd256-g10"),
    pytest.param(2, 4, 2, 256, 128, id="hd256-g2"),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_shapes(b, h, hkv, hd, smax, dtype):
    rng = np.random.default_rng(0)
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(rng, b, h, hkv, hd, smax,
                                                dtype)
    lens = rng.integers(1, smax + 1, (b,)).astype(np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == tq.dtype and got.shape == (b, h, hd)
    _close(got, j_decode(jq, jk, jv, jnp.asarray(lens), block_kv=64), dtype)
    _close(got, j_dref(jq, jk, jv, jnp.asarray(lens)), dtype)


@pytest.mark.parametrize("h,hkv", [(8, 4), (8, 1), (4, 2), (6, 3), (12, 4)])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_gqa_headdim_sweep(h, hkv, hd, dtype):
    """GQA group ratios incl. MQA and groups of 3 (not a power of two)."""
    rng = np.random.default_rng(1)
    b, smax = 2, 128
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(rng, b, h, hkv, hd, smax,
                                                dtype)
    lens = np.asarray([31, smax], np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens))
    _close(got, j_decode(jq, jk, jv, jnp.asarray(lens), block_kv=64), dtype)
    _close(got, j_dref(jq, jk, jv, jnp.asarray(lens)), dtype)


def test_decode_attention_kvlen_edge_cases():
    """A single live entry, a length that is no multiple of any tile,
    Smax - 1 and exactly Smax, in one batch."""
    rng = np.random.default_rng(2)
    b, h, hd, smax = 4, 4, 32, 256
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(rng, b, h, h, hd, smax,
                                                "float32")
    lens = np.asarray([1, 130, smax - 1, smax], np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens))
    _close(got, j_decode(jq, jk, jv, jnp.asarray(lens), block_kv=128),
           "float32")
    _close(got, j_dref(jq, jk, jv, jnp.asarray(lens)), "float32")
    # kv_len = 1 reproduces v[:, 0] (softmax over one entry)
    _close(got[0], tv[0, 0], "float32")


def test_decode_attention_kvlen_zero_is_zero_output():
    """kv_len = 0 gives a finite all-zero row, like the reference kernel
    (the reference's jnp oracle returns garbage there)."""
    rng = np.random.default_rng(3)
    b, h, hd, smax = 2, 4, 32, 128
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(rng, b, h, h, hd, smax,
                                                "float32")
    lens = np.asarray([0, 64], np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got[0], np.zeros((h, hd), np.float32))
    _close(got, j_decode(jq, jk, jv, jnp.asarray(lens), block_kv=64),
           "float32")
    _close(got[1], j_dref(jq, jk, jv, jnp.asarray(lens))[1], "float32")


@pytest.mark.parametrize("kv_len", [1, 7, 64, 131, 200])
def test_decode_attention_ignores_cache_past_kv_len(kv_len):
    """Cache entries at or past kv_len never influence the output."""
    rng = np.random.default_rng(4)
    b, h, hd, smax = 1, 2, 32, 256
    q = torch.from_numpy(rng.normal(0, 1, (b, h, hd)).astype(np.float32))
    k = rng.normal(0, 1, (b, smax, h, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, smax, h, hd)).astype(np.float32)
    k2, v2 = k.copy(), v.copy()
    k2[:, kv_len:] = 999.0
    v2[:, kv_len:] = -999.0
    out1 = decode_attention(q, torch.from_numpy(k), torch.from_numpy(v),
                            kv_len)
    out2 = decode_attention(q, torch.from_numpy(k2), torch.from_numpy(v2),
                            kv_len)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


@pytest.mark.parametrize("block_kv", [128, 256, 512])
def test_decode_attention_matches_every_reference_block_kv(block_kv):
    """The reference's KV tile is a pure scheduling knob: the port agrees
    with its kernel at every block_kv."""
    rng = np.random.default_rng(5)
    b, h, hkv, hd, smax = 2, 4, 2, 64, 512
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(rng, b, h, hkv, hd, smax,
                                                "float32")
    lens = np.asarray([200, 511], np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens))
    _close(got, j_decode(jq, jk, jv, jnp.asarray(lens), block_kv=block_kv),
           "float32")


def test_decode_attention_scalar_kv_len_and_scale():
    rng = np.random.default_rng(6)
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(rng, 3, 6, 2, 32, 64,
                                                "float32")
    got = decode_attention(tq, tk, tv, 40, scale=0.3)
    _close(got, j_decode(jq, jk, jv, jnp.int32(40), scale=0.3, block_kv=32),
           "float32")
    _close(got, decode_attention(tq, tk, tv, torch.full((3,), 40),
                                 scale=0.3), "float32")


def test_decode_attention_rejects_bad_inputs():
    q = torch.zeros(2, 4, 32)
    k = torch.zeros(2, 16, 2, 32)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        decode_attention(q.half(), k.half(), k.half(), 4)
    with pytest.raises(ValueError, match="does not match"):
        decode_attention(q, torch.zeros(2, 16, 3, 32),
                         torch.zeros(2, 16, 3, 32), 4)
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention(q, k, k, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="cuda"):
        decode_attention(q.to("meta"), k.to("meta"), k.to("meta"),
                         torch.zeros(2, dtype=torch.int32, device="meta"))


def _split_kv_decode(q, k, v, lens, *, scale, per):
    """The card's split-KV decode kernel in plain torch: each (batch row, KV
    head)'s live positions in splits of ``per``, each split walked in tiles
    of 64 with an fp32 online softmax whose probabilities are rounded to
    the cache dtype before P.V; a split past kv_len does nothing; one live
    split writes out directly, several are merged by their fp32 (m, l, acc)
    partials; kv_len = 0 gives zeros."""
    b, h, hd = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    out = torch.zeros((b, h, hd), dtype=q.dtype)
    for bi in range(b):
        n = min(max(int(lens[bi]), 0), smax)
        for kv in range(hkv):
            heads = slice(kv * g, (kv + 1) * g)
            qg = q[bi, heads].float() * scale
            parts = []
            for start in range(0, n, per):
                end = min(start + per, n)
                m = torch.full((g,), -math.inf)
                l, acc = torch.zeros(g), torch.zeros(g, hd)
                for p0 in range(start, end, 64):
                    rows = slice(p0, min(p0 + 64, end))
                    s = qg @ k[bi, rows, kv].float().T
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_new)
                    e = torch.exp(s - m_new[:, None])
                    l = l * alpha + e.sum(-1)
                    acc = acc * alpha[:, None] + e.to(v.dtype).float() @ \
                        v[bi, rows, kv].float()
                    m = m_new
                parts.append((m, l, acc))
            if not parts:
                continue
            mx = torch.stack([pm for pm, _, _ in parts]).amax(0)
            tot = sum(pl * torch.exp(pm - mx) for pm, pl, _ in parts)
            o = sum(pa * torch.exp(pm - mx)[:, None] for pm, _, pa in parts)
            out[bi, heads] = (o / tot.clamp_min(1e-30)[:, None]).to(q.dtype)
    return out


@pytest.mark.parametrize("per", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_kv_decode_matches_the_reference_kernel(per, dtype):
    """The split-KV partials and their merge, emulated in plain torch,
    against the reference's decode kernel in interpret mode: ragged lengths
    0, 1, 63, 64, 65 and Smax (tile and split edges; splits past kv_len
    hold no live position), G = 3 as in aiida-demo-110m."""
    rng = np.random.default_rng(23)
    b, h, hkv, hd, smax = 6, 12, 4, 64, 256
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(rng, b, h, hkv, hd, smax,
                                                dtype)
    lens = np.asarray([0, 1, 63, 64, 65, smax], np.int32)
    got = _split_kv_decode(tq, tk, tv, lens, scale=hd ** -0.5, per=per)
    assert got.dtype == tq.dtype
    _close(got, j_decode(jq, jk, jv, jnp.asarray(lens), block_kv=64), dtype)
    _close(got, decode_attention(tq, tk, tv, torch.from_numpy(lens)), dtype)
    assert bool((got[0] == 0).all())


def test_split_plan_spreads_the_cache_over_the_card():
    """The serving shape (B = 4, Hkv = 4, G = 3, Smax = 1024) splits into
    tiles of 64 positions: 256 blocks for 132 SMs. More rows (B * Hkv = 64)
    take longer splits so the blocks stay within four per SM; every split
    is a multiple of the tile, there are at most 64 per row, and together
    they cover the cache."""
    plan = da_ops.split_plan
    assert plan(4, 4, 3, 1024, 132) == (4, 16, 64)
    gc, splits, per = plan(16, 4, 3, 1024, 132)
    assert 16 * 4 * splits <= da_ops.BLOCKS_PER_SM * 132 and per == 128
    assert plan(2, 1, 8, 128, 132)[0] == 8
    for b, hkv, g, smax in ((1, 1, 1, 1), (1, 4, 3, 32768), (64, 8, 4, 4096),
                            (3, 2, 5, 700), (2, 2, 2, 0)):
        gc, splits, per = plan(b, hkv, g, smax, 132)
        assert per % da_ops.TILE == 0 and splits * per >= smax
        assert 1 <= splits <= da_ops.MAX_SPLITS and gc in (4, 8)


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

def _flash_inputs(rng, b, sq, skv, h, hkv, hd, dtype, std=1.0):
    jq, tq = _pair(rng.normal(0, std, (b, sq, h, hd)), dtype)
    jk, tk = _pair(rng.normal(0, std, (b, skv, hkv, hd)), dtype)
    jv, tv = _pair(rng.normal(0, 1, (b, skv, hkv, hd)), dtype)
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("b,s,h,hkv,hd", [
    (1, 64, 4, 4, 32),     # MHA
    (2, 128, 8, 2, 64),    # GQA 4x
    (1, 96, 6, 1, 32),     # MQA, non-pow2 seq
    (1, 97, 12, 4, 64),    # G = 3, prime length
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_shapes_dtypes(b, s, h, hkv, hd, dtype):
    rng = np.random.default_rng(10)
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(rng, b, s, s, h, hkv, hd,
                                               dtype)
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == (b, s, h, hd)
    _close(got, j_flash(jq, jk, jv, causal=True, block_q=32, block_kv=32),
           dtype)
    _close(got, j_fref(jq, jk, jv, causal=True), dtype)


@pytest.mark.parametrize("window", [16, 64])
def test_flash_attention_local_window(window):
    rng = np.random.default_rng(11)
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(rng, 1, 128, 128, 2, 2, 32,
                                               "float32")
    got = flash_attention(tq, tk, tv, causal=True, window=window)
    _close(got, j_flash(jq, jk, jv, causal=True, window=window, block_q=32,
                        block_kv=32), "float32")
    _close(got, j_fref(jq, jk, jv, causal=True, window=window), "float32")


def test_flash_attention_softcap():
    rng = np.random.default_rng(12)
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(rng, 1, 64, 64, 2, 2, 32,
                                               "float32", std=2.0)
    got = flash_attention(tq, tk, tv, causal=True, softcap=10.0)
    _close(got, j_flash(jq, jk, jv, causal=True, softcap=10.0, block_q=32,
                        block_kv=32), "float32")
    _close(got, j_fref(jq, jk, jv, causal=True, softcap=10.0), "float32")


@pytest.mark.parametrize("s", [1, 2, 37, 61])
def test_flash_attention_prime_lengths(s):
    """Lengths no tile divides (the reference shrinks its tiles to 1 row
    for a prime length; the port keeps fixed tiles and masks the edge)."""
    rng = np.random.default_rng(13)
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(rng, 1, s, s, 12, 4, 64,
                                               "float32")
    got = flash_attention(tq, tk, tv, causal=True)
    _close(got, j_flash(jq, jk, jv, causal=True, block_q=32, block_kv=32),
           "float32")


@pytest.mark.parametrize("sq,skv,q_offset,window", [
    (16, 48, 32, 0),      # a continuation chunk at the end of its keys
    (16, 48, 5, 0),
    (24, 40, 16, 8),
])
def test_flash_attention_q_offset(sq, skv, q_offset, window):
    rng = np.random.default_rng(14)
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(rng, 1, sq, skv, 4, 2, 32,
                                               "float32")
    out, lse = flash_attention_fwd(tq, tk, tv, causal=True, window=window,
                                   q_offset=q_offset)
    _close(out, j_fref(jq, jk, jv, causal=True, window=window,
                       q_offset=q_offset), "float32")
    j_out, j_lse = j_flash_kernel.flash_attention_fwd(
        jq, jk, jv, causal=True, window=window, scale=32 ** -0.5,
        softcap=0.0, q_offset=q_offset, block_q=8, block_kv=8,
        interpret=True)
    _close(out, j_out, "float32")
    _close(lse, j_lse, "float32")


@pytest.mark.parametrize("opts", [
    dict(),
    dict(window=16),
    dict(softcap=5.0),
    dict(scale=0.1),
    # hd 256, recurrentgemma-2b's, on 2 query heads and one KV head; the
    # reference's tiles of 64 take a 37-row length whole
    pytest.param(dict(hd=256, s=37, window=16), id="hd256-s37-window16"),
    pytest.param(dict(hd=256, s=64, window=32), id="hd256-s64-window32"),
    pytest.param(dict(hd=256, s=37, softcap=5.0), id="hd256-s37-softcap5"),
    pytest.param(dict(hd=256, s=64, window=16, softcap=5.0),
                 id="hd256-s64-window16-softcap5"),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_lse_matches_reference_kernel(opts, dtype):
    rng = np.random.default_rng(15)
    opts = dict(opts)
    hd, s = opts.pop("hd", 32), opts.pop("s", 64)
    h, hkv, block = (2, 1, 64) if hd == 256 else (6, 2, 32)
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(rng, 2, s, s, h, hkv, hd,
                                               dtype)
    full = dict(window=0, scale=hd ** -0.5, softcap=0.0) | opts
    out, lse = flash_attention_fwd(tq, tk, tv, causal=True, **full)
    assert lse.dtype == torch.float32 and lse.shape == (2, h, s)
    j_out, j_lse = j_flash_kernel.flash_attention_fwd(
        jq, jk, jv, causal=True, q_offset=0, block_q=block, block_kv=block,
        interpret=True, **full)
    _close(out, j_out, dtype)
    _close(lse, j_lse, dtype)


def test_flash_attention_plain_version_is_differentiable_on_cpu():
    """Gradients through the port's plain version match the reference
    kernel's custom VJP (tolerance of the reference's own gradient test)."""
    rng = np.random.default_rng(16)
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(rng, 1, 64, 64, 4, 2, 32,
                                               "float32")

    def lk(q, k, v):
        return jnp.sum(j_flash(q, k, v, causal=True, block_q=32,
                               block_kv=32) ** 2)

    want = jax.grad(lk, argnums=(0, 1, 2))(jq, jk, jv)
    ts = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    (flash_attention(*ts, causal=True) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-3)


def test_flash_attention_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="does not match"):
        flash_attention(q, torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32))
    with pytest.raises(ValueError, match="cuda"):
        flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_without_keys_gives_zeros_and_no_lse(hd, dtype,
                                                             causal):
    """Skv = 0: every row has no live key, so out is 0 (in q's dtype) and
    lse is -inf (the kernel's rule for a dead row), causal or not."""
    q = torch.ones(2, 5, 4, hd, dtype=dtype)
    k = torch.zeros(2, 0, 2, hd, dtype=dtype)
    out, lse = flash_attention_fwd(q, k, k, causal=causal, q_offset=-5)
    assert out.dtype == dtype and out.shape == q.shape
    assert bool((out == 0).all())
    assert lse.shape == (2, 4, 5) and bool((lse == -math.inf).all())


def test_flash_attention_fwd_saves_nothing_without_grad():
    """Without a gradient to take, the forward skips the autograd Function
    and gives the same numbers."""
    rng = np.random.default_rng(17)
    _, ts = _flash_inputs(rng, 1, 40, 40, 4, 2, 32, "float32")
    with torch.no_grad():
        out, lse = flash_attention_fwd(*ts, causal=True)
    assert out.grad_fn is None
    leaves = [t.clone().requires_grad_(True) for t in ts]
    g_out, g_lse = flash_attention_fwd(*leaves, causal=True)
    assert g_out.grad_fn is not None and not g_lse.requires_grad
    torch.testing.assert_close(out, g_out.detach(), atol=0, rtol=0)
    torch.testing.assert_close(lse, g_lse, atol=0, rtol=0)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 96, 127, 128, 129, 250, 511,
                               700])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_serving_prompt_lengths_launch_nothing_on_cpu(s,
                                                                      dtype):
    """One prompt of the dense model's serving path (B = 1, 12 query and 4
    KV heads, hd = 64, causal) at the serving lengths and the kernel's
    tile edges: the plain version matches the reference and counts no
    kernel launch, tensor-core or other."""
    rng = np.random.default_rng(20)
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(rng, 1, s, s, 12, 4, 64,
                                               dtype)
    fwd = fa_ops.flash_attention_fwd
    before = (fwd.launches, fwd.tensor_core_launches)
    out, lse = fwd(tq, tk, tv, causal=True)
    assert (fwd.launches, fwd.tensor_core_launches) == before
    assert out.dtype == tq.dtype and lse.shape == (1, 12, s)
    _close(out, j_fref(jq, jk, jv, causal=True), dtype)


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------

BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

BWD_CASES = [
    # the shapes of the reference's forward sweep (tests/test_kernels.py)
    dict(b=1, s=64, h=4, hkv=4, hd=32),                  # MHA
    dict(b=2, s=128, h=8, hkv=2, hd=64),                 # GQA 4x
    dict(b=1, s=96, h=6, hkv=1, hd=32),                  # MQA, non-pow2
    dict(b=1, s=96, h=12, hkv=4, hd=64, window=32),      # G = 3, window
    dict(b=1, s=64, h=4, hkv=2, hd=32, softcap=5.0),
    dict(b=1, s=32, skv=64, h=4, hkv=2, hd=32, q_offset=32),
    # what the card's tensor-core bodies treat specially: no causal mask,
    # hd = 128 (its own tile sizes), lengths across the 64-row tiles, and
    # G = 1 with a query offset and a window. The reference shrinks its
    # tiles until they divide the length (to 1 row at 65 and 129), so the
    # 129-row case gives it one tile instead (``block``)
    dict(b=1, s=64, h=4, hkv=2, hd=32, causal=False),
    dict(b=1, s=65, h=2, hkv=1, hd=128),
    dict(b=1, s=129, h=4, hkv=2, hd=32, block=256),
    dict(b=1, s=40, skv=72, h=2, hkv=2, hd=32, q_offset=32, window=24),
    # hd 256, recurrentgemma-2b's, on one KV head, windowed and softcapped;
    # one reference tile over the 37-row length
    dict(b=2, s=37, h=2, hkv=1, hd=256, window=16, block=64),
    dict(b=2, s=64, h=2, hkv=1, hd=256, window=32),
    dict(b=2, s=37, h=2, hkv=1, hd=256, softcap=5.0, block=64),
    dict(b=2, s=64, h=2, hkv=1, hd=256, window=16, softcap=5.0),
]


def _bwd_inputs(rng, c, dtype):
    skv = c.get("skv", c["s"])
    std = 2.0 if c.get("softcap") else 1.0
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(
        rng, c["b"], c["s"], skv, c["h"], c["hkv"], c["hd"], dtype, std=std)
    jdo, tdo = _pair(rng.normal(0, 1, (c["b"], c["s"], c["h"], c["hd"])),
                     dtype)
    opts = dict(causal=c.get("causal", True), window=c.get("window", 0),
                scale=c["hd"] ** -0.5, softcap=c.get("softcap", 0.0),
                q_offset=c.get("q_offset", 0))
    return (jq, jk, jv, jdo), (tq, tk, tv, tdo), opts


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_matches_reference_kernel(case, dtype):
    """The port's backward (plain version on CPU tensors) against the
    reference's two backward kernels in interpret mode, on the same out,
    lse and do."""
    rng = np.random.default_rng(17)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), opts = _bwd_inputs(rng, case,
                                                             dtype)
    out, lse = flash_attention_fwd(tq, tk, tv, **opts)
    got = flash_attention_bwd(tq, tk, tv, out, lse, tdo, **opts)
    j_out = jnp.asarray(out.float().numpy(), J_DT[dtype])
    block = case.get("block", 32)
    want = j_flash_kernel.flash_attention_bwd(
        jq, jk, jv, j_out, jnp.asarray(lse.numpy()), jdo, block_q=block,
        block_kv=block, interpret=True, **opts)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])


@pytest.mark.parametrize("case", [BWD_CASES[i] for i in (1, 3, 5, 11, 13)],
                         ids=lambda c: "-".join(f"{k}{v}"
                                                for k, v in c.items()))
def test_flash_attention_autograd_matches_reference_vjp(case):
    """Gradients through the port's autograd Function against the
    reference's custom VJP (atol 1e-3, the reference's own gradient test)."""
    rng = np.random.default_rng(18)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), opts = _bwd_inputs(rng, case,
                                                             "float32")
    _, vjp = jax.vjp(lambda q, k, v: j_flash(q, k, v, block_q=32,
                                             block_kv=32, **opts),
                     jq, jk, jv)
    want = vjp(jdo)
    ts = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    got = torch.autograd.grad(flash_attention(*ts, **opts), ts, tdo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)


@pytest.mark.parametrize("s,opts", [(100, {}), (100, {"window": 30}),
                                    (37, {"softcap": 4.0}),
                                    (61, {"q_offset": 9})])
def test_flash_attention_bwd_ragged_matches_autograd(s, opts):
    """Lengths no 32-row tile divides (the reference shrinks its tiles
    there): the Function's gradients equal torch autograd through the
    plain forward."""
    rng = np.random.default_rng(19)
    _, (tq, tk, tv) = _flash_inputs(rng, 2, s, s + opts.get("q_offset", 0),
                                    12, 4, 64, "float32")
    tdo = torch.from_numpy(rng.normal(0, 1, tq.shape).astype(np.float32))
    full = dict(causal=True, window=0, scale=0.125, softcap=0.0,
                q_offset=0) | opts
    ts = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    got = torch.autograd.grad(flash_attention(*ts, **full), ts, tdo)
    rs = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    want = torch.autograd.grad(flash_attention_ref(*rs, **full)[0], rs, tdo)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_flash_attention_bwd_takes_an_expanded_cotangent():
    """``.sum()`` hands the backward a stride-0 cotangent; the result
    equals the one for a materialised cotangent of ones."""
    rng = np.random.default_rng(20)
    _, (tq, tk, tv) = _flash_inputs(rng, 1, 40, 40, 4, 2, 32, "float32")
    ts = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    flash_attention(*ts).sum().backward()
    ones = torch.ones_like(tq)
    want = torch.autograd.grad(flash_attention(tq.requires_grad_(True), tk,
                                               tv), tq, ones)[0]
    torch.testing.assert_close(ts[0].grad, want)


def test_flash_attention_bwd_keyless_rows_give_zero():
    """A negative q_offset leaves early rows with no live key: lse = -inf
    there, and the backward gives p = 0, never NaN."""
    rng = np.random.default_rng(21)
    _, (tq, tk, tv) = _flash_inputs(rng, 1, 16, 16, 4, 2, 32, "float32")
    tdo = torch.ones_like(tq)
    opts = dict(causal=True, window=0, scale=32 ** -0.5, softcap=0.0,
                q_offset=-4)
    out, lse = flash_attention_fwd(tq, tk, tv, **opts)
    assert torch.isinf(lse[..., :4]).all()
    dq, dk, dv = flash_attention_bwd(tq, tk, tv, out, lse, tdo, **opts)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    assert (dq[:, :4] == 0).all()


def _tensor_core_bwd(q, k, v, out, lse, do, *, causal, window, scale,
                     softcap, q_offset):
    """The card's bfloat16 backward bodies in plain torch: fp32 logits, p
    and dS as in the reference, but P (before P^T.dO) and dS (before dS.K
    and dS^T.Q) rounded to bfloat16, products accumulated in fp32, and the
    outputs rounded to bfloat16."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, sq, hkv, g, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, sq, hkv, g, hd)
    raw = torch.einsum("bskgh,btkh->bkgst", qf, kf) * scale
    if softcap > 0.0:
        t = torch.tanh(raw / softcap)
        logits, dcap = softcap * t, 1.0 - t * t
    else:
        logits, dcap = raw, 1.0
    q_pos = torch.arange(sq)[:, None] + q_offset
    k_pos = torch.arange(skv)[None, :]
    live = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        live &= k_pos <= q_pos
    if window > 0:
        live &= k_pos > q_pos - window
    lse_g = lse.reshape(b, hkv, g, sq)[..., None]
    live = live & torch.isfinite(lse_g)
    p = torch.where(live, torch.exp(logits - torch.where(live, lse_g, 0.0)),
                    0.0)
    delta = (dof * out.float().reshape(b, sq, hkv, g, hd)).sum(-1)
    dp = torch.einsum("bskgh,btkh->bkgst", dof, vf)
    ds = torch.where(live, p * (dp - delta.permute(0, 2, 3, 1)[..., None])
                     * dcap, 0.0)
    p16, ds16 = (x.to(torch.bfloat16).float() for x in (p, ds))
    dq = torch.einsum("bkgst,btkh->bskgh", ds16, kf) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds16, qf) * scale
    dv = torch.einsum("bkgst,bskgh->btkh", p16, dof)
    return tuple(x.to(torch.bfloat16) for x in
                 (dq.reshape(b, sq, h, hd), dk, dv))


def test_tensor_core_rounding_stays_inside_the_bf16_bars():
    """The rounding the card's bfloat16 backward adds (P and dS to bf16
    before their products), emulated in plain torch at the training
    shape's heads and length (B = 1, S = 1024, H = 12, Hkv = 4, hd = 64,
    causal), against the reference's backward kernels in interpret mode:
    each output within 2e-2 abs+rel, and its error within 1e-2 of its
    norm, the bars the card's check holds the kernels to."""
    rng = np.random.default_rng(22)
    c = dict(b=1, s=1024, h=12, hkv=4, hd=64)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), opts = _bwd_inputs(rng, c,
                                                             "bfloat16")
    out, lse = flash_attention_fwd(tq, tk, tv, **opts)
    got = _tensor_core_bwd(tq, tk, tv, out, lse, tdo, **opts)
    want = j_flash_kernel.flash_attention_bwd(
        jq, jk, jv, jnp.asarray(out.float().numpy(), jnp.bfloat16),
        jnp.asarray(lse.numpy()), jdo, block_q=512, block_kv=512,
        interpret=True, **opts)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = _np(g), _np(w)
        np.testing.assert_allclose(g, w, atol=BWD_TOL["bfloat16"],
                                   rtol=BWD_TOL["bfloat16"], err_msg=name)
        share = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert share <= 1e-2, (name, share)

