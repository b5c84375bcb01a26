"""The port's kernels against the reference's, on the CPU.

Inputs are made with numpy from a fixed seed and go through both
packages: the reference's Pallas kernels run in interpret mode (as its own
tests run them), and the port's wrappers, given CPU tensors, run their
plain PyTorch versions. Tolerances are the reference's own
(``tests/test_kernels.py``): 5e-5 in float32, 2e-2 in bfloat16.
"""

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
from repro_torch.kernels.decode_attention.ops import decode_attention
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
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_lse_matches_reference_kernel(opts, dtype):
    rng = np.random.default_rng(15)
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(rng, 2, 64, 64, 6, 2, 32,
                                               dtype)
    full = dict(window=0, scale=32 ** -0.5, softcap=0.0) | opts
    out, lse = flash_attention_fwd(tq, tk, tv, causal=True, **full)
    assert lse.dtype == torch.float32 and lse.shape == (2, 6, 64)
    j_out, j_lse = j_flash_kernel.flash_attention_fwd(
        jq, jk, jv, causal=True, q_offset=0, block_q=32, block_kv=32,
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
]


def _bwd_inputs(rng, c, dtype):
    skv = c.get("skv", c["s"])
    std = 2.0 if c.get("softcap") else 1.0
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(
        rng, c["b"], c["s"], skv, c["h"], c["hkv"], c["hd"], dtype, std=std)
    jdo, tdo = _pair(rng.normal(0, 1, (c["b"], c["s"], c["h"], c["hd"])),
                     dtype)
    opts = dict(causal=True, window=c.get("window", 0),
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
    want = j_flash_kernel.flash_attention_bwd(
        jq, jk, jv, j_out, jnp.asarray(lse.numpy()), jdo, block_q=32,
        block_kv=32, interpret=True, **opts)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])


@pytest.mark.parametrize("case", [BWD_CASES[i] for i in (1, 3, 5)],
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
