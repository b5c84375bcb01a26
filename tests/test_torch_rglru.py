"""The port's hybrid family (recurrentgemma / Griffin) against the
reference, on the CPU: the RG-LRU scan kernel's wrapper, the modules of
``models/rglru.py``, the chunked and ring-buffer attention branches, and
the reduced recurrentgemma-2b model (forward, loss and gradients, prefill
and decode).

Inputs are made with numpy from fixed seeds and go through both packages;
the reference's Pallas scan runs in interpret mode, as its own tests run
it, and the port's wrapper, given CPU tensors, runs its plain version.
Everything is float32: modules at 5e-5, the scan's gradients at 1e-4
(the reference's bars), logits at 1e-4 as in ``test_torch_model.py`` (the
two frameworks sum the d-wide products in different orders), each
gradient leaf within 1e-4 of its norm.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.kernels.rglru_scan.ops import rglru_scan as j_scan
from repro.kernels.rglru_scan.ref import rglru_scan_ref as j_scan_ref
from repro.models import attention as j_attn
from repro.models import rglru as j_rg
from repro.models.registry import build as j_build
from repro_torch.configs import reduced_config
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import rglru as rg
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.registry import build
from repro_torch.serving.serve import make_decode_step, make_prefill_step

ARCH = "recurrentgemma-2b"
TOL = 5e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _scan_inputs(rng, b, s, d, lo=0.7, hi=0.999, xs=0.1):
    a = rng.uniform(lo, hi, (b, s, d)).astype(np.float32)
    x = rng.normal(0, xs, (b, s, d)).astype(np.float32)
    h0 = rng.normal(0, 1, (b, d)).astype(np.float32)
    return a, x, h0


def _cfgs(**over):
    over = dict(dtype="float32", kv_cache_dtype="float32") | over
    return j_reduced(ARCH).replace(**over), reduced_config(ARCH).replace(
        **over)


def _pair_models(seed=0, **over):
    jcfg, cfg = _cfgs(**over)
    jb = j_build(jcfg)
    jp = jb.init_params(jax.random.PRNGKey(seed))
    return (jcfg, jb, jp), (cfg, build(cfg),
                            params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu"))


# ---------------------------------------------------------------------------
# the scan kernel's wrapper (ports of tests/test_kernels.py's rglru tests)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,d,bt,bd", [
    (1, 64, 32, 16, 32),
    (2, 128, 96, 32, 32),
    (1, 96, 48, 32, 16),    # non-pow2 sizes
    (3, 37, 20, 128, 512),  # ragged: no block divides S or D
])
def test_rglru_scan_shapes(b, s, d, bt, bd):
    a, x, h0 = _scan_inputs(np.random.default_rng(s + d), b, s, d)
    hs, hl = rg_ops.rglru_scan(_t(a), _t(x), _t(h0), block_t=bt, block_d=bd)
    assert hs.dtype == hl.dtype == torch.float32
    assert hs.shape == (b, s, d) and hl.shape == (b, d)
    args = (jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    jhs, jhl = j_scan(*args, block_t=bt, block_d=bd)
    rhs, rhl = j_scan_ref(*args)
    for want_hs, want_hl in ((jhs, jhl), (rhs, rhl)):
        _close(hs, want_hs, 1e-5)
        _close(hl, want_hl, 1e-5)


def test_rglru_scan_takes_bfloat16_inputs():
    """bf16 a and x are widened exactly; outputs are fp32."""
    a, x, h0 = _scan_inputs(np.random.default_rng(5), 2, 50, 24)
    ja, jx = (jnp.asarray(v, jnp.bfloat16) for v in (a, x))
    ta, tx = (_t(v).bfloat16() for v in (a, x))
    hs, hl = rg_ops.rglru_scan(ta, tx, _t(h0))
    assert hs.dtype == torch.float32
    jhs, jhl = j_scan(ja, jx, jnp.asarray(h0))
    _close(hs, jhs)
    _close(hl, jhl)


def test_rglru_scan_gradients():
    """The autograd Function's backward (the reversed scan) against JAX's
    custom VJP of the kernel and autograd of its oracle."""
    b, s, d = 1, 64, 32
    a, x, h0 = _scan_inputs(np.random.default_rng(11), b, s, d, hi=0.99)

    def lk(a, x, h0):
        hs, hl = j_scan(a, x, h0, block_t=16, block_d=16)
        return jnp.sum(hs ** 2) + jnp.sum(hl)

    def lr(a, x, h0):
        hs, hl = j_scan_ref(a, x, h0)
        return jnp.sum(hs ** 2) + jnp.sum(hl)

    ins = [_t(v).requires_grad_(True) for v in (a, x, h0)]
    hs, hl = rg_ops.rglru_scan(*ins, block_t=16, block_d=16)
    got = torch.autograd.grad((hs ** 2).sum() + hl.sum(), ins)
    jins = (jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    for fn in (lk, lr):
        want = jax.grad(fn, argnums=(0, 1, 2))(*jins)
        for g, w in zip(got, want):
            _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("nblocks,bt", [(1, 4), (3, 8), (6, 32), (2, 17),
                                        (5, 12)])
def test_rglru_block_size_invariance(nblocks, bt):
    """The reference's hypothesis property over the same space, as a fixed
    sweep: the result does not depend on the block size, in either
    package."""
    b, d = 1, 16
    s = nblocks * bt
    rng = np.random.default_rng(nblocks * 100 + bt)
    a, x, _ = _scan_inputs(rng, b, s, d, lo=0.5, xs=0.2)
    h0 = np.zeros((b, d), np.float32)
    hs1, _ = rg_ops.rglru_scan(_t(a), _t(x), _t(h0), block_t=bt, block_d=d)
    hs2, _ = rg_ops.rglru_scan(_t(a), _t(x), _t(h0), block_t=s, block_d=d)
    assert torch.equal(hs1, hs2)
    jhs, _ = j_scan(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0),
                    block_t=bt, block_d=d)
    _close(hs1, jhs, 1e-5)


def test_rglru_scan_reverse_is_the_flipped_scan():
    """The plain version's ``reverse`` (what the kernel's reverse flag
    computes for the backward): the forward scan of the time-flipped
    inputs, flipped back."""
    a, x, h0 = (_t(v) for v in _scan_inputs(np.random.default_rng(2), 2,
                                             33, 8))
    hs, hl = rglru_scan_ref(a, x, h0, reverse=True)
    fhs, fhl = rglru_scan_ref(a.flip(1), x.flip(1), h0)
    assert torch.equal(hs, fhs.flip(1)) and torch.equal(hl, fhl)
    assert torch.equal(hl, hs[:, 0])


def test_rglru_scan_plain_version_launches_nothing():
    a, x, h0 = (_t(v) for v in _scan_inputs(np.random.default_rng(3), 1, 8,
                                             4))
    before = rg_ops.rglru_scan.launches
    hs, _ = rg_ops.rglru_scan(a.requires_grad_(True), x, h0)
    hs.sum().backward()
    assert rg_ops.rglru_scan.launches == before


def test_rglru_scan_rejects_bad_inputs():
    a = torch.rand(2, 5, 4)
    with pytest.raises(ValueError, match="one shape"):
        rg_ops.rglru_scan(a, torch.rand(2, 5, 3), torch.zeros(2, 4))
    with pytest.raises(ValueError, match="h0"):
        rg_ops.rglru_scan(a, a, torch.zeros(2, 5))
    with pytest.raises(ValueError, match="time step"):
        rg_ops.rglru_scan(a[:, :0], a[:, :0], torch.zeros(2, 4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rg_ops.rglru_scan(a.double(), a.double(), torch.zeros(2, 4))
    with pytest.raises(ValueError, match="positive"):
        rg_ops.rglru_scan(a, a, torch.zeros(2, 4), block_t=0)


# ---------------------------------------------------------------------------
# models/rglru.py, module by module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,block", [(40, 256), (37, 256), (96, 32),
                                     (128, 48), (1, 256)])
def test_blocked_scan_ref_matches(s, block):
    """The blocked plain scan (the ``use_pallas=False`` route)."""
    a, x, h0 = _scan_inputs(np.random.default_rng(s), 2, s, 16)
    hs, hl = rg.rglru_scan_ref(_t(a), _t(x), _t(h0), block=block)
    jhs, jhl = j_rg.rglru_scan_ref(jnp.asarray(a), jnp.asarray(x),
                                   jnp.asarray(h0), block=block)
    _close(hs, jhs)
    _close(hl, jhl)


def _block_params(seed=0):
    jcfg, cfg = _cfgs()
    spec = j_rg.make_rglru_block_specs(jcfg)
    from repro.models.common import init_params as j_init
    jp = j_init(jax.random.PRNGKey(seed), spec, jnp.float32)
    # nonzero biases so every term of the gates is exercised
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "b_a", "b_i"):
        jp[name] = jnp.asarray(rng.normal(0, 0.5, jp[name].shape),
                               jnp.float32)
    return (jcfg, jp), (cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                               "cpu"))


def test_rglru_gates_matches():
    (_, jp), (_, p) = _block_params()
    xr = np.random.default_rng(1).normal(0, 1, (2, 9, 128)).astype(
        np.float32)
    got = rg.rglru_gates(p, _t(xr))
    want = j_rg.rglru_gates(jp, jnp.asarray(xr))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    (_, jp), (_, p) = _block_params()
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 7, 128)).astype(np.float32)
    state = rng.normal(0, 1, (2, 3, 128)).astype(np.float32) \
        if with_state else None
    out, st = rg._causal_conv(p, _t(x), None if state is None else _t(state))
    jout, jst = j_rg._causal_conv(
        jp, jnp.asarray(x), None if state is None else jnp.asarray(state))
    _close(out, jout)
    _close(st, jst)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_forward_matches(use_pallas, with_state):
    (jcfg, jp), (cfg, p) = _block_params(1)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 12, 128)).astype(np.float32)
    state = {"h": rng.normal(0, 1, (2, 128)).astype(np.float32),
             "conv": rng.normal(0, 1, (2, 3, 128)).astype(np.float32)} \
        if with_state else None
    out, st = rg.rglru_block_forward(
        cfg, p, _t(x), None if state is None
        else {k: _t(v) for k, v in state.items()}, use_pallas=use_pallas)
    jout, jst = j_rg.rglru_block_forward(
        jcfg, jp, jnp.asarray(x), None if state is None
        else jax.tree.map(jnp.asarray, state), use_pallas=use_pallas)
    _close(out, jout)
    for name in ("h", "conv"):
        _close(st[name], jst[name])


def test_rglru_block_decode_matches_and_takes_the_plain_scan(monkeypatch):
    """A decode step runs the plain one-step scan, never the kernel's
    wrapper, as in the reference."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("decode reached the scan kernel's wrapper")

    monkeypatch.setattr(rg.rg_ops, "rglru_scan", no_kernel)
    (jcfg, jp), (cfg, p) = _block_params(2)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (3, 1, 128)).astype(np.float32)
    state = {"h": rng.normal(0, 1, (3, 128)).astype(np.float32),
             "conv": rng.normal(0, 1, (3, 3, 128)).astype(np.float32)}
    out, st = rg.rglru_block_decode(cfg, p, _t(x),
                                    {k: _t(v) for k, v in state.items()})
    jout, jst = j_rg.rglru_block_decode(jcfg, jp, jnp.asarray(x),
                                        jax.tree.map(jnp.asarray, state))
    _close(out, jout)
    for name in ("h", "conv"):
        _close(st[name], jst[name])


# ---------------------------------------------------------------------------
# attention: the chunked route and the ring buffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,hkv,s,window,softcap,causal", [
    (4, 2, 40, 0, 0.0, True),
    (4, 1, 64, 16, 0.0, True),
    (6, 3, 37, 0, 30.0, True),
    (4, 4, 48, 20, 5.0, True),
    (4, 2, 40, 0, 0.0, False),
])
def test_chunked_attention_matches(h, hkv, s, window, softcap, causal):
    """GQA, window, softcap, a non-causal case and a Skv that 16 does not
    divide (the block halves to 8 at S=40, to 1 at S=37)."""
    over = dict(attn_kv_block=16, attn_softcap=softcap)
    jcfg, cfg = (c.replace(**over) for c in _cfgs())
    rng = np.random.default_rng(h * s)
    q = rng.normal(0, 1, (2, s, h, 32)).astype(np.float32)
    k = rng.normal(0, 1, (2, s, hkv, 32)).astype(np.float32)
    v = rng.normal(0, 1, (2, s, hkv, 32)).astype(np.float32)
    pos = np.arange(s)
    got = attn._chunked_attention(cfg, _t(q), _t(k), _t(v), _t(pos),
                                  _t(pos), causal=causal, window=window)
    want = j_attn._chunked_attention(
        jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pos), jnp.asarray(pos), causal=causal, window=window)
    _close(got, want)
    direct = attn._direct_attention(cfg, _t(q), _t(k), _t(v), _t(pos),
                                    _t(pos), causal=causal, window=window)
    _close(got, direct)


def _attn_params(seed=0):
    """Attention parameters with the projections at std 1/sqrt(fan-in of
    their contraction): the reference's init takes the fan-in from
    shape[-2] (the head count), which drives outputs to ~30 where float32
    summation order alone moves them by more than 5e-5."""
    jcfg, cfg = _cfgs()
    from repro.models.common import init_params as j_init
    jp = j_init(jax.random.PRNGKey(seed), j_attn.make_attn_specs(jcfg),
                jnp.float32)
    for name in ("wq", "wk", "wv"):
        jp[name] = jp[name] * (jp[name].shape[-2] / jcfg.d_model) ** 0.5
    jp["wo"] = jp["wo"] * (jp["wo"].shape[-2]
                           / (jcfg.num_heads * jcfg.hd)) ** 0.5
    return (jcfg, jp), (cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                               "cpu"))


@pytest.mark.parametrize("s", [20, 32, 45])
@pytest.mark.parametrize("attn_impl", ["direct", "chunked"])
def test_windowed_prefill_into_cache_matches(s, attn_impl):
    """S below, at and past the window of 32: the output and the ring's
    contents (the last min(32, S) entries at slot pos % 32)."""
    (jcfg, jp), (cfg, p) = _attn_params()
    jcfg, cfg = (c.replace(attn_impl=attn_impl, attn_kv_block=16)
                 for c in (jcfg, cfg))
    window = 32
    x = np.random.default_rng(s).normal(0, 1, (2, s, 128)).astype(
        np.float32)
    pos = np.arange(s)
    cache = attn.init_kv_cache(cfg, 2, window, torch.device("cpu"))
    out, cache = attn.prefill_into_cache(cfg, p, _t(x), _t(pos), cache,
                                         window=window)
    jout, jcache = j_attn.prefill_into_cache(
        jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
        j_attn.init_kv_cache(jcfg, 2, window), window=window)
    _close(out, jout)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])
    # slot pos % 32 holds position pos for the last min(32, S) positions
    full = attn.init_kv_cache(cfg, 2, s, torch.device("cpu"))
    attn.prefill_into_cache(cfg, p, _t(x), _t(pos), full)
    for t in range(max(0, s - window), s):
        assert torch.equal(cache["k"][:, t % window], full["k"][:, t])


@pytest.mark.parametrize("kv_cache_dtype", ["float32", "int8"])
def test_windowed_attn_decode_matches_across_a_wrap(kv_cache_dtype):
    """Prefill 28 tokens into a ring of 16 slots, then 8 decode steps
    (positions 28..35, the write slot wrapping at 32): every output and
    the ring after each step."""
    (jcfg, jp), (cfg, p) = _attn_params(1)
    jcfg, cfg = (c.replace(kv_cache_dtype=kv_cache_dtype)
                 for c in (jcfg, cfg))
    window, n = 16, 28
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, n, 128)).astype(np.float32)
    pos = np.arange(n)
    cache = attn.init_kv_cache(cfg, 2, window, torch.device("cpu"))
    _, cache = attn.prefill_into_cache(cfg, p, _t(x), _t(pos), cache,
                                       window=window)
    _, jcache = j_attn.prefill_into_cache(
        jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
        j_attn.init_kv_cache(jcfg, 2, window), window=window)
    quantized = kv_cache_dtype == "int8"
    for step in range(8):
        xt = rng.normal(0, 1, (2, 1, 128)).astype(np.float32)
        out, cache = attn.attn_decode(cfg, p, _t(xt), cache,
                                      torch.tensor(n + step), window=window)
        jout, jcache = j_attn.attn_decode(cfg=jcfg, p=jp, x=jnp.asarray(xt),
                                          cache=jcache,
                                          pos=jnp.asarray(n + step,
                                                          jnp.int32),
                                          window=window)
        _close(out, jout, 2e-2 if quantized else TOL)
        for name in jcache:
            # an int8 code may sit one step off on a rounding boundary
            code = quantized and name in ("k", "v")
            _close(cache[name], jcache[name], 1.0 if code else TOL)


def test_windowed_decode_rejects_per_row_positions():
    (_, _), (cfg, p) = _attn_params()
    cache = attn.init_kv_cache(cfg, 2, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="ring-buffer"):
        attn.attn_decode(cfg, p, torch.zeros(2, 1, 128), cache,
                         torch.tensor([3, 4]), window=8)


# ---------------------------------------------------------------------------
# the reduced recurrentgemma-2b
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["direct", "chunked"])
def test_griffin_forward_matches(attn_impl):
    (jcfg, _, jp), (cfg, _, p) = _pair_models(use_pallas=True,
                                              attn_impl=attn_impl,
                                              attn_kv_block=16)
    tokens = np.random.default_rng(5).integers(1, 500, (2, 40))
    want = jax.jit(lambda p, t: j_rg.griffin_forward(jcfg, p, {"tokens": t}))(
        jp, jnp.asarray(tokens))
    before = rg_ops.rglru_scan.launches
    got = rg.griffin_forward(cfg, p, {"tokens": _t(tokens)})
    assert rg_ops.rglru_scan.launches == before       # the plain version
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("attn_impl", ["direct", "chunked"])
def test_griffin_loss_and_gradients_match(attn_impl):
    """The loss and the gradient of every parameter leaf, through the scan
    Function's backward and the config's remat policy."""
    from repro_torch.training.train_step import value_and_grad

    (jcfg, jb, jp), (cfg, b, p) = _pair_models(use_pallas=True,
                                               attn_impl=attn_impl,
                                               attn_kv_block=16)
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(1, 500, (2, 24)),
             "labels": rng.integers(1, 500, (2, 24)),
             "mask": (rng.uniform(size=(2, 24)) > 0.2).astype(np.float32)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jb.loss_fn,
                                                    has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    (loss, metrics), grads = value_and_grad(
        b, p, {k: _t(v) for k, v in batch.items()})
    _close(loss, jloss)
    assert float(metrics["tokens"]) == float(batch["mask"].sum())
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                            jgrads))
    got = common.tree_leaves(grads)
    assert len(got) == len(want)
    for (path, w), (key, g) in zip(want, got):
        assert key == "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                               for k in path)
        err = float(np.linalg.norm(_np(g) - w))
        assert err <= GRAD_TOL * max(float(np.linalg.norm(w)), 1e-12), key


@pytest.mark.parametrize("attn_impl", ["direct", "chunked"])
def test_griffin_prefill_and_decode_match(attn_impl):
    """A 40-token prompt past the window of 32, then 4 greedy decode
    steps: the logits, the tokens and every state leaf after each step."""
    (jcfg, jb, jp), (cfg, b, p) = _pair_models(use_pallas=True,
                                               attn_impl=attn_impl,
                                               attn_kv_block=16)
    n, max_len = 40, 48
    prompt = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, n))
    jlogits, jstate = jax.jit(jb.prefill_fn)(
        jp, {"tokens": jnp.asarray(prompt)}, jb.init_cache(2, max_len))
    state = b.init_cache(2, max_len, "cpu")
    before = rg_ops.rglru_scan.launches
    logits, state = b.prefill_fn(p, {"tokens": _t(prompt)}, state)
    assert rg_ops.rglru_scan.launches == before       # CPU: no launch

    def same_state():
        want = jax.tree.leaves(jstate)
        got = [t for _, t in common.tree_leaves(state)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w, LOGIT_TOL)

    _close(logits, jlogits, LOGIT_TOL)
    same_state()
    j_decode = jax.jit(jb.decode_fn)
    for step in range(4):
        tok = np.asarray(jlogits[:, -1, :cfg.vocab_size]).argmax(-1)[:, None]
        assert logits[:, -1, :cfg.vocab_size].argmax(-1).tolist() == \
            tok[:, 0].tolist()
        jlogits, jstate = j_decode(jp, jstate, jnp.asarray(tok),
                                   jnp.asarray(n + step, jnp.int32))
        logits, state = b.decode_fn(p, state, _t(tok), torch.tensor(n + step))
        _close(logits, jlogits, LOGIT_TOL)
        same_state()


@pytest.mark.parametrize("arch", [ARCH])
def test_prefill_equals_stepwise_decode(arch):
    """Twin of tests/test_serving.py's case for the hybrid: prefilling N
    tokens lands in the same state as feeding them one decode step at a
    time: identical next token and greedy continuation."""
    cfg = reduced_config(arch).replace(dtype="float32",
                                       kv_cache_dtype="float32")
    bundle = build(cfg)
    params = bundle.init_params(1, "cpu")
    prefill = make_prefill_step(bundle)
    decode = make_decode_step(bundle)
    n, extra, max_len = 8, 4, 32
    prompt = torch.from_numpy(
        np.random.default_rng(4).integers(1, cfg.vocab_size, (1, n)))

    def continue_greedy(tok, cache, pos):
        seq = [int(tok[0, 0])]
        for i in range(extra):
            tok, cache = decode(params, cache, tok.long(),
                                torch.tensor(pos + i))
            seq.append(int(tok[0, 0]))
        return seq

    tok_a, cache_a = prefill(params, {"tokens": prompt},
                             bundle.init_cache(1, max_len, "cpu"))
    seq_a = continue_greedy(tok_a, cache_a, n)
    tok_b, cache_b = prefill(params, {"tokens": prompt[:, :1]},
                             bundle.init_cache(1, max_len, "cpu"))
    for i in range(1, n):
        tok_b, cache_b = decode(params, cache_b, prompt[:, i:i + 1],
                                torch.tensor(i))
    seq_b = continue_greedy(tok_b, cache_b, n)
    assert seq_a == seq_b


def test_init_griffin_state_matches():
    jcfg, cfg = _cfgs(dtype="bfloat16", kv_cache_dtype="bfloat16")
    want = j_rg.init_griffin_state(jcfg, 3, 20)
    got = rg.init_griffin_state(cfg, 3, 20, torch.device("cpu"))
    assert [sorted(s) for s in got] == [sorted(s) for s in want]
    for g, w in zip(got, want):
        for name in w:
            assert tuple(g[name].shape) == w[name].shape
            assert str(g[name].dtype).split(".")[-1] == str(w[name].dtype)
            assert not g[name].any()


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------

def test_params_bridge_round_trips_a_list_of_layers():
    (_, jb, jp), (_, b, p) = _pair_models()
    ref = jax.tree.map(np.asarray, jp)
    assert isinstance(p["layers"], list) and len(p["layers"]) == 3
    back = params_to_numpy(p)
    assert jax.tree.structure(ref) == jax.tree.structure(back)
    for (path, a), bk in zip(jax.tree_util.tree_leaves_with_path(ref),
                             jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, bk, err_msg=str(path))
    # the port's own init makes the same tree of shapes, leaves in the
    # order JAX flattens them
    mine = b.init_params(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(np.shape, ref) == jax.tree.map(
        lambda t: tuple(t.shape), mine)
    assert [k for k, _ in common.tree_leaves(mine)] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(ref)]
    lam = mine["layers"][0]["kind_rglru"]["lam"]
    a = torch.sigmoid(lam) ** 8            # the init's a^2 lands in
    assert bool(((a > 0.9) & (a < 0.999)).all())   # (0.9, 0.999)


def test_cast_for_compute_keeps_the_hybrids_fp32_leaves():
    """The leaves the reference reads in fp32 at every use stay fp32; the
    rest go to the activation dtype once."""
    cfg = reduced_config(ARCH)
    p = build(cfg).init_params(0, "cpu")
    cast = common.cast_for_compute(p, torch.bfloat16, torch.device("cpu"))
    for key, t in common.tree_leaves(cast):
        want = torch.float32 if key.split("/")[-1] in common.FP32_LEAVES \
            else torch.bfloat16
        assert t.dtype == want, key
    rec = cast["layers"][0]["kind_rglru"]
    for name in ("ln", "lam", "w_a", "w_i", "b_a", "b_i", "conv_w",
                 "conv_b"):
        assert rec[name].dtype == torch.float32, name
    assert rec["w_x"].dtype == torch.bfloat16


def test_rglru_module_imports_no_jax():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    prog = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.abspath(src)!r})
        import repro_torch.models.rglru
        import repro_torch.kernels.rglru_scan.ops
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print("BAD", bad)
    """)
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout
