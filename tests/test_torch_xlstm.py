"""The port's ssm family (xLSTM) against the reference, on the CPU: the
chunkwise mLSTM kernel's wrapper, the modules of ``models/xlstm.py`` and
the reduced xlstm-350m (8 layers with the sLSTM at position 7, d=128,
mLSTM head dim 64, chunk 32): forward, loss and gradients, prefill and
decode.

Inputs are made with numpy from fixed seeds and go through both packages;
the reference's Pallas mLSTM kernel runs in interpret mode, as its own
tests run it, and the port's wrapper, given CPU tensors, runs its plain
chunkwise version. Tolerances are the reference's: 5e-5 in fp32 and 2e-2
in bf16 (``tests/test_kernels.py:22``); the kernel against the sequential
oracle hs 1e-4, C 1e-3, m 1e-5 (``tests/test_kernels.py:267-269``);
prefill and decode logits and state at 1e-4 in fp32, as the other
families' (the two frameworks sum the d-wide products in different
orders); each gradient leaf within 1e-4 of its norm.

The reduced model is badly conditioned at the reference's init: where an
mLSTM head's output is near zero, the group norm (eps 1e-6) scales its
rounding ~400x, so two correct float32 forwards end 1e-3 apart and bf16
forwards are chaotic in both packages. The whole-model forward tests
therefore hold every layer fed the reference's own input, and the
float32 forward also by its greedy tokens and its distance from a
float64 evaluation of the same function.
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
from repro.kernels.mlstm_chunk.ops import mlstm_chunk as j_mlstm
from repro.kernels.mlstm_chunk.ref import mlstm_ref as j_mlstm_ref
from repro.models import common as j_common
from repro.models import xlstm as j_x
from repro.models.registry import build as j_build
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.mlstm_chunk import ops as ml_ops
from repro_torch.kernels.mlstm_chunk.ref import (NEG_BIG, chunk_len,
                                                 cumsum_in_order,
                                                 mlstm_recurrent_ref)
from repro_torch.models import common
from repro_torch.models import xlstm as x
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.registry import build
from repro_torch.serving.serve import (BatchScheduler, make_decode_step,
                                       make_prefill_step)

ARCH = "xlstm-350m"
TOL = {"float32": 5e-5, "bfloat16": 2e-2}
ORACLE = {"hs": 1e-4, "C": 1e-3, "m": 1e-5}
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol=TOL["float32"]):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _mlstm_inputs(rng, b, h, s, hd, state=False):
    """The reference's sweep inputs (``tests/test_kernels.py:258-265``);
    with ``state``, a nonzero finite (C0, n0, m0)."""
    q, k, v = (rng.normal(0, 1, (b, h, s, hd)).astype(np.float32)
               for _ in range(3))
    li = rng.normal(0, 1, (b, h, s)).astype(np.float32)
    lf = -np.abs(rng.normal(1, 0.5, (b, h, s))).astype(np.float32)
    if state:
        C0 = rng.normal(0, 0.5, (b, h, hd, hd)).astype(np.float32)
        n0 = rng.normal(0, 0.5, (b, h, hd)).astype(np.float32)
        m0 = rng.normal(0, 1, (b, h)).astype(np.float32)
    else:
        C0 = np.zeros((b, h, hd, hd), np.float32)
        n0 = np.zeros((b, h, hd), np.float32)
        m0 = np.full((b, h), -1e30, np.float32)
    return q, k, v, li, lf, C0, n0, m0


def _hold_to_reference_and_oracle(ins, chunk):
    """The wrapper on CPU tensors against the reference's kernel (interpret
    mode) at 5e-5 and against both sequential oracles at the oracle bars."""
    hs, (C, n, m) = ml_ops.mlstm_chunk(*map(_t, ins), chunk=chunk)
    assert hs.dtype == torch.float32 and hs.shape == ins[0].shape
    assert C.dtype == n.dtype == m.dtype == torch.float32
    jins = [jnp.asarray(a) for a in ins]
    jhs, (jC, jn, jm) = j_mlstm(*jins, chunk=chunk)
    for g, w in ((hs, jhs), (C, jC), (n, jn), (m, jm)):
        _close(g, w)
    oracles = (j_mlstm_ref(*jins), mlstm_recurrent_ref(*map(_t, ins)))
    for rhs, (rC, _, rm) in oracles:
        np.testing.assert_allclose(_np(hs), _np(rhs), atol=ORACLE["hs"])
        np.testing.assert_allclose(_np(C), _np(rC), atol=ORACLE["C"])
        np.testing.assert_allclose(_np(m), _np(rm), atol=ORACLE["m"])
    return hs, (C, n, m)


# ---------------------------------------------------------------------------
# the mLSTM kernel's wrapper (ports of tests/test_kernels.py's mlstm tests)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,s,hd,chunk", [
    (1, 2, 64, 32, 16),
    (2, 3, 64, 32, 32),
    (1, 1, 128, 64, 64),
    (2, 2, 37, 32, 16),     # odd S past the chunk: L = 1
    (1, 2, 96, 32, 64),     # S = 96 with chunk 64: L = 32
])
@pytest.mark.parametrize("state", [False, True])
def test_mlstm_chunk_shapes(b, h, s, hd, chunk, state):
    ins = _mlstm_inputs(np.random.default_rng(s + hd + chunk), b, h, s, hd,
                        state)
    _hold_to_reference_and_oracle(ins, chunk)


@pytest.mark.parametrize("state", [False, True])
def test_model_chunkwise_matches(state):
    """``models/xlstm.py``'s chunkwise form against the reference model's
    (``xlstm.py:159``; -inf masking, m0 not clamped)."""
    ins = _mlstm_inputs(np.random.default_rng(21), 2, 2, 96, 32, state)
    hs, st = x.mlstm_chunkwise(*map(_t, ins), chunk=32)
    jhs, jst = j_x.mlstm_chunkwise(*(jnp.asarray(a) for a in ins), chunk=32)
    for g, w in zip((hs, *st), (jhs, *jst)):
        _close(g, w)


def test_chunk_rule_is_the_references():
    assert [chunk_len(s, c) for s, c in ((37, 16), (96, 64), (96, 128),
                                         (2048, 128), (1, 128), (129, 128))] \
        == [1, 32, 96, 128, 1, 1]


def test_mlstm_carried_state_continuation():
    """Processing [first half -> state -> second half] equals processing
    the full sequence at once (``tests/test_kernels.py:272``)."""
    q, k, v, li, lf, C0, n0, m0 = map(
        _t, _mlstm_inputs(np.random.default_rng(3), 1, 2, 64, 32))
    full, _ = ml_ops.mlstm_chunk(q, k, v, li, lf, C0, n0, m0, chunk=16)
    half = slice(0, 32)
    h1, (C, n, m) = ml_ops.mlstm_chunk(
        q[:, :, half], k[:, :, half], v[:, :, half], li[:, :, half],
        lf[:, :, half], C0, n0, m0, chunk=16)
    rest = slice(32, 64)
    h2, _ = ml_ops.mlstm_chunk(q[:, :, rest], k[:, :, rest], v[:, :, rest],
                               li[:, :, rest], lf[:, :, rest], C, n, m,
                               chunk=16)
    np.testing.assert_allclose(_np(h1), _np(full[:, :, :32]), atol=1e-4)
    np.testing.assert_allclose(_np(h2), _np(full[:, :, 32:]), atol=1e-4)


def test_mlstm_chunk_takes_bfloat16():
    """bf16 q/k/v: hs in bf16 at the bf16 bar, the fp32 state at 5e-5 (the
    state is computed in fp32 from the same widened inputs)."""
    ins = list(_mlstm_inputs(np.random.default_rng(9), 2, 2, 64, 32, True))
    tq, tk, tv = (_t(a).bfloat16() for a in ins[:3])
    hs, (C, n, m) = ml_ops.mlstm_chunk(tq, tk, tv, *map(_t, ins[3:]),
                                       chunk=16)
    assert hs.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in ins[:3])
    jhs, (jC, jn, jm) = j_mlstm(jq, jk, jv,
                                *(jnp.asarray(a) for a in ins[3:]), chunk=16)
    assert jhs.dtype == jnp.bfloat16
    _close(hs, jhs, TOL["bfloat16"])
    for g, w in ((C, jC), (n, jn), (m, jm)):
        _close(g, w)


def _tensor_core_mlstm(q, k, v, li, lf, C0, n0, m0):
    """The card's bfloat16 tensor-core mLSTM body in plain torch (chunks of
    128 rows), rounding where it rounds: the scores q k^T, q C_prev and
    q n_prev from bf16 q/k with fp32 sums, scaled after; the three fp32
    operands of its bf16 products, C_prev (of q C_prev), att (of att v) and
    the update's kk = k k_scale, each split into bf16 hi and lo = bf16(x -
    hi), both products summed into one fp32 term (one rounding to bf16
    moves hs past its 2e-2 bar, and C past its 5e-5 bar); den_intra
    summed from the fp32 att; n, the gates and the state in fp32 as in the
    plain version."""

    def split(x):
        hi = x.bfloat16().float()
        return hi, (x - hi).bfloat16().float()

    s, hd = q.shape[2], q.shape[3]
    L = 128
    scale = 1.0 / float(hd) ** 0.5
    C, n = C0.float(), n0.float()
    m = torch.clamp_min(m0.float(), NEG_BIG)
    tri = torch.ones((L, L), dtype=torch.bool).tril()
    hs = []
    for c0 in range(0, s, L):
        sl = slice(c0, c0 + L)
        qc, kc, vc = (t[:, :, sl].float() for t in (q, k, v))
        lic, lfc = li[:, :, sl].float(), lf[:, :, sl].float()
        b_cum = cumsum_in_order(lfc)
        total = b_cum[..., -1:]
        D = b_cum[..., :, None] - b_cum[..., None, :] + lic[..., None, :]
        D = torch.where(tri, D, NEG_BIG)
        m_inter = b_cum + m[..., None]
        m_out = torch.clamp_min(torch.maximum(D.amax(dim=-1), m_inter),
                                NEG_BIG)
        inter_scale = torch.exp(m_inter - m_out)
        C_hi, C_lo = split(C)
        h_inter = (qc @ C_hi + qc @ C_lo) * scale
        den_inter = (qc @ n[..., None])[..., 0] * scale
        att = (qc @ kc.transpose(-1, -2)) * scale * torch.exp(
            D - m_out[..., None])
        att = torch.where(tri, att, 0.0)
        att_hi, att_lo = split(att)
        h_intra = torch.cat([att_hi, att_lo], dim=-1) @ torch.cat([vc, vc],
                                                                  dim=-2)
        den = den_inter * inter_scale + att.sum(dim=-1)
        denom = torch.maximum(den.abs(), torch.exp(-m_out))
        hs.append((h_inter * inter_scale[..., None] + h_intra)
                  / denom[..., None])
        m_cand = (lic + total - b_cum).amax(dim=-1)
        m_new = torch.maximum(m + total[..., 0], m_cand)
        c_scale = torch.exp(m + total[..., 0] - m_new)
        k_scale = torch.exp(lic + total - b_cum - m_new[..., None])
        kk = kc * k_scale[..., None]
        kk_hi, kk_lo = split(kk)
        C = C * c_scale[..., None, None] + torch.cat(
            [kk_hi, kk_lo], dim=-2).transpose(-1, -2) @ torch.cat([vc, vc],
                                                                  dim=-2)
        n = n * c_scale[..., None] + kk.sum(dim=-2)
        m = m_new
    return torch.cat(hs, dim=2).bfloat16(), (C, n, m)


def test_tensor_core_mlstm_rounding_stays_inside_the_bars():
    """The rounding the card's tensor-core mLSTM body adds, emulated in
    plain torch at the serving head dim and prompt (B = 1, H = 2, S = 2048,
    hd = 512, bf16 q/k/v), against the reference's kernel in interpret
    mode, its sequential oracle and the port's plain version, at the bars
    the card's check holds the kernel to: hs within 2e-2 abs+rel and 1e-2
    of its norm of the kernel and the plain version; C, n and m within
    5e-5 abs+rel of the plain version; against the oracle hs 2e-2, C 1e-3
    and m 1e-5, or where the plain version is itself farther, no farther
    than it plus the kernel-vs-plain bar."""
    ins = list(_mlstm_inputs(np.random.default_rng(13), 1, 2, 2048, 512))
    tq, tk, tv = (_t(a).bfloat16() for a in ins[:3])
    rest = list(map(_t, ins[3:]))
    hs, state = _tensor_core_mlstm(tq, tk, tv, *rest)
    phs, pstate = ml_ops.mlstm_chunk(tq, tk, tv, *rest, chunk=128)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in ins[:3])
    jrest = [jnp.asarray(a) for a in ins[3:]]
    jhs, _ = j_mlstm(jq, jk, jv, *jrest, chunk=128)
    ohs, (oC, _, om) = j_mlstm_ref(jq, jk, jv, *jrest)
    for want in (jhs, phs):
        g, w = _np(hs), _np(want)
        np.testing.assert_allclose(g, w, atol=TOL["bfloat16"],
                                   rtol=TOL["bfloat16"])
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 1e-2
    for got, want in zip(state, pstate):
        _close(got, want, 5e-5)
    for name, g, p, w, bar in (("hs", hs, phs, ohs, TOL["bfloat16"]),
                               ("C", state[0], pstate[0], oC, ORACLE["C"]),
                               ("m", state[2], pstate[2], om, ORACLE["m"])):
        plain = np.abs(_np(p) - _np(w)).max()
        if plain > bar:
            bar = plain + (TOL["bfloat16"] if name == "hs" else 5e-5)
        rtol = TOL["bfloat16"] if name == "hs" else 0.0
        np.testing.assert_allclose(_np(g), _np(w), atol=bar, rtol=rtol,
                                   err_msg=name)


def test_tensor_core_route_is_bf16_with_full_chunks():
    """Which CUDA calls take the tensor-core body: bfloat16 q/k/v, chunks
    of 128 rows (the serving prefill's) and head dims that are a multiple
    of 64; fp32, shorter chunks and other head dims stay on the CUDA-core
    body."""
    take = ml_ops.takes_tensor_cores
    assert take(torch.bfloat16, 128, 512) and take(torch.bfloat16, 128, 64)
    assert not take(torch.float32, 128, 512)
    for L in (1, 4, 32, 37, 64, 96):
        assert not take(torch.bfloat16, L, 512)
    for hd in (32, 96, 160):
        assert not take(torch.bfloat16, 128, hd)
    # the full-width serving prefill: 2048-token prompts, head dim 512
    cfg = get_config(ARCH)
    hd = 2 * cfg.d_model // cfg.num_heads
    assert hd == 512 and take(torch.bfloat16,
                              chunk_len(2048, cfg.mlstm_chunk), hd)


def test_mlstm_chunk_plain_version_launches_nothing():
    ins = map(_t, _mlstm_inputs(np.random.default_rng(1), 1, 1, 16, 32))
    before = ml_ops.mlstm_chunk.launches
    ml_ops.mlstm_chunk(*ins, chunk=8)
    assert ml_ops.mlstm_chunk.launches == before


def test_mlstm_chunk_rejects_bad_inputs():
    good = list(map(_t, _mlstm_inputs(np.random.default_rng(2), 1, 2, 16,
                                      32)))

    def call(i=None, t=None, chunk=8):
        ins = list(good)
        if i is not None:
            ins[i] = t
        return ml_ops.mlstm_chunk(*ins, chunk=chunk)

    with pytest.raises(ValueError, match="one shape"):
        call(1, good[1][:, :, :8])
    with pytest.raises(ValueError, match="C0 must be"):
        call(5, good[5][..., :16])
    with pytest.raises(ValueError, match="li must be"):
        call(3, good[3][None])
    with pytest.raises(TypeError, match="one dtype"):
        call(0, good[0].double())
    with pytest.raises(TypeError, match="one dtype"):
        call(2, good[2].bfloat16())
    with pytest.raises(TypeError, match="float tensor"):
        call(7, good[7].long())
    with pytest.raises(ValueError, match="chunk must be"):
        call(chunk=0)
    with pytest.raises(ValueError, match="at least one"):
        ml_ops.mlstm_chunk(*(t[:, :, :0] for t in good[:5]), *good[5:])
    with pytest.raises(ValueError, match="one device"):
        call(6, good[6].to("meta"))
    with pytest.raises(ValueError, match="cuda"):
        ml_ops.mlstm_chunk(*(t.to("meta") for t in good))
    with pytest.raises(RuntimeError, match="forward only"):
        call(0, good[0].clone().requires_grad_(True))


# ---------------------------------------------------------------------------
# modules of models/xlstm.py against their JAX counterparts
# ---------------------------------------------------------------------------

def _cfgs(**over):
    over = dict(dtype="float32") | over
    return j_reduced(ARCH).replace(**over), reduced_config(ARCH).replace(
        **over)


def _pair_models(seed=0, **over):
    jcfg, cfg = _cfgs(**over)
    jb = j_build(jcfg)
    jp = jb.init_params(jax.random.PRNGKey(seed))
    return (jcfg, jb, jp), (cfg, build(cfg),
                            params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu"))


def _block_params(kind, seed=0):
    """The first layer of that kind of a reduced model, with its ones/zeros
    leaves replaced by random values so that every leaf matters."""
    (jcfg, _, jp), (cfg, _, p) = _pair_models(seed)
    i = 0 if kind == "mlstm" else 7
    rng = np.random.default_rng(seed + 1)
    jl = {name: np.asarray(a) for name, a in jp["layers"][i][kind].items()}
    for name in ("ln", "ln_b", "b_i", "b_f", "b_z", "b_o", "gn_scale",
                 "conv_b"):
        if name in jl:
            jl[name] = (jl[name] + rng.normal(0, 0.3, jl[name].shape)) \
                .astype(np.float32)
    return (jcfg, {k: jnp.asarray(a) for k, a in jl.items()}), \
        (cfg, params_from_numpy(jl, "cpu"))


def test_layer_norm_matches():
    rng = np.random.default_rng(0)
    xs = rng.normal(2, 3, (3, 5, 96)).astype(np.float32)
    w, b = (rng.normal(0, 1, 96).astype(np.float32) for _ in range(2))
    want = j_common.layer_norm(jnp.asarray(xs), jnp.asarray(w),
                               jnp.asarray(b), 1e-6)
    _close(common.layer_norm(_t(xs), _t(w), _t(b), 1e-6), want)
    got = common.layer_norm(_t(xs).bfloat16(), _t(w), _t(b), 1e-6)
    assert got.dtype == torch.bfloat16
    want = j_common.layer_norm(jnp.asarray(xs, jnp.bfloat16), jnp.asarray(w),
                               jnp.asarray(b), 1e-6)
    _close(got, want, TOL["bfloat16"])


def test_group_norm_matches():
    """Population variance, as ``jnp.var``."""
    rng = np.random.default_rng(1)
    xs = rng.normal(1, 2, (2, 7, 4 * 24)).astype(np.float32)
    scale = rng.normal(1, 0.5, 96).astype(np.float32)
    want = j_x._group_norm(jnp.asarray(xs), jnp.asarray(scale), 4)
    _close(x._group_norm(_t(xs), _t(scale), 4), want)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    rng = np.random.default_rng(2)
    xs = rng.normal(0, 1, (2, 11, 40)).astype(np.float32)
    w = rng.normal(0, 1, (4, 40)).astype(np.float32)
    b = rng.normal(0, 1, 40).astype(np.float32)
    state = rng.normal(0, 1, (2, 3, 40)).astype(np.float32) \
        if with_state else None
    out, st = x._causal_conv(_t(w), _t(b), _t(xs),
                             None if state is None else _t(state))
    jout, jst = j_x._causal_conv(jnp.asarray(w), jnp.asarray(b),
                                 jnp.asarray(xs),
                                 None if state is None else
                                 jnp.asarray(state))
    _close(out, jout)
    _close(st, jst)


def test_blockdiag_matches():
    rng = np.random.default_rng(3)
    xs = rng.normal(0, 1, (2, 5, 4, 16)).astype(np.float32)
    w = rng.normal(0, 1, (4, 16, 16)).astype(np.float32)
    _close(x._blockdiag(_t(xs), _t(w)),
           j_x._blockdiag(jnp.asarray(xs), jnp.asarray(w)))


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_qkv_gates_matches(with_state):
    (jcfg, jp), (cfg, p) = _block_params("mlstm")
    rng = np.random.default_rng(4)
    xs = rng.normal(0, 1, (2, 12, cfg.d_model)).astype(np.float32)
    conv = rng.normal(0, 1, (2, 3, x.d_inner(cfg))).astype(np.float32) \
        if with_state else None
    got = x._mlstm_qkv_gates(cfg, p, _t(xs),
                             None if conv is None else _t(conv))
    want = j_x._mlstm_qkv_gates(jcfg, jp, jnp.asarray(xs),
                                None if conv is None else jnp.asarray(conv))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    # the layout the kernel takes: unit stride on hd
    assert all(t.stride(-1) == 1 for t in got[:3])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_block_forward_matches(use_pallas, with_state):
    (jcfg, jp), (cfg, p) = _block_params("mlstm")
    jcfg, cfg = (c.replace(use_pallas=use_pallas) for c in (jcfg, cfg))
    rng = np.random.default_rng(5)
    b, s = 2, 64
    xs = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    jstate = state = None
    if with_state:
        nh, hd = cfg.num_heads, x.head_dim(cfg)
        st = {"C": rng.normal(0, 0.3, (b, nh, hd, hd)),
              "n": rng.normal(0, 0.3, (b, nh, hd)),
              "m": rng.normal(0, 1, (b, nh)),
              "conv": rng.normal(0, 1, (b, 3, x.d_inner(cfg)))}
        st = {k: a.astype(np.float32) for k, a in st.items()}
        jstate = {k: jnp.asarray(a) for k, a in st.items()}
        state = {k: _t(a) for k, a in st.items()}
    before = ml_ops.mlstm_chunk.launches
    out, ns = x.mlstm_block_forward(cfg, p, _t(xs), state)
    assert ml_ops.mlstm_chunk.launches == before       # CPU: no launch
    jout, jns = j_x.mlstm_block_forward(jcfg, jp, jnp.asarray(xs), jstate)
    _close(out, jout)
    assert sorted(ns) == sorted(jns)
    for name in jns:
        _close(ns[name], jns[name])


def test_mlstm_block_decode_takes_the_recurrence():
    """S == 1 runs the one-step recurrence (the reference's route), not
    the chunkwise forms, whatever ``use_pallas`` says."""
    (jcfg, jp), (cfg, p) = _block_params("mlstm")
    jcfg, cfg = (c.replace(use_pallas=True) for c in (jcfg, cfg))
    xs = np.random.default_rng(6).normal(0, 1, (3, 1, cfg.d_model)) \
        .astype(np.float32)
    out, ns = x.mlstm_block_forward(cfg, p, _t(xs))
    jout, jns = j_x.mlstm_block_forward(jcfg, jp, jnp.asarray(xs))
    _close(out, jout)
    for name in jns:
        _close(ns[name], jns[name])


def test_slstm_cell_scan_matches():
    (jcfg, jp), (cfg, p) = _block_params("slstm")
    rng = np.random.default_rng(7)
    b, s, d = 2, 20, cfg.d_model
    xs = [rng.normal(0, 1, (b, s, d)).astype(np.float32) for _ in range(4)]
    st = {"c": rng.normal(0, 1, (b, d)), "n": np.abs(rng.normal(1, 1, (b, d))),
          "m": rng.normal(0, 1, (b, d)), "h": rng.normal(0, 1, (b, d))}
    st = {k: a.astype(np.float32) for k, a in st.items()}
    hs, new = x.slstm_cell_scan(p, *map(_t, xs),
                                {k: _t(a) for k, a in st.items()},
                                cfg.num_heads)
    jhs, jnew = j_x.slstm_cell_scan(jp, *map(jnp.asarray, xs),
                                    {k: jnp.asarray(a)
                                     for k, a in st.items()},
                                    jcfg.num_heads)
    _close(hs, jhs)
    for name in jnew:
        _close(new[name], jnew[name])


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_block_forward_matches(with_state):
    (jcfg, jp), (cfg, p) = _block_params("slstm")
    rng = np.random.default_rng(8)
    b, s, d = 2, 16, cfg.d_model
    xs = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    jstate = state = None
    if with_state:
        st = {"c": rng.normal(0, 1, (b, d)),
              "n": np.abs(rng.normal(1, 1, (b, d))),
              "m": rng.normal(0, 1, (b, d)), "h": rng.normal(0, 1, (b, d)),
              "conv": rng.normal(0, 1, (b, 3, d))}
        st = {k: a.astype(np.float32) for k, a in st.items()}
        jstate = {k: jnp.asarray(a) for k, a in st.items()}
        state = {k: _t(a) for k, a in st.items()}
    out, ns = x.slstm_block_forward(cfg, p, _t(xs), state)
    jout, jns = j_x.slstm_block_forward(jcfg, jp, jnp.asarray(xs), jstate)
    _close(out, jout)
    assert sorted(ns) == sorted(jns)
    for name in jns:
        _close(ns[name], jns[name])


# ---------------------------------------------------------------------------
# the reduced xlstm-350m
# ---------------------------------------------------------------------------

def _stack_in_step(jcfg, jp, cfg, p, tokens):
    """Each layer of the stack and the head, the port's fed the reference's
    own input: yields (name, port output, reference output)."""
    jx = jnp.take(jp["embedding"].astype(jcfg.activation_dtype),
                  jnp.asarray(tokens), axis=0)
    for i, (jl, tl) in enumerate(zip(jp["layers"], p["layers"])):
        kind = next(iter(jl))
        jfn = j_x.slstm_block_forward if kind == "slstm" \
            else j_x.mlstm_block_forward
        jout, _ = jax.jit(lambda a, q, f=jfn: f(jcfg, q, a))(jx, jl[kind])
        tin = _t(np.asarray(jx.astype(jnp.float32))).to(cfg.activation_dtype)
        out, _ = x._block(cfg, tl, tin, None)
        yield f"layer {i} ({kind})", out, jout
        jx = jx + jout
    tin = _t(np.asarray(jx.astype(jnp.float32))).to(cfg.activation_dtype)
    want = j_common.layer_norm(jx, jp["ln_final"], jp["ln_final_b"],
                               jcfg.norm_eps) @ jp["lm_head"].astype(jx.dtype)
    yield "head", x._logits(cfg, p, tin), want


def _float64_logits(cfg, p, tokens):
    """The port's forward in float64, the yardstick for how far a float32
    run of the function can be from its exact value: parameters and
    activations in float64, and every fp32 cast of the port's code
    (``.float()``) widened to float64 for the call."""
    p64 = common.map_tree(lambda t: t.double(), p)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        h = p64["embedding"][_t(tokens)]
        for lp in p64["layers"]:
            h = h + x._block(cfg.replace(use_pallas=False), lp, h, None)[0]
        logits = x._logits(cfg, p64, h)
    assert logits.dtype == torch.float64
    return logits.numpy()


def test_xlstm_forward_matches_in_float32():
    """Every layer of the reduced model, fed the reference's own input,
    matches at 5e-5, and the head at 1e-4. End to end the two float32 runs
    are ~1e-3 apart: where an mLSTM head's output is near zero, the group
    norm (eps 1e-6) scales its rounding by ~400x, in both packages. So the
    whole forward is held by its greedy tokens (identical at every
    position) and by its distance from the float64 evaluation of the same
    function: the port's is no larger than the reference's (+1e-4)."""
    (jcfg, _, jp), (cfg, _, p) = _pair_models(use_pallas=True)
    tokens = np.random.default_rng(5).integers(1, 500, (2, 64))
    before = ml_ops.mlstm_chunk.launches
    for name, got, want in _stack_in_step(jcfg, jp, cfg, p, tokens):
        _close(got, want, LOGIT_TOL if name == "head" else TOL["float32"])
    want = np.asarray(jax.jit(
        lambda p, t: j_x.xlstm_forward(jcfg, p, {"tokens": t}))(
        jp, jnp.asarray(tokens)))
    got = _np(x.xlstm_forward(cfg, p, {"tokens": _t(tokens)}))
    assert ml_ops.mlstm_chunk.launches == before       # the plain version
    v = cfg.vocab_size
    np.testing.assert_array_equal(got[..., :v].argmax(-1),
                                  want[..., :v].argmax(-1))
    exact = _float64_logits(cfg, p, tokens)
    assert np.abs(got - exact).max() <= \
        np.abs(want - exact).max() + LOGIT_TOL


def test_xlstm_forward_matches_in_bfloat16():
    """bf16 activations: every layer of the reduced model, fed the
    reference's own input, within the reference's bf16 bar (2e-2) as a
    share of its norm, and the logits bf16 and finite. Elementwise the
    bar does not apply to a whole block: XLA and PyTorch round 28-40% of
    bf16 ``silu`` outputs to different neighbours (measured on this CPU
    over 1e5 normal values), so q and k differ by an ulp here and there,
    and a few of 16,384 block outputs move past 2e-2."""
    (jcfg, _, jp), (cfg, _, p) = _pair_models(use_pallas=True,
                                              dtype="bfloat16")
    tokens = np.random.default_rng(5).integers(1, 500, (2, 64))
    for name, got, want in _stack_in_step(jcfg, jp, cfg, p, tokens):
        assert got.dtype == torch.bfloat16, name
        g, w = _np(got), _np(want)
        err = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        assert err <= TOL["bfloat16"], (name, err)
    logits = x.xlstm_forward(cfg, p, {"tokens": _t(tokens)})
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())


def test_xlstm_loss_and_gradients_match():
    """The loss and the gradient of every parameter leaf, through the
    chunkwise path (the kernel has no backward, as in the reference) and
    the config's remat policy."""
    from repro_torch.training.train_step import value_and_grad

    (jcfg, jb, jp), (cfg, b, p) = _pair_models()
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(1, 500, (2, 48)),
             "labels": rng.integers(1, 500, (2, 48)),
             "mask": (rng.uniform(size=(2, 48)) > 0.2).astype(np.float32)}
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
    # a leaf is held to 1e-4 of its own norm, or of 1e-4 of the whole
    # gradient's: the input-gate biases' gradients vanish by the
    # stabiliser's shift invariance (norms 3e-9 to 2e-3 against 95 here),
    # so what is left of them is rounding in either package
    total = float(np.sqrt(sum(np.sum(np.square(w)) for _, w in want)))
    for (path, w), (key, g) in zip(want, got):
        assert key == "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                               for k in path)
        err = float(np.linalg.norm(_np(g) - w))
        assert err <= GRAD_TOL * max(float(np.linalg.norm(w)),
                                     GRAD_TOL * total), key


def test_kernel_route_refuses_gradients():
    """With ``use_pallas`` the loss reaches the kernel's wrapper, which has
    no backward and says so rather than differentiating the plain path."""
    cfg = reduced_config(ARCH).replace(dtype="float32", use_pallas=True)
    b = build(cfg)
    p = common.map_tree(lambda t: t.requires_grad_(True),
                        b.init_params(0, "cpu"))
    tokens = torch.ones((1, 8), dtype=torch.long)
    with pytest.raises(RuntimeError, match="forward only"):
        b.loss_fn(p, {"tokens": tokens, "labels": tokens})


def _same_state(state, jstate, tol):
    want = jax.tree.leaves(jstate)
    got = [t for _, t in common.tree_leaves(state)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, tol)


def test_xlstm_prefill_and_decode_match():
    """A 64-token prompt (two chunks of 32), then 4 greedy decode steps:
    the logits, the tokens and every state leaf after each step."""
    (jcfg, jb, jp), (cfg, b, p) = _pair_models(use_pallas=True)
    n = 64
    prompt = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, n))
    jlogits, jstate = jax.jit(jb.prefill_fn)(
        jp, {"tokens": jnp.asarray(prompt)}, jb.init_cache(2, 80))
    state = b.init_cache(2, 80, "cpu")
    before = ml_ops.mlstm_chunk.launches
    logits, state = b.prefill_fn(p, {"tokens": _t(prompt)}, state)
    assert ml_ops.mlstm_chunk.launches == before       # CPU: no launch
    _close(logits, jlogits, LOGIT_TOL)
    _same_state(state, jstate, LOGIT_TOL)
    j_decode = jax.jit(jb.decode_fn)
    for step in range(4):
        tok = np.asarray(jlogits[:, -1, :cfg.vocab_size]).argmax(-1)[:, None]
        assert logits[:, -1, :cfg.vocab_size].argmax(-1).tolist() == \
            tok[:, 0].tolist()
        jlogits, jstate = j_decode(jp, jstate, jnp.asarray(tok),
                                   jnp.asarray(n + step, jnp.int32))
        logits, state = b.decode_fn(p, state, _t(tok), torch.tensor(n + step))
        _close(logits, jlogits, LOGIT_TOL)
        _same_state(state, jstate, LOGIT_TOL)


@pytest.mark.parametrize("arch", [ARCH])
def test_prefill_equals_stepwise_decode(arch):
    """Twin of tests/test_serving.py's case for the ssm family: prefilling
    N tokens lands in the same state as feeding them one decode step at a
    time (the port against itself), and the greedy continuation equals the
    reference bundle's."""
    (jcfg, jb, jp), (cfg, bundle, params) = _pair_models(use_pallas=True)
    prefill = make_prefill_step(bundle)
    decode = make_decode_step(bundle)
    n, extra, max_len = 40, 4, 64
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

    # the reference bundle, prefill then greedy decode
    jlogits, jcache = jax.jit(jb.prefill_fn)(
        jp, {"tokens": jnp.asarray(prompt.numpy())},
        jb.init_cache(1, max_len))
    j_decode = jax.jit(jb.decode_fn)
    seq_j = []
    for i in range(extra + 1):
        tok = np.asarray(jlogits[:, -1, :cfg.vocab_size]).argmax(-1)[:, None]
        seq_j.append(int(tok[0, 0]))
        if i < extra:
            jlogits, jcache = j_decode(jp, jcache, jnp.asarray(tok),
                                       jnp.asarray(n + i, jnp.int32))
    assert seq_a == seq_j


def test_init_xlstm_state_matches():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    want = j_x.init_xlstm_state(jcfg, 3, 20)
    got = x.init_xlstm_state(cfg, 3, 20, torch.device("cpu"))
    assert [sorted(s) for s in got] == [sorted(s) for s in want]
    for g, w in zip(got, want):
        for name in w:
            assert tuple(g[name].shape) == w[name].shape
            assert str(g[name].dtype).split(".")[-1] == str(w[name].dtype)
            np.testing.assert_array_equal(_np(g[name]), _np(w[name]))


def test_build_gives_the_xlstm_bundle():
    """The family builds; its cache is ``init_xlstm_state``'s, on the
    device asked for."""
    cfg = reduced_config(ARCH)
    b = build(cfg)
    assert len(b.specs["layers"]) == 8 and "slstm" in b.specs["layers"][7]
    got = b.init_cache(2, 16, "cpu")
    want = x.init_xlstm_state(cfg, 2, 16, torch.device("cpu"))
    assert [sorted(s) for s in got] == [sorted(s) for s in want]
    for g, w in zip(got, want):
        for name in w:
            assert g[name].dtype == w[name].dtype
            assert torch.equal(g[name], w[name])


def test_scheduler_refuses_the_xlstm():
    cfg = reduced_config(ARCH)
    bundle = build(cfg)
    with pytest.raises(ValueError, match="recurrent"):
        BatchScheduler(bundle, bundle.init_params(0, "cpu"), batch_size=1,
                       max_len=16, device="cpu")


def test_xlstm_entry_points_without_device_raise_where_there_is_no_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = build(reduced_config(ARCH))
    for call in (lambda: b.init_params(0), lambda: b.init_cache(1, 16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------

def test_params_bridge_round_trips_the_xlstm_tree():
    (_, jb, jp), (_, b, p) = _pair_models()
    ref = jax.tree.map(np.asarray, jp)
    assert isinstance(p["layers"], list) and len(p["layers"]) == 8
    assert [sorted(lp) for lp in p["layers"]] == \
        [["mlstm"]] * 7 + [["slstm"]]
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


def test_cast_for_compute_keeps_the_xlstms_fp32_leaves():
    """The leaves the reference reads in fp32 stay fp32; the rest go to
    the activation dtype once."""
    cfg = reduced_config(ARCH)
    p = build(cfg).init_params(0, "cpu")
    cast = common.cast_for_compute(p, torch.bfloat16, torch.device("cpu"))
    fp32 = {"ln", "ln_b", "conv_w", "conv_b", "w_i", "b_i", "w_f", "b_f",
            "gn_scale", "r_i", "r_f", "r_z", "r_o", "b_z", "b_o",
            "ln_final", "ln_final_b"}
    for key, t in common.tree_leaves(cast):
        want = torch.float32 if key.split("/")[-1] in fp32 \
            else torch.bfloat16
        assert t.dtype == want, key
    assert fp32 <= common.FP32_LEAVES


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_bf16_serving_keeps_the_fp32_leaves(kind):
    """Random init hides the fp32 leaves (``b_f``, ``gn_scale`` and the
    biases are ones or zeros), so they are perturbed here. A bf16 serving
    step of a block from its state, with the weights cast once by
    ``cast_for_compute``, holds its output and every fp32 state leaf to
    the reference (which casts at each use) within 2e-2 of their norms;
    with every leaf rounded to bf16 instead, each of them lands farther
    from the reference (about twice as far, measured)."""
    (jcfg, jp), (cfg, p) = _block_params(kind, 3)
    jcfg, cfg = (c.replace(dtype="bfloat16", use_pallas=True)
                 for c in (jcfg, cfg))
    xs = np.random.default_rng(1).normal(0, 1, (2, 64, cfg.d_model)) \
        .astype(np.float32)
    i = 0 if kind == "mlstm" else 7
    jfn = j_x.mlstm_block_forward if kind == "mlstm" \
        else j_x.slstm_block_forward
    jout, jnew = jfn(jcfg, jp, jnp.asarray(xs, jnp.bfloat16),
                     j_x.init_xlstm_state(jcfg, 2, 64)[i])

    def err(a, b):
        return float(np.linalg.norm(_np(a) - _np(b)) / np.linalg.norm(_np(b)))

    def run(params):
        state = x.init_xlstm_state(cfg, 2, 64, torch.device("cpu"))[i]
        out, new = x._block(cfg, {kind: params}, _t(xs).bfloat16(), state)
        return {"out": err(out, jout)} | {
            name: err(new[name], jnew[name]) for name in jnew
            if name != "conv"}

    kept = run(common.cast_for_compute(p, torch.bfloat16,
                                       torch.device("cpu")))
    rounded = run({name: t.bfloat16() for name, t in p.items()})
    for name, e in kept.items():
        assert e <= TOL["bfloat16"], (name, e)
        assert e < rounded[name], (name, e, rounded[name])


def test_xlstm_module_imports_no_jax():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    prog = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.abspath(src)!r})
        import repro_torch.models.xlstm
        import repro_torch.kernels.mlstm_chunk.ops
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print("BAD", bad)
    """)
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout
