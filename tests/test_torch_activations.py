"""The port's activations against the reference's ``jax.nn`` functions,
on the CPU.

``jax.nn.sigmoid``, ``silu`` and ``gelu`` round each of their ops to the
input's dtype (their compiled HLO converts to bf16 after every negate,
exp, add, divide, multiply and tanh); a fused torch activation rounds once
at the end. The recipe: 65,536 values, ``standard_normal * 3`` from numpy
seed 0. In bf16 the port's ``sigmoid``, ``silu``, ``gelu_tanh`` and
``gelu_exact`` must equal the reference's element for element; in float32,
where the port takes the fused torch op (``gelu_exact`` excepted), they
agree within 1e-6 (XLA's and PyTorch's ``exp``, ``tanh`` and ``erfc``
differ by an ulp).

Each rewritten call site's activation step is held alone, fed the same
pre-activation from numpy: SwiGLU and GeGLU (``act(g) * u``, bf16), the
hybrid's GELU branch (bf16), the RG-LRU gates and the sLSTM's output gate
(float32 at their sites: within 1e-6), the xLSTM's SiLUs and gated GeLU
(bf16). Whole layers stay at the 2e-2 bar of their own tests, because
their matmuls round differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import common as j_common
from repro.models import rglru as j_rglru
from repro_torch.models import common, rglru

N = 65_536


def _values(seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(N) * 3).astype(
        np.float32)


def _bf16_pair(x: np.ndarray):
    """The same bf16 values in both packages."""
    return jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


PAIRS = {
    "sigmoid": (jax.nn.sigmoid, common.sigmoid),
    "silu": (jax.nn.silu, common.silu),
    "gelu_tanh": (jax.nn.gelu, common.gelu_tanh),
    "gelu_exact": (lambda v: jax.nn.gelu(v, approximate=False),
                   common.gelu_exact),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_activation_is_bit_equal_in_bf16(name):
    fj, ft = PAIRS[name]
    xj, xt = _bf16_pair(_values())
    out = ft(xt)
    assert out.dtype == torch.bfloat16
    mism = np.mean(_np(fj(xj)) != _np(out))
    assert mism == 0.0, f"{name}: {mism:.2%} of bf16 elements differ"


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_activation_agrees_in_float32(name):
    fj, ft = PAIRS[name]
    x = _values()
    np.testing.assert_allclose(_np(ft(torch.from_numpy(x))),
                               np.asarray(fj(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_exact"])
def test_act_fn_entries_match_the_reference(name):
    """Every ``_ACTS`` entry: bit-equal in bf16, 1e-6 in float32."""
    x = _values(1)
    xj, xt = _bf16_pair(x)
    fj, ft = j_common.act_fn(name), common.act_fn(name)
    assert np.array_equal(_np(fj(xj)), _np(ft(xt))), name
    np.testing.assert_allclose(_np(ft(torch.from_numpy(x))),
                               np.asarray(fj(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


def test_fused_torch_activations_are_what_was_replaced():
    """The measured size of the fault: the fused forms differ from the
    reference in a third to two fifths of the bf16 elements."""
    xj, xt = _bf16_pair(_values())
    for fj, fused in ((jax.nn.sigmoid, torch.sigmoid), (jax.nn.silu, F.silu),
                      (jax.nn.gelu, lambda v: F.gelu(v, approximate="tanh"))):
        mism = np.mean(_np(fj(xj)) != _np(fused(xt)))
        assert 0.3 < mism < 0.45, mism


# --- call sites --------------------------------------------------------------

def _pre(shape, seed, dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 3).astype(dtype)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp_step_is_bit_equal_in_bf16(act):
    """SwiGLU / GeGLU: ``act(g) * u`` on bf16 pre-activations, as
    ``mlp_forward`` and ``moe_forward`` compute it between their
    matmuls."""
    g, u = _pre((4, 16, 256), 2), _pre((4, 16, 256), 3)
    gj, gt = _bf16_pair(g)
    uj, ut = _bf16_pair(u)
    ref = j_common.act_fn(act)(gj) * uj
    out = common.act_fn(act)(gt) * ut
    assert np.array_equal(_np(ref), _np(out))


def test_hybrid_gelu_branch_is_bit_equal_in_bf16():
    """The recurrent block's GELU branch (reference ``rglru.py:180``)."""
    yj, yt = _bf16_pair(_pre((2, 32, 128), 4))
    assert np.array_equal(_np(jax.nn.gelu(yj)), _np(common.gelu_tanh(yt)))


def test_rglru_gates_match_the_reference():
    """The RG-LRU gates (reference ``rglru.py:115-116``) run in float32 on
    a bf16 input: the port's ``rglru_gates`` against the reference's, the
    same parameters through numpy."""
    nb, blk = 4, 32
    rng = np.random.default_rng(5)
    p = {"w_a": rng.standard_normal((nb, blk, blk)).astype(np.float32) / 6,
         "w_i": rng.standard_normal((nb, blk, blk)).astype(np.float32) / 6,
         "b_a": rng.standard_normal(nb * blk).astype(np.float32),
         "b_i": rng.standard_normal(nb * blk).astype(np.float32),
         "lam": rng.standard_normal(nb * blk).astype(np.float32)}
    xj, xt = _bf16_pair(_pre((2, 16, nb * blk), 6))
    aj, bj = j_rglru.rglru_gates({k: jnp.asarray(v) for k, v in p.items()},
                                 xj)
    at, bt = rglru.rglru_gates({k: torch.from_numpy(v)
                                for k, v in p.items()}, xt)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6,
                               rtol=1e-6)


def test_slstm_output_gate_matches_in_float32():
    """The sLSTM's output gate (reference ``xlstm.py:350``):
    ``sigmoid(xo + ro)`` on float32 pre-activations."""
    x = _pre((4, 512), 7)
    np.testing.assert_allclose(
        common.sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.sigmoid(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("site", ["conv_silu", "z_gate", "gated_gelu"])
def test_xlstm_bf16_steps_are_bit_equal(site):
    """The xLSTM's bf16 activation steps: the mLSTM's and sLSTM's SiLU
    after the causal conv (reference ``xlstm.py:276``, ``:376``), the
    mLSTM's output gate ``h * silu(z)`` (``:318``) and the sLSTM's gated
    GeLU ``gelu(u1) * u2`` (``:398``)."""
    aj, at = _bf16_pair(_pre((2, 8, 192), 8))
    bj, bt = _bf16_pair(_pre((2, 8, 192), 9))
    if site == "conv_silu":
        ref, out = jax.nn.silu(aj), common.silu(at)
    elif site == "z_gate":
        ref, out = bj * jax.nn.silu(aj), bt * common.silu(at)
    else:
        ref, out = jax.nn.gelu(aj) * bj, common.gelu_tanh(at) * bt
    assert np.array_equal(_np(ref), _np(out))
