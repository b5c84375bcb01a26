"""The port's MoE layer against the reference, on the CPU: the twin of
``tests/test_moe.py`` (routing, capacity, gradient hygiene, the two
sharding strategies) for the reduced ``moonshot-v1-16b-a3b`` and
``grok-1-314b``, and parity of ``moe_forward``'s output, aux loss and
gradients with ``repro.models.mlp.moe_forward``.

Parameters come from the reference's init and cross through numpy;
inputs are made with numpy from fixed seeds. float32 is held at 5e-5,
bfloat16 at 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import mlp as JM
from repro.models.common import init_params as j_init_params
from repro_torch.configs import reduced_config
from repro_torch.models import mlp as M
from repro_torch.models.convert import params_from_numpy

ARCHS = ["moonshot-v1-16b-a3b", "grok-1-314b"]
SHARDINGS = ["expert", "ffn"]
TOL = {"float32": 5e-5, "bfloat16": 2e-2}


def _setup(arch, moe_sharding="expert", capacity_factor=4.0, **over):
    """(reference cfg, params), (port cfg, params): the reference's init
    of the layer, bridged."""
    over = dict(dtype="float32", param_dtype="float32",
                moe_sharding=moe_sharding,
                moe_capacity_factor=capacity_factor) | over
    jcfg = j_reduced(arch).replace(**over)
    jp = j_init_params(jax.random.PRNGKey(0), JM.make_moe_specs(jcfg),
                       jnp.float32)
    cfg = reduced_config(arch).replace(**over)
    return (jcfg, jp), (cfg, params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"))


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (*shape, cfg.d_model)).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# the twin of tests/test_moe.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_shape_and_finite(arch):
    _, (cfg, params) = _setup(arch)
    x = torch.from_numpy(_x(cfg, (2, 16), 1))
    out, aux = M.moe_forward(cfg, params, x)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(aux) > 0.0        # load-balance loss positive


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_strategies_numerically_identical(arch):
    """EP vs TP-in-expert is a sharding choice, not a math choice."""
    _, (cfg_ep, params) = _setup(arch, "expert")
    cfg_tp = cfg_ep.replace(moe_sharding="ffn")
    x = torch.from_numpy(_x(cfg_ep, (2, 16), 2))
    out_ep, aux_ep = M.moe_forward(cfg_ep, params, x)
    out_tp, aux_tp = M.moe_forward(cfg_tp, params, x)
    np.testing.assert_allclose(_np(out_ep), _np(out_tp), atol=1e-6)
    assert float(aux_ep) == float(aux_tp)
    assert M.make_moe_specs(cfg_ep).keys() == M.make_moe_specs(cfg_tp).keys()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_token_permutation_equivariance(arch):
    """Permuting tokens permutes outputs (at ample capacity)."""
    _, (cfg, params) = _setup(arch, capacity_factor=8.0, moe_group_size=32)
    x = torch.from_numpy(_x(cfg, (1, 32), 3))
    out, _ = M.moe_forward(cfg, params, x)
    perm = np.random.default_rng(0).permutation(32)
    out_p, _ = M.moe_forward(cfg, params, x[:, perm])
    np.testing.assert_allclose(_np(out_p), _np(out)[:, perm], atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_capacity_drops_overflow_tokens(arch):
    """Capacity floors at 4 slots: a tiny factor drops most tokens, so the
    output's norm is far smaller; with every choice dropped a token's
    output is zero."""
    _, (cfg, params) = _setup(arch, capacity_factor=1e-9)
    assert M._capacity(cfg, 64) == 4
    x = torch.from_numpy(_x(cfg, (1, 64), 4))
    out_low, _ = M.moe_forward(cfg, params, x)
    out_hi, _ = M.moe_forward(cfg.replace(moe_capacity_factor=8.0), params,
                              x)
    assert float(out_low.norm()) < 0.8 * float(out_hi.norm())
    # E experts x 4 slots hold at most 4E choices: the last tokens of the
    # group find every chosen buffer full
    dropped = out_low[0].abs().sum(-1) == 0
    assert int(dropped.sum()) >= 64 - 4 * cfg.num_experts
    assert not bool(dropped[:2].any())      # the first tokens always fit


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_router_gradient_flows_but_onehots_blocked(arch, monkeypatch):
    _, (cfg, params) = _setup(arch)
    x = torch.from_numpy(_x(cfg, (1, 16), 5))
    hots = []
    one_hot = M._one_hot

    def watched(index, n):
        hots.append(one_hot(index, n))
        return hots[-1]

    monkeypatch.setattr(M, "_one_hot", watched)
    live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out, aux = M.moe_forward(cfg, live, x)
    (out.square().sum() + 0.01 * aux).backward()
    router_g = float(live["router"].grad.abs().sum())
    expert_g = float(live["w_gate"].grad.abs().sum())
    assert router_g > 0.0, "router must learn through topw + aux loss"
    assert expert_g > 0.0
    assert np.isfinite(router_g) and np.isfinite(expert_g)
    # the routing one-hots (top-1, selection, capacity slot) carry no graph
    assert len(hots) == 3
    assert not any(h.requires_grad for h in hots)


# ---------------------------------------------------------------------------
# parity with the reference's moe_forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("moe_sharding", SHARDINGS)
@pytest.mark.parametrize("capacity_factor", [4.0, 1.25, 1e-9])
def test_moe_forward_and_grads_match_reference(arch, moe_sharding,
                                               capacity_factor):
    """Output, aux loss and the gradients of every parameter and of x, in
    float32, at ample, the published and the floor capacity (the same
    tokens dropped)."""
    (jcfg, jp), (cfg, p) = _setup(arch, moe_sharding, capacity_factor)
    x = _x(cfg, (2, 48), 6)       # 96 tokens: groups of 64 halve to 32

    def j_loss(pp, xx):
        out, aux = JM.moe_forward(jcfg, pp, xx)
        return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)

    (_, (j_out, j_aux)), (j_gp, j_gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = M.moe_forward(cfg, live, tx)
    (out.square().sum() + 0.01 * aux).backward()
    tol = TOL["float32"]
    np.testing.assert_allclose(_np(out), np.asarray(j_out), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(float(aux.detach()), float(j_aux), atol=tol,
                               rtol=tol)
    for name, t in live.items():
        want = np.asarray(j_gp[name])
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(_np(t.grad), want, atol=tol * scale,
                                   rtol=tol, err_msg=name)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(j_gx), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_bf16_matches_reference(arch):
    (jcfg, jp), (cfg, p) = _setup(arch, dtype="bfloat16")
    x = _x(cfg, (2, 32), 7)
    j_out, j_aux = JM.moe_forward(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    out, aux = M.moe_forward(cfg, p, torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(_np(out), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(float(aux), float(j_aux), atol=tol, rtol=tol)


def test_top_k_orders_ties_like_lax_top_k():
    """Equal router probabilities: the lower expert index comes first, as
    in ``lax.top_k``, so the port and the reference pick the same
    experts."""
    probs = np.asarray([[0.25, 0.25, 0.25, 0.25],
                        [0.1, 0.4, 0.1, 0.4],
                        [0.3, 0.2, 0.3, 0.2],
                        [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        jw, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tw, ti = M.top_k_stable(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("tokens", [1, 4, 96, 700, 1024, 3008, 8192])
def test_groups_and_capacity_match_reference(tokens):
    """The group size (halved until it divides the tokens) and the
    capacity, at the serving and training token counts."""
    for arch in ("moonshot-v1-16b-a3b", "grok-1-314b"):
        from repro.configs import get_config as j_get_config
        from repro_torch.configs import get_config

        jcfg, cfg = j_get_config(arch), get_config(arch)
        g = M._group_size(cfg, tokens)
        want = min(jcfg.moe_group_size, tokens)
        while tokens % want:
            want //= 2
        assert g == want
        assert M._capacity(cfg, g) == JM._capacity(jcfg, g)


def test_moe_specs_match_reference():
    for arch in ARCHS:
        for sharding in SHARDINGS:
            jcfg = j_reduced(arch).replace(moe_sharding=sharding)
            cfg = reduced_config(arch).replace(moe_sharding=sharding)
            mine, ref = M.make_moe_specs(cfg), JM.make_moe_specs(jcfg)
            assert sorted(mine) == sorted(ref)
            for k in ref:
                assert mine[k].shape == ref[k].shape
                assert mine[k].axes == ref[k].axes
                assert mine[k].init == ref[k].init
