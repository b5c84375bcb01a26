"""The port's training path against the reference, on the CPU.

Loss, remat, optimisers, the train step, checkpoints, the data stream and
the launcher. Parameters come from the reference's init and cross through
numpy; batches are made with numpy from fixed seeds. The reduced
``aiida-demo-110m`` runs in float32, and the reference's Pallas kernels in
interpret mode. Losses are held at rtol 1e-5 and gradients at 1e-4 of
each leaf's norm: the two frameworks sum in different orders (with the
attention projections fan-in scaled, see ``_fan_in_scaled``, they agree
to ~1e-6).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import common as j_common
from repro.models import transformer as j_tf
from repro.models.registry import build as j_build
from repro.training import checkpoint as j_ckpt
from repro.training import optim as J
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import TokenStream as JTokenStream
from repro.training.train_step import TrainConfig as JTrainConfig
from repro.training.train_step import init_train_state as j_init_state
from repro.training.train_step import make_train_step as j_make_step
from repro_torch.configs import reduced_config
from repro_torch.launch import train as launch_train
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optim as O
from repro_torch.training.data import (DataConfig, TokenStream,
                                       deserialize_state, serialize_state)
from repro_torch.training.train_step import (TrainConfig, _accumulate,
                                             _split_microbatches,
                                             init_train_state,
                                             make_train_step, value_and_grad)

ARCH = "aiida-demo-110m"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _leaves(tree) -> dict[str, np.ndarray]:
    """Path -> numpy leaf, for a torch tree or a JAX/numpy tree."""
    if isinstance(next(iter(_flat(tree).values())), torch.Tensor):
        return {k: v.detach().float().numpy() if v.is_floating_point()
                else v.numpy() for k, v in tree_leaves(tree)}
    return {k: np.asarray(v) for k, v in _flat(tree).items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _fan_in_scaled(cfg, tree):
    """``tree`` (numpy) with the attention projections rescaled to std
    1/sqrt(the fan-in they contract over). The reference's init takes the
    fan-in from the stacked leaf's shape[-2] (heads for wq/wk/wv,
    head_dim for wo), which makes attention logits so large that float32
    rounding differences between the frameworks grow to ~1e-4 of the
    gradients; with this scale they stay at ~1e-6."""
    attn = tree["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        attn[name] = attn[name] * np.float32(
            (attn[name].shape[-2] / cfg.d_model) ** 0.5)
    attn["wo"] = attn["wo"] * np.float32(
        (attn["wo"].shape[-2] / (cfg.num_heads * cfg.hd)) ** 0.5)
    return tree


def _pair_models(seed=0, arch=ARCH, **over):
    """(reference cfg, bundle, params), (port cfg, bundle, params): the
    reference's init, fan-in scaled, in both packages."""
    over = dict(dtype="float32", kv_cache_dtype="float32") | over
    jcfg = j_reduced(arch).replace(**over)
    jb = j_build(jcfg)
    params = _fan_in_scaled(jcfg, _np_tree(
        jb.init_params(jax.random.PRNGKey(seed))))
    cfg = reduced_config(arch).replace(**over)
    return ((jcfg, jb, jax.tree.map(jnp.asarray, params)),
            (cfg, build(cfg), params_from_numpy(params, "cpu")))


def _batch(cfg, b=2, s=32, seed=0, mask=False):
    """Tokens and labels of ``s`` text positions (and a VLM's patch
    embeddings before them)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    if mask:
        out["mask"] = (rng.random((b, s)) > 0.3).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            0, 1, (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_softmax_cross_entropy_matches_reference(dtype, with_mask):
    """Padded vocab (500 real of 768) and a mask, incl. a fully masked row."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (3, 16, 768)).astype(np.float32)
    labels = rng.integers(0, 500, (3, 16)).astype(np.int32)
    mask = (rng.random((3, 16)) > 0.4).astype(np.float32) if with_mask \
        else None
    if mask is not None:
        mask[1] = 0.0
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    tl = _t(logits).to(getattr(torch, dtype))
    want, wden = j_common.softmax_cross_entropy(
        jl, jnp.asarray(labels), None if mask is None else jnp.asarray(mask),
        500)
    got, den = common.softmax_cross_entropy(
        tl, _t(labels), None if mask is None else _t(mask), 500)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert den.item() == float(wden)


def test_softmax_cross_entropy_all_masked_is_zero_over_one():
    logits = torch.zeros(1, 4, 256)
    loss, den = common.softmax_cross_entropy(
        logits, torch.zeros(1, 4, dtype=torch.long), torch.zeros(1, 4), 256)
    assert loss.item() == 0.0 and den.item() == 1.0


#: the dense archs beside aiida-demo-110m, the reduced MoE and VLM
LOSS_ARCHS = ["qwen3-4b", "qwen2-0.5b", "granite-3-2b", "deepseek-67b",
              "moonshot-v1-16b-a3b", "grok-1-314b", "llava-next-34b"]
#: every route for aiida-demo-110m; for each other arch the plain CE with
#: direct attention and the chunked CE with the kernel route
LOSS_CASES = [(ARCH, a, c) for c in (0, 8) for a in ("direct", "pallas")] + [
    (arch, a, c) for arch in LOSS_ARCHS
    for a, c in (("direct", 0), ("pallas", 8))]
#: (loss rtol, each gradient leaf's error over its norm): aiida-demo-110m,
#: and every other arch
LOSS_TOL = {ARCH: (1e-5, 1e-4), None: (1e-4, 1e-3)}


@pytest.mark.parametrize(
    "arch,attn_impl,ce_chunk", LOSS_CASES,
    ids=[f"{c}-{a}" if arch == ARCH else f"{arch}-{c}-{a}"
         for arch, a, c in LOSS_CASES])
def test_lm_loss_and_grads_match_reference(arch, attn_impl, ce_chunk):
    """Loss, its metrics (the MoE's aux loss among them) and every
    gradient leaf; a VLM's loss is taken on its text positions only."""
    (jcfg, _, jp), (cfg, _, p) = _pair_models(arch=arch, attn_impl=attn_impl,
                                              ce_chunk=ce_chunk)
    batch = _batch(cfg, mask=ce_chunk > 0)
    loss_tol, grad_tol = LOSS_TOL.get(arch, LOSS_TOL[None])
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda pp, bb: j_tf.lm_loss(jcfg, pp, bb), has_aux=True))(
            jp, jax.tree.map(jnp.asarray, batch))
    live = common.map_tree(lambda t: t.requires_grad_(True), p)
    loss, met = tf.lm_loss(cfg, live, {k: _t(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=loss_tol)
    for name in ("ce_loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(met[name].item(), float(jmet[name]),
                                   rtol=loss_tol, atol=1e-7)
    if cfg.family == "moe":
        assert met["aux_loss"].item() > 0.0
    want = _leaves(jgrads)
    for key, t in tree_leaves(live):
        assert _rel(t.grad.numpy(), want[key]) < grad_tol, key


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

POLICIES = ["off", "none", "nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable", "everything_saveable"]


def test_remat_policies_leave_gradients_unchanged():
    cfg = reduced_config(ARCH).replace(dtype="float32", attn_impl="pallas")
    bundle = build(cfg)
    params = bundle.init_params(0, "cpu")
    batch = {k: _t(v) for k, v in _batch(cfg).items()}
    runs = {}
    for name in POLICIES:
        b = build(cfg.replace(remat_policy=name))
        (loss, _), grads = value_and_grad(b, params, batch)
        runs[name] = (loss, dict(tree_leaves(grads)))
    loss0, g0 = runs["off"]
    for name, (loss, g) in runs.items():
        torch.testing.assert_close(loss, loss0, atol=0, rtol=1e-6)
        for key in g0:
            torch.testing.assert_close(g[key], g0[key], atol=1e-7,
                                       rtol=1e-5, msg=f"{name} {key}")


def test_remat_policy_names_match_reference():
    for name in POLICIES[1:]:
        j_common.remat_policy(name)           # the reference accepts it
        common.remat_policy(name)
    for mod in (j_common, common):
        with pytest.raises(ValueError, match="unknown remat policy"):
            mod.remat_policy("sometimes")


# ---------------------------------------------------------------------------
# optimisers (the cases of tests/test_optim.py, as parity)
# ---------------------------------------------------------------------------

def _both_update(cfg_kw, params, grads, steps=1, name="adamw"):
    """Run the reference's and the port's update ``steps`` times."""
    jcfg, tcfg = J.OptimConfig(name=name, **cfg_kw), O.OptimConfig(
        name=name, **cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    js, ts = J.opt_init(jcfg, jp), O.opt_init(tcfg, tp)
    for step in range(steps):
        g = grads(step)
        jp, js, jlr = J.opt_update(jcfg, {k: jnp.asarray(v) for k, v in
                                          g.items()}, js, jp,
                                   jnp.asarray(step))
        tp, ts, tlr = O.opt_update(tcfg, {k: _t(v) for k, v in g.items()},
                                   ts, tp, torch.tensor(step))
        np.testing.assert_allclose(tlr.item(), float(jlr), rtol=1e-6)
    return (jp, js), (tp, ts)


def test_adamw_matches_reference_math():
    kw = dict(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
              warmup_steps=1, total_steps=10**9)
    (jp, js), (tp, ts) = _both_update(
        kw, {"w": np.asarray([1.0, -2.0], np.float32)},
        lambda _: {"w": np.asarray([0.5, 0.5], np.float32)})
    np.testing.assert_allclose(tp["w"].numpy(), [0.9, -2.1], atol=1e-6)
    np.testing.assert_allclose(ts["mu"]["w"].numpy(), [0.05, 0.05],
                               atol=1e-7)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               atol=1e-7)
    np.testing.assert_allclose(ts["nu"]["w"].numpy(),
                               np.asarray(js["nu"]["w"]), rtol=1e-6)


def test_adamw_weight_decay_decoupled():
    kw = dict(lr=0.1, weight_decay=0.5, warmup_steps=1, total_steps=10**9)
    (jp, _), (tp, _) = _both_update(
        kw, {"w": np.asarray([2.0], np.float32)},
        lambda _: {"w": np.asarray([0.0], np.float32)})
    np.testing.assert_allclose(tp["w"].numpy(), [2.0 - 0.1 * 0.5 * 2.0],
                               atol=1e-6)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               atol=1e-7)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimiser_trajectory_matches_reference(name):
    """Ten steps on a tree of a matrix, a stacked 3-D leaf and a vector,
    with weight decay, warmup and cosine decay."""
    rng = np.random.default_rng(1)
    params = {"m": rng.normal(size=(6, 5)).astype(np.float32),
              "s": rng.normal(size=(2, 4, 3)).astype(np.float32),
              "v": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(10)]
    kw = dict(lr=0.05, warmup_steps=3, total_steps=10)
    (jp, js), (tp, ts) = _both_update(kw, params, grads.__getitem__,
                                      steps=10, name=name)
    for key, want in _leaves(jp).items():
        np.testing.assert_allclose(tp[key].numpy(), want, rtol=1e-5,
                                   atol=1e-6)
    for key, want in _leaves(js).items():
        np.testing.assert_allclose(_leaves(ts)[key], want, rtol=1e-5,
                                   atol=1e-7)


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros(64, 128), "b": torch.zeros(128)}
    state = O.adafactor_init(params)
    jstate = J.adafactor_init({k: jnp.zeros(v.shape) for k, v in
                               params.items()})
    assert state["fac"]["w"]["vr"].shape == (64,)
    assert state["fac"]["w"]["vc"].shape == (128,)
    assert state["fac"]["b"]["v"].shape == (128,)
    assert {k: v.shape for k, v in _leaves(state).items()} == \
        {k: v.shape for k, v in _leaves(jstate).items()}
    n_state = sum(x.numel() for _, x in tree_leaves(state))
    assert n_state < sum(x.numel() for x in params.values()) / 10


def test_adafactor_reduces_loss():
    cfg = O.OptimConfig(name="adafactor", lr=0.05, warmup_steps=1,
                        total_steps=1000)
    w = {"w": _t(np.random.default_rng(0).normal(size=(8, 8))
                 .astype(np.float32))}
    state = O.opt_init(cfg, w)
    target = torch.eye(8)

    def loss(p):
        return ((p["w"] - target) ** 2).sum()

    l0 = loss(w).item()
    for step in range(60):
        live = {"w": w["w"].clone().requires_grad_(True)}
        g = {"w": torch.autograd.grad(loss(live), live["w"])[0]}
        w, state, _ = O.opt_update(cfg, g, state, w, torch.tensor(step))
    assert loss(w).item() < l0 * 0.3


def test_grad_clip_matches_reference():
    tree = {"a": torch.tensor([3.0, 4.0]), "b": {"c": torch.tensor([0.0])}}
    clipped, norm = O.clip_by_global_norm(tree, 1.0)
    assert norm.item() == pytest.approx(5.0)
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.8], atol=1e-6)
    clipped2, _ = O.clip_by_global_norm(tree, 10.0)
    np.testing.assert_allclose(clipped2["a"].numpy(), [3.0, 4.0])
    jc, jn = J.clip_by_global_norm({"a": jnp.asarray([3.0, 4.0]),
                                    "b": {"c": jnp.asarray([0.0])}}, 1.0)
    assert norm.item() == float(jn)
    np.testing.assert_array_equal(clipped["a"].numpy(), np.asarray(jc["a"]))


@pytest.mark.parametrize("step", [1, 2, 50, 99, 100, 101, 500, 999, 1000])
def test_lr_schedule_properties(step):
    cfg = O.OptimConfig(lr=1e-3, warmup_steps=100, total_steps=1000,
                        min_lr_ratio=0.1)
    lr = O.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    assert lr.dtype == torch.float32
    lr = lr.item()
    assert 0.0 < lr <= cfg.lr * (1.0 + 1e-6)
    if step >= cfg.warmup_steps:
        assert lr >= cfg.lr * cfg.min_lr_ratio * 0.99
    want = float(J.lr_schedule(J.OptimConfig(
        lr=1e-3, warmup_steps=100, total_steps=1000, min_lr_ratio=0.1),
        jnp.asarray(step)))
    np.testing.assert_allclose(lr, want, rtol=1e-6)


def test_lr_schedule_monotone_warmup():
    cfg = O.OptimConfig(lr=1e-3, warmup_steps=50, total_steps=1000)
    lrs = [O.lr_schedule(cfg, torch.tensor(s)).item() for s in range(0, 49)]
    assert all(b > a for a, b in zip(lrs, lrs[1:]))
    assert lrs[0] > 0.0


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _port_grads(bundle, params, batch, n, clip):
    """The clipped gradients the port's step uses, for the sign-flip rule."""
    if n > 1:
        grads = common.map_tree(torch.zeros_like, params)
        for mb in _split_microbatches(batch, n):
            grads = _accumulate(grads, value_and_grad(bundle, params,
                                                       mb)[1], n)
    else:
        grads = value_and_grad(bundle, params, batch)[1]
    return O.clip_by_global_norm(grads, clip)[0]


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(opt, microbatches):
    """Two steps from the reference's parameters on the same batches: loss,
    grad_norm, lr and every metric after each step; parameters after each.

    The sign-flip rule: at step 1 AdamW's mu_hat / sqrt(nu_hat) is
    g / (|g| + eps), +-1 for every entry whose gradient is well above eps
    (and Adafactor's update of a vector leaf is g / |g|), so a gradient
    entry at rounding level whose sign differs between the two frameworks
    moves its parameter by 2 lr. More generally a difference d in an entry
    g moves the update by about d / |g| of lr, up to that 2 lr. The
    gradients agree to ~1e-6 of their leaf's norm (see
    ``test_lm_loss_and_grads_match_reference``), so each entry may differ
    by 1e-5 plus the sum of the steps' lr times min(2, 1e-5 max|g| / |g|),
    with |g| its smallest clipped gradient over the steps taken."""
    (jcfg, jb, jp), (cfg, b, p) = _pair_models(attn_impl="pallas")
    ocfg = dict(name=opt, lr=1e-2, warmup_steps=2, total_steps=10)
    jt = JTrainConfig(optim=J.OptimConfig(**ocfg), microbatches=microbatches)
    tt = TrainConfig(optim=O.OptimConfig(**ocfg), microbatches=microbatches)
    jstate = j_init_state(jb, jt, jax.random.PRNGKey(0))
    jstate["params"] = jp
    tstate = {"step": torch.zeros((), dtype=torch.int32), "params": p,
              "opt": O.opt_init(tt.optim, p)}
    jstep, tstep = jax.jit(j_make_step(jb, jt)), make_train_step(b, tt)
    g_min = {k: np.full(v.shape, np.inf) for k, v in _leaves(p).items()}
    lr_sum = 0.0
    for i in range(2):
        batch = _batch(cfg, b=4, s=16, seed=10 + i)
        tb = {k: _t(v) for k, v in batch.items()}
        for key, g in tree_leaves(_port_grads(b, tstate["params"], tb,
                                              microbatches, 1.0)):
            g = g.abs().numpy()
            g_min[key] = np.minimum(g_min[key], g / max(g.max(), 1e-30))
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tmet = tstep(tstate, tb)
        for name in ("loss", "grad_norm", "lr", "ce_loss", "aux_loss",
                     "tokens"):
            assert tmet[name].dtype == torch.float32
            np.testing.assert_allclose(tmet[name].item(), float(jmet[name]),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        lr_sum += float(jmet["lr"])
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        want = _leaves(jstate["params"])
        for key, got in _leaves(tstate["params"]).items():
            flip = np.minimum(2.0, 1e-5 / np.maximum(g_min[key], 1e-30))
            tol = 1e-5 + lr_sum * flip
            diff = np.abs(got - want[key])
            assert (diff <= tol).all(), (key, float(diff.max()))


def test_init_train_state_shapes_match_reference():
    cfg = reduced_config(ARCH)
    jcfg = j_reduced(ARCH)
    for name in ("adamw", "adafactor"):
        tcfg = TrainConfig(optim=O.OptimConfig(name=name))
        state = init_train_state(build(cfg), tcfg, 0, "cpu")
        want = jax.eval_shape(lambda n=name: j_init_state(
            j_build(jcfg), JTrainConfig(optim=J.OptimConfig(name=n)),
            jax.random.PRNGKey(0)))
        assert state["step"].dtype == torch.int32
        assert {k: tuple(v.shape) for k, v in tree_leaves(state)} == \
            {k: tuple(v.shape) for k, v in _flat(want).items()}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _states():
    """The same AdamW train state in both packages (reduced, fp32)."""
    (jcfg, jb, jp), (cfg, b, p) = _pair_models()
    jt = JTrainConfig()
    jstate = j_init_state(jb, jt, jax.random.PRNGKey(0))
    jstate["step"] = jnp.asarray(7, jnp.int32)
    jstate["opt"]["mu"] = jax.tree.map(lambda x: x + 0.5, jstate["opt"]["mu"])
    tstate = {"step": torch.tensor(7, dtype=torch.int32),
              "params": params_from_numpy(_np_tree(jstate["params"]), "cpu"),
              "opt": {"mu": params_from_numpy(_np_tree(jstate["opt"]["mu"]),
                                              "cpu"),
                      "nu": params_from_numpy(_np_tree(jstate["opt"]["nu"]),
                                              "cpu")}}
    return jstate, tstate


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for key in la:
        assert la[key].dtype == lb[key].dtype, key
        np.testing.assert_array_equal(la[key], lb[key], err_msg=key)


def test_reference_checkpoint_restores_in_port(tmp_path):
    jstate, tstate = _states()
    j_ckpt.save_checkpoint(str(tmp_path), 7, jstate)
    got = ckpt.restore_checkpoint(str(tmp_path), target=tstate,
                                  device="cpu")
    _assert_same(got, tstate)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    _assert_same(ckpt.restore_checkpoint(str(tmp_path), device="cpu"),
                 tstate)


def test_port_checkpoint_restores_in_reference(tmp_path):
    jstate, tstate = _states()
    path = ckpt.save_checkpoint(str(tmp_path), 7, tstate)
    with open(os.path.join(path, "manifest.json")) as fh:
        leaves = json.load(fh)["leaves"]
    assert "params/layers/attn/wq" in leaves and "step" in leaves
    _assert_same(j_ckpt.restore_checkpoint(str(tmp_path), target=jstate),
                 jstate)
    _assert_same(j_ckpt.restore_checkpoint(str(tmp_path)), jstate)


def test_checkpoint_reads_a_sharded_leaf(tmp_path):
    """The reference writes one file per shard for a multi-device leaf."""
    d = tmp_path / "step_3"
    d.mkdir()
    full = np.arange(24, dtype=np.float32).reshape(4, 6)
    np.save(d / "w.shard0.npy", full[:2])
    np.save(d / "w.shard1.npy", full[2:])
    (d / "manifest.json").write_text(json.dumps({"step": 3, "leaves": {"w": {
        "shape": [4, 6], "dtype": "float32", "shards": [
            {"file": "w.shard0.npy", "index": [[0, 2], None]},
            {"file": "w.shard1.npy", "index": [[2, 4], None]}]}}}))
    np.testing.assert_array_equal(
        ckpt.restore_checkpoint(str(tmp_path), device="cpu")["w"].numpy(),
        full)


def test_checkpoint_gc_and_latest_step(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    state = {"w": torch.ones(3), "step": torch.tensor(0, dtype=torch.int32)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(str(tmp_path), s, state, max_to_keep=2)
    (tmp_path / "step_9.tmp").mkdir()          # a save cut short
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5",
                                            "step_9.tmp"]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert j_ckpt.latest_step(str(tmp_path)) == 5
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "empty"), device="cpu")
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save_checkpoint(str(tmp_path), 6, {"w": torch.ones(2).bfloat16()})


def test_restore_without_device_raises_where_there_is_no_card(
        tmp_path, monkeypatch):
    """Like every entry point of the port, restoring lands on the card
    unless the caller names a device: without a card it raises."""
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore_checkpoint(str(tmp_path))
    assert ckpt.restore_checkpoint(str(tmp_path), device="cpu")["w"] \
        .device.type == "cpu"


def test_async_checkpointer(tmp_path):
    _, tstate = _states()
    cp = ckpt.AsyncCheckpointer(str(tmp_path), max_to_keep=1)
    cp.save(1, tstate)
    cp.save(2, tstate)            # joins the first write
    cp.wait()
    assert cp.last_path == str(tmp_path / "step_2")
    assert sorted(os.listdir(tmp_path)) == ["step_2"]
    _assert_same(ckpt.restore_checkpoint(str(tmp_path), device="cpu"),
                 tstate)
    with pytest.raises(TypeError, match="bfloat16"):
        cp.save(3, {"w": torch.ones(2).bfloat16()})
    (tmp_path / "file").write_text("")
    bad = ckpt.AsyncCheckpointer(str(tmp_path / "file"))
    bad.save(1, {"w": torch.ones(2)})      # the write fails in its thread
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                             # the error is raised once


# ---------------------------------------------------------------------------
# data stream
# ---------------------------------------------------------------------------

def test_token_stream_equals_reference_and_resumes_exactly():
    kw = dict(vocab_size=500, seq_len=24, batch_size=3, seed=4)
    mine, ref = TokenStream(DataConfig(**kw)), JTokenStream(JDataConfig(**kw))
    for _ in range(3):
        a, b = mine.next_batch(), ref.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    payload = serialize_state(mine)
    expect = [mine.next_batch() for _ in range(2)]
    resumed = TokenStream(DataConfig(**kw))
    deserialize_state(resumed, payload)
    for want in expect:
        got = resumed.next_batch()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["labels"], want["labels"])


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
          "--seq", "16", "--log-every", "1"]


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH,
         "--steps", "3", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "step 3/3" in proc.stdout
    assert ckpt.latest_step(str(tmp_path)) == 3
    first = ckpt.restore_checkpoint(str(tmp_path), device="cpu")
    launch_train.main([*LAUNCH, "--steps", "5", "--ckpt-dir",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "step 4/5" in out
    assert "step 1/5" not in out
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert int(ckpt.restore_checkpoint(str(tmp_path), device="cpu")["step"]) \
        == 5
    assert int(first["step"]) == 3


def test_launcher_nan_loss_exits_310(tmp_path):
    with pytest.raises(SystemExit) as exc:
        launch_train.main([*LAUNCH, "--steps", "2", "--lr", "nan"])
    assert exc.value.code == 310


def test_launcher_trains_on_a_mesh_and_resumes_on_another(tmp_path, capfd,
                                                          monkeypatch):
    """``--data-mesh 2`` spawns two gloo ranks (FSDP) that train, print from
    rank 0 only and save sharded checkpoints; ``--model-mesh 2`` resumes
    from them on two ranks that split the heads, with a NaN learning
    rate: rank 0 reads step 4's NaN loss and every rank exits 310. The
    launcher waits for its ranks with no deadline: a caller's default one
    is cut to half a second here, which both runs outlive."""
    spawn = launch_train.spawn_ranks

    def short_default_deadline(*args, **kw):
        kw.setdefault("timeout", 0.5)
        return spawn(*args, **kw)

    monkeypatch.setattr(launch_train, "spawn_ranks", short_default_deadline)
    launch_train.main([*LAUNCH, "--steps", "2", "--data-mesh", "2",
                       "--ckpt-dir", str(tmp_path)])
    out = capfd.readouterr().out
    assert out.count("step 2/2") == 1 and "final checkpoint" in out
    with open(tmp_path / "step_2" / "manifest.json") as fh:
        emb = json.load(fh)["leaves"]["params/embedding"]
    assert [s["index"] for s in emb["shards"]] == [[None, [0, 64]],
                                                   [None, [64, 128]]]
    with pytest.raises(SystemExit) as exc:
        launch_train.main([*LAUNCH, "--steps", "4", "--model-mesh", "2",
                           "--lr", "nan", "--ckpt-dir", str(tmp_path)])
    assert exc.value.code == 310
    out = capfd.readouterr().out
    assert out.count("resumed from step 2") == 1
    assert out.count("step 3/4") == 1
    assert "step 1/4" not in out and "step 4/4" not in out
    assert ckpt.latest_step(str(tmp_path)) == 2
