"""Twin of ``tests/test_models_smoke.py`` for the port's LM families
(dense, MoE, VLM) and the audio family (whisper), on the CPU at reduced
size: the forward pass, a train
step and the serving path (prefill + decode) of every LM arch, each held
against the reference given the reference's parameters; the full
configs' numbers and parameter trees, computed from the specs without
allocating; the bf16 init route of the full-width runs, and the batch
layout a VLM and an audio model take.

Parameters cross through numpy, batches are made with numpy from fixed
seeds. float32 losses are held at 1e-4 relative and the grad norm at
1e-3; greedy tokens must be identical. bf16 losses are held at 2e-2.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced
from repro.models.registry import ShapeCell
from repro.models.registry import build as j_build
from repro.serving.serve import make_decode_step as j_make_decode
from repro.serving.serve import make_prefill_step as j_make_prefill
from repro.training.train_step import TrainConfig as JTrainConfig
from repro.training.train_step import init_train_state as j_init_state
from repro.training.train_step import make_train_step as j_make_step
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models import common
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import LM_FAMILIES, build
from repro_torch.serving.serve import make_decode_step, make_prefill_step
from repro_torch.training import optim as O
from repro_torch.training.train_step import TrainConfig, make_train_step

ARCHS = [a for a in ARCH_IDS if a != "aiida-demo-110m"
         and get_config(a).family in (*LM_FAMILIES, "audio")]


def _np_batch(bundle, b, s, seed):
    """A batch of ``bundle.batch_shapes``: integer inputs in the vocab,
    float inputs (a VLM's patches, an audio model's frames) standard
    normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in bundle.batch_shapes(b, s).items():
        if dtype == torch.int32:
            out[name] = rng.integers(0, bundle.cfg.vocab_size, shape
                                     ).astype(np.int32)
        else:
            out[name] = rng.normal(0, 1, shape).astype(np.float32)
    return out


def _torch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v) if v.dtype == np.int32
            else torch.from_numpy(v).to(dtype) for k, v in batch.items()}


def _pair(arch, dtype="float32", seed=0):
    """The reference's bundle and train state, the port's bundle and the
    same parameters."""
    jcfg = j_reduced(arch).replace(dtype=dtype)
    jb = j_build(jcfg)
    jstate = j_init_state(jb, JTrainConfig(), jax.random.PRNGKey(seed))
    cfg = reduced_config(arch).replace(dtype=dtype)
    b = build(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                               "cpu")
    return (jb, jstate), (b, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_forward_and_train_step(arch):
    (jb, jstate), (bundle, params) = _pair(arch)
    batch = _np_batch(bundle, 2, 64, 0)
    jbatch = jax.tree.map(jnp.asarray, batch)

    loss, metrics = bundle.loss_fn(params, _torch(batch))
    jloss, jmet = jb.loss_fn(jstate["params"], jbatch)
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)), f"{arch}: non-finite loss {loss}"
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(metrics["aux_loss"].item(),
                               float(jmet["aux_loss"]), rtol=1e-4, atol=1e-7)
    assert (metrics["aux_loss"].item() > 0) == (bundle.cfg.family == "moe")

    tcfg = TrainConfig()
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
             "opt": O.opt_init(tcfg.optim, params)}
    state, m = make_train_step(bundle, tcfg)(state, _torch(batch))
    _, jm = jax.jit(j_make_step(jb, JTrainConfig()))(jstate, jbatch)
    assert bool(torch.isfinite(m["loss"])), f"{arch}: train loss {m['loss']}"
    assert bool(torch.isfinite(m["grad_norm"]))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-3)
    assert int(state["step"]) == 1
    # params actually moved (some leaves may legitimately have ~0 grads;
    # check the global update magnitude)
    delta = sum(float((a - b).abs().sum())
                for (_, a), (_, b) in zip(common.tree_leaves(params),
                                          common.tree_leaves(state["params"])))
    assert delta > 1e-3, f"{arch}: optimizer did not move params ({delta})"


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_bf16_loss_matches_reference(arch):
    """The reduced config as published (bf16 activations, fp32 masters)."""
    (jb, jstate), (bundle, params) = _pair(arch, dtype="bfloat16")
    batch = _np_batch(bundle, 2, 64, 1)
    loss, _ = bundle.loss_fn(params, _torch(batch, torch.bfloat16))
    jloss, _ = jb.loss_fn(jstate["params"], jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
        else jnp.asarray(a), batch))
    assert bool(torch.isfinite(loss))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_serving_path(arch):
    """Prefill, then three decode steps, through the serving steps: the
    tokens in range and equal to the reference's (float32)."""
    (jb, jstate), (bundle, params) = _pair(arch)
    cfg = bundle.cfg
    b, s = 2, 32
    batch = _np_batch(bundle, b, s, 2)
    # a VLM's s spans its patches and its text, as in the reference
    n = cfg.num_patches + batch["tokens"].shape[1]
    cache = bundle.init_cache(b, n + 8, "cpu")
    tok, cache = make_prefill_step(bundle)(params, _torch(batch), cache)
    jtok, jcache = jax.jit(j_make_prefill(jb))(
        jstate["params"], jax.tree.map(jnp.asarray, batch),
        jb.init_cache(b, n + 8))
    assert tok.shape == (b, 1)
    assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size
    assert tok.tolist() == np.asarray(jtok).tolist()
    decode, j_decode = make_decode_step(bundle), jax.jit(j_make_decode(jb))
    for i in range(3):
        tok, cache = decode(params, cache, tok.long(), torch.tensor(n + i))
        jtok, jcache = j_decode(jstate["params"], jcache, jtok,
                                jnp.asarray(n + i))
        assert tok.shape == (b, 1)
        assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size
        assert tok.tolist() == np.asarray(jtok).tolist()


# ---------------------------------------------------------------------------
# full configs: numbers and parameter trees (no allocation)
# ---------------------------------------------------------------------------

def test_full_configs_match_assignment():
    """The full (non-reduced) configs carry the exact assigned numbers."""
    expect = {
        "deepseek-67b": (95, 8192, 64, 8, 22016, 102400),
        "qwen3-4b": (36, 2560, 32, 8, 9728, 151936),
        "granite-3-2b": (40, 2048, 32, 8, 8192, 49155),
        "qwen2-0.5b": (24, 896, 14, 2, 4864, 151936),
        "grok-1-314b": (64, 6144, 48, 8, 32768, 131072),
        "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163840),
        "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256000),
        "llava-next-34b": (60, 7168, 56, 8, 20480, 64000),
        "whisper-large-v3": (32, 1280, 20, 20, 5120, 51866),
        "xlstm-350m": (24, 1024, 4, 4, 0, 50304),
    }
    for arch, (L, d, h, kv, ff, vocab) in expect.items():
        cfg = get_config(arch)
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.d_ff, cfg.vocab_size) == (L, d, h, kv, ff, vocab), arch


def test_moe_and_vlm_configs():
    grok = get_config("grok-1-314b")
    assert grok.num_experts == 8 and grok.num_experts_per_tok == 2
    moon = get_config("moonshot-v1-16b-a3b")
    assert moon.num_experts == 64 and moon.num_experts_per_tok == 6
    assert get_config("llava-next-34b").num_patches == 2880


def _spec_shapes(tree):
    return {path: s.shape for path, s in common.tree_leaves(tree)}


#: parameters of the full configs served on the card, from the
#: reference's specs
FULL_PARAMS = {"moonshot-v1-16b-a3b": 28_057_995_264,
               "llava-next-34b": 34_440_297_472,
               "whisper-large-v3": 1_535_718_400}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_tree_matches_reference(arch):
    """Every leaf of the full config's tree, by path and shape, is the
    reference's (the stacked experts (L, E, d, f), the router, the
    projector), and so is the parameter count."""
    from repro.models.common import ParamSpec as JSpec

    mine = _spec_shapes(build(get_config(arch)).specs)
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): s.shape
           for path, s in jax.tree_util.tree_leaves_with_path(
               j_build(j_get_config(arch)).specs,
               is_leaf=lambda x: isinstance(x, JSpec))}
    assert mine == ref
    count = sum(math.prod(s) for s in mine.values())
    if arch in FULL_PARAMS:
        assert count == FULL_PARAMS[arch]
    if arch == "moonshot-v1-16b-a3b":
        assert mine["layers/moe/w_gate"] == (48, 64, 2048, 1408)
        assert mine["layers/moe/router"] == (48, 2048, 64)
    if arch == "llava-next-34b":
        assert mine["mm_projector"] == (7168, 7168)
    if arch == "whisper-large-v3":
        assert mine["enc_layers/mlp/w1"] == (32, 1280, 5120)
        assert mine["dec_layers/cross_attn/wk"] == (32, 1280, 20, 64)


# ---------------------------------------------------------------------------
# the init of full-width runs, and a VLM's batch
# ---------------------------------------------------------------------------

#: per family served at full width, a norm leaf (all ones) and the
#: largest normal leaf
INIT_LEAVES = {"moonshot-v1-16b-a3b": ("ln_final", "layers/moe/w_gate"),
               "llava-next-34b": ("ln_final", "mm_projector"),
               "whisper-large-v3": ("enc_ln/w", "enc_layers/mlp/w1")}


@pytest.mark.parametrize("arch", sorted(INIT_LEAVES))
def test_init_on_device_follows_the_init_rules(arch):
    """The route the full-width runs take (there with a generator on the
    card): every leaf in the config's param dtype, drawn where the
    generator lives, by the reference's rules (ones for norms, std
    1/sqrt(shape[-2]) for the rest), reproducible from a seed."""
    cfg = reduced_config(arch).replace(param_dtype="bfloat16")
    bundle = build(cfg)
    p1 = bundle.init_params_on_device(torch.Generator().manual_seed(0))
    p2 = bundle.init_params_on_device(torch.Generator().manual_seed(0))
    shapes = _spec_shapes(bundle.specs)
    leaves = common.tree_leaves(p1)
    assert {path: tuple(t.shape) for path, t in leaves} == shapes
    for (path, a), (_, b) in zip(leaves, common.tree_leaves(p2)):
        assert a.dtype == torch.bfloat16, path
        assert torch.equal(a, b), path
    flat = dict(leaves)
    norm, big = INIT_LEAVES[arch]
    assert torch.equal(flat[norm], torch.ones(cfg.d_model,
                                              dtype=torch.bfloat16))
    w = flat[big].float()
    want = w.shape[-2] ** -0.5
    assert abs(float(w.std()) - want) < 0.05 * want
    assert abs(float(w.mean())) < 0.05 * want


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shapes_match_reference(arch):
    for b, s in ((2, 64), (1, 4096)):
        for cfg_of, jcfg_of in ((reduced_config, j_reduced),
                                (get_config, j_get_config)):
            mine = build(cfg_of(arch)).batch_shapes(b, s)
            ref = j_build(jcfg_of(arch)).batch_struct(
                ShapeCell("smoke", "train", s, b))
            assert sorted(mine) == sorted(ref)
            for name, (shape, dtype) in mine.items():
                assert shape == ref[name].shape, name
                assert str(dtype).split(".")[-1] == str(ref[name].dtype)
