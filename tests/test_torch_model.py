"""The port's configs, weight bridge, primitives and dense LM against the
reference, on the CPU, at reduced size in float32.

Parameters come from the reference's own init and cross through numpy;
inputs are made with numpy from fixed seeds. Logits are held at atol and
rtol 1e-4 (the two frameworks sum the d-wide products in different
orders); greedy tokens must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced
from repro.models import common as j_common
from repro.models import transformer as j_tf
from repro.models.registry import build as j_build
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.registry import build
from repro_torch.serving.serve import make_decode_step, make_prefill_step

ARCH = "aiida-demo-110m"
DENSE_ARCHS = ["aiida-demo-110m", "qwen3-4b", "qwen2-0.5b", "granite-3-2b",
               "deepseek-67b"]
LOGIT_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair_models(arch=ARCH, seed=0, **over):
    """(reference cfg, bundle, params), (port cfg, bundle, params) with
    the reference's parameters bridged into the port."""
    over = dict(dtype="float32", kv_cache_dtype="float32") | over
    jcfg = j_reduced(arch).replace(**over)
    jb = j_build(jcfg)
    jp = jb.init_params(jax.random.PRNGKey(seed))
    cfg = reduced_config(arch).replace(**over)
    b = build(cfg)
    return (jcfg, jb, jp), (cfg, b, params_from_numpy(_np_tree(jp), "cpu"))


def _close(got, want, tol=LOGIT_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# configs and the weight bridge
# ---------------------------------------------------------------------------

def test_arch_ids_match_reference():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("arch", J_ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference_field_for_field(arch, reduced):
    mine = (reduced_config if reduced else get_config)(arch)
    ref = (j_reduced if reduced else j_get_config)(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.hd == ref.hd and mine.padded_vocab == ref.padded_vocab
    assert mine.kv_heads_eff == ref.kv_heads_eff
    assert str(mine.activation_dtype).endswith(ref.dtype)


@pytest.mark.parametrize("arch", DENSE_ARCHS + ["moonshot-v1-16b-a3b",
                                                "grok-1-314b",
                                                "llava-next-34b"])
def test_params_bridge_round_trips_leaf_for_leaf(arch):
    (_, jb, jp), (_, b, p) = _pair_models(arch)
    ref = _np_tree(jp)
    back = params_to_numpy(p)
    assert jax.tree.structure(ref) == jax.tree.structure(back)
    for (path, a), bk in zip(jax.tree_util.tree_leaves_with_path(ref),
                             jax.tree.leaves(back)):
        assert a.dtype == bk.dtype, path
        np.testing.assert_array_equal(a, bk, err_msg=str(path))
    # the port's own init makes the same tree of shapes
    mine = b.init_params(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(np.shape, ref) == jax.tree.map(
        lambda t: tuple(t.shape), mine)


def test_init_params_is_seeded_and_follows_the_init_rules():
    b = build(reduced_config(ARCH))
    p1 = b.init_params(torch.Generator().manual_seed(3), "cpu")
    p2 = b.init_params(3, "cpu")
    for (_, x), (_, y) in zip(common.tree_leaves(p1), common.tree_leaves(p2)):
        assert torch.equal(x, y)
    assert torch.equal(p1["ln_final"], torch.ones(128))
    # the reference's rule: std = 1/sqrt(shape[-2]) of the stacked leaf
    for name in ("wq", "wo"):
        w = p1["layers"]["attn"][name]
        assert w.dtype == torch.float32
        want = w.shape[-2] ** -0.5
        assert abs(float(w.std()) - want) < 0.05 * want, name


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 5, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, (64,)).astype(np.float32)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    _close(got, j_common.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6),
           5e-5)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (2, 7, 4, 32)).astype(np.float32)
    k = rng.normal(0, 1, (2, 7, 2, 32)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 12, 13, 14, 900]])
    got = common.rope(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(pos), theta)
    want = j_common.rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                         theta)
    for g, w in zip(got, want):
        _close(g, w, 5e-5)


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_exact"])
def test_act_fn_matches(name):
    x = np.linspace(-6, 6, 257).astype(np.float32)
    _close(common.act_fn(name)(torch.from_numpy(x)),
           j_common.act_fn(name)(jnp.asarray(x)), 5e-5)


# ---------------------------------------------------------------------------
# the dense LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("attn_impl", ["direct", "pallas", "chunked"])
def test_lm_forward_matches(arch, attn_impl):
    """qk_norm (qwen3), qkv_bias + tied embeddings (qwen2), the granite
    multipliers, under both attention routes."""
    (jcfg, _, jp), (cfg, _, p) = _pair_models(arch, attn_impl=attn_impl)
    tokens = np.random.default_rng(2).integers(1, 500, (2, 12))
    want, _ = j_tf.lm_forward(jcfg, jp, {"tokens": jnp.asarray(tokens)})
    got, aux = tf.lm_forward(cfg, p, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    assert float(aux) == 0.0             # dense layers add no aux loss


def _prompt_batch(cfg, prompt, rng):
    """numpy inputs of a prefill: the prompt, and a VLM's patch
    embeddings drawn from ``rng``."""
    batch = {"tokens": prompt}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            0, 1, (prompt.shape[0], cfg.num_patches, cfg.d_model)
        ).astype(np.float32)
    return batch


#: the reduced MoE and VLM beside the dense archs
LM_ARCHS = DENSE_ARCHS + ["moonshot-v1-16b-a3b", "llava-next-34b"]

#: (arch, attn_impl, decode_impl, kv_cache_dtype, per_row): every route
#: of the prefill and decode for aiida-demo-110m, four for each other arch
DECODE_ROUTES = [(a, d, k, r) for a in ("direct", "pallas")
                 for d in ("direct", "pallas")
                 for k in ("bfloat16", "int8") for r in (False, True)]
DECODE_CASES = [(ARCH, *route) for route in DECODE_ROUTES] + [
    (arch, *route) for arch in LM_ARCHS[1:] for route in (
        ("direct", "direct", "bfloat16", False),
        ("pallas", "pallas", "bfloat16", True),
        ("pallas", "pallas", "int8", True),
        ("direct", "pallas", "int8", False))]


def _decode_id(case):
    arch, attn_impl, decode_impl, kv_cache_dtype, per_row = case
    route = f"{per_row}-{kv_cache_dtype}-{decode_impl}-{attn_impl}"
    return route if arch == ARCH else f"{arch}-{route}"


@pytest.mark.parametrize(
    "arch,attn_impl,decode_impl,kv_cache_dtype,per_row", DECODE_CASES,
    ids=[_decode_id(c) for c in DECODE_CASES])
def test_prefill_and_decode_match(arch, attn_impl, decode_impl,
                                  kv_cache_dtype, per_row):
    """lm_prefill logits and cache, then two lm_decode_step logits, with a
    scalar or a per-row position vector; kv_cache_dtype 'bfloat16' means a
    cache in the activation dtype (float32 here). A VLM's prompt follows
    its patches, so its decode positions start after both."""
    over = dict(attn_impl=attn_impl, decode_impl=decode_impl,
                kv_cache_dtype=kv_cache_dtype)
    (jcfg, jb, jp), (cfg, b, p) = _pair_models(arch, **over)
    rng = np.random.default_rng(3)
    n, max_len = 10, 32
    prompt = rng.integers(1, cfg.vocab_size, (2, n))
    batch = _prompt_batch(cfg, prompt, rng)
    n += cfg.num_patches
    j_logits, j_cache = jax.jit(jb.prefill_fn)(
        jp, jax.tree.map(jnp.asarray, batch), jb.init_cache(2, max_len))
    cache = b.init_cache(2, max_len, "cpu")
    logits, cache = b.prefill_fn(
        p, {k: torch.from_numpy(v) for k, v in batch.items()}, cache)
    _close(logits, j_logits)
    for name in j_cache:
        # an int8 code may sit one step away where k/v fall on a rounding
        # boundary (the products are summed in another order)
        quantized = kv_cache_dtype == "int8" and name in ("k", "v")
        _close(cache[name], j_cache[name], 1.0 if quantized else LOGIT_TOL)
    assert torch.equal(logits[:, -1].argmax(-1),
                       torch.from_numpy(np.asarray(j_logits[:, -1])
                                        .argmax(-1)))

    j_decode = jax.jit(jb.decode_fn)
    tok = rng.integers(1, cfg.vocab_size, (2, 1))
    for step in range(2):
        pos = np.asarray([n + step, n - 3 + step]) if per_row \
            else np.asarray(n + step)
        j_logits, j_cache = j_decode(jp, j_cache, jnp.asarray(tok),
                                     jnp.asarray(pos, jnp.int32))
        logits, cache = b.decode_fn(p, cache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        _close(logits, j_logits)
        want_tok = np.asarray(j_logits[:, -1, :cfg.vocab_size]).argmax(-1)
        assert logits[:, -1, :cfg.vocab_size].argmax(-1).tolist() == \
            want_tok.tolist()
        tok = want_tok[:, None]


def test_cache_write_clamps_past_the_end():
    """Like the reference's dynamic_update_slice, a position past the end
    of the cache writes the last slot, never out of range."""
    from repro_torch.models.attention import _cache_write

    cache = {"k": torch.zeros(2, 4, 1, 2), "v": torch.zeros(2, 4, 1, 2)}
    k = torch.ones(2, 1, 1, 2)
    _cache_write(cache, k, 2 * k, torch.tensor([7, 1]), quantized=False)
    assert cache["k"][0, 3].eq(1).all() and cache["k"][1, 1].eq(1).all()
    assert cache["k"].sum() == 4 and cache["v"].sum() == 8
    _cache_write(cache, 3 * k, 3 * k, torch.tensor(9), quantized=False)
    assert cache["k"][:, 3].eq(3).all()


STEPWISE_CASES = [(arch, d) for arch in LM_ARCHS
                  for d in ("direct", "pallas")]


@pytest.mark.parametrize(
    "arch,decode_impl", STEPWISE_CASES,
    ids=[d if a == ARCH else f"{a}-{d}" for a, d in STEPWISE_CASES])
def test_prefill_equals_stepwise_decode(arch, decode_impl):
    """Prefilling N tokens lands in the same state as feeding them one
    decode step at a time: identical next token and greedy continuation.
    A VLM's stepwise run prefills its patches and the first token. A MoE
    layer drops a token past an expert's capacity, which a one-token step
    never does: the MoE is held where the prefill drops none."""
    cfg = reduced_config(arch).replace(dtype="float32",
                                       kv_cache_dtype="float32",
                                       decode_impl=decode_impl,
                                       moe_capacity_factor=4.0)
    bundle = build(cfg)
    params = bundle.init_params(1, "cpu")
    prefill = make_prefill_step(bundle)
    decode = make_decode_step(bundle)
    n, extra, max_len = 8, 4, 32
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, cfg.vocab_size, (1, n))
    batch = {k: torch.from_numpy(v)
             for k, v in _prompt_batch(cfg, prompt, rng).items()}
    p0 = cfg.num_patches
    if cfg.family == "moe":
        from repro_torch.models.mlp import _capacity, _group_size

        g = _group_size(cfg, n)
        assert _capacity(cfg, g) >= g      # every expert holds its group

    def continue_greedy(tok, cache, pos):
        seq = [int(tok[0, 0])]
        for i in range(extra):
            tok, cache = decode(params, cache, tok.long(),
                                torch.tensor(pos + i))
            seq.append(int(tok[0, 0]))
        return seq

    tok_a, cache_a = prefill(params, batch,
                             bundle.init_cache(1, max_len, "cpu"))
    seq_a = continue_greedy(tok_a, cache_a, p0 + n)
    tok_b, cache_b = prefill(params, batch | {"tokens": batch["tokens"][:, :1]},
                             bundle.init_cache(1, max_len, "cpu"))
    for i in range(1, n):
        tok_b, cache_b = decode(params, cache_b,
                                batch["tokens"][:, i:i + 1],
                                torch.tensor(p0 + i))
    seq_b = continue_greedy(tok_b, cache_b, p0 + n)
    assert seq_a == seq_b


def test_launcher_trains_on_a_2x2_mesh_and_resumes_on_one_device(
        tmp_path, capfd):
    """Four gloo ranks (FSDP over data, heads over model) train, print from
    rank 0 only and write each leaf's four shards once; one process
    without a mesh resumes from them."""
    import json

    from repro_torch.launch.train import main
    from repro_torch.training import checkpoint

    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "1",
            "--seq", "16", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    main([*argv, "--steps", "2", "--data-mesh", "2", "--model-mesh", "2"])
    out = capfd.readouterr().out
    assert out.count("step 1/2") == 1 and out.count("step 2/2") == 1
    with open(tmp_path / "step_2" / "manifest.json") as fh:
        leaves = json.load(fh)["leaves"]
    wq = [s["index"] for s in leaves["params/layers/attn/wq"]["shards"]]
    assert len(wq) == len({json.dumps(i) for i in wq}) == 4
    main([*argv, "--steps", "3"])
    out = capfd.readouterr().out
    assert "resumed from step 2" in out and out.count("step 3/3") == 1
    assert checkpoint.latest_step(str(tmp_path)) == 3


# ---------------------------------------------------------------------------
# bf16: constants rounded as JAX rounds them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [0.22, 12.0, 2560 ** 0.5, 128 ** 0.5])
def test_bf16_scalings_match_jax_element_for_element(c):
    """JAX rounds a Python-float constant to bf16 before it multiplies a
    bf16 array; ``mul_scalar`` must give the same bits (granite's
    residual 0.22 and embedding 12.0, the Griffin embedding scales at full
    and reduced width). A plain ``x * c`` in PyTorch differs in a fifth to
    a third of the elements at 0.22 and 2560 ** 0.5."""
    x = np.random.default_rng(0).normal(0, 1, 10_000).astype(np.float32)
    want = np.asarray((jnp.asarray(x, jnp.bfloat16) * c).astype(jnp.float32))
    got = common.mul_scalar(torch.from_numpy(x).bfloat16(), c)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("arch", ["granite-3-2b", "recurrentgemma-2b"])
def test_bf16_embedding_and_residual_scaling_match_jax(arch):
    """The embedding scalings of the dense LM (granite's multiplier) and of
    the hybrid (sqrt(d_model)), and granite's residual branch, in bf16
    against the reference's own code, bit for bit."""
    from repro_torch.models import rglru as rg

    jcfg = j_reduced(arch).replace(d_model=2560)
    cfg = reduced_config(arch).replace(d_model=2560)
    rng = np.random.default_rng(1)
    emb = rng.normal(0, 1, (64, 2560)).astype(np.float32)
    tokens = rng.integers(0, 64, (2, 9))
    if arch == "granite-3-2b":
        want = j_tf.embed_tokens(jcfg, {"embedding": jnp.asarray(emb)},
                                 jnp.asarray(tokens))
        got = tf.embed_tokens(cfg, {"embedding": torch.from_numpy(emb)},
                              torch.from_numpy(tokens))
    else:      # the reference's griffin_forward scales inline
        want = jnp.take(jnp.asarray(emb, jnp.bfloat16), jnp.asarray(tokens),
                        axis=0) * (jcfg.d_model ** 0.5)
        got = rg._embed(cfg, {"embedding": torch.from_numpy(emb)},
                        torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # the residual branch: x + rm * a in the reference
    x, a = (rng.normal(0, 1, (4, 2560)).astype(np.float32) for _ in range(2))
    jx, ja = (jnp.asarray(v, jnp.bfloat16) for v in (x, a))
    tx, ta = (torch.from_numpy(v).bfloat16() for v in (x, a))
    want = jx + jcfg.residual_multiplier * ja
    got = tx + common.mul_scalar(ta, cfg.residual_multiplier)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
