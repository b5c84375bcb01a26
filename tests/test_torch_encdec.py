"""The port's audio family (``models/encdec.py``, whisper-large-v3's
encoder-decoder) against the reference, on the CPU, at reduced size.

Parameters come from the reference's own init and cross through numpy
(``params_from_numpy``); inputs are made with numpy from fixed seeds.
float32 values are held at 5e-5 (atol and rtol) and bf16 at 2e-2
(``tests/test_kernels.py:22``), except where the sinusoid's bound below is
wider; gradients by each leaf's error over its norm. Greedy tokens must be
identical in float32. With ``attn_impl="pallas"`` / ``decode_impl=
"pallas"`` the reference runs its Pallas kernels in interpret mode, as its
own tests do, and the port the kernels' plain versions (CPU tensors).

The sinusoid. Both packages compute ``inv = exp(-c * i)`` in float32, and
XLA's and PyTorch's ``exp`` differ by one ulp on some ``i`` (``inv <= 1``,
so one ulp is at most 2**-24). An angle ``p * inv`` then moves by at most
``p * 2**-24`` before it is rounded, and by one ulp of the angle more
after; ``sin`` and ``cos`` add a few ulp of their result (at most
2**-24 each). At ``length`` positions:

    bound(length) = (length - 1) * 2**-24 + ulp(length - 1) + 4 * 2**-24

which is 9.5e-7 at 16 positions (under 5e-5, so 5e-5 holds) and 2.1e-4 at
1500 (1.2e-4 measured at d = 1280). The encoder adds the table to its
frames, so at 1500 frames its output is held at that bound times the
encoder's gain from input to output (``ENC_GAIN``, held by
:func:`test_encoder_gain_is_under_its_bound`); given the reference's own
table, at 5e-5.

At 1500 frames the attention projections are fan-in scaled (``_pair``'s
``scaled``, as ``chip_smoke.py``'s parity phases scale them). The
reference's init takes a projection's fan-in from its shape[-2], the head
count, so wq and wk have std 1/2 where the contraction runs over d = 128:
the encoder's softmax over 1500 keys is then nearly an argmax, its gain is
~600 (measured), and a one-ulp difference in summation order moves its
output by 4e-4 even with equal tables. Scaled, the gain is ~3.6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced
from repro.models import common as j_common
from repro.models import encdec as j_ed
from repro.models.common import ParamSpec as JSpec
from repro.models.registry import build as j_build
from repro.serving.serve import make_decode_step as j_make_decode
from repro.serving.serve import make_prefill_step as j_make_prefill
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import common, encdec
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build
from repro_torch.serving.serve import make_decode_step, make_prefill_step

ARCH = "whisper-large-v3"
F32_TOL, BF16_TOL = 5e-5, 2e-2
#: the full config's parameters, from the reference's specs
FULL_PARAMS = 1_535_718_400


def sinusoid_bound(length: int) -> float:
    """The bound the module docstring derives for a table of ``length``
    positions, or 5e-5 where that holds."""
    ulp = float(np.spacing(np.float32(max(length - 1, 1))))
    derived = (length - 1) * 2.0 ** -24 + ulp + 4 * 2.0 ** -24
    return max(F32_TOL, derived)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def fan_in_scaled(cfg, tree):
    """A numpy parameter tree with every attention projection rescaled to
    std 1/sqrt(fan-in of its contraction): wq/wk/wv by sqrt(shape[-2] /
    d_model), wo by sqrt(shape[-2] / (heads * hd))."""
    tree = jax.tree.map(np.array, tree)
    for stack, names in (("enc_layers", ("attn",)),
                         ("dec_layers", ("self_attn", "cross_attn"))):
        for name in names:
            a = tree[stack][name]
            for w in ("wq", "wk", "wv"):
                a[w] = a[w] * np.float32((a[w].shape[-2] / cfg.d_model) ** 0.5)
            a["wo"] = a["wo"] * np.float32(
                (a["wo"].shape[-2] / (cfg.num_heads * cfg.hd)) ** 0.5)
    return tree


def _pair(frames=16, seed=0, scaled=None, **over):
    """(reference cfg, bundle, params), (port cfg, bundle, params): the
    reduced whisper (d 128, 4/4 heads of 32, 2 + 2 layers) with
    ``frames`` frame embeddings, in float32 unless ``over`` says
    otherwise, the reference's parameters in both packages, fan-in scaled
    if ``scaled`` (by default at more than 16 frames)."""
    over = dict(dtype="float32", kv_cache_dtype="float32",
                num_frames=frames) | over
    jcfg = j_reduced(ARCH).replace(**over)
    jb = j_build(jcfg)
    jp = _np_tree(jb.init_params(jax.random.PRNGKey(seed)))
    if frames > 16 if scaled is None else scaled:
        jp = fan_in_scaled(jcfg, jp)
    cfg = reduced_config(ARCH).replace(**over)
    return ((jcfg, jb, jax.tree.map(jnp.asarray, jp)),
            (cfg, build(cfg), params_from_numpy(jp, "cpu")))


def _batch(cfg, b=2, s=12, seed=0):
    """frames standard normal, tokens and labels in the vocab."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"frames": rng.normal(0, 1, (b, cfg.num_frames, cfg.d_model)
                                 ).astype(np.float32),
            "tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a) if a.dtype == np.int32 \
        else torch.from_numpy(a).to(dtype)


def _close(got, want, tol=F32_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _spec_shapes(tree, leaf_type):
    if leaf_type is JSpec:
        return {"/".join(str(getattr(k, "key", k)) for k in path): s.shape
                for path, s in jax.tree_util.tree_leaves_with_path(
                    tree, is_leaf=lambda x: isinstance(x, JSpec))}
    return {path: s.shape for path, s in common.tree_leaves(tree)}


# ---------------------------------------------------------------------------
# primitives and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,dim", [(1, 128), (16, 128), (448, 1280),
                                        (1500, 128), (1500, 1280)])
def test_sinusoidal_positions_match_reference(length, dim):
    got = common.sinusoidal_positions(length, dim)
    assert got.dtype == torch.float32 and got.shape == (length, dim)
    _close(got, j_common.sinusoidal_positions(length, dim),
           sinusoid_bound(length))


def test_sinusoid_bound_keeps_5e5_where_it_holds():
    assert sinusoid_bound(16) == F32_TOL
    assert sinusoid_bound(1500) == pytest.approx(
        1499 * 2.0 ** -24 + 2.0 ** -13 + 4 * 2.0 ** -24)


def test_step_sinusoid_is_the_tables_row():
    """A decode step's sinusoid (one scalar position, as the reference's
    ``:251-258``) is row ``pos`` of the table, bit for bit."""
    cfg = get_config(ARCH)
    table = common.sinusoidal_positions(448, cfg.d_model)
    for pos in (0, 1, 131, 447):
        assert torch.equal(common.sinusoid(torch.tensor(pos), cfg.d_model),
                           table[pos])


@pytest.mark.parametrize("full", [False, True])
def test_whisper_specs_match_reference(full):
    """Every leaf, by path and shape, is the reference's, reduced and
    full; the full count is 1,535,718,400."""
    cfg, jcfg = ((get_config(ARCH), j_get_config(ARCH)) if full
                 else (reduced_config(ARCH), j_reduced(ARCH)))
    mine = _spec_shapes(encdec.make_whisper_specs(cfg), None)
    ref = _spec_shapes(j_ed.make_whisper_specs(jcfg), JSpec)
    assert mine == ref
    assert _spec_shapes(build(cfg).specs, None) == ref
    if full:
        assert sum(math.prod(s) for s in mine.values()) == FULL_PARAMS
        assert mine["enc_layers/attn/wq"] == (32, 1280, 20, 64)
        assert mine["dec_layers/cross_attn/bk"] == (32, 20, 64)
        assert mine["embedding"] == (51968, 1280)


def test_cross_attention_specs_equal_self_attention_specs():
    from repro_torch.models import attention as attn

    cfg = get_config(ARCH)
    assert attn.make_attn_specs(cfg, cross=True) == attn.make_attn_specs(cfg)


def test_init_draws_the_references_rules():
    """The reduced tree drawn by the port has every leaf's shape, ones and
    zeros for the LayerNorms and biases."""
    cfg = reduced_config(ARCH)
    p = build(cfg).init_params(0, "cpu")
    flat = dict(common.tree_leaves(p))
    assert torch.equal(flat["enc_ln/w"], torch.ones(cfg.d_model))
    assert torch.equal(flat["dec_layers/ln3/b"],
                       torch.zeros(cfg.num_layers, cfg.d_model))
    assert not flat["dec_layers/cross_attn/bq"].any()
    assert float(flat["enc_layers/mlp/w1"].std()) == pytest.approx(
        cfg.d_model ** -0.5, rel=0.05)


# ---------------------------------------------------------------------------
# encoder, decoder, loss
# ---------------------------------------------------------------------------

#: the reduced encoder's gain from its input to its output at 1500 frames
#: (fan-in scaled), measured from the port on a perturbed input (3.20-3.56
#: over three seeds); the 1500-frame bound is the sinusoid's times this
ENC_GAIN = 4.0


@pytest.mark.parametrize("frames", [16, 1500])
@pytest.mark.parametrize("attn_impl", ["direct", "chunked", "pallas"])
def test_encode_matches_reference(frames, attn_impl):
    """``encode`` at 16 frames (the chunked block is 16, one pass of its
    loop) and at 1500 (block 4: 375 passes; the reference scans them) on
    every attention route (``pallas`` keeps the non-causal encoder on the
    chunked path in both packages)."""
    (jcfg, _, jp), (cfg, _, p) = _pair(frames, attn_impl=attn_impl)
    frames_np = _batch(cfg)["frames"]
    want = jax.jit(lambda pp, f: j_ed.encode(jcfg, pp, f))(
        jp, jnp.asarray(frames_np))
    got = encdec.encode(cfg, p, _t(frames_np))
    assert got.shape == (2, frames, cfg.d_model)
    tol = F32_TOL if frames == 16 else ENC_GAIN * sinusoid_bound(frames)
    _close(got, want, tol)


@pytest.mark.parametrize("attn_impl", ["direct", "chunked"])
def test_encode_at_1500_frames_given_the_references_sinusoid(
        attn_impl, monkeypatch):
    """With the reference's sinusoid table the 1500-frame encoder is held
    at 5e-5: the rest of the encoder adds nothing to the bound."""
    (jcfg, _, jp), (cfg, _, p) = _pair(1500, attn_impl=attn_impl)
    table = torch.from_numpy(np.array(
        j_common.sinusoidal_positions(1500, cfg.d_model)))
    monkeypatch.setattr(encdec, "sinusoidal_positions",
                        lambda n, d, device=None: table[:n].to(device))
    frames_np = _batch(cfg, seed=1)["frames"]
    want = jax.jit(lambda pp, f: j_ed.encode(jcfg, pp, f))(
        jp, jnp.asarray(frames_np))
    _close(encdec.encode(cfg, p, _t(frames_np)), want)


def test_encoder_gain_is_under_its_bound():
    """:data:`ENC_GAIN` holds: a perturbation of the encoder's input by
    ``eps`` at every element moves its output by less than ``ENC_GAIN *
    eps`` (the port against itself, three seeds, 1500 frames)."""
    _, (cfg, _, p) = _pair(1500)
    eps = 1e-3
    for seed in range(3):
        f = _t(_batch(cfg, seed=seed)["frames"])
        sign = torch.from_numpy(np.random.default_rng(seed).choice(
            [-1.0, 1.0], f.shape).astype(np.float32))
        with torch.no_grad():
            a = encdec.encode(cfg, p, f)
            b = encdec.encode(cfg, p, f + eps * sign)
        assert float((a - b).abs().max()) < ENC_GAIN * eps


@pytest.mark.parametrize("attn_impl", ["direct", "pallas"])
def test_decode_train_logits_match_reference(attn_impl):
    (jcfg, _, jp), (cfg, _, p) = _pair(attn_impl=attn_impl)
    batch = _batch(cfg)
    enc = j_ed.encode(jcfg, jp, jnp.asarray(batch["frames"]))
    want = jax.jit(lambda pp, t, e: j_ed.decode_train(jcfg, pp, t, e))(
        jp, jnp.asarray(batch["tokens"]), enc)
    got = encdec.decode_train(cfg, p, _t(batch["tokens"]),
                              torch.from_numpy(np.array(enc)))
    assert got.shape == (2, 12, cfg.padded_vocab)
    _close(got, want)


#: each gradient leaf's error over its norm: at the reference's init
#: (the bar ``tests/test_torch_training.py`` holds every arch but the demo
#: to; its attention is nearly an argmax, which amplifies the two
#: packages' rounding to 1e-4..6e-4) and fan-in scaled (1e-6 measured)
GRAD_TOL = {False: 1e-3, True: F32_TOL}
#: the key bias gets no gradient (softmax is shift-invariant along the
#: keys, and with no rotary embedding q . bk is the same for every key):
#: both packages' gradients are rounding, up to 1.3e-6, held absolutely
ZERO_GRAD_TOL = 1e-5


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("attn_impl", ["direct", "pallas"])
def test_whisper_loss_and_every_gradient_leaf_match_reference(attn_impl,
                                                              scaled):
    """fp32 loss (5e-5 relative), its metrics (``aux_loss`` zero), and
    every gradient leaf by its error over its norm (``GRAD_TOL``);
    ``jax.grad`` on the reference side."""
    (jcfg, _, jp), (cfg, _, p) = _pair(attn_impl=attn_impl, scaled=scaled)
    batch = _batch(cfg, seed=2)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda pp, bb: j_ed.whisper_loss(jcfg, pp, bb), has_aux=True))(
            jp, jax.tree.map(jnp.asarray, batch))
    live = common.map_tree(lambda t: t.requires_grad_(True), p)
    loss, met = encdec.whisper_loss(cfg, live,
                                    {k: _t(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=F32_TOL)
    for name in ("ce_loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(met[name].item(), float(jmet[name]),
                                   rtol=F32_TOL, atol=1e-7)
    assert met["aux_loss"].item() == 0.0
    want = dict(common.tree_leaves(_np_tree(jgrads)))
    got = dict(common.tree_leaves(live))
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        if key.endswith("/bk"):
            assert np.abs(want[key]).max() < ZERO_GRAD_TOL, key
            assert float(t.grad.abs().max()) < ZERO_GRAD_TOL, key
        else:
            assert _rel(t.grad.numpy(), want[key]) < GRAD_TOL[scaled], key


def test_whisper_bf16_loss_matches_reference():
    """The reduced config as published: bf16 activations, fp32 masters."""
    (jcfg, _, jp), (cfg, _, p) = _pair(dtype="bfloat16",
                                       kv_cache_dtype="bfloat16")
    batch = _batch(cfg, seed=3)
    jloss, _ = j_ed.whisper_loss(jcfg, jp, jax.tree.map(jnp.asarray, batch))
    loss, _ = encdec.whisper_loss(cfg, p, {k: _t(v, torch.bfloat16)
                                           for k, v in batch.items()})
    assert bool(torch.isfinite(loss))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=BF16_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

#: (frames, attn_impl, dtype): the reduced config's routes, and 1500
#: frames on the chunked path. bf16 holds at 2e-2 because the port rounds
#: as the reference's ops are written (``gelu_tanh``); XLA's fusions keep
#: some intermediates in fp32, so the jitted reference is itself up to
#: 0.03 from its op-by-op evaluation in a third of the elements
PREFILL_CASES = [(16, "direct", "float32"), (16, "pallas", "float32"),
                 (16, "pallas", "bfloat16"), (1500, "chunked", "float32")]


def _prefill_tol(frames, dtype):
    if dtype == "bfloat16":
        return BF16_TOL
    return F32_TOL if frames == 16 else ENC_GAIN * sinusoid_bound(frames)


@pytest.mark.parametrize("frames,attn_impl,dtype", PREFILL_CASES)
def test_prefill_logits_and_caches_match_reference(frames, attn_impl, dtype):
    """``whisper_prefill``'s last-position logits and all three caches
    (the self cache's k and v, the cross K/V), fan-in scaled: at the
    reference's init the decoder's near-argmax softmax moves its second
    layer's k by 2e-4 in float32 (measured), past the bar, on rounding
    alone."""
    over = dict(attn_impl=attn_impl, dtype=dtype, kv_cache_dtype=dtype)
    (jcfg, jb, jp), (cfg, b, p) = _pair(frames, scaled=True, **over)
    batch = _batch(cfg, s=10, seed=4)
    batch.pop("labels")
    jlog, jcache = jax.jit(jb.prefill_fn)(
        jp, jax.tree.map(jnp.asarray, batch), jb.init_cache(2, 24))
    cache = b.init_cache(2, 24, "cpu")
    dt = cfg.activation_dtype
    logits, cache = b.prefill_fn(p, {k: _t(v, dt) for k, v in batch.items()},
                                 cache)
    tol = _prefill_tol(frames, dtype)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    _close(logits, jlog, tol)
    for name in ("k", "v"):
        _close(cache["self"][name], jcache["self"][name], tol)
    for name in ("cross_k", "cross_v"):
        assert cache[name].shape == (cfg.num_layers, 2, frames,
                                     cfg.kv_heads_eff, cfg.hd)
        assert cache[name].dtype == dt
        _close(cache[name], jcache[name], tol)
    if dtype == "float32":
        assert logits[:, -1].argmax(-1).tolist() == \
            np.asarray(jlog[:, -1]).argmax(-1).tolist()


@pytest.mark.parametrize("decode_impl", ["direct", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(decode_impl, dtype):
    """Three ``whisper_decode_step``s after a prefill, from the
    reference's own caches (fan-in scaled, as the prefill's test): logits
    at the dtype's tolerance, and in float32 the same argmax."""
    over = dict(attn_impl="pallas", decode_impl=decode_impl, dtype=dtype,
                kv_cache_dtype=dtype)
    (jcfg, jb, jp), (cfg, b, p) = _pair(scaled=True, **over)
    batch = _batch(cfg, s=6, seed=5)
    batch.pop("labels")
    _, jcache = jax.jit(jb.prefill_fn)(
        jp, jax.tree.map(jnp.asarray, batch), jb.init_cache(2, 16))
    cache = common.map_tree(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            cfg.activation_dtype), _np_tree(jcache))
    j_decode = jax.jit(jb.decode_fn)
    tok = np.random.default_rng(5).integers(1, cfg.vocab_size, (2, 1))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for step in range(3):
        pos = 6 + step
        jlog, jcache = j_decode(jp, jcache, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos, jnp.int32))
        logits, cache = b.decode_fn(p, cache, torch.from_numpy(tok),
                                    torch.tensor(pos))
        _close(logits, jlog, tol)
        _close(cache["self"]["k"], jcache["self"]["k"], tol)
        want = np.asarray(jlog[:, -1, :cfg.vocab_size], np.float32).argmax(-1)
        if dtype == "float32":
            assert logits[:, -1, :cfg.vocab_size].argmax(-1).tolist() == \
                want.tolist()
        tok = want[:, None]


@pytest.mark.parametrize("attn_impl,decode_impl", [("direct", "direct"),
                                                   ("pallas", "pallas")])
def test_greedy_tokens_through_the_serving_steps_match_reference(
        attn_impl, decode_impl):
    """``make_prefill_step`` then 8 ``make_decode_step``s in float32:
    identical tokens."""
    over = dict(attn_impl=attn_impl, decode_impl=decode_impl)
    (jcfg, jb, jp), (cfg, b, p) = _pair(**over)
    batch = _batch(cfg, s=4, seed=6)
    batch.pop("labels")
    jtok, jcache = jax.jit(j_make_prefill(jb))(
        jp, jax.tree.map(jnp.asarray, batch), jb.init_cache(2, 16))
    tok, cache = make_prefill_step(b)(p, {k: _t(v) for k, v in batch.items()},
                                      b.init_cache(2, 16, "cpu"))
    got, want = [tok.tolist()], [np.asarray(jtok).tolist()]
    j_decode, decode = jax.jit(j_make_decode(jb)), make_decode_step(b)
    for i in range(8):
        jtok, jcache = j_decode(jp, jcache, jtok, jnp.asarray(4 + i))
        tok, cache = decode(p, cache, tok.long(), torch.tensor(4 + i))
        got.append(tok.tolist())
        want.append(np.asarray(jtok).tolist())
    assert got == want


@pytest.mark.parametrize("decode_impl", ["direct", "pallas"])
def test_prefill_equals_stepwise_decode(decode_impl):
    """A prompt prefilled whole, or its first token prefilled and the rest
    decoded one by one, leaves the same self cache (5e-5) and continues
    with the same greedy tokens."""
    _, (cfg, b, p) = _pair(attn_impl="pallas", decode_impl=decode_impl)
    batch = {k: _t(v) for k, v in _batch(cfg, s=6, seed=7).items()
             if k != "labels"}
    prefill, decode = make_prefill_step(b), make_decode_step(b)
    n = 6

    def continue_greedy(tok, cache):
        seq = [tok.tolist()]
        for i in range(5):
            tok, cache = decode(p, cache, tok.long(), torch.tensor(n + i))
            seq.append(tok.tolist())
        return seq, cache

    tok_a, cache_a = prefill(p, batch, b.init_cache(2, 16, "cpu"))
    tok_b, cache_b = prefill(p, batch | {"tokens": batch["tokens"][:, :1]},
                             b.init_cache(2, 16, "cpu"))
    for i in range(1, n):
        tok_b, cache_b = decode(p, cache_b, batch["tokens"][:, i:i + 1].long(),
                                torch.tensor(i))
    for name in ("k", "v"):
        _close(cache_b["self"][name][:, :, :n], cache_a["self"][name][:, :, :n])
    assert torch.equal(cache_a["cross_k"], cache_b["cross_k"])
    seq_a, _ = continue_greedy(tok_a, cache_a)
    seq_b, _ = continue_greedy(tok_b, cache_b)
    assert seq_a == seq_b


def test_decode_step_takes_a_scalar_position():
    """The reference's step sinusoid broadcasts a scalar only: a per-row
    position vector is refused, not given a path the reference lacks."""
    _, (cfg, b, p) = _pair()
    cache = b.init_cache(2, 16, "cpu")
    with pytest.raises(ValueError, match="scalar"):
        b.decode_fn(p, cache, torch.ones(2, 1, dtype=torch.long),
                    torch.tensor([3, 4]))


def test_batch_shapes_and_extra_inputs_match_reference():
    from repro.models.registry import ShapeCell

    for cfg_of, jcfg_of in ((reduced_config, j_reduced),
                            (get_config, j_get_config)):
        bundle = build(cfg_of(ARCH))
        for bsz, s in ((2, 64), (4, 448)):
            mine = bundle.batch_shapes(bsz, s)
            ref = j_build(jcfg_of(ARCH)).batch_struct(
                ShapeCell("t", "train", s, bsz))
            assert sorted(mine) == sorted(ref) == ["frames", "labels",
                                                   "tokens"]
            for name, (shape, dtype) in mine.items():
                assert shape == ref[name].shape, name
                assert str(dtype).split(".")[-1] == str(ref[name].dtype)


def test_draw_extra_inputs_follow_the_job_recipe():
    """An audio batch's frames are the generator's next standard-normal
    draws in float32 (``tpujob.py:62-64``); a VLM's patches are zeros and
    draw nothing."""
    bundle = build(reduced_config(ARCH))
    rng, twin = np.random.default_rng(9), np.random.default_rng(9)
    got = bundle.draw_extra_inputs(2, rng, "cpu")
    want = twin.normal(0, 1, (2, 16, 128)).astype(np.float32)
    assert list(got) == ["frames"] and got["frames"].dtype == torch.float32
    assert np.array_equal(got["frames"].numpy(), want)
    vlm = build(reduced_config("llava-next-34b"))
    state = rng.bit_generator.state
    patches = vlm.draw_extra_inputs(2, rng, "cpu")["patches"]
    assert not patches.any() and rng.bit_generator.state == state


def test_unknown_family_raises():
    with pytest.raises(NotImplementedError, match="unknown family"):
        build(reduced_config(ARCH).replace(family="sonar"))
