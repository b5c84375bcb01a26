"""The donated train step (``make_train_step(..., donate=True)``) on the CPU.

The reference jits its step with ``donate_argnums=(0,)``: XLA writes the
new parameters and moments into the old buffers. The port's donated step
writes them into the given state's tensors. Each case here takes three
steps from clones of one state, donated and functional, and holds every
leaf ``torch.equal`` and every donated leaf's storage unchanged: AdamW
and Adafactor, one and two microbatches, a dict-of-layers model (the
reduced dense LM) and list-of-layers ones (the reduced hybrid and
xLSTM), fp32 and bf16 parameters. Also: gradients that share storage or
overlap, an asynchronous checkpoint taken just before a donated step,
the dry run's count of the donated state, and the donated step against
the reference's jitted, donated step. The mesh cases are in
``tests/_torch_sharded_train_ranks.py`` (``DONATED_CASES``).
"""

import os
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models.registry import build as j_build
from repro.training import optim as J
from repro.training.train_step import TrainConfig as JTrainConfig
from repro.training.train_step import init_train_state as j_init_state
from repro.training.train_step import make_train_step as j_make_step
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun as dr
from repro_torch.models.common import map_tree, tree_leaves
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import ShapeCell, build
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optim import (OptimConfig, clip_by_global_norm,
                                        opt_init)
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             make_train_step, value_and_grad)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_sharded_train_ranks as ranks  # noqa: E402

ARCHS = ("aiida-demo-110m", "recurrentgemma-2b", "xlstm-350m")
STEPS = 3
#: the reference's fp32 tolerance (``tests/test_kernels.py``)
PARITY_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the CPU ranks run (``setup_devices``): these
    steps are many small ops, and beside the other test workers a pool of
    threads per op waits more than it computes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clone(tree):
    return map_tree(lambda t: t.clone(), tree)


def _batches(cfg, bundle, rows=4, seq=16, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.integers(1, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(r[:, :-1].copy()),
                 "labels": torch.from_numpy(r[:, 1:].copy())}
        batch.update(bundle.draw_extra_inputs(rows, rng, "cpu"))
        out.append(batch)
    return out


def _donated_against_functional(bundle, tcfg, state, batches):
    """Both steps from clones of ``state`` on ``batches``: the donated
    state, the functional one, whether each donated step returned the
    dict it was given, the leaves that left their storage, and each
    step's metrics both ways."""
    functional, donated = _clone(state), _clone(state)
    ptrs = {k: t.data_ptr() for k, t in tree_leaves(donated)}
    f_step = make_train_step(bundle, tcfg)
    d_step = make_train_step(bundle, tcfg, donate=True)
    same_dict, metrics = True, []
    for batch in batches:
        functional, mf = f_step(functional, batch)
        got, md = d_step(donated, batch)
        same_dict &= got is donated
        metrics.append((mf, md))
    moved = [k for k, t in tree_leaves(donated) if t.data_ptr() != ptrs[k]]
    return donated, functional, same_dict, moved, metrics


def _assert_bit_equal(got, want):
    want = dict(tree_leaves(want))
    unequal = [k for k, t in tree_leaves(got)
               if not (t.dtype == want[k].dtype and torch.equal(t, want[k]))]
    assert not unequal, unequal


#: every arch with each optimizer and dtype; two microbatches on the dense
#: LM and the hybrid (the reduced xLSTM's steps are the slowest here)
CASES = [(a, o, m, d) for a in ARCHS for o in ("adamw", "adafactor")
         for m in ((1,) if a == "xlstm-350m" else (1, 2))
         for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("arch,opt,micro,dtype", CASES,
                         ids=[f"{a}-{o}-micro{m}-{d}" for a, o, m, d in CASES])
def test_donated_step_equals_functional(arch, opt, micro, dtype):
    """Three steps donated and functional from clones of one state: every
    leaf (step, parameters, moments) and every metric bit-equal, each
    donated step returns the dict it was given, and no donated leaf
    leaves its storage."""
    cfg = reduced_config(arch)
    bundle = build(cfg)
    tcfg = TrainConfig(optim=OptimConfig(name=opt, lr=1e-2, warmup_steps=2,
                                         total_steps=10),
                       microbatches=micro)
    state = init_train_state(bundle, tcfg, 0, "cpu")
    if dtype == "bfloat16":
        state["params"] = map_tree(lambda t: t.bfloat16(), state["params"])
        state["opt"] = opt_init(tcfg.optim, state["params"])
    donated, functional, same_dict, moved, metrics = \
        _donated_against_functional(bundle, tcfg, state, _batches(cfg,
                                                                  bundle))
    _assert_bit_equal(donated, functional)
    assert same_dict and not moved, moved
    assert int(donated["step"]) == STEPS
    for mf, md in metrics:
        assert all(torch.equal(mf[k], md[k]) for k in mf)
    assert all(t.dtype == torch.bfloat16 for _, t in
               tree_leaves(donated["params"])) == (dtype == "bfloat16")


def _toy_bundle():
    """A loss whose gradients the in-place update must not write as
    autograd hands them back: ``a + b``'s backward gives both one tensor,
    and a sum's an expanded (overlapping) one."""
    def loss_fn(params, batch):
        x = batch["x"]
        loss = ((x @ (params["a"] + params["b"])) ** 2).mean() \
            + params["c"].sum()
        return loss, {"tokens": torch.tensor(float(x.shape[0]))}

    return types.SimpleNamespace(loss_fn=loss_fn)


def test_donated_step_copies_shared_and_overlapping_gradients():
    """Gradients that are one tensor for two parameters, or an expanded
    one, are copied before the in-place clip and update, so the donated
    step still equals the functional one."""
    gen = torch.Generator().manual_seed(0)
    params = {k: torch.randn(s, generator=gen) for k, s in
              (("a", (4, 3)), ("b", (4, 3)), ("c", (5,)))}
    (_, _), grads = value_and_grad(_toy_bundle(), params,
                                   {"x": torch.randn(2, 4, generator=gen)})
    assert grads["a"].untyped_storage().data_ptr() == \
        grads["b"].untyped_storage().data_ptr()
    assert 0 in grads["c"].stride()
    tcfg = TrainConfig(optim=OptimConfig(lr=1e-1, warmup_steps=1))
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
             "opt": opt_init(tcfg.optim, params)}
    batches = [{"x": torch.randn(2, 4, generator=gen)} for _ in range(STEPS)]
    donated, functional, same_dict, moved, _ = _donated_against_functional(
        _toy_bundle(), tcfg, state, batches)
    _assert_bit_equal(donated, functional)
    assert same_dict and not moved


def test_async_checkpoint_of_a_donated_state(tmp_path, monkeypatch):
    """``AsyncCheckpointer.save``, then a donated step that rewrites the
    state while the save's thread has not yet written it, then ``wait``:
    the checkpoint restores the state as it was before the step."""
    cfg = reduced_config("aiida-demo-110m")
    bundle = build(cfg)
    tcfg = TrainConfig()
    state = init_train_state(bundle, tcfg, 0, "cpu")
    step = make_train_step(bundle, tcfg, donate=True)
    batches = _batches(cfg, bundle, n=2)
    state, _ = step(state, batches[0])
    before = _clone(state)
    stepped = threading.Event()
    write = ckpt._write

    def write_after_the_step(*args, **kw):
        assert stepped.wait(timeout=60)
        return write(*args, **kw)

    monkeypatch.setattr(ckpt, "_write", write_after_the_step)
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(1, state)
    state, _ = step(state, batches[1])
    stepped.set()
    saver.wait()
    assert int(state["step"]) == 2
    _assert_bit_equal(ckpt.restore_checkpoint(
        str(tmp_path), target=init_train_state(bundle, tcfg, 1, "cpu"),
        device="cpu"), before)


def test_dryrun_counts_the_donated_state():
    """The reduced dense LM's train cell, run for real on the CPU: the
    outputs alias the whole state (``alias_size_in_bytes``), and the temp
    is lower than the functional step's by at least 90% of the state's
    bytes (no second state). A decode cell aliases its cache."""
    bundle = build(reduced_config("aiida-demo-110m"))
    var = dr.BASELINE

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype)

    cell = ShapeCell("train_small", "train", 32, 4)
    mem = dr.cell_stats(bundle, cell, var, None,
                        device="cpu")["memory_analysis"]
    _, (state, batch) = dr.cell_inputs(bundle, cell, var, None, None, zeros)
    state_bytes = dr.local_bytes(state)
    assert mem["alias_size_in_bytes"] == state_bytes
    functional = make_train_step(bundle, TrainConfig(
        microbatches=var.microbatches,
        optim=OptimConfig(name=var.optimizer)))
    _, counter = dr.trace_step(functional, (state, batch))
    assert counter.peak_bytes - mem["temp_size_in_bytes"] >= \
        0.9 * state_bytes, (counter.peak_bytes, mem, state_bytes)
    cell = ShapeCell("decode_small", "decode", 32, 4)
    mem = dr.cell_stats(bundle, cell, var, None,
                        device="cpu")["memory_analysis"]
    _, (_, cache, _, _) = dr.cell_inputs(bundle, cell, var, None, None,
                                         zeros)
    assert mem["alias_size_in_bytes"] == dr.local_bytes(cache) > 0


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_donated_step_matches_reference_donated_step(opt):
    """Three steps of the port's donated step against the reference's
    step jitted with ``donate_argnums=(0,)``, from the reference's
    parameters (attention projections fan-in scaled) on the same batches,
    in fp32: loss, grad_norm and lr within 5e-5, every parameter within
    5e-5 plus the sign-flip allowance of
    ``tests/test_torch_training.py::test_train_step_matches_reference``
    (an entry whose gradient is at rounding level moves by up to 2 lr in
    either framework)."""
    arch = "aiida-demo-110m"
    over = dict(dtype="float32", kv_cache_dtype="float32",
                attn_impl="pallas")
    jcfg = j_reduced(arch).replace(**over)
    jb = j_build(jcfg)
    ocfg = dict(name=opt, lr=1e-2, warmup_steps=2, total_steps=10)
    jt = JTrainConfig(optim=J.OptimConfig(**ocfg))
    jstate = j_init_state(jb, jt, jax.random.PRNGKey(0))
    params = ranks.fan_in_scaled(jcfg, jax.tree.map(np.asarray,
                                                    jstate["params"]))
    jstate["params"] = jax.tree.map(jnp.asarray, params)
    cfg = reduced_config(arch).replace(**over)
    bundle = build(cfg)
    tt = TrainConfig(optim=OptimConfig(**ocfg))
    p = params_from_numpy(params, "cpu")
    state = {"step": torch.zeros((), dtype=torch.int32), "params": p,
             "opt": opt_init(tt.optim, p)}
    jstep = jax.jit(j_make_step(jb, jt), donate_argnums=(0,))
    step = make_train_step(bundle, tt, donate=True)
    g_min = {k: np.full(t.shape, np.inf) for k, t in tree_leaves(p)}
    lr_sum = 0.0
    for batch in _batches(cfg, bundle, seed=10):
        grads = clip_by_global_norm(value_and_grad(
            bundle, state["params"], batch)[1], 1.0)[0]
        for key, g in tree_leaves(grads):
            g = g.abs().numpy()
            g_min[key] = np.minimum(g_min[key], g / max(g.max(), 1e-30))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v.numpy())
                                    for k, v in batch.items()})
        state, m = step(state, batch)
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[name].item(), float(jm[name]),
                                       rtol=PARITY_TOL, err_msg=name)
        lr_sum += float(jm["lr"])
    assert int(state["step"]) == int(jstate["step"]) == STEPS
    want = {k: np.asarray(v) for k, v in tree_leaves(jstate["params"])}
    for key, got in tree_leaves(state["params"]):
        flip = np.minimum(2.0, 1e-5 / np.maximum(g_min[key], 1e-30))
        diff = np.abs(got.numpy() - want[key])
        assert (diff <= PARITY_TOL + lr_sum * flip).all(), \
            (key, float(diff.max()))
