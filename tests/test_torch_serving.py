"""The port's continuous-batching scheduler and engines against the
reference's, on the CPU.

With the reference's parameters bridged into the port, the port's
``BatchScheduler`` must give greedy tokens (and finish reasons) identical
to the reference scheduler in each scheduling scenario of
``tests/test_serving.py``. Also: the engine memo, the ``generate``
calcfunction (a cache hit runs zero decode steps; with the reference's
parameters in float32 it returns the reference's tokens and stats), the
rule that entry points without ``device=`` (or ``on_device``) raise where
there is no card, and that the port imports neither JAX nor ``repro``.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models.registry import build as j_build
from repro.serving.serve import BatchScheduler as JScheduler
from repro.serving.serve import Request as JRequest
from repro_torch.configs import reduced_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build
from repro_torch.serving.serve import BatchScheduler, QueueFullError, Request

ARCH = "aiida-demo-110m"


def _models(decode_impl="direct"):
    over = dict(dtype="float32", kv_cache_dtype="float32",
                decode_impl=decode_impl)
    jb = j_build(j_reduced(ARCH).replace(**over))
    jp = jb.init_params(jax.random.PRNGKey(0))
    b = build(reduced_config(ARCH).replace(**over))
    return (jb, jp), (b, params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu"))


@pytest.fixture(scope="module")
def lm():
    return _models()


def _prompts(n, length=6, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, length).tolist() for _ in range(n)]


def _serve_both(lm, prompts, new_tokens, *, batch=2, max_len=64, eos_id=-1):
    """Serve ``prompts`` through the reference and the port; assert they
    agree and return the port's (scheduler, requests)."""
    (jb, jp), (b, p) = lm
    jsched = JScheduler(jb, jp, batch_size=batch, max_len=max_len,
                        eos_id=eos_id)
    jreqs = [JRequest(rid=i, prompt=list(pr), max_new_tokens=new_tokens)
             for i, pr in enumerate(prompts)]
    sched = BatchScheduler(b, p, batch_size=batch, max_len=max_len,
                           eos_id=eos_id, device="cpu")
    reqs = [Request(rid=i, prompt=list(pr), max_new_tokens=new_tokens)
            for i, pr in enumerate(prompts)]
    for s, rs in ((jsched, jreqs), (sched, reqs)):
        for r in rs:
            s.submit(r)
        s.run()
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [r.finish_reason for r in reqs] == \
        [r.finish_reason for r in jreqs]
    return sched, reqs


def test_max_new_tokens_enforced(lm):
    _, reqs = _serve_both(lm, _prompts(3), new_tokens=5)
    for r in reqs:
        assert r.done and r.finish_reason == "length"
        assert len(r.generated) == 5


def test_slot_reuse_after_eos(lm):
    prompts = _prompts(2)
    _, probe = _serve_both(lm, [prompts[0]], new_tokens=4)
    eos = probe[0].generated[1]
    sched, reqs = _serve_both(lm, prompts, new_tokens=8, batch=1, eos_id=eos)
    assert reqs[0].finish_reason == "eos"
    assert len(reqs[0].generated) <= 2
    assert reqs[1].done
    assert reqs[1].started_at >= reqs[0].finished_at
    assert all(s is None for s in sched.slots)


def test_fifo_admission_under_full_batch(lm):
    _, reqs = _serve_both(lm, _prompts(6), new_tokens=4, batch=2)
    starts = [r.started_at for r in reqs]
    assert starts == sorted(starts)
    assert all(r.done for r in reqs)


def test_cobatched_neighbors_do_not_leak(lm):
    prompts = _prompts(4, seed=8)
    _, alone = _serve_both(lm, [prompts[0]], new_tokens=6, batch=4)
    _, crowd = _serve_both(lm, prompts, new_tokens=6, batch=4)
    assert alone[0].generated == crowd[0].generated


def test_mixed_prompt_lengths_at_different_depths(lm):
    """Co-batched slots at different positions (ragged per-row depths)."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 500, n).tolist() for n in (3, 11, 7, 20, 5)]
    _serve_both(lm, prompts, new_tokens=7, batch=3)


def test_cache_full_eviction(lm):
    _, reqs = _serve_both(lm, _prompts(1, length=12), new_tokens=100,
                          batch=1, max_len=16)
    assert reqs[0].done and reqs[0].finish_reason == "cache_full"
    assert len(reqs[0].generated) < 100


def test_oversized_prompt_rejected(lm):
    _, (b, p) = lm
    sched = BatchScheduler(b, p, batch_size=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="cannot fit"):
        sched.submit(Request(rid=0, prompt=list(range(1, 17)),
                             max_new_tokens=1))


def test_max_pending_rejects_with_counter(lm):
    from repro_torch.observability.metrics import get_registry

    _, (b, p) = lm
    sched = BatchScheduler(b, p, batch_size=1, max_len=16, max_pending=2,
                           device="cpu")
    reqs = [Request(rid=i, prompt=[1, 2, 3], max_new_tokens=1)
            for i in range(3)]
    sched.submit(reqs[0])
    sched.submit(reqs[1])
    rejected = get_registry().counter("serving.rejected")
    before = rejected.value
    with pytest.raises(QueueFullError, match="max_pending=2"):
        sched.submit(reqs[2])
    assert rejected.value == before + 1
    sched.run()
    assert reqs[0].done and reqs[1].done
    sched.submit(reqs[2])
    assert len(sched.queue) == 1


def test_max_pending_validation(lm):
    _, (b, p) = lm
    with pytest.raises(ValueError, match="max_pending"):
        BatchScheduler(b, p, batch_size=1, max_len=16, max_pending=0,
                       device="cpu")


def test_serving_metrics_keep_their_names(lm):
    from repro_torch.observability.metrics import reset_registry

    reg = reset_registry()
    _, reqs = _serve_both(lm, _prompts(3), new_tokens=4, batch=2)
    c = reg.snapshot()["counters"]
    assert c["serving.requests_submitted"] == 3
    assert c["serving.requests_completed"] == 3
    assert c["serving.tokens_generated"] == 12
    assert c["serving.prefill_tokens"] == 18
    assert c["serving.decode_steps"] >= 3
    assert reg.histogram("serving.request_seconds").count == 3


def test_kernel_decode_route_matches_direct(lm):
    """decode_impl='pallas' (the decode kernel's route; its plain version
    on the CPU) gives the same greedy tokens as the masked einsum, and
    both match the reference's kernel route."""
    prompts = _prompts(3, seed=10)
    _, direct = _serve_both(lm, prompts, new_tokens=6)
    _, routed = _serve_both(_models("pallas"), prompts, new_tokens=6)
    assert [r.generated for r in direct] == [r.generated for r in routed]


def test_engine_memo_buckets_by_cache_size():
    from repro_torch.serving.inference import get_engine, reset_engines

    reset_engines()
    e1 = get_engine(ARCH, 0, need_len=10, device="cpu")
    e2 = get_engine(ARCH, 0, need_len=100, device="cpu")   # same 128 bucket
    e3 = get_engine(ARCH, 0, need_len=200, device="cpu")   # next power of 2
    assert e1 is e2
    assert e3 is not e1
    assert e3.scheduler.max_len == 256
    req = e1.generate_one([3, 5, 7, 11], 4)
    assert req.done and len(req.generated) == 4
    reset_engines()


def test_prompt_fingerprint_matches_reference():
    from repro.serving.inference import prompt_fingerprint as j_fp
    from repro_torch.serving.inference import prompt_fingerprint

    assert prompt_fingerprint(ARCH, 3, [1, 2, 3]) == j_fp(ARCH, 3, [1, 2, 3])
    assert prompt_fingerprint(ARCH, 3, [1, 2, 3]) != \
        prompt_fingerprint(ARCH, 3, [1, 2, 4])


def test_entry_points_without_device_raise_where_there_is_no_card(
        monkeypatch, lm, port_engine):
    from repro_torch.core.datatypes import ArrayData, Int, Str
    from repro_torch.serving.inference import (ServingEngine, generate,
                                               get_engine)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (b, p) = lm
    calls = [
        lambda: b.init_params(0),
        lambda: b.init_cache(1, 16),
        lambda: BatchScheduler(b, p, batch_size=1, max_len=16),
        lambda: ServingEngine(ARCH, 0, 128),
        lambda: get_engine(ARCH, 0),
        lambda: params_from_numpy({"w": np.zeros(2, np.float32)}),
        lambda: generate(Str(ARCH), ArrayData(np.asarray([1, 2], np.int32)),
                         Int(2), Int(0), Int(-1)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_recurrent_family_rejected():
    """Twin of tests/test_serving.py's: the scheduler splices per-slot KV
    rows and refuses the hybrid, whose state has none."""
    cfg = reduced_config("recurrentgemma-2b")
    bundle = build(cfg)
    params = bundle.init_params(0, "cpu")
    with pytest.raises(ValueError, match="recurrent"):
        BatchScheduler(bundle, params, batch_size=1, max_len=16,
                       device="cpu")


def test_hybrid_entry_points_without_device_raise_where_there_is_no_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = build(reduced_config("recurrentgemma-2b"))
    for call in (lambda: b.init_params(0), lambda: b.init_cache(1, 16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # with the CPU named, they run there
    assert b.init_params(0, "cpu")["layers"][0]["kind_rglru"]["lam"] \
        .device.type == "cpu"
    state = b.init_cache(2, 16, "cpu")
    assert len(state) == 3 and state[2]["k"].shape[1] == 16


IMPORT_PROG = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.path.insert(0, {src!r})
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.")
                 or m == "repro" or m.startswith("repro."))
    print("MODULES", len(names))
    print("NAMES", " ".join(names))
    print("BAD", bad)
""")


def test_port_imports_neither_jax_nor_repro():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_PROG.format(src=os.path.abspath(src))],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout
    n = int(proc.stdout.split("MODULES")[1].split()[0])
    assert n >= 72, proc.stdout
    names = proc.stdout.split("NAMES")[1].split("\n")[0].split()
    for mod in ("training.data", "training.optim", "training.train_step",
                "training.checkpoint", "launch.train", "models.xlstm",
                "models.encdec", "kernels.mlstm_chunk.ops", "kernels.mlstm_chunk.ref",
                "observability.metrics", "observability.trace",
                "observability.timeline", "chaos.faults",
                "provenance.repository", "provenance.store",
                "core.exit_code", "core.statemachine", "core.ports",
                "core.process_spec", "core.datatypes", "core.builder",
                "core.process", "core.process_functions",
                "caching.hashing", "caching.config", "caching.registry",
                "engine.communicator", "engine.transport", "engine.runner",
                "engine.launch", "serving.inference"):
        assert f"repro_torch.{mod}" in names, mod


def test_chip_smoke_imports_neither_jax_nor_repro():
    root = os.path.join(os.path.dirname(__file__), "..")
    prog = textwrap.dedent(f"""
        import runpy, sys
        mod = runpy.run_path({os.path.join(os.path.abspath(root),
                                           'chip_smoke.py')!r},
                             run_name="not_main")
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print("BAD", bad)
    """)
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout
    with open(os.path.join(root, "chip_smoke.py")) as f:
        text = f.read()
    assert "import jax" not in text and "from repro." not in text


# ---------------------------------------------------------------------------
# the generate calcfunction
# ---------------------------------------------------------------------------

@pytest.fixture()
def port_engine():
    """The port's global engine state, fresh: caching policy, metrics
    registry, an in-memory store with a runner as the default, and the
    serving engine memo."""
    from repro_torch.caching.config import reset_policy
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.observability.metrics import reset_registry
    from repro_torch.provenance.store import configure_store
    from repro_torch.serving.inference import reset_engines

    def reset():
        reset_policy()
        reset_registry()
        reset_engines()
        set_default_runner(None)
        return configure_store(":memory:")

    runner = Runner(store=reset())
    set_default_runner(runner)
    yield runner
    reset()


def _generate(prompt, new=4, seed=0):
    from repro_torch.core.datatypes import ArrayData, Int, Str
    from repro_torch.serving.inference import generate

    return generate(Str(ARCH), ArrayData(np.asarray(prompt, np.int32)),
                    Int(new), Int(seed), Int(-1))


def test_generate_cache_hit_runs_zero_decode_steps(port_engine):
    """Twin of tests/test_serving.py's, on the CPU through on_device."""
    from repro_torch.caching import enable_caching
    from repro_torch.observability.metrics import get_registry
    from repro_torch.serving.inference import on_device, prompt_fingerprint

    steps = get_registry().counter("serving.decode_steps")
    prompt = [3, 5, 7, 11, 13]
    with on_device("cpu"), enable_caching():
        cold = _generate(prompt)
        before = steps.value
        assert before > 0
        hot = _generate(prompt)
    assert steps.value == before, "cache hit must not touch the decoder"
    np.testing.assert_array_equal(np.asarray(cold["tokens"].value),
                                  np.asarray(hot["tokens"].value))
    stats = hot["stats"].value
    assert stats["new_tokens"] == len(np.asarray(hot["tokens"].value))
    assert stats["fingerprint"] == prompt_fingerprint(ARCH, 0, prompt)
    attrs = [json.loads(r["attributes"] or "{}") for r in
             _calc_nodes(port_engine.store)]
    assert len(attrs) == 2 and "cached_from" not in attrs[0]
    assert attrs[1]["cached_from_pk"] == 1


def test_generate_distinct_prompts_do_not_collide(port_engine):
    """Twin of tests/test_serving.py's, on the CPU through on_device."""
    from repro_torch.caching import enable_caching
    from repro_torch.serving.inference import on_device

    with on_device("cpu"), enable_caching():
        a = _generate([1, 2, 3])
        b = _generate([1, 2, 4])
    fa = a["stats"].value["fingerprint"]
    fb = b["stats"].value["fingerprint"]
    assert fa != fb
    nodes = _calc_nodes(port_engine.store)
    assert len({r["node_hash"] for r in nodes}) == 2
    assert all("cached_from" not in json.loads(r["attributes"] or "{}")
               for r in nodes)


def _calc_nodes(store):
    from repro_torch.provenance.store import NodeType, QueryBuilder

    return (QueryBuilder(store).nodes(NodeType.CALC_FUNCTION)
            .project("node_hash", "attributes").all())


def test_on_device_is_restored_and_not_fingerprinted(port_engine):
    from repro_torch.caching import enable_caching
    from repro_torch.serving import inference

    assert inference._DEVICE is None
    with inference.on_device("cpu"):
        with inference.on_device(torch.device("cpu")):
            pass
        assert inference._DEVICE == "cpu"
        with enable_caching():
            _generate([9, 8, 7])
    assert inference._DEVICE is None
    # the device is neither an input nor a stat
    (node,) = _calc_nodes(port_engine.store)
    labels = {label for _, _, label in
              port_engine.store.incoming(node["pk"])}
    assert labels == {"arch", "prompt", "max_new_tokens", "seed", "eos_id"}
    assert "device" not in node["attributes"]


def test_generate_matches_reference(port_engine, runner, monkeypatch):
    """With both packages' serving config in float32 and the reference's
    parameters in the port's engine, the two ``generate`` calls give
    identical tokens and stats (but the wall time)."""
    import repro.serving.inference as j_inf
    from repro.core.datatypes import ArrayData as JArrayData
    from repro.core.datatypes import Int as JInt
    from repro.core.datatypes import Str as JStr
    from repro_torch.serving import inference

    def f32(reduced):
        return lambda arch, decode_impl: reduced(arch).replace(
            decode_impl=decode_impl, dtype="float32",
            kv_cache_dtype="float32")

    monkeypatch.setattr(j_inf, "_serving_config", f32(j_reduced))
    monkeypatch.setattr(inference, "_serving_config", f32(reduced_config))
    j_inf.reset_engines()
    prompt, new = [7, 1, 300, 42, 5, 99], 6
    try:
        j_eng = j_inf.get_engine(ARCH, 0, need_len=len(prompt) + new)
        eng = inference.get_engine(ARCH, 0, need_len=len(prompt) + new,
                                   device="cpu")
        assert eng.cfg.dtype == "float32"
        eng.params = params_from_numpy(
            jax.tree.map(np.asarray, j_eng.params), "cpu")
        eng.scheduler = BatchScheduler(
            eng.bundle, eng.params, batch_size=inference.DEFAULT_BATCH_SIZE,
            max_len=eng.scheduler.max_len, eos_id=-1, device="cpu")
        want = j_inf.generate(JStr(ARCH),
                              JArrayData(np.asarray(prompt, np.int32)),
                              JInt(new), JInt(0), JInt(-1))
        with inference.on_device("cpu"):
            got = _generate(prompt, new)
    finally:
        j_inf.reset_engines()
    np.testing.assert_array_equal(got["tokens"].value, want["tokens"].value)
    assert got["tokens"].value.dtype == want["tokens"].value.dtype
    g, w = dict(got["stats"].value), dict(want["stats"].value)
    assert g.pop("wall_seconds") >= 0 and w.pop("wall_seconds") >= 0
    assert g == w and g["new_tokens"] == new
