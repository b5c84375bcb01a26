"""The port's example drivers and crash script on the CPU.

``examples/train_lm_torch.py`` (the ``PretrainWorkChain``): its losses
equal its recipe run directly; killed with SIGKILL after its first chunk
committed, ``--resume <pk>`` restores the model checkpoint and finishes
with the uninterrupted run's losses, also when the kill falls between
the model checkpoint and the engine's; without a card and without
``--device cpu`` it raises. Beside ``examples/train_lm.py`` (JAX on the
CPU) it prints the same state, exit and reports, writes the same node
and link rows (less its ``device`` input) and input values, and has the
same outline and exit codes. ``examples/serve_lm_torch.py`` serves its
requests on the CPU, and ``scripts/daemon_crash_test_torch.py`` recovers
its jobs from crashing workers. ``examples/quickstart_torch.py`` and
``examples/share_cache_torch.py`` print what their reference examples
print (less times), ``scripts/daemon_e2e_torch.py`` runs its four jobs
through a daemon on the CPU (and raises without a card and without
``--device``), and ``scripts/check_fault_points_torch.py`` finds the
port's fault points, scenarios and docs in sync, as the reference's lint
finds its own.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.provenance.store import NodeType, ProvenanceStore, \
    QueryBuilder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TRAIN = os.path.join(ROOT, "examples", "train_lm_torch.py")
# tiny preset, 6 steps in chunks of 2, on the CPU
RECIPE = ["--device", "cpu", "--steps", "6", "--chunk", "2"]


@pytest.fixture(autouse=True)
def _reset_port_state(monkeypatch):
    """The port's global state: caching policy, metrics registry, default
    runner and current store."""
    from repro_torch.caching.config import ENV_VAR, reset_policy
    from repro_torch.engine.runner import set_default_runner
    from repro_torch.observability.metrics import reset_registry
    from repro_torch.provenance.store import configure_store

    def reset():
        reset_policy()
        reset_registry()
        set_default_runner(None)
        configure_store(":memory:")

    monkeypatch.delenv(ENV_VAR, raising=False)
    reset()
    yield
    reset()


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))


def _run(args, cwd, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def _chain(db):
    store = ProvenanceStore(db)
    rows = (QueryBuilder(store).nodes(NodeType.WORK_CHAIN)
            .project("pk", "process_state", "exit_status").all())
    return store, rows


def _final_losses(store, pk):
    return _final_metrics(store, pk)["losses"]


def _committed_step(store, pk):
    """The chain's step in its last durable engine checkpoint."""
    ck = store.load_checkpoint(pk)
    if not ck:
        return 0
    return ck["extras"]["ctx"].get("step", {}).get("__raw__", 0)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_example():
    return _load(TRAIN, "train_lm_torch")


def _chain_pk(store):
    return (QueryBuilder(store).nodes(NodeType.WORK_CHAIN)
            .project("pk").all())[0]["pk"]


def _final_metrics(store, pk):
    from repro_torch.provenance.store import LinkType

    return next(store.load_data(p).value for p, _, label in
                store.outgoing(pk, LinkType.RETURN)
                if label == "final_metrics")


def test_pretrain_chain_equals_its_recipe_run_directly(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.engine.launch import run_get_node
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.models.registry import build
    from repro_torch.provenance.store import configure_store
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.optim import OptimConfig
    from repro_torch.training.train_step import (
        TrainConfig, init_train_state, make_train_step,
    )

    ex = _load_example()
    set_default_runner(Runner(store=configure_store(":memory:")))
    builder = ex.PretrainWorkChain.get_builder()
    builder.preset = ex.PRESETS["tiny"]
    builder.total_steps = 4
    builder.chunk_steps = 2
    builder.device = "cpu"
    builder.ckpt_dir = {"dir": str(tmp_path / "ckpt")}
    outputs, proc = run_get_node(builder)
    assert proc.is_finished_ok
    metrics = outputs["final_metrics"].value
    assert metrics["steps"] == 4 and len(metrics["losses"]) == 2

    cfg = get_config("aiida-demo-110m").replace(**ex.PRESETS["tiny"])
    bundle = build(cfg)
    tcfg = TrainConfig(optim=OptimConfig(lr=3e-3, warmup_steps=10,
                                         total_steps=4))
    state = init_train_state(bundle, tcfg, 0, "cpu")
    step_fn = make_train_step(bundle, tcfg)
    data = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  batch_size=4, seed=17))
    direct = []
    for i in range(4):
        state, m = step_fn(state, {k: torch.from_numpy(v.copy())
                                   for k, v in data.next_batch().items()})
        if i % 2:
            direct.append(float(m["loss"]))
    np.testing.assert_allclose(metrics["losses"], direct, rtol=1e-6)


@pytest.fixture(scope="module")
def whole_run_losses(tmp_path_factory):
    """The losses of the recipe run through without a kill."""
    whole = tmp_path_factory.mktemp("whole")
    done = _run([TRAIN, *RECIPE], cwd=whole)
    assert done.returncode == 0, done.stderr
    store, rows = _chain(str(whole / "examples_out" / "train_lm.db"))
    want = _final_losses(store, rows[0]["pk"])
    store.close()
    return want


def test_killed_chain_resumes_from_its_last_chunk(tmp_path,
                                                  whole_run_losses):
    killed = tmp_path / "killed"
    killed.mkdir()
    proc = subprocess.Popen([sys.executable, TRAIN, *RECIPE], cwd=killed,
                            env=_env(), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    db = str(killed / "examples_out" / "train_lm.db")
    pk, deadline = None, time.time() + 240
    try:
        while time.time() < deadline and proc.poll() is None:
            if os.path.exists(db):
                store, rows = _chain(db)
                if rows:
                    pk = rows[0]["pk"]
                    if _committed_step(store, pk) >= 2:
                        store.close()
                        break
                store.close()
            time.sleep(0.02)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    assert pk is not None and proc.returncode == -signal.SIGKILL, \
        proc.stderr.read().decode()
    store, rows = _chain(db)
    assert rows[0]["process_state"] not in ("finished", "excepted")
    store.close()

    resumed = _run([TRAIN, "--device", "cpu", "--resume", str(pk)],
                   cwd=killed)
    assert resumed.returncode == 0, resumed.stderr
    assert "state=finished" in resumed.stdout
    store, rows = _chain(db)
    assert rows[0]["process_state"] == "finished"
    assert rows[0]["exit_status"] == 0
    reports = [log["message"] for log in store.get_logs(pk)]
    assert any(m.startswith("restored model checkpoint at step")
               for m in reports), reports
    got = _final_losses(store, pk)
    store.close()
    assert len(got) == 3
    np.testing.assert_allclose(got, whole_run_losses, rtol=1e-6)


# the example with its tensor checkpointer patched to SIGKILL the process
# right after the second chunk's model checkpoint, before the engine
# checkpoints the chain: the model checkpoint is then one chunk ahead of
# the chain's step and data cursor
_KILL_AFTER_MODEL_SAVE = """
import os, runpy, signal, sys
from repro_torch.training import checkpoint

save = checkpoint.save_checkpoint


def save_then_die(directory, step, state, **kwargs):
    path = save(directory, step, state, **kwargs)
    if step == 4:
        os.kill(os.getpid(), signal.SIGKILL)
    return path


checkpoint.save_checkpoint = save_then_die
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def test_kill_between_model_and_engine_checkpoints_resumes_exactly(
        tmp_path, whole_run_losses):
    from repro_torch.training.checkpoint import latest_step

    proc = _run(["-c", _KILL_AFTER_MODEL_SAVE, TRAIN, *RECIPE], cwd=tmp_path)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    db = str(tmp_path / "examples_out" / "train_lm.db")
    store, rows = _chain(db)
    pk = rows[0]["pk"]
    assert _committed_step(store, pk) == 2
    store.close()
    assert latest_step(str(tmp_path / "examples_out" / f"ckpt_{pk}")) == 4

    resumed = _run([TRAIN, "--device", "cpu", "--resume", str(pk)],
                   cwd=tmp_path)
    assert resumed.returncode == 0, resumed.stderr
    store, rows = _chain(db)
    assert rows[0]["process_state"] == "finished"
    reports = [log["message"] for log in store.get_logs(pk)]
    assert "restored model checkpoint at step 2" in reports, reports
    got = _final_losses(store, pk)
    store.close()
    np.testing.assert_allclose(got, whole_run_losses, rtol=1e-6)


# ---------------------------------------------------------------------------
# parity with the reference's example (examples/train_lm.py, JAX on the CPU)
# ---------------------------------------------------------------------------

def _outline(instructions):
    return [(type(i).__name__, getattr(i, "name", None),
             getattr(i, "cond_name", None),
             _outline(getattr(i, "body", []))) for i in instructions]


def _rows(db):
    """The store's node and link rows, less what differs between runs."""
    import sqlite3

    conn = sqlite3.connect(db)
    try:
        nodes = conn.execute(
            "SELECT pk, node_type, process_type, label, process_state,"
            " exit_status, exit_message FROM nodes ORDER BY pk").fetchall()
        links = conn.execute(
            "SELECT in_id, out_id, link_type, label FROM links"
            " ORDER BY pk").fetchall()
    finally:
        conn.close()
    return nodes, links


def _without_device_input(nodes, links):
    """The port's chain takes its device as an input; renumber the rest."""
    device = {i for i, _, _, label in links if label == "device"}
    keep = [n for n in nodes if n[0] not in device]
    pk = {n[0]: k + 1 for k, n in enumerate(keep)}
    return ([(pk[n[0]], *n[1:]) for n in keep],
            [(pk[i], pk[o], t, label) for i, o, t, label in links
             if i not in device])


def test_pretrain_chain_matches_the_reference_example(tmp_path):
    import re

    recipe = ["--steps", "4", "--chunk", "2"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    ref = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "train_lm.py"),
         *recipe], cwd=ref_dir, env=dict(_env(), JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    port = _run([TRAIN, "--device", "cpu", *recipe], cwd=port_dir)
    assert ref.returncode == 0, ref.stderr
    assert port.returncode == 0, port.stderr

    # the same state, exit and reports; losses, norms and rates differ
    # (the two packages draw their initial weights apart)
    def masked(out):
        return re.sub(r"\d+\.\d+", "<x>", out).splitlines()

    assert masked(port.stdout) == masked(ref.stdout)
    assert "state=finished exit=ExitCode(status=0" in ref.stdout

    ref_db = str(ref_dir / "examples_out" / "train_lm.db")
    port_db = str(port_dir / "examples_out" / "train_lm.db")
    assert _without_device_input(*_rows(port_db)) == _rows(ref_db)

    # the chain's inputs hold the same values, but the kernels' attention
    def values(db):
        store = ProvenanceStore(db)
        try:
            chain = _chain_pk(store)
            got = {label: store.load_data(p).value
                   for p, _, label in store.incoming(chain)}
            got["final_metrics"] = _final_metrics(store, chain)
        finally:
            store.close()
        return got

    want, got = values(ref_db), values(port_db)
    assert got.pop("device") == "cpu"
    assert got["preset"].pop("attn_impl") == "pallas"
    ref_m, port_m = want.pop("final_metrics"), got.pop("final_metrics")
    assert got == want
    assert sorted(port_m) == sorted(ref_m)
    assert port_m["steps"] == ref_m["steps"] == 4
    assert port_m["nan_restarts"] == ref_m["nan_restarts"] == 0
    assert len(port_m["losses"]) == len(ref_m["losses"]) == 2
    assert np.isfinite(port_m["losses"]).all()
    assert port_m["final_loss"] == port_m["losses"][-1]

    # the same outline and exit codes
    ref_chain = _load(os.path.join(ROOT, "examples", "train_lm.py"),
                      "train_lm").PretrainWorkChain.spec()
    port_chain = _load_example().PretrainWorkChain.spec()
    assert (_outline(port_chain.get_outline())
            == _outline(ref_chain.get_outline()))
    assert ({k: tuple(v) for k, v in port_chain.exit_codes.items()}
            == {k: tuple(v) for k, v in ref_chain.exit_codes.items()})


def test_train_example_without_a_card_or_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example trains on it")
    out = _run([TRAIN, "--steps", "2", "--chunk", "2"], cwd=tmp_path)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert not (tmp_path / "examples_out").exists()


def test_serve_example_on_the_cpu(tmp_path):
    out = _run([os.path.join(ROOT, "examples", "serve_lm_torch.py"),
                "--device", "cpu", "--requests", "5", "--new-tokens", "8"],
               cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "served 5 requests through 4 slots" in out.stdout


def test_crash_script_recovers_its_jobs_on_the_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "daemon_crash_test_torch",
        os.path.join(ROOT, "scripts", "daemon_crash_test_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.crash_recovery(str(tmp_path / "daemon"),
                             {**mod.JOB, "device": "cpu"})
    assert out["restarts"] >= 1
    assert set(out["states"].values()) == {"finished"}, out["states"]
    assert set(out["exit_statuses"].values()) == {0}
    json.dumps(out["broker"])           # the stats travel as JSON


def _masked(text):
    """Printed lines less times (``0.06s``) and speed-ups (``2.2x``)."""
    import re

    return re.sub(r"\d+\.\d+(?=[sx]\b)", "<x>", text).splitlines()


@pytest.mark.parametrize("example", ["quickstart", "share_cache"])
def test_engine_example_prints_what_the_reference_prints(tmp_path, example):
    """The example and its reference, each in its own working directory:
    the same sections, values, node and link counts and cache hits; each
    writes its stores under ``examples_out/`` there."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    ref = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", f"{example}.py")],
        cwd=ref_dir, env=dict(_env(), JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    port = _run([os.path.join(ROOT, "examples", f"{example}_torch.py")],
                cwd=port_dir)
    assert ref.returncode == 0, ref.stderr
    assert port.returncode == 0, port.stderr
    assert _masked(port.stdout) == _masked(ref.stdout)
    assert sorted(os.listdir(port_dir / "examples_out")) == sorted(
        os.listdir(ref_dir / "examples_out"))
    if example == "share_cache":
        assert "12/12 cache hits" in port.stdout
    else:
        assert "process.workchain        3 nodes" in port.stdout


def test_engine_example_takes_an_output_directory(tmp_path):
    out = _run([os.path.join(ROOT, "examples", "share_cache_torch.py"),
                "--out", "elsewhere"], cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "-> elsewhere/share_results.zip" in out.stdout
    assert not (tmp_path / "examples_out").exists()
    out = _run([os.path.join(ROOT, "examples", "quickstart_torch.py"),
                "--out", "elsewhere"], cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "elsewhere" / "quickstart.db").exists()


def test_daemon_e2e_script_passes_on_the_cpu(tmp_path):
    import re

    out = _run([os.path.join(ROOT, "scripts", "daemon_e2e_torch.py"),
                "--device", "cpu"], cwd=tmp_path, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.splitlines()[-1] == "DAEMON E2E PASS"
    jobs = re.findall(r"^(\d+) (\w+) exit: (\S+)$", out.stdout, re.M)
    assert len(jobs) == 4
    assert {(state, status) for _, state, status in jobs} == {
        ("finished", "0")}


def test_daemon_e2e_script_without_a_card_or_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script trains on it")
    out = _run([os.path.join(ROOT, "scripts", "daemon_e2e_torch.py")],
               cwd=tmp_path)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "daemon started" not in out.stdout


def test_fault_point_lint_passes_as_the_reference_lint_does():
    import re

    ref = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "check_fault_points.py")],
        env=dict(_env(), JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=120)
    port = _run([os.path.join(ROOT, "scripts",
                              "check_fault_points_torch.py")], cwd=ROOT)
    assert ref.returncode == 0, ref.stdout
    assert port.returncode == 0, port.stdout
    counts = re.compile(r"OK \((\d+) points instrumented, (\d+) scenarios")
    assert counts.search(port.stdout).groups() == counts.search(
        ref.stdout).groups()
