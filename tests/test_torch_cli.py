"""The port's CLI (the verdi role), on the CPU.

Twins of ``tests/test_cli.py`` (``GPUTrainJob`` for ``TPUTrainJob``) and
of the two CLI cases of ``tests/test_control.py``
(``test_cli_kill_falls_back_to_durable_marker``,
``test_cli_kill_terminates_daemon_process``, its job on the CPU), run
against ``repro_torch``. Also: ``python -m repro_torch.cli`` over a
profile loads no torch, and the CLI and the backfill's class resolver
refuse the reference package's classes and modules without importing
them. And the two packages' CLIs, run over one store this package wrote,
print the same for the store, graph, fsck, chaos-check and archive
commands, and write byte-identical archives.
"""

import asyncio
import json
import os
import re
import subprocess
import sys

import pytest

from repro_torch import cli
from repro_torch.core import ArrayData, Int, WorkChain, calcfunction
from repro_torch.core.process import Process
from repro_torch.engine.broker import BrokerServer
from repro_torch.engine.daemon import make_process_task_handler
from repro_torch.engine.runner import Runner, set_default_runner
from repro_torch.provenance.store import configure_store

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(autouse=True)
def _reset_port_state(monkeypatch):
    """The port's global state: caching policy, metrics registry, default
    runner and current store."""
    from repro_torch.caching.config import ENV_VAR, reset_policy
    from repro_torch.observability.metrics import reset_registry

    def reset():
        reset_policy()
        reset_registry()
        set_default_runner(None)
        configure_store(":memory:")

    monkeypatch.delenv(ENV_VAR, raising=False)
    reset()
    yield
    reset()


@pytest.fixture()
def profile(tmp_path):
    db = str(tmp_path / "profile.db")
    store = configure_store(db)
    set_default_runner(Runner(store=store))

    @calcfunction
    def add(a, b):
        return a + b

    add(Int(1), Int(2))
    store.close()
    set_default_runner(None)
    return db


def test_process_list(profile, capsys):
    cli.main(["-p", profile, "process", "list"])
    out = capsys.readouterr().out
    assert "add" in out and "finished" in out


def test_process_report_and_show(profile, capsys):
    cli.main(["-p", profile, "process", "list"])
    capsys.readouterr()
    cli.main(["-p", profile, "process", "report", "1"])
    out = capsys.readouterr().out
    assert "add<1>" in out
    cli.main(["-p", profile, "process", "show", "1"])
    out = capsys.readouterr().out
    assert "input_calc" in out and "create" in out


def test_graph_export(profile, tmp_path, capsys):
    out_file = str(tmp_path / "g.dot")
    cli.main(["-p", profile, "graph", "export", "1", "--out", out_file])
    content = open(out_file).read()
    assert content.startswith("digraph provenance")
    assert "n1" in content and "->" in content


def test_stats(profile, capsys):
    cli.main(["-p", profile, "stats"])
    out = capsys.readouterr().out
    assert "process.calcfunction" in out
    assert "unfinished processes: 0" in out


def test_process_inputs_spec_dump(profile, capsys):
    cli.main(["-p", profile, "process", "inputs",
              "repro_torch.calcjobs:GPUTrainJob"])
    out = capsys.readouterr().out
    assert "GPUTrainJob" in out
    assert "config" in out and "Dict" in out and "required" in out
    assert "metadata/" in out and "non_db" in out
    assert "ERROR_NAN_LOSS" in out


def test_process_inputs_bare_name_and_bad_name(profile, capsys):
    cli.main(["-p", profile, "process", "inputs", "GPUTrainJob"])
    out = capsys.readouterr().out
    assert "repro_torch.calcjobs" in out
    with pytest.raises(SystemExit, match="cannot resolve"):
        cli.main(["-p", profile, "process", "inputs", "NopeNotAClass"])


def test_cache_stats_reports_collisions(profile, capsys):
    cli.main(["-p", profile, "cache", "stats"])
    out = capsys.readouterr().out
    assert "collisions" in out
    assert "0 hash-collision occurrence(s)" in out


# ---------------------------------------------------------------------------
# twin of tests/test_control.py::test_cli_kill_falls_back_to_durable_marker
# ---------------------------------------------------------------------------

class Spin(Process):
    """Runs 'forever' in small interruptible slices — a control target."""

    async def run(self):
        for _ in range(5000):
            await self._pause_point()
            await self.interruptible(asyncio.sleep(0.01))


def run(coro, timeout=60):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


def test_cli_kill_falls_back_to_durable_marker(tmp_path, capsys):
    """`process kill` on a pk with no live endpoint (queued, or its
    worker died) records the kill durably; the next pickup honours it."""
    db = str(tmp_path / "store.db")

    async def main():
        server = BrokerServer(str(tmp_path / "broker.db"))
        host, port = await server.start()
        with open(tmp_path / "broker.json", "w") as fh:
            json.dump({"host": host, "port": port}, fh)
        store = configure_store(db)
        process = Spin(inputs={}, runner=Runner(store=store))
        pk = process.pk
        store.close()

        def cli_kill():
            cli.main(["-p", db, "process", "kill", str(pk),
                      "-w", str(tmp_path), "--message", "late kill"])

        await asyncio.get_running_loop().run_in_executor(None, cli_kill)
        return pk

    pk = run(main())
    assert "kill recorded durably" in capsys.readouterr().out

    async def resume():
        store = configure_store(db)
        runner = Runner(store=store)
        await make_process_task_handler(runner, store)({"pk": pk})
        return store.get_node(pk)

    node = run(resume())
    assert node["process_state"] == "killed"
    assert json.loads(node["attributes"])["kill_requested"] == "late kill"


# ---------------------------------------------------------------------------
# what the CLI loads: no torch for the store's commands, never the reference
# ---------------------------------------------------------------------------

def _fresh(code, *args):
    """Run ``code`` in a fresh interpreter with the repo's ``src`` on the
    path; returns the completed process."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-c", code, *args], env=env,
                          capture_output=True, text=True, timeout=120)


_CLI_THEN_MODULES = """
import json, sys
from repro_torch import cli
try:
    cli.main(sys.argv[1:])
    code = 0
except SystemExit as exc:
    code = exc.code
print(json.dumps({"code": code if isinstance(code, int) else str(code),
                  "torch": "torch" in sys.modules,
                  "jax": "jax" in sys.modules,
                  "repro": sorted(m for m in sys.modules
                                  if m == "repro" or m.startswith("repro."))}))
"""


def _cli_in_fresh_process(*argv):
    proc = _fresh(_CLI_THEN_MODULES, *argv)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [
    ["process", "list"], ["process", "report", "1"], ["process", "show", "1"],
    ["node", "show", "1"], ["graph", "export", "1"], ["stats"],
    ["cache", "stats"], ["cache", "show", "1"], ["cache", "backfill"],
    ["archive", "create", "-o", "{tmp}/a.zip", "--all"],
    ["store", "fsck"], ["chaos", "check"],
])
def test_store_commands_load_no_torch(profile, tmp_path, argv):
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    out, loaded = _cli_in_fresh_process("-p", profile, *argv)
    assert loaded["code"] in (0, None), out
    assert not loaded["torch"] and not loaded["jax"] and not loaded["repro"]


def test_archive_inspect_and_import_load_no_torch(profile, tmp_path):
    archive = str(tmp_path / "a.zip")
    _cli_in_fresh_process("-p", profile, "archive", "create", "-o", archive,
                          "--all")
    for argv in (["archive", "inspect", archive],
                 ["-p", str(tmp_path / "b.db"), "archive", "import",
                  archive]):
        if argv[0] != "-p":
            argv = ["-p", profile, *argv]
        out, loaded = _cli_in_fresh_process(*argv)
        assert loaded["code"] in (0, None), out
        assert not loaded["torch"] and not loaded["jax"]
    assert "imported 4 node(s)" in out


def test_python_m_cli_process_list_leaves_torch_out(profile):
    code = ("import runpy, sys\n"
            "sys.argv = ['repro_torch.cli'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.cli', run_name='__main__')\n"
            "finally:\n"
            "    print('torch' in sys.modules)\n")
    proc = _fresh(code, "-p", profile, "process", "list")
    assert proc.returncode == 0, proc.stderr
    assert "add" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "False"


@pytest.mark.parametrize("path", [
    "repro.calcjobs:TPUTrainJob", "repro.calcjobs.TPUTrainJob",
    "repro:Process",
])
def test_cli_refuses_reference_class_without_importing_it(profile, path):
    out, loaded = _cli_in_fresh_process("-p", profile, "process", "inputs",
                                        path)
    assert "reference package" in str(loaded["code"])
    assert loaded["repro"] == [] and not loaded["jax"]


def test_cli_backfill_refuses_reference_module(profile):
    out, loaded = _cli_in_fresh_process("-p", profile, "cache", "backfill",
                                        "--resolve", "repro.calcjobs")
    assert "reference package" in str(loaded["code"])
    assert loaded["repro"] == [] and not loaded["jax"]


def test_class_resolver_refuses_reference_modules_in_a_fresh_process():
    code = """
import json, sys
from repro_torch.caching.backfill import ClassResolver
from repro_torch.core.process import ReferencePackageError
refused = []
for name in ("repro", "repro.calcjobs", "repro.core.process"):
    try:
        ClassResolver(modules=[name])
    except ReferencePackageError:
        refused.append(name)
ok = ClassResolver(modules=["repro_torch.chaos.workloads"])
print(json.dumps({"refused": refused,
                  "resolved": ok.resolve("ChaosCalc").__module__,
                  "repro": sorted(m for m in sys.modules
                                  if m == "repro" or m.startswith("repro."))}))
"""
    proc = _fresh(code)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["refused"] == ["repro", "repro.calcjobs", "repro.core.process"]
    assert got["resolved"] == "repro_torch.chaos.workloads"
    assert got["repro"] == []


# ---------------------------------------------------------------------------
# twin of tests/test_control.py::test_cli_kill_terminates_daemon_process
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_cli_kill_terminates_daemon_process(tmp_path):
    import time

    from repro_torch.calcjobs import GPUTrainJob
    from repro_torch.core import Dict as DictData
    from repro_torch.engine.controller import ProcessController
    from repro_torch.engine.daemon import Daemon

    terminal = ("finished", "excepted", "killed")
    daemon = Daemon(str(tmp_path), workers=1, slots=4)
    daemon.start()
    try:
        # a job long enough that it is still running when the kill lands
        pk = daemon.submit(GPUTrainJob, {"config": DictData(
            {"arch": "qwen2-0.5b", "steps": 5000, "batch": 1, "seq": 8,
             "device": "cpu"})})
        store = configure_store(daemon.store_path)

        t0 = time.time()
        while time.time() - t0 < 120:
            node = store.get_node(pk) or {}
            if node.get("process_state") in ("running", "waiting"):
                break
            daemon.supervise()
            time.sleep(0.3)
        else:
            pytest.fail(f"process never started: {node}")

        cli.main(["-p", daemon.store_path, "process", "kill", str(pk),
                  "-w", str(tmp_path), "--message", "cli kill"])

        t0 = time.time()
        while time.time() - t0 < 60:
            node = store.get_node(pk)
            if node["process_state"] in terminal:
                break
            time.sleep(0.2)
        assert node["process_state"] == "killed", node
        assert node["exit_status"] == 998
        assert json.loads(node["attributes"])["kill_requested"] == "cli kill"

        # the durable event log lets a late watcher see the whole story
        with ProcessController.from_workdir(str(tmp_path)) as ctl:
            events = list(ctl.watch(pk=pk, timeout=2.0, replay_since=0))
        assert any(body.get("state") == "killed"
                   for _, _, body in events), events
    finally:
        daemon.stop()


# ---------------------------------------------------------------------------
# parity: both packages' CLIs over one store print the same
# ---------------------------------------------------------------------------

@calcfunction
def _add(a, b):
    return a + b


@calcfunction
def _scale(x):
    import numpy as np

    from repro_torch.core import ArrayData

    return ArrayData(np.arange(6, dtype=np.float32).reshape(2, 3) * x.value)


@calcfunction
def _boom(x):
    raise ValueError(f"boom {x.value}")


class Twice(WorkChain):
    """Two calcfunctions in a row, a report between them."""

    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("x", valid_type=Int)
        spec.output("y", valid_type=Int)
        spec.output("table", valid_type=ArrayData)
        spec.outline(cls.first, cls.second)

    def first(self):
        self.ctx.y = _add(self.inputs["x"], Int(1))
        self.report("first gave %d", self.ctx.y.value)

    def second(self):
        self.out("y", _add(self.ctx.y, Int(2)))
        self.out("table", _scale(self.ctx.y))


@pytest.fixture(scope="module")
def parity_profile(tmp_path_factory):
    """A store written by this package: a finished workchain with two
    calcfunction children and an array output, and an excepted
    calcfunction. Returns (profile, archive made from it)."""
    root = tmp_path_factory.mktemp("parity")
    db = str(root / "profile.db")
    store = configure_store(db)
    runner = Runner(store=store)
    set_default_runner(runner)
    runner.run(Twice, {"x": Int(3)})
    with pytest.raises(RuntimeError, match="boom 7"):
        _boom(Int(7))
    store.close()
    set_default_runner(None)
    configure_store(":memory:")
    archive = str(root / "all.zip")
    assert _cli_process("repro_torch", "-p", db, "archive", "create", "-o",
                        archive, "--all").returncode == 0
    return db, archive


def _cli_process(package, *argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", f"{package}.cli", *argv],
                          env=env, capture_output=True, text=True,
                          timeout=120)


def _masked(text):
    """Ages (``11s``, ``3m``) depend on when each CLI ran."""
    return re.sub(r"\b\d+[smhd]\b", "<age>", text)


@pytest.mark.parametrize("argv", [
    ["process", "list"], ["process", "list", "--state", "excepted"],
    ["process", "show", "1"], ["process", "report", "1"],
    ["node", "show", "1"], ["graph", "export", "1"], ["stats"],
    ["cache", "stats"], ["store", "fsck"], ["chaos", "check"],
    ["archive", "inspect", "{archive}"],
])
def test_cli_prints_what_the_reference_cli_prints(parity_profile, argv):
    db, archive = parity_profile
    argv = [a.replace("{archive}", archive) for a in argv]
    ref = _cli_process("repro", "-p", db, *argv)
    port = _cli_process("repro_torch", "-p", db, *argv)
    assert ref.returncode == 0, ref.stderr
    assert port.returncode == 0, port.stderr
    assert ref.stdout.strip()
    assert _masked(port.stdout) == _masked(ref.stdout)


def test_cli_archive_create_equals_the_reference_cli(parity_profile,
                                                     tmp_path):
    db, _ = parity_profile
    made = {}
    for package in ("repro", "repro_torch"):
        out = str(tmp_path / f"{package}.zip")
        proc = _cli_process(package, "-p", db, "archive", "create", "-o",
                            out, "--all")
        assert proc.returncode == 0, proc.stderr
        made[package] = (open(out, "rb").read(),
                         proc.stdout.replace(out, "<archive>"))
    assert made["repro_torch"] == made["repro"]
    assert "1 array payload(s)" in made["repro"][1]
