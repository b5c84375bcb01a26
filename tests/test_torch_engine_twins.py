"""The engine modules of the port's last engine slice are the reference's
modules with ``repro.`` renamed to ``repro_torch.``, apart from departures
named here.

After the rename, every line of the reference module is still in the
port's module, in order, except the lines listed below, and the port's
top-level names are the reference's plus the ones listed. The departures:

* ``caching/backfill.py``: the resolver refuses a ``repro``/``repro.*``
  module before importing it (``core.process.refuse_reference``); the
  docstrings name ``python -m repro_torch.cli`` for the ``repro`` script.
* ``chaos/harness.py``: the clock starts once every worker has connected
  (``_await_workers``, bounded by ``WORKER_CONNECT_TIMEOUT``) and the
  workload is submitted from there; a scheduled SIGKILL aims at a worker
  in the lease table, as the SIGSTOP does; the harness reaps what it
  SIGKILLs (``_reap``) and supervises once more after its loop; the loop
  wakes at each scheduled fault's offset (``_sleep_until_next``), not at
  the next quarter-second tick; ``ScenarioResult.connect_wait`` records
  the wait. ``broker-kill9`` and ``fleet-churn`` take a longer ``pause``
  (``tests/test_torch_chaos.py`` holds every other field to the
  reference's). These departures are approved.
* ``cli.py``: bare class names resolve in ``repro_torch.core`` and
  ``repro_torch.calcjobs``, a ``repro``/``repro.*`` class path or resolver
  module is refused with the CLI's error exit, the usage text names
  ``python -m repro_torch.cli``, the help names ``GPUTrainJob``, and
  ``chaos run --json`` prints ``connect_wait``.

``provenance/archive.py`` and ``chaos/workloads.py`` have no departure.
"""

import ast
import difflib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TWINS = {
    "provenance/archive.py": ([], set()),
    "chaos/workloads.py": ([], set()),
    "caching/backfill.py": ([
        "``repro cache invalidate`` carry a ``cache_invalidated`` "
        "attribute and",
        "#: meta keys for durable backfill telemetry (shown by "
        "`repro cache stats`",
        "        from repro.core.process import Process",
    ], set()),
    "chaos/harness.py": ([
        "        n=6, steps=5, pause=0.15, workers=2,",
        "        n=8, steps=5, pause=0.12, workers=3,",
        "    t0 = time.time()",
        "        deadline = t0 + sc.timeout",
        "                    os.kill(live[victim % len(live)], "
        "signal.SIGKILL)",
        "            time.sleep(0.25)",
        "        broker_restarts=daemon.broker_restarts, meta=meta)",
    ], {"WORKER_CONNECT_TIMEOUT", "_await_workers", "_reap",
        "_sleep_until_next"}),
    "cli.py": ([
        "    repro -p <profile.db> archive create -o results.zip --pk 42 "
        "[--all]",
        "    repro -p <profile.db> archive inspect results.zip",
        "    repro -p <other.db>   archive import results.zip",
        "    repro -p <profile.db> process pause|play|kill|status <pk> "
        "[-w WORKDIR]",
        "    repro -p <profile.db> process watch [--pk PK] [--once] "
        "[--timeout T]",
        "    repro -p <profile.db> process top [--once] [--interval S]",
        "    repro chaos list",
        "    repro chaos points",
        "    repro chaos run --scenario kill9-midstep --seed 1 [--json]",
        "    repro -p <profile.db> chaos check [--pk PK --expect-terminal]",
        '    or a bare name exported by repro.core / repro.calcjobs."""',
        "    from repro.core.process import Process",
        '        candidates.extend((("repro.core", path), '
        '("repro.calcjobs", path)))',
        "    stats = backfill_hashes(",
        "        store,",
        "        resolve_modules=args.resolve,",
        "        process_types=args.process_type or None,",
        "        batch_size=args.batch_size,",
        "        dry_run=args.dry_run,",
        "        include_invalidated=args.include_invalidated,",
        "        progress=print)",
        '                    help="e.g. repro.calcjobs:TPUTrainJob or '
        'TPUTrainJob")',
    ], set()),
}


def _top_level_names(source):
    names = set()
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            names.add(node.target.id)
    return names


@pytest.mark.parametrize("module", sorted(TWINS))
def test_port_module_is_the_reference_renamed(module):
    removed_ok, added_names = TWINS[module]
    with open(os.path.join(ROOT, "src", "repro", module)) as fh:
        ref = fh.read()
    with open(os.path.join(ROOT, "src", "repro_torch", module)) as fh:
        port = fh.read().replace("repro_torch", "repro")
    ref_lines, port_lines = ref.splitlines(), port.splitlines()
    matcher = difflib.SequenceMatcher(None, ref_lines, port_lines,
                                      autojunk=False)
    removed = [line for tag, i1, i2, _, _ in matcher.get_opcodes()
               if tag in ("replace", "delete") for line in ref_lines[i1:i2]]
    assert removed == removed_ok
    ref_names, port_names = _top_level_names(ref), _top_level_names(port)
    assert ref_names <= port_names
    assert port_names - ref_names == added_names


def test_scenario_result_adds_only_the_connect_wait():
    import dataclasses

    from repro.chaos.harness import ScenarioResult as Ref
    from repro_torch.chaos.harness import ScenarioResult as Port

    ref = [(f.name, f.type) for f in dataclasses.fields(Ref)]
    port = [(f.name, f.type) for f in dataclasses.fields(Port)]
    assert port == ref + [("connect_wait", "float")]
