"""Unified process launchers (paper §II.A; AiiDA 1.0 ``aiida.engine.launch``).

The one documented way to launch any process::

    from repro_torch.engine.launch import run, run_get_node, run_get_pk, submit

    results = run(AddWorkChain, a=Int(1), b=Int(2))     # blocking
    results, node = run_get_node(builder)               # blocking, + node
    results, pk = run_get_pk(AddWorkChain, a=1, b=2)    # blocking, + pk
    handle = submit(builder)                            # non-blocking

Every launcher accepts either ``(ProcessClass, **inputs)`` or a
:class:`~repro_torch.core.builder.ProcessBuilder` (keyword arguments override
builder values). ``run*`` drive the process to completion on the default
runner's loop; ``submit`` schedules it as a task on the runner's loop.

``Runner.run``/``Runner.submit`` remain the underlying mechanism; use them
directly only when driving an explicit, non-default runner.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Any, Mapping

from repro_torch.core.builder import expand_launch_target
from repro_torch.core.process import Process

ResultAndNode = namedtuple("ResultAndNode", ["results", "node"])
ResultAndPk = namedtuple("ResultAndPk", ["results", "pk"])


def _default_runner():
    from repro_torch.engine.runner import default_runner
    return default_runner()


def _expand(process, inputs, kwargs):
    """Combine the positional inputs dict and keyword inputs, then expand:
    both override-styles flow through the same builder-merge semantics."""
    overrides = dict(inputs or {})
    overrides.update(kwargs)
    return expand_launch_target(process, overrides)


def run(process, inputs: Mapping[str, Any] | None = None, *,
        runner=None, **kwargs) -> dict[str, Any]:
    """Run a process to completion, blocking; returns its outputs."""
    return run_get_node(process, inputs, runner=runner, **kwargs).results


def run_get_node(process, inputs: Mapping[str, Any] | None = None, *,
                 runner=None, **kwargs) -> ResultAndNode:
    """Run a process to completion, blocking; returns ``(outputs,
    process)`` — the process object doubles as the provenance node view
    (``.pk``, ``.exit_code``, ``.is_finished_ok``)."""
    process_class, merged = _expand(process, inputs, kwargs)
    runner = runner or _default_runner()
    outputs, node = runner.run(process_class, merged)
    return ResultAndNode(outputs, node)


def run_get_pk(process, inputs: Mapping[str, Any] | None = None, *,
               runner=None, **kwargs) -> ResultAndPk:
    """Run a process to completion, blocking; returns ``(outputs, pk)``."""
    results, node = run_get_node(process, inputs, runner=runner, **kwargs)
    return ResultAndPk(results, node.pk)


def submit(process, inputs: Mapping[str, Any] | None = None, *,
           runner=None, **kwargs):
    """Schedule a process without waiting. Returns a ``ProcessHandle``
    (with ``.pk``) on the runner's loop."""
    process_class, merged = _expand(process, inputs, kwargs)
    runner = runner or _default_runner()
    return runner.submit(process_class, inputs=merged)


def instantiate(process, inputs: Mapping[str, Any] | None = None, *,
                runner=None, **kwargs) -> Process:
    """Construct (but do not schedule) a process: node + input links +
    initial checkpoint are created, so the pk can be shipped anywhere."""
    process_class, merged = _expand(process, inputs, kwargs)
    return process_class(inputs=merged, runner=runner or _default_runner())
