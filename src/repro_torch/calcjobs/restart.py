"""BaseRestartWorkChain: the canonical AiiDA error-handling pattern the
paper motivates (§I: "the problem of error handling when running
high-throughput simulations").

Wraps any subprocess class in a while-loop: run → inspect exit code →
consult registered *process handlers* → retry (possibly with modified
inputs) up to max_iterations. This is what turns the engine's exit-code
machinery into automated fault recovery at scale.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.core.datatypes import Dict, Int
from repro_torch.core.exit_code import ExitCode
from repro_torch.core.process_spec import ProcessSpec
from repro_torch.core.workchain import ToContext, WorkChain, while_


def process_handler(*exit_statuses: int):
    """Decorator marking a method as a handler for given exit statuses."""

    def deco(fn: Callable) -> Callable:
        fn._handler_statuses = exit_statuses
        return fn

    return deco


class HandlerReport:
    def __init__(self, do_break: bool = False,
                 exit_code: ExitCode | None = None):
        self.do_break = do_break
        self.exit_code = exit_code


class BaseRestartWorkChain(WorkChain):
    _process_class: type | None = None

    #: synthetic exit status for a child that died without recording one
    #: (excepted or killed — e.g. its worker was chaos-killed mid-step and
    #: a durable kill landed). Handlers register for it like any real
    #: status, so dead children can be retried instead of read as success.
    EXIT_STATUS_DIED = 999

    @classmethod
    def define(cls, spec: ProcessSpec) -> None:
        super().define(spec)
        spec.input("max_iterations", valid_type=Int, default=Int(3))
        spec.inputs.dynamic = True
        spec.outputs.dynamic = True
        spec.exit_code(401, "ERROR_MAXIMUM_ITERATIONS_EXCEEDED",
                       "the maximum number of iterations was exceeded")
        spec.exit_code(402, "ERROR_UNRECOVERABLE_FAILURE",
                       "the subprocess failed with an unhandled exit code")
        spec.outline(
            cls.setup,
            while_(cls.should_run_process)(
                cls.run_process,
                cls.inspect_process,
            ),
            cls.results,
        )

    # -- outline steps ---------------------------------------------------------
    def setup(self) -> None:
        self.ctx.iteration = 0
        self.ctx.is_finished = False
        self.ctx.unhandled = False
        self.ctx.children = []
        self.ctx.process_inputs = {
            k: v for k, v in self.inputs.items()
            if k not in ("metadata", "max_iterations")}

    def should_run_process(self) -> bool:
        return (not self.ctx.is_finished and
                self.ctx.iteration < int(self.inputs["max_iterations"].value))

    def run_process(self):
        self.ctx.iteration += 1
        child = self.submit(self._process_class, **self.ctx.process_inputs)
        self.report("launching %s<%d> (iteration %d)",
                    self._process_class.__name__, child.pk,
                    self.ctx.iteration)
        return ToContext(children=_append(child))

    def inspect_process(self):
        child = self.ctx.children[-1]
        status = child.exit_status or 0
        if status == 0 and child.process_state != "finished":
            # no exit code was ever recorded: the child excepted or was
            # killed — that must not read as success
            status = self.EXIT_STATUS_DIED
        if status == 0:
            self.ctx.is_finished = True
            return None
        for name in dir(type(self)):
            fn = getattr(type(self), name)
            statuses = getattr(fn, "_handler_statuses", None)
            if statuses and status in statuses:
                report = fn(self, child)
                if isinstance(report, HandlerReport):
                    if report.exit_code is not None:
                        return report.exit_code
                    if report.do_break:
                        self.ctx.is_finished = True
                return None
        self.ctx.unhandled = True
        self.report("exit status %d unhandled; giving up", status)
        return self.exit_codes.ERROR_UNRECOVERABLE_FAILURE

    def results(self):
        if not self.ctx.is_finished:
            return self.exit_codes.ERROR_MAXIMUM_ITERATIONS_EXCEEDED
        child = self.ctx.children[-1]
        for label, value in child.outputs.items():
            self.out(label, value)
        return None


def _append(child):
    from repro_torch.core.workchain import append_
    return append_(child)
