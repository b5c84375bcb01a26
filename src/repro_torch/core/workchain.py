"""WorkChain (paper §II.B.3): checkpointable multi-step workflows.

The outline DSL (``while_``, ``if_``/``elif_``/``else_``, ``return_``)
compiles to a tree of *steppers*, each of which can serialize its exact
position — so a work chain interrupted between steps (crash, restart,
pause) resumes from the last completed step with its context intact.

Between every step the engine checkpoints (context + stepper position) and
yields the event loop. Steps that submit subprocesses return ``ToContext``
awaitables; the chain transitions to WAITING until the children broadcast
termination (paper §III.C.c), then continues with the child nodes bound
into its context.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Mapping

from repro_torch.core.datatypes import DataValue
from repro_torch.core.exit_code import ExitCode
from repro_torch.core.process import Process, ProcessState
from repro_torch.observability import trace
from repro_torch.provenance.store import NodeType


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

class AttributeDict(dict):
    """The work chain context: a dict with attribute access (self.ctx.n)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as exc:
            raise AttributeError(k) from exc

    def __setattr__(self, k, v):
        self[k] = v

    def __delattr__(self, k):
        del self[k]


class ProcessNodeView:
    """A finished subprocess as seen from a parent's context."""

    def __init__(self, store, pk: int):
        self._store = store
        self.pk = pk

    @property
    def _node(self) -> dict:
        from repro_torch.provenance.store import SUMMARY_COLUMNS
        return self._store.get_node(self.pk, columns=SUMMARY_COLUMNS) or {}

    @property
    def process_state(self) -> str:
        return self._node.get("process_state", "")

    @property
    def exit_status(self) -> int | None:
        return self._node.get("exit_status")

    @property
    def is_finished(self) -> bool:
        return self.process_state in ("finished", "excepted", "killed")

    @property
    def is_finished_ok(self) -> bool:
        return self.process_state == "finished" and self.exit_status == 0

    @property
    def outputs(self) -> AttributeDict:
        from repro_torch.provenance.store import LinkType
        out = AttributeDict()
        for out_pk, lt, label in self._store.outgoing(self.pk):
            if lt in (LinkType.CREATE.value, LinkType.RETURN.value):
                parts = label.split("__")
                tgt = out
                for p in parts[:-1]:
                    tgt = tgt.setdefault(p, AttributeDict())
                tgt[parts[-1]] = self._store.load_data(out_pk)
        return out

    def __repr__(self):
        return f"ProcessNodeView(pk={self.pk}, state={self.process_state!r})"


# ---------------------------------------------------------------------------
# ToContext / append_
# ---------------------------------------------------------------------------

class _Append:
    def __init__(self, value):
        self.value = value


def append_(value) -> _Append:
    return _Append(value)


class ToContext(dict):
    """Register submitted subprocesses as awaitables (paper listing 11)."""


# ---------------------------------------------------------------------------
# Outline instructions and steppers
# ---------------------------------------------------------------------------

class _Instruction:
    def create_stepper(self):
        raise NotImplementedError


class _Step(_Instruction):
    def __init__(self, method):
        if not callable(method):
            raise TypeError(f"outline entries must be callables, got {method!r}")
        self.name = method.__name__

    def create_stepper(self):
        return _StepStepper(self)


class _Block(_Instruction):
    def __init__(self, instructions):
        self.body = _build_outline(instructions)

    def create_stepper(self):
        return _SequenceStepper(self.body)


class _While(_Instruction):
    def __init__(self, condition):
        self.cond_name = condition.__name__
        self.body: list[_Instruction] = []

    def __call__(self, *instructions):
        self.body = _build_outline(instructions)
        return self

    def create_stepper(self):
        return _WhileStepper(self)


class _If(_Instruction):
    def __init__(self, condition):
        self.branches: list[tuple[str | None, list[_Instruction]]] = []
        self._pending_cond = condition.__name__

    def __call__(self, *instructions):
        self.branches.append((self._pending_cond, _build_outline(instructions)))
        self._pending_cond = None
        return self

    def elif_(self, condition):
        self._pending_cond = condition.__name__
        return self

    def else_(self, *instructions):
        self.branches.append((None, _build_outline(instructions)))
        return self

    def create_stepper(self):
        return _IfStepper(self)


class _Return(_Instruction):
    def __init__(self, exit_code: ExitCode | int = 0):
        self.exit_code = exit_code

    def __call__(self, exit_code):
        return _Return(exit_code)

    def create_stepper(self):
        return _ReturnStepper(self)


def while_(condition) -> _While:
    return _While(condition)


def if_(condition) -> _If:
    return _If(condition)


return_ = _Return()


def _build_outline(instructions) -> list[_Instruction]:
    out: list[_Instruction] = []
    for ins in instructions:
        if isinstance(ins, _Instruction):
            out.append(ins)
        else:
            out.append(_Step(ins))
    return out


# -- steppers: execute one basic step per call; save/load position ----------

class _StepStepper:
    def __init__(self, step: _Step):
        self.step_def = step
        self.done = False

    def step(self, wc: "WorkChain"):
        method = getattr(wc, self.step_def.name)
        with trace.span("workchain.step", step=self.step_def.name):
            result = method()
        self.done = True
        return True, result

    def save(self):
        return {"t": "step", "done": self.done}

    def load(self, pos):
        self.done = pos.get("done", False)


class _SequenceStepper:
    def __init__(self, body: list[_Instruction]):
        self.body = body
        self.idx = 0
        self.child = None

    def step(self, wc):
        if self.idx >= len(self.body):
            return True, None
        if self.child is None:
            self.child = self.body[self.idx].create_stepper()
        finished, result = self.child.step(wc)
        if finished:
            self.idx += 1
            self.child = None
        return self.idx >= len(self.body), result

    def save(self):
        return {"t": "seq", "idx": self.idx,
                "child": self.child.save() if self.child else None}

    def load(self, pos):
        self.idx = pos["idx"]
        if pos.get("child") is not None and self.idx < len(self.body):
            self.child = self.body[self.idx].create_stepper()
            self.child.load(pos["child"])


class _WhileStepper:
    def __init__(self, ins: _While):
        self.ins = ins
        self.child: _SequenceStepper | None = None
        self.checked = False

    def step(self, wc):
        if self.child is None:
            cond = getattr(wc, self.ins.cond_name)()
            if not cond:
                return True, None
            self.child = _SequenceStepper(self.ins.body)
        finished, result = self.child.step(wc)
        if finished:
            self.child = None   # re-check the condition next step
        # a while-stepper is never finished by its body completing — only
        # by its condition evaluating false at the top of a future step
        return False, result

    def save(self):
        return {"t": "while", "child": self.child.save() if self.child else None}

    def load(self, pos):
        if pos.get("child") is not None:
            self.child = _SequenceStepper(self.ins.body)
            self.child.load(pos["child"])


class _IfStepper:
    def __init__(self, ins: _If):
        self.ins = ins
        self.branch: int | None = None
        self.child: _SequenceStepper | None = None

    def step(self, wc):
        if self.branch is None:
            self.branch = -1
            for i, (cond_name, _body) in enumerate(self.ins.branches):
                if cond_name is None or getattr(wc, cond_name)():
                    self.branch = i
                    break
            if self.branch < 0:
                return True, None
            self.child = _SequenceStepper(self.ins.branches[self.branch][1])
        finished, result = self.child.step(wc)
        return finished, result

    def save(self):
        return {"t": "if", "branch": self.branch,
                "child": self.child.save() if self.child else None}

    def load(self, pos):
        self.branch = pos.get("branch")
        if self.branch is not None and self.branch >= 0 and pos.get("child"):
            self.child = _SequenceStepper(self.ins.branches[self.branch][1])
            self.child.load(pos["child"])


class _ReturnStepper:
    def __init__(self, ins: _Return):
        self.ins = ins

    def step(self, wc):
        ec = self.ins.exit_code
        if isinstance(ec, int) and ec == 0:
            return True, _STOP_OK
        return True, ec

    def save(self):
        return {"t": "return"}

    def load(self, pos):
        pass


class _StopOK:
    """Sentinel: outline return_ with status 0 — finish early, success."""


_STOP_OK = _StopOK()


# ---------------------------------------------------------------------------
# The WorkChain itself
# ---------------------------------------------------------------------------

class Awaitable:
    def __init__(self, key: str, pk: int, append: bool):
        self.key = key
        self.pk = pk
        self.append = append


class WorkChain(Process):
    NODE_TYPE = NodeType.WORK_CHAIN

    def __init__(self, inputs=None, **kw):
        # chain state must exist before Process.__init__ writes the initial
        # checkpoint (checkpoint_extras() reads ctx/stepper/awaitables) —
        # without it a freshly-created chain cannot be shipped to a daemon
        # worker, which resumes purely from the persisted checkpoint
        self.ctx = AttributeDict()
        self._awaitables: list[Awaitable] = []
        self._stepper = None
        super().__init__(inputs, **kw)

    # -- submitting children (paper §II.B.3.d) ----------------------------------
    def submit(self, process_class, **inputs):
        """Submit a child process; accepts a Process class (with keyword
        inputs) or a ProcessBuilder, like the engine/launch.py free
        functions."""
        return self.runner.submit(process_class, inputs=inputs,
                                  parent_pk=self.pk)

    def to_context(self, **kwargs) -> None:
        for key, value in kwargs.items():
            if isinstance(value, _Append):
                self._awaitables.append(Awaitable(key, value.value.pk, True))
            else:
                self._awaitables.append(Awaitable(key, value.pk, False))

    # -- driver ---------------------------------------------------------------------
    async def run(self):
        outline = self.spec().get_outline()
        if outline is None:
            raise RuntimeError(
                f"{type(self).__name__} defines no outline")
        if self._stepper is None:
            self._stepper = _SequenceStepper(outline)
        # resuming with awaitables pending? resolve them first
        if self._awaitables:
            await self._resolve_awaitables()

        while True:
            await self._pause_point()
            # the transition between steps yields the interpreter so other
            # processes on this runner make progress (paper §II.B.3)
            await asyncio.sleep(0)
            finished, result = self._stepper.step(self)

            if isinstance(result, _StopOK):
                return None
            if isinstance(result, ExitCode):
                return result
            if isinstance(result, int) and result != 0:
                return result
            if isinstance(result, ToContext):
                self.to_context(**result)
            if self._awaitables:
                self.transition_to(ProcessState.WAITING)
                await self._resolve_awaitables()
                if not self.is_terminated:
                    self.transition_to(ProcessState.RUNNING)
            else:
                # checkpoint between steps (engine guarantee, §II.B.3):
                # marked dirty here, flushed in ONE transaction at the
                # pause point above — always before the next step runs
                self._ckpt_dirty = True
            if finished:
                return None

    async def _resolve_awaitables(self) -> None:
        pending = list(self._awaitables)
        self._awaitables.clear()
        # one event-driven wait per child, all concurrent: the chain wakes
        # when the LAST terminal broadcast arrives, not after a poll sweep
        await self.interruptible(
            self.runner.wait_all([aw.pk for aw in pending]))
        for aw in pending:
            view = ProcessNodeView(self.store, aw.pk)
            if aw.append:
                self.ctx.setdefault(aw.key, []).append(view)
            else:
                self.ctx[aw.key] = view

    # -- exposed inputs helper (paper listing 16) ----------------------------------
    def exposed_inputs(self, process_class, namespace: str | None = None
                       ) -> dict:
        names = self.spec().exposed_input_names(process_class, namespace)
        source = (self.inputs.get(namespace, {}) if namespace
                  else self.inputs)
        return {k: source[k] for k in names if k in source}

    # -- checkpoint integration --------------------------------------------------------
    def checkpoint_extras(self) -> dict:
        return {
            "ctx": _serialize_ctx(self.ctx),
            "stepper": self._stepper.save() if self._stepper else None,
            "awaitables": [(a.key, a.pk, a.append) for a in self._awaitables],
        }

    def load_checkpoint_extras(self, extras: dict) -> None:
        self.ctx = _deserialize_ctx(extras.get("ctx", {}), self.store)
        self._awaitables = [Awaitable(k, pk, ap)
                            for k, pk, ap in extras.get("awaitables", [])]
        outline = self.spec().get_outline()
        self._stepper = _SequenceStepper(outline)
        if extras.get("stepper") is not None:
            self._stepper.load(extras["stepper"])


def _serialize_ctx(ctx: Mapping[str, Any]) -> dict:
    out = {}
    for k, v in ctx.items():
        if isinstance(v, ProcessNodeView):
            out[k] = {"__node__": v.pk}
        elif isinstance(v, DataValue) and v.is_stored:
            # by reference: per-step checkpoints stop copying payloads
            out[k] = {"__data_ref__": v.pk}
        elif isinstance(v, DataValue):
            out[k] = {"__data__": v.to_payload(), "pk": v.pk}
        elif isinstance(v, list) and all(
                isinstance(e, ProcessNodeView) for e in v):
            out[k] = {"__nodes__": [e.pk for e in v]}
        elif isinstance(v, Mapping):
            out[k] = {"__ns__": _serialize_ctx(v)}
        else:
            out[k] = {"__raw__": v}
    return out


def _deserialize_ctx(payload: dict, store) -> AttributeDict:
    ctx = AttributeDict()
    for k, entry in payload.items():
        if "__node__" in entry:
            ctx[k] = ProcessNodeView(store, entry["__node__"])
        elif "__nodes__" in entry:
            ctx[k] = [ProcessNodeView(store, pk) for pk in entry["__nodes__"]]
        elif "__data_ref__" in entry:
            ctx[k] = store.load_data(entry["__data_ref__"])
        elif "__data__" in entry:
            dv = DataValue.from_payload(entry["__data__"])
            dv.pk = entry.get("pk")
            ctx[k] = dv
        elif "__ns__" in entry:
            ctx[k] = _deserialize_ctx(entry["__ns__"], store)
        else:
            ctx[k] = entry.get("__raw__")
    return ctx
