"""The Runner (paper §III.A): event loop + persistence + communication +
transport, with vertical scaling via *process slots*.

A runner can drive any number of concurrent processes (bounded by its slot
count); the daemon (engine/daemon.py) scales horizontally by running one
runner per OS worker process.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Iterable

from repro_torch.core.exit_code import ExitCode
from repro_torch.core.process import Process
from repro_torch.observability import metrics as _metrics
from repro_torch.observability import trace
from repro_torch.engine.communicator import (
    LocalCommunicator, parse_state_subject, process_rpc_id,
)
from repro_torch.core.statemachine import TERMINAL_STATES
from repro_torch.provenance.store import (
    SUMMARY_COLUMNS, ProvenanceStore, current_store,
)

# derived from the canonical state-machine set — the single source of truth
TERMINAL = tuple(s.value for s in TERMINAL_STATES)

logger = logging.getLogger("repro_torch.engine")


class ProcessHandle:
    def __init__(self, process: Process, task: asyncio.Task | None = None):
        self.process = process
        self.task = task

    @property
    def pk(self) -> int:
        return self.process.pk

    async def wait(self) -> ExitCode:
        await self.process.wait_done()
        return self.process.exit_code


class QueuedHandle:
    """Handle for a process shipped to the daemon via the task queue."""

    def __init__(self, pk: int):
        self.pk = pk


class Runner:
    def __init__(self, *, store: ProvenanceStore | None = None,
                 communicator=None, loop: asyncio.AbstractEventLoop | None = None,
                 slots: int = 200, liveness_interval: float = 30.0):
        self.store = store or current_store()
        self.communicator = communicator or LocalCommunicator()
        self._loop = loop
        self.slots = slots
        # NOT a poll interval: waits are event-driven; this only bounds how
        # often a waiter double-checks the store in case the owning worker
        # crashed without broadcasting a terminal state
        self.liveness_interval = liveness_interval
        # distinct submitter ids get fair (round-robin) dispatch at the
        # broker; None folds into the anonymous submitter lane
        self.submitter_id: str | None = None
        self.logger = logger
        self._processes: dict[int, ProcessHandle] = {}
        self._slot_sem: asyncio.Semaphore | None = None
        from repro_torch.engine.transport import TransportQueue
        self.transport_queue = TransportQueue()

    # -- loop plumbing -----------------------------------------------------------
    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        if self._loop is None:
            try:
                self._loop = asyncio.get_running_loop()
            except RuntimeError:
                self._loop = asyncio.new_event_loop()
                asyncio.set_event_loop(self._loop)
        return self._loop

    def _sem(self) -> asyncio.Semaphore:
        if self._slot_sem is None:
            self._slot_sem = asyncio.Semaphore(self.slots)
        return self._slot_sem

    # -- process control RPC (paper §III.C.b) ---------------------------------------
    def control(self, pk: int, intent: str, **kw) -> Any:
        """Send a control intent (pause/play/kill/status) to a live
        process. With a LocalCommunicator this returns the result; with a
        BrokerClient it returns an awaitable to ``await``."""
        return self.communicator.rpc_send(process_rpc_id(pk),
                                          {"intent": intent, **kw})

    # -- submission --------------------------------------------------------------------
    def submit(self, process_class, inputs: dict | None = None,
               parent_pk: int | None = None):
        """Instantiate + schedule a process (class or ProcessBuilder). In
        distributed (daemon) mode the process node + checkpoint are
        created locally but execution is shipped through the durable task
        queue, so any worker can pick it up (and resume it if that worker
        dies). Prefer the free functions in ``engine/launch.py`` — this is
        the underlying mechanism for explicit-runner use."""
        from repro_torch.core.builder import expand_launch_target
        with trace.span("engine.submit"):
            process_class, inputs = expand_launch_target(process_class,
                                                         inputs)
            process = process_class(inputs=inputs, runner=self,
                                    parent_pk=parent_pk)
            _metrics.get_registry().counter("engine.submits").inc()
            if getattr(self, "distributed", False):
                from repro_torch.engine.daemon import PROCESS_QUEUE
                # "ts" lets the picking worker measure queue latency;
                # "submitter" feeds the broker's fair-dispatch rotation
                payload = {"pk": process.pk, "ts": time.time()}
                if self.submitter_id is not None:
                    payload["submitter"] = self.submitter_id
                self.communicator.task_send(PROCESS_QUEUE, payload)
                return QueuedHandle(process.pk)
            return self._schedule(process)

    def _schedule(self, process: Process) -> ProcessHandle:
        # controllable from the moment of submission — even while queued
        # behind the slot semaphore (step_until_terminated re-registers
        # idempotently and unregisters on termination)
        process._register_control()

        async def _drive():
            async with self._sem():
                try:
                    return await process.step_until_terminated()
                finally:
                    self._processes.pop(process.pk, None)

        # create_task works on a not-yet-running loop; the task starts when
        # the loop does.
        task = self.loop.create_task(_drive())
        handle = ProcessHandle(process, task)
        self._processes[process.pk] = handle
        return handle

    def resume_from_checkpoint(self, pk: int,
                               epoch: int | None = None
                               ) -> ProcessHandle | None:
        """Recreate a process from its persisted checkpoint and schedule
        it. ``epoch`` (when resuming a broker-delivered task) is the lease
        fencing token the process stamps on every flush/terminal write."""
        checkpoint = self.store.load_checkpoint(pk)
        if checkpoint is None:
            return None
        process = Process.recreate_from_checkpoint(checkpoint, runner=self,
                                                   epoch=epoch)
        return self._schedule(process)

    # -- synchronous driving ---------------------------------------------------------
    def run_sync(self, process: Process) -> ExitCode:
        """Drive a process without suspending (process functions block the
        interpreter by design, §II.B.2). Works inside or outside a running
        event loop."""
        coro = process.step_until_terminated()
        try:
            coro.send(None)
        except StopIteration as stop:
            return stop.value
        coro.close()
        raise RuntimeError(
            f"{type(process).__name__} attempted a real asynchronous wait "
            "inside a synchronous (process function) context")

    def run(self, process_class, inputs: dict | None = None
            ) -> tuple[dict, Process]:
        """Blockingly run a process (class or ProcessBuilder) to
        completion on this runner's loop."""
        from repro_torch.core.builder import expand_launch_target
        process_class, inputs = expand_launch_target(process_class, inputs)
        process = process_class(inputs=inputs, runner=self)
        if self.loop.is_running():
            raise RuntimeError("Runner.run() cannot be used inside a running "
                               "loop; use submit()")
        self.loop.run_until_complete(process.step_until_terminated())
        return process.outputs, process

    def run_until_complete(self, awaitable):
        return self.loop.run_until_complete(awaitable)

    # -- waiting on processes (local fast-path, remote purely event-driven) ----------
    async def wait_for_process(self, pk: int) -> None:
        """Block until the process is terminal. Local processes complete
        via their done-event; remote processes complete when their
        terminal ``state_changed.<pk>.<state>`` broadcast arrives — there
        is no poll loop, only a coarse liveness fallback that re-checks
        the store in case the owning worker crashed without broadcasting."""
        with trace.span("engine.wait", pk=pk):
            await self._wait_for_process(pk)

    async def _wait_for_process(self, pk: int) -> None:
        handle = self._processes.get(pk)
        if handle is not None:
            await handle.process.wait_done()
            return

        ev = asyncio.Event()
        loop = asyncio.get_running_loop()

        def on_broadcast(subject: str, sender, body):
            parsed = parse_state_subject(subject)
            if parsed and parsed[0] == pk and parsed[1] in TERMINAL:
                loop.call_soon_threadsafe(ev.set)

        # subscribe BEFORE the store check: a terminal broadcast landing
        # between check and subscribe would otherwise be lost
        token = self.communicator.add_broadcast_subscriber(
            on_broadcast, subject_filter=f"state_changed.{pk}.*")
        try:
            # with server-side filter pushdown the subscription is only
            # effective once the broker has processed it — barrier first,
            # then check the store, so no terminal event can fall between
            barrier = getattr(self.communicator, "subscription_barrier",
                              None)
            if barrier is not None:
                await barrier()
            node = self.store.get_node(pk, columns=SUMMARY_COLUMNS)
            if node and node.get("process_state") in TERMINAL:
                return
            while True:
                try:
                    await asyncio.wait_for(ev.wait(),
                                           timeout=self.liveness_interval)
                    return
                except asyncio.TimeoutError:
                    node = self.store.get_node(pk, columns=SUMMARY_COLUMNS)
                    if node and node.get("process_state") in TERMINAL:
                        return
        finally:
            self.communicator.remove_broadcast_subscriber(token)

    @staticmethod
    def _target_pk(target) -> int:
        return target if isinstance(target, int) else target.pk

    async def wait(self, target) -> dict | None:
        """Wait for a process (handle, queued handle or pk) to reach a
        terminal state; returns its final node row."""
        pk = self._target_pk(target)
        await self.wait_for_process(pk)
        return self.store.get_node(pk, columns=SUMMARY_COLUMNS)

    async def wait_all(self, targets: Iterable) -> list[dict | None]:
        """Wait for many processes concurrently (one broadcast
        subscription each, no serialization of the waits)."""
        return list(await asyncio.gather(
            *[self.wait(t) for t in targets]))

    def close(self) -> None:
        self.communicator.close()


_DEFAULT: Runner | None = None


def default_runner() -> Runner:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Runner()
    return _DEFAULT


def set_default_runner(runner: Runner | None) -> None:
    global _DEFAULT
    _DEFAULT = runner
