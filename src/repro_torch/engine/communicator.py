"""kiwiPy-style communicator (paper §III.C): task queues, RPC, broadcast.

This module defines the *control-plane contract* every engine layer speaks:

* **RPC** — each live process subscribes under the identifier
  ``process.<pk>`` and accepts intent messages
  ``{"intent": "pause" | "play" | "kill" | "status"}`` (the legacy
  ``"action"`` key is accepted as an alias). Any client holding a
  communicator can therefore control any process, wherever it runs.
* **Broadcast** — every state transition is published under the subject
  ``state_changed.<pk>.<state>`` (e.g. ``state_changed.42.finished``);
  subscribers filter with fnmatch wildcards (``state_changed.42.*``,
  ``state_changed.*.killed``, …). Waiting on a process is therefore an
  event subscription, not a poll loop.
* **Task queues** — at-least-once delivery: tasks are acknowledged only on
  successful completion; un-acked tasks are redelivered after a
  visibility timeout (``requeue_timeout``), the in-process analogue of
  RabbitMQ's heartbeat-based requeue.

``LocalCommunicator`` is the in-process implementation. The cross-process
implementation with durable (sqlite) queues and RPC forwarding across OS
processes lives in ``repro_torch.engine.broker`` and exposes the same interface.
"""

from __future__ import annotations

import asyncio
import fnmatch
import itertools
import time
from typing import Any, Awaitable, Callable

RpcHandler = Callable[[dict], Any]
BroadcastHandler = Callable[[str, Any, dict], None]
TaskHandler = Callable[[dict], Awaitable[Any]]

#: intents a process RPC subscriber must understand (paper §III.C.b)
CONTROL_INTENTS = ("pause", "play", "kill", "status")


def process_rpc_id(pk: int) -> str:
    """The RPC identifier a live process subscribes under."""
    return f"process.{pk}"


def state_subject(pk: int, state: str) -> str:
    """The broadcast subject for one process state transition."""
    return f"state_changed.{pk}.{state}"


def parse_state_subject(subject: str) -> tuple[int, str] | None:
    """Inverse of :func:`state_subject`; None for foreign subjects."""
    parts = subject.split(".")
    if len(parts) != 3 or parts[0] != "state_changed":
        return None
    try:
        return int(parts[1]), parts[2]
    except ValueError:
        return None


def control_intent(msg: dict) -> str | None:
    """Extract the intent from a control RPC message ('action' is the
    legacy alias)."""
    return msg.get("intent", msg.get("action"))


class CommunicatorClosed(RuntimeError):
    pass


class LocalCommunicator:
    """In-process communicator. ``requeue_timeout`` is a visibility
    timeout: size it above the longest legitimate handler runtime, or a
    slow-but-alive handler's task will be redelivered concurrently
    (at-least-once, like RabbitMQ). ``task_prefetch`` bounds concurrent
    handler invocations per queue. The daemon's process queue rides the
    broker, whose liveness signal is heartbeats, not this timeout."""

    def __init__(self, *, requeue_timeout: float = 30.0,
                 task_prefetch: int = 64):
        self._rpc: dict[str, RpcHandler] = {}
        self._broadcast: dict[int, tuple[str | None, BroadcastHandler]] = {}
        self._bc_counter = itertools.count()
        self._queues: dict[str, asyncio.Queue] = {}
        self._subscribers: dict[str, list[TaskHandler]] = {}
        self._subscribed: dict[str, asyncio.Event] = {}
        self._consumers: dict[str, asyncio.Task] = {}
        self._inflight: dict[str, list[dict]] = {}
        self._prefetch: dict[str, asyncio.Semaphore] = {}
        self._handler_tasks: set[asyncio.Future] = set()
        self._sweeper: asyncio.Task | None = None
        self.requeue_timeout = requeue_timeout
        self.task_prefetch = task_prefetch
        self._closed = False

    # -- RPC -------------------------------------------------------------------
    def add_rpc_subscriber(self, identifier: str, handler: RpcHandler) -> None:
        self._rpc[identifier] = handler

    def remove_rpc_subscriber(self, identifier: str) -> None:
        self._rpc.pop(identifier, None)

    def rpc_send(self, identifier: str, msg: dict,
                 timeout: float | None = None) -> Any:
        # ``timeout`` is interface parity with the broker clients; a local
        # handler is a direct call, so there is nothing to dead-line
        handler = self._rpc.get(identifier)
        if handler is None:
            raise KeyError(f"no RPC subscriber for {identifier!r}")
        return handler(msg)

    def rpc_identifiers(self, pattern: str = "*") -> list[str]:
        """Registered RPC identifiers matching an fnmatch pattern."""
        return sorted(i for i in self._rpc if fnmatch.fnmatch(i, pattern))

    # -- broadcast ----------------------------------------------------------------
    def add_broadcast_subscriber(self, handler: BroadcastHandler,
                                 subject_filter: str | None = None) -> int:
        token = next(self._bc_counter)
        self._broadcast[token] = (subject_filter, handler)
        return token

    def remove_broadcast_subscriber(self, token: int) -> None:
        self._broadcast.pop(token, None)

    def broadcast_send(self, subject: str, sender: Any = None,
                       body: dict | None = None) -> None:
        for subject_filter, handler in list(self._broadcast.values()):
            if subject_filter and not fnmatch.fnmatch(subject, subject_filter):
                continue
            try:
                handler(subject, sender, body or {})
            except Exception:  # noqa: BLE001 — subscribers cannot break engine
                import logging
                logging.getLogger("repro_torch.engine").exception(
                    "broadcast subscriber failed")

    # -- task queues ------------------------------------------------------------------
    def _queue(self, name: str) -> asyncio.Queue:
        if name not in self._queues:
            self._queues[name] = asyncio.Queue()
            self._inflight[name] = []
        return self._queues[name]

    def _subscribed_event(self, name: str) -> asyncio.Event:
        if name not in self._subscribed:
            self._subscribed[name] = asyncio.Event()
        return self._subscribed[name]

    def task_send(self, queue: str, payload: dict) -> None:
        self._queue(queue).put_nowait(payload)

    def task_send_many(self, queue: str, payloads: list[dict],
                       submitter: str | None = None) -> None:
        """Batch enqueue (interface parity with the broker clients; in
        process there is no syscall to amortize)."""
        q = self._queue(queue)
        for payload in payloads:
            q.put_nowait(payload)

    def add_task_subscriber(self, queue: str, handler: TaskHandler,
                            prefetch: int | None = None) -> None:
        if prefetch is not None:
            # per-queue override of the global prefetch bound
            self._prefetch.setdefault(queue, asyncio.Semaphore(prefetch))
        self._subscribers.setdefault(queue, []).append(handler)
        self._subscribed_event(queue).set()
        if queue not in self._consumers:
            self._consumers[queue] = asyncio.ensure_future(
                self._consume(queue))
        if self._sweeper is None:
            self._sweeper = asyncio.ensure_future(self._sweep_inflight())

    async def _consume(self, queue: str) -> None:
        q = self._queue(queue)
        sem = self._prefetch.setdefault(
            queue, asyncio.Semaphore(self.task_prefetch))
        while not self._closed:
            # no busy-requeue spin: park until someone subscribes
            await self._subscribed_event(queue).wait()
            # prefetch bound (RabbitMQ-style): at most ``task_prefetch``
            # handlers in flight per queue — backpressure for bursts,
            # while one hung handler still cannot stall the queue
            await sem.acquire()
            payload = await q.get()
            handlers = self._subscribers.get(queue, [])
            if not handlers:
                # no subscriber after all: park again instead of spinning
                sem.release()
                self._subscribed_event(queue).clear()
                q.put_nowait(payload)
                continue
            entry = {"t": time.monotonic(), "payload": payload,
                     "queue": queue}
            self._inflight[queue].append(entry)
            # dispatch concurrently so one hung handler cannot stall the
            # queue (and so the visibility-timeout sweeper has teeth);
            # track the future so close() can cancel in-flight handlers
            fut = asyncio.ensure_future(
                self._run_task(handlers[0], entry, sem))
            self._handler_tasks.add(fut)
            fut.add_done_callback(self._handler_tasks.discard)

    async def _run_task(self, handler: TaskHandler, entry: dict,
                        sem: asyncio.Semaphore) -> None:
        queue, payload = entry["queue"], entry["payload"]
        try:
            await handler(payload)
            self._ack(entry)            # success -> ack (drop from inflight)
        except Exception:  # noqa: BLE001 — nack: requeue the task
            import logging
            logging.getLogger("repro_torch.engine").exception(
                "task handler failed; requeuing")
            if self._ack(entry):
                # throttle BEFORE requeueing: the concurrent dispatch loop
                # would otherwise spin a persistently-failing task
                await asyncio.sleep(0.1)
                self._queue(queue).put_nowait(payload)
        finally:
            sem.release()

    def _ack(self, entry: dict) -> bool:
        """Drop an entry from inflight; False if the sweeper already
        requeued it (redelivery in progress — at-least-once semantics)."""
        try:
            self._inflight[entry["queue"]].remove(entry)
            return True
        except (KeyError, ValueError):
            return False

    async def _sweep_inflight(self) -> None:
        """Visibility-timeout redelivery: a task whose handler has not
        acked within ``requeue_timeout`` is presumed hung and requeued
        (the in-process analogue of the broker's heartbeat reaper)."""
        interval = max(min(self.requeue_timeout / 4, 1.0), 0.01)
        while not self._closed:
            await asyncio.sleep(interval)
            deadline = time.monotonic() - self.requeue_timeout
            for queue, entries in self._inflight.items():
                for entry in [e for e in entries if e["t"] < deadline]:
                    entries.remove(entry)
                    import logging
                    logging.getLogger("repro_torch.engine").warning(
                        "task in %r exceeded requeue_timeout; redelivering",
                        queue)
                    self._queue(queue).put_nowait(entry["payload"])

    def queue_depth(self, queue: str) -> int:
        return self._queue(queue).qsize()

    def close(self) -> None:
        self._closed = True
        for task in self._consumers.values():
            task.cancel()
        for fut in list(self._handler_tasks):
            fut.cancel()
        if self._sweeper is not None:
            self._sweeper.cancel()
