"""The Process class (paper §II.A, §III.B).

Any entity the engine can run. Combines:

* the declarative ProcessSpec (ports, exit codes),
* the extended state machine (CREATED → RUNNING → WAITING → … fig. 6),
* provenance integration (a process node is created on instantiation,
  inputs are linked on creation, outputs on termination),
* checkpoint persistence at every state transition (fig. 7),
* external control (pause / play / kill) via interruptible waits,
* broadcast of state changes so parents can resume on child termination.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import time
import traceback
from typing import Any, Mapping

from repro_torch.chaos import faults as chaos
from repro_torch.core.datatypes import DataValue, to_data_value
from repro_torch.core.exit_code import ExitCode
from repro_torch.core.ports import PortNamespace
from repro_torch.core.process_spec import ProcessSpec
from repro_torch.core.statemachine import ProcessState, StateMachine
from repro_torch.observability import metrics as _metrics
from repro_torch.observability import trace
from repro_torch.observability.timeline import (
    STATE_HISTORY_ATTR, TRACE_LEVELNAME, serialize_spans,
)
from repro_torch.provenance.store import LinkType, NodeType, StaleEpochError

# The process currently executing in this task — used to attach CALL links
# for synchronously-nested process functions (paper fig. 2).
CURRENT_PROCESS: contextvars.ContextVar["Process | None"] = \
    contextvars.ContextVar("CURRENT_PROCESS", default=None)

_INPUT_LINK = {
    NodeType.CALC_FUNCTION: LinkType.INPUT_CALC,
    NodeType.CALC_JOB: LinkType.INPUT_CALC,
    NodeType.WORK_FUNCTION: LinkType.INPUT_WORK,
    NodeType.WORK_CHAIN: LinkType.INPUT_WORK,
    NodeType.PROCESS: LinkType.INPUT_WORK,
}
_OUTPUT_LINK = {
    NodeType.CALC_FUNCTION: LinkType.CREATE,
    NodeType.CALC_JOB: LinkType.CREATE,
    NodeType.WORK_FUNCTION: LinkType.RETURN,
    NodeType.WORK_CHAIN: LinkType.RETURN,
    NodeType.PROCESS: LinkType.RETURN,
}
_CALL_LINK = {
    NodeType.CALC_FUNCTION: LinkType.CALL_CALC,
    NodeType.CALC_JOB: LinkType.CALL_CALC,
    NodeType.WORK_FUNCTION: LinkType.CALL_WORK,
    NodeType.WORK_CHAIN: LinkType.CALL_WORK,
    NodeType.PROCESS: LinkType.CALL_WORK,
}


class ProcessKilled(Exception):
    pass


class ReferencePackageError(RuntimeError):
    """A checkpoint, class path or module names the reference package."""


def refuse_reference(module: str, what: str) -> None:
    """Raise :class:`ReferencePackageError` when ``module`` is ``repro``
    or a ``repro.*`` module, before anything imports it. Both packages
    share one store schema, so a profile can name the reference's
    classes; importing them would load the JAX package, and their
    extras and hashes are not this package's."""
    if module == "repro" or module.startswith("repro."):
        raise ReferencePackageError(
            f"{what} is of the reference package ({module}); repro_torch "
            "runs only its own process classes")


class Process(StateMachine):
    NODE_TYPE: NodeType = NodeType.PROCESS
    # caching (AiiDA 1.0 §caching): bump CACHE_VERSION to invalidate every
    # cached result of a class after a behaviour change; CACHEABLE=None
    # derives eligibility from the node type (calc-like yes, work-like no)
    CACHE_VERSION: int = 1
    CACHEABLE: bool | None = None
    _spec_cache: dict[type, ProcessSpec] = {}

    # -- specification ---------------------------------------------------------
    @classmethod
    def define(cls, spec: ProcessSpec) -> None:
        """Subclasses extend; must call super().define(spec)."""

    @classmethod
    def spec(cls) -> ProcessSpec:
        if cls not in Process._spec_cache:
            spec = ProcessSpec()
            cls.define(spec)
            Process._spec_cache[cls] = spec
        return Process._spec_cache[cls]

    @classmethod
    def get_builder(cls):
        """A ProcessBuilder over this class's input ports: tab-completable
        namespace attribute access, per-assignment validation and raw-value
        serialization (paper §II.A; launch it via engine/launch.py)."""
        from repro_torch.core.builder import ProcessBuilder
        return ProcessBuilder(cls)

    # -- construction ------------------------------------------------------------
    def __init__(self, inputs: Mapping[str, Any] | None = None, *,
                 runner=None, parent_pk: int | None = None):
        super().__init__()
        from repro_torch.engine.runner import default_runner
        self.runner = runner or default_runner()
        self.store = self.runner.store
        spec = self.spec()

        # serialize (raw python → DataValue through port serializers) first,
        # so defaults — including callable ones evaluated per-instantiation —
        # and caller values are wrapped before validation and fingerprinting
        merged = _merge_defaults(spec.inputs, dict(inputs or {}))
        merged = spec.inputs.serialize(merged)
        err = spec.validate_inputs(merged)
        if err is not None:
            raise ValueError(f"invalid inputs for {type(self).__name__}: {err}")
        self.inputs = merged
        self.metadata = dict(merged.get("metadata") or {})

        self.outputs: dict[str, Any] = {}
        self._exit_code: ExitCode | None = None
        self._killed_msg: str | None = None
        self._done = asyncio.Event()
        self._play = asyncio.Event()
        self._play.set()
        self._interrupts: list[asyncio.Future] = []
        self._pause_requested = False
        # write coalescing (unit of work): state/attribute updates and
        # checkpoint writes buffer here and flush in ONE store transaction
        # at the next flush boundary (pause point, interruptible await,
        # long-lived state, termination) — ~2 commits per process instead
        # of one commit per store call
        self._pending_update: dict | None = None
        self._ckpt_dirty = False
        self._last_ckpt_json: str | None = None
        # lease epoch (fencing token): set when this instance was handed
        # its pk by the broker; every flush/terminal transaction asserts
        # it against the store so a stale holder cannot write (§III.C)
        self._epoch: int | None = None
        # per-state dwell times ([state, wall-ts] per transition) — rides
        # the existing attribute writes, no extra commits
        self._state_history: list[list] = []
        self._timeline = None

        # input fingerprint — computed for every cacheable type regardless
        # of the current policy (so any later run can reuse this node);
        # never-cacheable types (workchains …) skip the O(bytes) digest
        self._input_hash: str | None = None
        try:
            from repro_torch.caching.config import _is_cacheable
            from repro_torch.caching.hashing import compute_input_hash
            if _is_cacheable(type(self)):
                self._input_hash = compute_input_hash(type(self), merged,
                                                      ns=spec.inputs)
        except Exception:  # noqa: BLE001 — hashing must never block creation
            pass

        # provenance node + input links + initial checkpoint, atomically:
        # one commit for the whole creation instead of one per input
        parent = CURRENT_PROCESS.get()
        if parent_pk is None and parent is not None:
            parent_pk = parent.pk
        with self.store.transaction():
            self.pk = self.store.create_process_node(
                self.NODE_TYPE, process_type=type(self).__name__,
                label=self.metadata.get("label", ""),
                description=self.metadata.get("description", ""),
                node_hash=self._input_hash)
            self._link_inputs(spec.inputs, merged, prefix="")
            if parent_pk is not None:
                self.store.add_link(parent_pk, self.pk,
                                    _CALL_LINK[self.NODE_TYPE],
                                    f"CALL_{self.pk}")
            self.parent_pk = parent_pk
            # initial checkpoint: a freshly-created process can be shipped
            # to a daemon worker (task queue carries only the pk; §III.C.a)
            try:
                self._write_checkpoint()
            except Exception:  # noqa: BLE001
                pass

    def _link_inputs(self, ns: PortNamespace, values: Mapping[str, Any],
                     prefix: str) -> None:
        pairs: list[tuple[DataValue, str]] = []
        self._collect_input_links(ns, values, prefix, pairs)
        if not pairs:
            return
        link_type = _INPUT_LINK[self.NODE_TYPE]
        self.store.store_data_many([dv for dv, _label in pairs])
        self.store.add_links([(dv.pk, self.pk, link_type, label)
                              for dv, label in pairs])

    def _collect_input_links(self, ns: PortNamespace,
                             values: Mapping[str, Any], prefix: str,
                             pairs: list[tuple[DataValue, str]]) -> None:
        for key, value in values.items():
            port = ns.get(key)
            label = f"{prefix}{key}"
            if port is not None and port.non_db:
                continue
            if isinstance(port, PortNamespace) and isinstance(value, Mapping):
                self._collect_input_links(port, value, f"{label}__", pairs)
                continue
            if isinstance(value, DataValue):
                pairs.append((value, label))
            elif isinstance(value, Mapping) and (
                    port is None or getattr(port, "dynamic", False)):
                for k2, v2 in value.items():
                    if isinstance(v2, DataValue):
                        pairs.append((v2, f"{label}__{k2}"))

    # -- identity ------------------------------------------------------------------
    @property
    def pid(self) -> int:
        return self.pk

    @property
    def exit_code(self) -> ExitCode | None:
        return self._exit_code

    @property
    def exit_codes(self):
        return self.spec().exit_codes

    @property
    def is_finished_ok(self) -> bool:
        return (self.state is ProcessState.FINISHED and
                self._exit_code is not None and
                self._exit_code.is_finished_ok)

    # -- reporting (paper §II.B.3.b) -------------------------------------------------
    def report(self, msg: str, *args) -> None:
        message = msg % args if args else msg
        self.store.add_log(self.pk, "REPORT", message)
        self.runner.logger.info("[%s|%d] %s", type(self).__name__, self.pk,
                                message)

    # -- outputs (paper §II.B.3.e) ------------------------------------------------------
    def out(self, label: str, value: Any) -> None:
        """Record an output in memory; committed at step/termination."""
        self.outputs[label] = value

    def _commit_outputs(self) -> str | None:
        """Validate + store outputs, link them (bulk). Returns error or
        None."""
        err = self.spec().validate_outputs(self.outputs)
        if err is not None:
            return err
        link_type = _OUTPUT_LINK[self.NODE_TYPE]
        pairs: list[tuple[DataValue, str]] = []
        for label, value in self.outputs.items():
            if isinstance(value, Mapping) and not isinstance(value, DataValue):
                for k2, v2 in value.items():
                    pairs.append((to_data_value(v2), f"{label}__{k2}"))
                continue
            pairs.append((to_data_value(value), label))
        if pairs:
            self.store.store_data_many([dv for dv, _label in pairs])
            self.store.add_links([(self.pk, dv.pk, link_type, label)
                                  for dv, label in pairs])
        return None

    # -- provenance write coalescing (unit of work) ---------------------------
    def _merge_pending(self, update: dict) -> None:
        if self._pending_update is None:
            self._pending_update = dict(update)
            return
        attrs = dict(self._pending_update.get("attributes") or {})
        attrs.update(update.get("attributes") or {})
        self._pending_update.update(update)
        self._pending_update["attributes"] = attrs

    def stash_attributes(self, attrs: dict) -> None:
        """Record node attributes without an immediate commit; they land
        with the step's transaction at the next flush boundary."""
        self._merge_pending({"attributes": dict(attrs)})

    def _write_checkpoint(self) -> None:
        """Serialize + persist the checkpoint, skipping the write when it
        is byte-identical to the last one (the dirty check)."""
        js = json.dumps(self.get_checkpoint())
        if js != self._last_ckpt_json:
            self.store.save_checkpoint(self.pk, js)
            self._last_ckpt_json = js

    def _flush_provenance(self) -> None:
        """Write buffered state updates + the checkpoint in one store
        transaction. Called at every suspension point the engine controls,
        so durability is guaranteed before the process can lose the CPU."""
        if self._pending_update is None and not self._ckpt_dirty:
            return
        # the engine-step-vs-store-flush seam: between here and the commit
        # the step exists only in memory — a crash must roll the process
        # back to its previous durable checkpoint, losing work but never
        # correctness
        chaos.fault_point("process.flush.pre", pk=self.pk)
        with trace.span("checkpoint.flush"), self.store.transaction():
            self.store.fence_epoch(self.pk, self._epoch)
            if self._pending_update is not None:
                update, self._pending_update = self._pending_update, None
                self.store.update_process(self.pk, **update)
            if self._ckpt_dirty and not self.state.is_terminal:
                try:
                    self._write_checkpoint()
                except Exception:  # noqa: BLE001 — must not kill the run
                    self.runner.logger.exception(
                        "checkpoint failed for %d", self.pk)
        self._ckpt_dirty = False
        # flush durable, process about to continue — the other edge of
        # the seam (a crash here redelivers an up-to-date checkpoint)
        chaos.fault_point("process.flush.post", pk=self.pk)

    def checkpoint_now(self) -> None:
        """Force a durable checkpoint immediately (stage boundaries in
        CalcJob), folded into one transaction with any buffered update."""
        self._ckpt_dirty = True
        self._flush_provenance()

    # -- state machine hooks -------------------------------------------------------------
    def on_entered(self, from_state: ProcessState) -> None:
        state = self.state
        self._state_history.append([state.value, time.time()])
        self._merge_pending({
            "state": state.value,
            "exit_status": (self._exit_code.status
                            if self._exit_code else None),
            "exit_message": (self._exit_code.message
                             if self._exit_code else None),
            "attributes": {"paused": state is ProcessState.PAUSED,
                           STATE_HISTORY_ATTR: self._state_history}})
        if state.is_terminal:
            # the terminal write is one transaction: final state +
            # buffered attributes + checkpoint removal (joins the caller's
            # step transaction when there is one)
            with self.store.transaction():
                self.store.fence_epoch(self.pk, self._epoch)
                update, self._pending_update = self._pending_update, None
                self.store.update_process(self.pk, **update)
                self.store.delete_checkpoint(self.pk)
            self._ckpt_dirty = False
            self._done.set()
        elif state is ProcessState.RUNNING:
            # short transit state: coalesce into the step's transaction at
            # the next flush boundary (pause point / interruptible await /
            # terminal transition)
            self._ckpt_dirty = True
        else:
            # WAITING / PAUSED are long-lived and externally observable:
            # make them (and their checkpoint) durable right away
            self._ckpt_dirty = True
            self._flush_provenance()
        comm = getattr(self.runner, "communicator", None)
        if comm is not None:
            from repro_torch.engine.communicator import state_subject
            body = {"pk": self.pk,
                    "from": from_state.value,
                    "state": state.value,
                    "exit_status": (self._exit_code.status
                                    if self._exit_code else None),
                    "ts": time.time()}
            # never broadcast ahead of durability: a waiter in another OS
            # process reads the store the moment this lands — when the
            # terminal transition sits inside a step transaction, the
            # broadcast is deferred until that transaction commits
            self.store.after_commit(lambda: comm.broadcast_send(
                subject=state_subject(self.pk, state.value),
                sender=self.pk, body=body))

    # -- checkpointing (paper §III.B.1, fig. 7) ---------------------------------------------
    def get_checkpoint(self) -> dict:
        """Serialize enough state to recreate this process ('out_state')."""
        return {
            "process_class": f"{type(self).__module__}:{type(self).__qualname__}",
            "pk": self.pk,
            "state": self.state.value,
            "inputs": _serialize_inputs(self.spec().inputs, self.inputs),
            "parent_pk": self.parent_pk,
            "extras": self.checkpoint_extras(),
        }

    def checkpoint_extras(self) -> dict:
        """Subclass hook (workchain ctx, calcjob stage, …)."""
        return {}

    def load_checkpoint_extras(self, extras: dict) -> None:  # noqa: B027
        pass

    @classmethod
    def recreate_from_checkpoint(cls, checkpoint: dict, runner=None,
                                 epoch: int | None = None) -> "Process":
        import importlib

        mod_name, _, qual = checkpoint["process_class"].partition(":")
        refuse_reference(mod_name, f"process {checkpoint.get('pk')}, a "
                                   f"{checkpoint['process_class']},")
        mod = importlib.import_module(mod_name)
        klass = mod
        for part in qual.split("."):
            klass = getattr(klass, part)
        self = object.__new__(klass)  # bypass __init__ node creation
        StateMachine.__init__(self)
        from repro_torch.engine.runner import default_runner
        self.runner = runner or default_runner()
        self.store = self.runner.store
        self.inputs = _deserialize_inputs(checkpoint["inputs"], self.store)
        self.metadata = dict(self.inputs.get("metadata") or {})
        self.outputs = {}
        self._exit_code = None
        self._killed_msg = None
        self._done = asyncio.Event()
        self._play = asyncio.Event()
        self._play.set()
        self._interrupts = []
        self._pause_requested = False
        self._pending_update = None
        self._ckpt_dirty = False
        self._last_ckpt_json = None
        self._epoch = epoch
        self._timeline = None
        self.pk = checkpoint["pk"]
        self.parent_pk = checkpoint.get("parent_pk")
        node = self.store.get_node(
            self.pk, columns=("node_hash", "attributes")) or {}
        self._input_hash = node.get("node_hash")
        # continue the recorded dwell history across worker hand-offs
        try:
            attrs = json.loads(node.get("attributes") or "{}")
            self._state_history = list(attrs.get(STATE_HISTORY_ATTR) or [])
        except ValueError:
            self._state_history = []
        self.load_checkpoint_extras(checkpoint.get("extras", {}))
        return self

    # -- external control (paper §III.C RPC) ---------------------------------------------------
    def _control_handler(self, msg: dict) -> Any:
        """The per-process RPC endpoint: any client reaching
        ``process.<pk>`` (directly or forwarded through the broker) drives
        this process with an intent message."""
        from repro_torch.engine.communicator import CONTROL_INTENTS, control_intent
        intent = control_intent(msg)
        if intent == "pause":
            self.pause()
            return True
        if intent == "play":
            self.play()
            return True
        if intent == "kill":
            message = msg.get("message", "killed via RPC")
            # durable first: should this worker die before the in-memory
            # kill lands, no restarted worker may resurrect the process
            try:
                self.store.update_process(
                    self.pk, attributes={"kill_requested": message})
            except Exception:  # noqa: BLE001 — still honour the live kill
                pass
            self.kill(message)
            return True
        if intent == "status":
            return {"pk": self.pk, "state": self.state.value,
                    "paused": self.state is ProcessState.PAUSED,
                    "exit_status": (self._exit_code.status
                                    if self._exit_code else None)}
        raise ValueError(f"unknown control intent {intent!r}; "
                         f"expected one of {CONTROL_INTENTS}")

    def _register_control(self) -> None:
        comm = getattr(self.runner, "communicator", None)
        if comm is not None:
            from repro_torch.engine.communicator import process_rpc_id
            comm.add_rpc_subscriber(process_rpc_id(self.pk),
                                    self._control_handler)

    def _unregister_control(self) -> None:
        comm = getattr(self.runner, "communicator", None)
        if comm is not None:
            from repro_torch.engine.communicator import process_rpc_id
            comm.remove_rpc_subscriber(process_rpc_id(self.pk))

    def _kill_requested_durably(self) -> str | None:
        """A kill recorded in the store by a control client — honoured on
        (re)start so a kill survives worker crashes and restarts."""
        try:
            node = self.store.get_node(self.pk,
                                       columns=("attributes",)) or {}
            attrs = json.loads(node.get("attributes") or "{}")
            return attrs.get("kill_requested")
        except Exception:  # noqa: BLE001
            return None

    def pause(self) -> None:
        self._pause_requested = True
        self._play.clear()

    def play(self) -> None:
        self._pause_requested = False
        if self.state is ProcessState.PAUSED:
            self.resume_from_pause()
        self._play.set()

    def kill(self, msg: str = "killed by user") -> None:
        if self.is_terminated:
            return
        self._killed_msg = msg
        for fut in list(self._interrupts):
            if not fut.done():
                fut.set_exception(ProcessKilled(msg))
        self._play.set()

    async def _pause_point(self) -> None:
        """Honour pause and kill requests between steps; blocks while
        paused. Under a daemon worker (distributed runner) also re-reads
        the durable ``kill_requested`` marker, so a kill recorded while
        this worker was racing to pick the process up (live RPC not yet
        routable) still lands at the next step boundary rather than only
        after a worker restart. Local runs skip the per-step store read —
        their control RPCs arrive in-memory."""
        self._flush_provenance()
        if self._killed_msg is None and \
                getattr(self.runner, "distributed", False):
            self._killed_msg = self._kill_requested_durably()
        if self._killed_msg is not None:
            raise ProcessKilled(self._killed_msg)
        if self._pause_requested and not self.state.is_terminal:
            self.transition_to(ProcessState.PAUSED)
            await self._play.wait()
            if self._killed_msg is not None:
                raise ProcessKilled(self._killed_msg)
            # resume_from_pause() happened in play()

    async def interruptible(self, coro_or_future):
        """Await something, but let kill() break in. Buffered provenance
        writes flush first — this coroutine is about to lose the CPU for
        an unbounded time, so its state must be durable."""
        self._flush_provenance()
        loop = asyncio.get_running_loop()
        interrupt = loop.create_future()
        self._interrupts.append(interrupt)
        try:
            task = asyncio.ensure_future(coro_or_future)
            done, _ = await asyncio.wait(
                {task, interrupt}, return_when=asyncio.FIRST_COMPLETED)
            if interrupt in done:
                task.cancel()
                interrupt.result()  # raises ProcessKilled
            return task.result()
        finally:
            self._interrupts.remove(interrupt)
            if not interrupt.done():
                interrupt.cancel()

    # -- execution driver -----------------------------------------------------------------------
    async def run(self) -> ExitCode | int | None:
        """Subclasses implement the body."""
        raise NotImplementedError

    # -- caching fast path (AiiDA 1.0 §caching) -------------------------------
    def _maybe_use_cache(self) -> ExitCode | None:
        """Consult the cache; on a hit clone the cached outputs onto this
        node and return the cached exit code, else None. Skipping run()
        entirely means a CalcJob never even submits to the scheduler."""
        if self._input_hash is None:
            return None
        try:
            from repro_torch.caching.config import is_caching_enabled_for
            from repro_torch.caching.registry import CacheRegistry
            if not is_caching_enabled_for(type(self)):
                return None
            with trace.span("cache.lookup", pk=self.pk):
                hit = CacheRegistry(self.store).find_cached(
                    type(self).__name__, self._input_hash,
                    exclude_pk=self.pk)
            if hit is None:
                _metrics.get_registry().counter("cache.misses").inc()
                return None
            # phase 1, read-only: rehydrate every output before touching
            # the graph, so a bad source leaves no partial clone behind
            clones = [(label, link_type,
                       DataValue.from_payload(
                           self.store.load_data(data_pk).to_payload()))
                      for label, link_type, data_pk in hit.outputs]
            src_attrs = json.loads(
                (self.store.get_node(hit.pk, columns=("attributes",)) or {})
                .get("attributes") or "{}")
        except Exception:  # noqa: BLE001 — a broken cache must not break runs
            self.store.add_log(self.pk, "WARNING",
                               "cache lookup failed:\n" +
                               traceback.format_exc())
            return None
        try:
            # phase 2: commit the clones — one transaction, bulk writes
            out_ports = self.spec().outputs
            with self.store.transaction():
                self.store.fence_epoch(self.pk, self._epoch)
                self.store.store_data_many(
                    [clone for _l, _lt, clone in clones])
                self.store.add_links(
                    [(self.pk, clone.pk, LinkType(link_type), label)
                     for label, link_type, clone in clones])
                for label, _link_type, clone in clones:
                    # re-nest '<port>__<key>' labels, but only when the
                    # prefix is a declared output port — a flat label that
                    # merely contains '__' stays flat, matching the
                    # cold-run shape
                    ns_label, sep, sub = label.partition("__")
                    if sep and out_ports.get(label) is None and \
                            out_ports.get(ns_label) is not None:
                        self.outputs.setdefault(ns_label, {})[sub] = clone
                    else:
                        self.outputs[label] = clone
                # honest provenance: carry over the source's attributes
                # and advertise what this node was cloned from
                attrs = {k: v for k, v in src_attrs.items()
                         if k not in ("paused", "cached_from",
                                      "cached_from_pk", "kill_requested")}
                attrs.update(cached_from=hit.uuid, cached_from_pk=hit.pk)
                self.store.update_process(self.pk, attributes=attrs)
                self.report("cache hit: cloned %d output(s) from %s<%d>",
                            len(hit.outputs), type(self).__name__, hit.pk)
            _metrics.get_registry().counter("cache.hits").inc()
            return ExitCode(hit.exit_status, hit.exit_message or "",
                            "SUCCESS")
        except StaleEpochError:
            raise  # fenced: the abandon path owns this, not "recompute"
        except Exception:  # noqa: BLE001 — txn already rolled the clones
            # back (links, nodes, attribute writes); only the in-memory
            # output dict needs clearing before run() starts clean
            self.outputs.clear()
            self.store.add_log(self.pk, "WARNING",
                               "cache clone failed; recomputing:\n" +
                               traceback.format_exc())
            return None

    def _persist_timeline(self) -> None:
        """Drain this run's span timeline into ONE TRACE log row. Called
        inside the terminal transaction, so the timeline rides the
        existing unit of work (no extra commit per process)."""
        sink, self._timeline = self._timeline, None
        if sink is None:
            return
        try:
            spans = sink.drain(stamp_open=True)
            if spans:
                self.store.add_logs([(self.pk, TRACE_LEVELNAME,
                                      serialize_spans(spans), time.time())])
        except Exception:  # noqa: BLE001 — telemetry must not kill the run
            self.runner.logger.exception(
                "timeline persistence failed for %d", self.pk)

    def _fenced_abandon(self) -> None:
        """A store transaction was rejected for carrying a stale lease
        epoch: this instance is a zombie (its pk was requeued and is now
        owned — at a higher epoch — by another worker). Abandon cleanly:
        no node write, no state transition, just bump the durable
        ``lease.fenced_writes`` counter the chaos judge asserts on and
        release local waiters. The authoritative run elsewhere produces
        the one true set of outputs."""
        self.runner.logger.warning(
            "process %d fenced at epoch %s: a newer lease holder owns it; "
            "abandoning without writing", self.pk, self._epoch)
        try:
            self.store.incr_meta("lease.fenced_writes")
        except Exception:  # noqa: BLE001 — bookkeeping must not raise here
            pass
        _metrics.get_registry().counter("lease.fenced_writes").inc()
        self._exit_code = ExitCode(
            997, "stale lease epoch; another worker owns this process",
            "FENCED")
        self._done.set()

    async def step_until_terminated(self) -> ExitCode:
        token = CURRENT_PROCESS.set(self)
        # the whole run is one root span; sub-steps (state transitions,
        # cache lookup, checkpoint flushes, workchain steps) nest under
        # it and the drained tree persists with the terminal transaction
        self._timeline = trace.start_timeline()
        sink_token = (trace.push_sink(self._timeline)
                      if self._timeline is not None else None)
        root = trace.span("process.run", pk=self.pk,
                          process=type(self).__name__)
        root.__enter__()
        # every live process is reachable over RPC for its whole run —
        # regardless of which runner/worker drives it (paper §III.C.b)
        self._register_control()
        try:
            # a kill recorded durably while no worker owned this process
            # is applied before any work — no resurrection after restart
            killed = self._kill_requested_durably()
            if killed is not None:
                raise ProcessKilled(killed)
            await self._pause_point()
            self.transition_to(ProcessState.RUNNING)
            exit_code = self._maybe_use_cache()
            if exit_code is None:
                with trace.span("process.body"):
                    result = await self.run()
                exit_code = _interpret_result(result)
                # body done, terminal unit of work not started: a crash
                # here reruns the process from its last checkpoint — the
                # invariant checker proves outputs still land exactly once
                chaos.fault_point("process.terminal.pre", pk=self.pk)
                # the terminal step is one unit of work: output storing +
                # links + final state + checkpoint removal + span
                # timeline, one commit
                with self.store.transaction():
                    if exit_code.is_finished_ok:
                        err = self._commit_outputs()
                        if err is not None:
                            exit_code = ExitCode(
                                11, f"output validation failed: {err}",
                                "ERROR_INVALID_OUTPUTS")
                    self._exit_code = exit_code
                    self._persist_timeline()
                    if not self.is_terminated:
                        self.transition_to(ProcessState.FINISHED)
            else:
                self._exit_code = exit_code
                with self.store.transaction():
                    self._persist_timeline()
                    if not self.is_terminated:
                        self.transition_to(ProcessState.FINISHED)
        except StaleEpochError:
            # fencing token rejected: another worker holds a newer lease
            # on this pk. Abandon without writing anything — the new
            # holder's run is the authoritative one (split-brain safety).
            self._fenced_abandon()
        except ProcessKilled as exc:
            self._exit_code = ExitCode(998, str(exc), "KILLED")
            try:
                with self.store.transaction():
                    self._persist_timeline()
                    if not self.is_terminated:
                        self.transition_to(ProcessState.KILLED)
            except StaleEpochError:
                self._fenced_abandon()
        except Exception:  # noqa: BLE001 → EXCEPTED, never propagate
            tb = traceback.format_exc()
            self._exit_code = ExitCode(999, "process excepted", "EXCEPTED")
            try:
                with self.store.transaction():
                    self.store.add_log(self.pk, "ERROR", tb)
                    self._persist_timeline()
                    if not self.is_terminated:
                        self.transition_to(ProcessState.EXCEPTED)
            except StaleEpochError:
                self._fenced_abandon()
        finally:
            self._unregister_control()
            root.__exit__(None, None, None)
            if sink_token is not None:
                trace.pop_sink(sink_token)
            CURRENT_PROCESS.reset(token)
        return self._exit_code

    async def wait_done(self) -> None:
        await self._done.wait()


def _interpret_result(result: Any) -> ExitCode:
    if result is None:
        return ExitCode(0, "", "SUCCESS")
    if isinstance(result, ExitCode):
        return result
    if isinstance(result, int):
        if result < 0:
            raise ValueError("exit status must be non-negative")
        return ExitCode(result, "", "")
    raise TypeError(f"process returned {type(result).__name__}; expected "
                    "None, int or ExitCode")


def _merge_defaults(ns: PortNamespace, values: dict[str, Any]) -> dict[str, Any]:
    out = dict(values)
    for name, port in ns.items():
        if isinstance(port, PortNamespace):
            sub = out.get(name)
            merged = _merge_defaults(port, dict(sub) if sub else {})
            if merged:
                out[name] = merged
        elif name not in out and port.has_default:
            out[name] = port.default
    return out


def _serialize_inputs(ns: PortNamespace, values: Mapping[str, Any]) -> dict:
    out: dict[str, Any] = {}
    for key, value in values.items():
        port = ns.get(key) if ns is not None else None
        if isinstance(value, DataValue):
            if value.is_stored:
                # stored values serialize by reference: checkpoints stop
                # embedding (potentially huge) payload copies — the store
                # (shared by every worker on this profile) rehydrates them
                out[key] = {"__data_ref__": value.pk}
            else:
                out[key] = {"__data__": value.to_payload(), "pk": value.pk}
        elif isinstance(value, Mapping):
            sub_ns = port if isinstance(port, PortNamespace) else None
            out[key] = {"__ns__": _serialize_inputs(sub_ns, value)}
        elif isinstance(value, (str, int, float, bool, type(None))):
            out[key] = {"__raw__": value}
        else:
            out[key] = {"__repr__": repr(value)}
    return out


def _deserialize_inputs(payload: dict, store) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, entry in payload.items():
        if "__data_ref__" in entry:
            out[key] = store.load_data(entry["__data_ref__"])
        elif "__data__" in entry:
            dv = DataValue.from_payload(entry["__data__"])
            dv.pk = entry.get("pk")
            out[key] = dv
        elif "__ns__" in entry:
            out[key] = _deserialize_inputs(entry["__ns__"], store)
        elif "__raw__" in entry:
            out[key] = entry["__raw__"]
        else:
            out[key] = entry.get("__repr__")
    return out
