"""The daemon (paper §III.A.1 — the Circus role).

Spawns and supervises: one broker process (the RabbitMQ role) and N worker
processes, each running one Runner with S process slots — scaling is
horizontal × vertical = workers × slots (paper fig. 5). Crashed workers are
restarted; their in-flight tasks are requeued by the broker heartbeat
reaper, and the replacement worker resumes the processes from their last
checkpoints.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import logging
import multiprocessing as mp
import os
import time
from typing import Any

from repro_torch.chaos import faults as chaos
from repro_torch.engine.runner import TERMINAL
from repro_torch.observability import logs as obs_logs
from repro_torch.observability import metrics as _metrics
from repro_torch.observability import trace
from repro_torch.provenance.store import SUMMARY_COLUMNS, StaleEpochError

logger = logging.getLogger("repro_torch.engine.daemon")

PROCESS_QUEUE = "process.queue"

#: pickup latency can legitimately reach minutes when 100k tasks queue
#: behind 10k live slots — extend the default buckets so p99 stays
#: computable at saturation
PICKUP_BUCKETS = _metrics.DEFAULT_BUCKETS + (60.0, 120.0, 300.0, 600.0)


# ---------------------------------------------------------------------------
# Worker main
# ---------------------------------------------------------------------------

def make_process_task_handler(runner, store, owned: set | None = None):
    """The worker's task-queue handler: resume one process from its
    checkpoint and drive it to termination. ``owned`` (when given) tracks
    the pks this worker currently runs — advertised over the worker's own
    RPC endpoint. Factored out so tests can exercise the exact
    resume/kill-durability path without spawning OS processes."""
    from repro_torch.core.process import Process, ReferencePackageError

    #: pks this handler is currently driving — a second delivery of the
    #: same pk (duplicate task row after a partition/requeue race) must
    #: not run the process twice concurrently. Returning early is safe:
    #: the duplicate's own task row gets acked while the original row
    #: stays inflight until the real execution settles.
    running: set[int] = set()

    async def handle(payload: dict) -> None:
        pk = payload["pk"]
        registry = _metrics.get_registry()
        registry.counter("daemon.tasks").inc()
        sent_ts = payload.get("ts")
        if sent_ts is not None:
            # submit→pickup latency: how long the task sat in the queue
            registry.histogram("daemon.pickup_seconds",
                               buckets=PICKUP_BUCKETS).observe(
                max(0.0, time.time() - sent_ts))
        if pk in running:
            registry.counter("daemon.duplicate_tasks").inc()
            return
        # slot-gate BEFORE materializing the Process: tasks delivered
        # beyond the slot count wait here as pk-only payloads, so resident
        # Process objects (checkpoint, inputs, namespaces) stay bounded by
        # the slot count — worker RSS does not grow with the backlog
        async with runner._sem():
            if pk in running:
                registry.counter("daemon.duplicate_tasks").inc()
                return
            chaos.fault_point("daemon.checkpoint.pre", pk=pk)
            # fence FIRST: record this delivery's lease epoch in the store
            # before doing any work. From here on, any holder of an older
            # epoch (a zombie whose lease lapsed and was requeued to us)
            # has its flush/terminal writes rejected. A delivery that is
            # itself stale (the pk was re-leased past us while this frame
            # sat in the socket) self-rejects here and just acks.
            epoch = payload.get("epoch")
            if epoch is not None:
                try:
                    store.fence_epoch(pk, int(epoch))
                except StaleEpochError:
                    registry.counter("daemon.stale_deliveries").inc()
                    return
                except KeyError:
                    raise RuntimeError(f"no node for process {pk}") from None
            checkpoint = store.load_checkpoint(pk)
            if checkpoint is None:
                node = store.get_node(pk, columns=SUMMARY_COLUMNS)
                if node and node.get("process_state") in TERMINAL:
                    return  # duplicate delivery of a finished process
                raise RuntimeError(f"no checkpoint for process {pk}")
            with trace.span("daemon.resume", pk=pk):
                try:
                    process = Process.recreate_from_checkpoint(
                        checkpoint, runner=runner,
                        epoch=int(epoch) if epoch is not None else None)
                except ReferencePackageError as exc:
                    # no worker of this package can ever resume it: settle
                    # the task as failed instead of nacking it into an
                    # endless requeue, and keep the worker up
                    registry.counter("daemon.failed_tasks").inc()
                    logger.error("task for process %d failed: %s", pk, exc)
                    return
            # rematerialized, first step not taken — the canonical
            # kill-9-mid-step window the paper's robustness story covers
            chaos.fault_point("daemon.checkpoint.post", pk=pk)
            running.add(pk)
            if owned is not None:
                owned.add(pk)
            registry.gauge("daemon.resident_processes").inc()
            try:
                # step_until_terminated registers process.<pk> RPC itself
                # and honours a durably-recorded kill before doing any work
                with obs_logs.pk_context(pk):
                    await process.step_until_terminated()
            finally:
                registry.gauge("daemon.resident_processes").dec()
                running.discard(pk)
                if owned is not None:
                    owned.discard(pk)

    return handle


def _rss_kb() -> int:
    """This process's resident set size in kB (0 where /proc is absent)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    return 0


def _cuda_peak_bytes() -> int:
    """Peak card memory this process's caching allocator has handed out
    (0 where there is no card)."""
    import torch

    if not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.max_memory_allocated())


def _preload_torch() -> float:
    """Import torch and initialise CUDA (where there is a card) before the
    worker connects to the broker; returns the seconds it took. Loading
    torch's shared libraries and ``cuInit`` hold the GIL for seconds on a
    card's machine: done by a worker's first payload thread, they starve
    the event loop that sends the heartbeats, and the broker, which takes
    a worker missing two 1 s beats for dead, requeues its tasks."""
    t0 = time.perf_counter()
    import torch

    if torch.cuda.is_available():
        torch.cuda.init()
    return time.perf_counter() - t0


def _worker_main(broker_host: str, broker_port: int, store_path: str,
                 slots: int, crash_after: float | None = None) -> None:
    """Entry point of one daemon worker OS process."""
    import random
    import uuid

    from repro_torch.engine.broker import BrokerClient
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.provenance.store import configure_store

    obs_logs.configure()  # honours REPRO_LOG_LEVEL; repro_torch.* only
    preload_s = _preload_torch()
    store = configure_store(store_path)

    async def main() -> None:
        # the stable worker NAME is the lease identity: it survives a
        # reconnect (same worker, new socket), so the broker can tell a
        # reconnecting holder from a replacement and only bump epochs for
        # genuine hand-offs
        worker_id = f"worker.{os.getpid()}-{uuid.uuid4().hex[:6]}"
        client = BrokerClient(broker_host, broker_port,
                              worker_name=worker_id)
        await client.connect()
        # REPRO_LIVENESS_INTERVAL shortens the store-recheck fallback that
        # papers over lost terminal broadcasts (chaos partition scenarios)
        liveness = float(os.environ.get("REPRO_LIVENESS_INTERVAL", "30"))
        runner = Runner(store=store, communicator=client, slots=slots,
                        liveness_interval=liveness)
        runner.distributed = True
        set_default_runner(runner)

        # advertise this worker + the pks it owns (control-plane directory);
        # the advert doubles as the worker's metrics publication — a
        # controller's workers() merges these snapshots client-side
        obs_logs.set_worker_id(worker_id)
        owned: set[int] = set()
        client.add_rpc_subscriber(
            worker_id,
            lambda msg: {"worker": worker_id, "pid": os.getpid(),
                         "slots": slots, "pks": sorted(owned),
                         "resident": len(owned), "rss_kb": _rss_kb(),
                         "cuda_peak_bytes": _cuda_peak_bytes(),
                         "preload_s": preload_s,
                         "metrics": _metrics.get_registry().snapshot()})

        # prefetch = slots: the broker parks anything beyond the worker's
        # concurrency in the durable queue (ready-queue high-water mark)
        client.add_task_subscriber(
            PROCESS_QUEUE, make_process_task_handler(runner, store, owned),
            prefetch=slots)
        if crash_after is not None:
            # fault-injection for tests: die hard mid-work
            await asyncio.sleep(crash_after + random.random() * 0.1)
            os._exit(17)
        while True:
            await asyncio.sleep(3600)

    asyncio.run(main())


def _broker_main(db_path: str, port_file: str,
                 heartbeat: float = 1.0, port: int = 0) -> None:
    """Broker OS process. A non-zero ``port`` pins the listen address —
    the daemon restarts a crashed broker on the SAME port so connected
    workers and submitters reconnect without rediscovery; the replacement
    rebuilds leases/tasks from the broker sqlite (``_recover``)."""
    from repro_torch.engine.broker import BrokerServer

    obs_logs.configure()

    async def main() -> None:
        server = BrokerServer(db_path, port=port, heartbeat=heartbeat)
        host, bound = await server.start()
        with open(port_file, "w") as fh:
            json.dump({"host": host, "port": bound}, fh)
        while True:
            await asyncio.sleep(3600)

    asyncio.run(main())


# ---------------------------------------------------------------------------
# The daemon supervisor
# ---------------------------------------------------------------------------

class Daemon:
    def __init__(self, workdir: str, *, workers: int = 2, slots: int = 50,
                 store_path: str | None = None,
                 crash_after: float | None = None,
                 heartbeat: float = 1.0):
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.store_path = store_path or os.path.join(workdir, "provenance.db")
        self.broker_db = os.path.join(workdir, "broker.db")
        self.port_file = os.path.join(workdir, "broker.json")
        self.n_workers = workers
        self.slots = slots
        self.crash_after = crash_after
        # liveness window: a worker missing 2x this is presumed dead and
        # its in-flight tasks requeued. Raise it for saturation workloads
        # where thousands of simultaneous resumes can starve a worker's
        # heartbeat task for seconds without the worker being dead.
        self.heartbeat = heartbeat
        # spawn, never fork: a forked child cannot use CUDA once the
        # parent has touched it
        self._ctx = mp.get_context("spawn")
        self._broker_proc: mp.Process | None = None
        self._workers: list[mp.Process] = []
        self.host: str | None = None
        self.port: int | None = None
        self.broker_restarts = 0
        self._submit_client = None
        self.submitter_id = f"daemon-{os.getpid()}"

    # -- lifecycle ---------------------------------------------------------------
    def _spawn_broker(self, port: int, timeout: float) -> None:
        if os.path.exists(self.port_file):
            os.unlink(self.port_file)
        self._broker_proc = self._ctx.Process(
            target=_broker_main,
            args=(self.broker_db, self.port_file, self.heartbeat, port),
            daemon=True)
        self._broker_proc.start()
        t0 = time.time()
        while not os.path.exists(self.port_file):
            if time.time() - t0 > timeout:
                raise TimeoutError("broker did not start")
            time.sleep(0.05)
        time.sleep(0.05)
        with open(self.port_file) as fh:
            info = json.load(fh)
        self.host, self.port = info["host"], info["port"]

    def start(self, timeout: float = 20.0) -> None:
        self._spawn_broker(0, timeout)
        for i in range(self.n_workers):
            self._spawn_worker()

    def _spawn_worker(self) -> None:
        p = self._ctx.Process(
            target=_worker_main,
            args=(self.host, self.port, self.store_path, self.slots,
                  self.crash_after),
            daemon=True)
        p.start()
        self._workers.append(p)

    def supervise(self) -> int:
        """Restart dead workers AND a dead broker (the Circus role).
        Returns #restarts (workers + broker). A restarted broker is pinned
        to the old port, so live workers' reconnect loops find it without
        rediscovery and re-``own`` their pks with epoch validation."""
        restarts = 0
        if self._broker_proc is not None and not self._broker_proc.is_alive():
            logger.warning("broker died (exitcode %s); restarting on "
                           "port %s", self._broker_proc.exitcode, self.port)
            chaos.fault_point("broker.restart", port=self.port or 0)
            self._spawn_broker(self.port or 0, timeout=20.0)
            # the old submitter socket points at the dead process; drop it
            # so the next send reconnects (with full-jitter retries)
            if self._submit_client is not None:
                self._submit_client.close()
                self._submit_client = None
            self.broker_restarts += 1
            restarts += 1
        for i, p in enumerate(list(self._workers)):
            if not p.is_alive():
                logger.warning("worker %d died (exitcode %s); restarting",
                               i, p.exitcode)
                self._workers.remove(p)
                self._spawn_worker()
                restarts += 1
        return restarts

    def scale_workers(self, n: int) -> None:
        """Dynamically grow/shrink the pool (Circus 'incr')."""
        while len(self._workers) < n:
            self._spawn_worker()
        while len(self._workers) > n:
            p = self._workers.pop()
            p.terminate()
        self.n_workers = n

    def worker_pids(self) -> list[int]:
        """OS pids of the live worker processes (e.g. for RSS sampling)."""
        return [p.pid for p in self._workers if p.is_alive()]

    def stop(self) -> None:
        if self._submit_client is not None:
            self._submit_client.close()
            self._submit_client = None
        for p in self._workers:
            p.terminate()
        if self._broker_proc is not None:
            self._broker_proc.terminate()
        for p in self._workers:
            p.join(timeout=5)
        if self._broker_proc is not None:
            self._broker_proc.join(timeout=5)

    # -- client-side submission ---------------------------------------------------
    def submit(self, process_class, inputs: dict | None = None) -> int:
        """Create the process node + initial checkpoint locally, then ship
        the pk through the durable task queue (paper §III.C.a). Accepts a
        Process class + inputs or a ProcessBuilder, like engine/launch.py."""
        from repro_torch.core.builder import expand_launch_target
        from repro_torch.engine.runner import Runner
        from repro_torch.provenance.store import configure_store, current_store

        process_class, inputs = expand_launch_target(process_class, inputs)
        store = current_store()
        if store.path != self.store_path:
            store = configure_store(self.store_path)
        runner = Runner(store=store)
        process = process_class(inputs=inputs, runner=runner)
        pk = process.pk
        self.send_task(pk)
        return pk

    def _submitter(self):
        """One persistent broker connection for all submissions (the old
        path opened a fresh socket and slept 50 ms per task)."""
        if self._submit_client is None:
            from repro_torch.engine.broker import SyncBrokerClient
            self._submit_client = SyncBrokerClient(self.host, self.port)
        return self._submit_client

    def send_task(self, pk: int) -> None:
        """Ship one pk through the durable queue; returns once the broker
        acks the durable enqueue (no sleep, no per-task socket)."""
        self._submitter().task_send(
            PROCESS_QUEUE, {"pk": pk, "ts": time.time()},
            submitter=self.submitter_id)

    def send_tasks(self, pks, chunk: int = 1000) -> int:
        """Batch-ship many pks: ``task_send_many`` frames of ``chunk``
        payloads, each acked as one durable insert. Returns the count."""
        client = self._submitter()
        pks = list(pks)
        sent = 0
        for i in range(0, len(pks), chunk):
            now = time.time()
            sent += client.task_send_many(
                PROCESS_QUEUE,
                [{"pk": pk, "ts": now} for pk in pks[i:i + chunk]],
                submitter=self.submitter_id)
        return sent

    def controller(self):
        """A synchronous control-plane client for this daemon's broker
        (pause/play/kill/status/watch)."""
        from repro_torch.engine.controller import ProcessController
        return ProcessController(self.host, self.port)
