"""The port's daemon on the CPU: the durable broker, worker OS processes,
crash recovery, leases and epoch fencing, the control plane and fsck
(paper §III.A, §III.C).

Twins of ``tests/test_daemon.py``, ``tests/test_control.py`` (but the two
CLI cases; the daemon half of the CLI kill runs through a
``ProcessController``), ``tests/test_leases.py``, the sweep and
pause/play/kill cases of ``tests/test_system.py`` and the daemon cases of
``tests/test_builder.py`` and ``tests/test_caching.py``, run against
``repro_torch``; every job carries ``"device": "cpu"``. Also: a daemon
worker's imports load neither JAX nor the reference package, and a
worker settles a task whose checkpoint the reference wrote as failed
instead of crashing or requeueing it.
"""

import asyncio
import json
import os
import sqlite3
import subprocess
import sys
import time

import pytest

from repro_torch.calcjobs import GPUTrainJob
from repro_torch.core import Dict, Int, ToContext, WorkChain, append_, while_
from repro_torch.core.process import Process
from repro_torch.engine.broker import (
    _TASKS_SCHEMA, BrokerClient, BrokerServer, SyncBrokerClient,
)
from repro_torch.engine.communicator import (
    parse_state_subject, process_rpc_id, state_subject,
)
from repro_torch.engine.daemon import Daemon, make_process_task_handler
from repro_torch.engine.runner import Runner
from repro_torch.provenance.store import (
    LinkType, NodeType, QueryBuilder, StaleEpochError, configure_store,
)

TERMINAL = ("finished", "excepted", "killed")
SMALL = {"arch": "qwen2-0.5b", "steps": 1, "batch": 1, "seq": 8,
         "device": "cpu"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_port_state(monkeypatch):
    """The port's global state: caching policy, metrics registry, default
    runner and current store."""
    from repro_torch.caching.config import ENV_VAR, reset_policy
    from repro_torch.engine.runner import set_default_runner
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
def store():
    """Fresh in-memory port store, no default runner."""
    from repro_torch.engine.runner import set_default_runner

    st = configure_store(":memory:")
    set_default_runner(None)
    yield st
    set_default_runner(None)


@pytest.fixture()
def runner(store):
    from repro_torch.engine.runner import set_default_runner

    r = Runner(store=store)
    set_default_runner(r)
    yield r


# ===========================================================================
# twins of tests/test_daemon.py
# ===========================================================================


def _wait_all(daemon, store, pks, timeout=150, supervise=True,
              heal_after=None):
    t0 = time.time()
    restarts = 0
    while time.time() - t0 < timeout:
        states = {pk: (store.get_node(pk) or {}).get("process_state")
                  for pk in pks}
        if all(s in TERMINAL for s in states.values()):
            return states, restarts
        if supervise:
            r = daemon.supervise()
            restarts += r
            if heal_after is not None and restarts >= heal_after:
                daemon.crash_after = None
        time.sleep(0.4)
    return states, restarts


@pytest.mark.slow
def test_daemon_processes_jobs(tmp_path):
    daemon = Daemon(str(tmp_path), workers=2, slots=8)
    daemon.start()
    try:
        pks = [daemon.submit(GPUTrainJob,
                             {"config": Dict({**SMALL, "seed": i})})
               for i in range(3)]
        store = configure_store(daemon.store_path)
        states, _ = _wait_all(daemon, store, pks)
        assert all(s == "finished" for s in states.values()), states
        assert all(store.get_node(pk)["exit_status"] == 0 for pk in pks)
        # each worker imported torch before it connected, and reports
        # its peak card memory (none here: the jobs ran on the CPU)
        with daemon.controller() as ctl:
            adverts = ctl.workers()
        assert len(adverts) == 2
        assert all(a["preload_s"] > 0 and a["cuda_peak_bytes"] == 0
                   for a in adverts)
    finally:
        daemon.stop()


@pytest.mark.slow
def test_daemon_worker_crash_recovery(tmp_path):
    """Workers hard-exit mid-job; the broker requeues their tasks; the
    supervisor restarts workers; jobs finish from their checkpoints."""
    daemon = Daemon(str(tmp_path), workers=2, slots=8, crash_after=1.5)
    daemon.start()
    try:
        pks = [daemon.submit(GPUTrainJob,
                             {"config": Dict({**SMALL, "seed": i})})
               for i in range(3)]
        store = configure_store(daemon.store_path)
        states, restarts = _wait_all(daemon, store, pks, timeout=200,
                                     heal_after=4)
        assert restarts > 0, "no worker crashes were injected"
        assert all(s == "finished" for s in states.values()), states
        assert all(store.get_node(pk)["exit_status"] == 0 for pk in pks)
    finally:
        daemon.stop()


# ===========================================================================
# twins of tests/test_control.py
# ===========================================================================


class Spin(Process):
    """Runs 'forever' in small interruptible slices — a control target."""

    async def run(self):
        for _ in range(5000):
            await self._pause_point()
            await self.interruptible(asyncio.sleep(0.01))


class Quick(Process):
    async def run(self):
        await asyncio.sleep(0.05)


def run(coro, timeout=60):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


async def _broker_pair(tmp_path):
    """A broker + two connected clients (one 'worker', one 'control')."""
    server = BrokerServer(str(tmp_path / "broker.db"))
    host, port = await server.start()
    worker = BrokerClient(host, port)
    await worker.connect()
    control = BrokerClient(host, port)
    await control.connect()
    return server, worker, control


async def _status_until(control, pk, want, attempts=200):
    for _ in range(attempts):
        status = await control.rpc_send_async(process_rpc_id(pk),
                                              {"intent": "status"})
        if status["state"] == want:
            return status
        await asyncio.sleep(0.02)
    raise AssertionError(f"process {pk} never reached {want!r}: {status}")


# ---------------------------------------------------------------------------
# subject / identifier scheme
# ---------------------------------------------------------------------------

def test_subject_scheme_roundtrip():
    assert state_subject(42, "finished") == "state_changed.42.finished"
    assert parse_state_subject("state_changed.42.finished") == (42, "finished")
    assert parse_state_subject("unrelated.42.finished") is None
    assert parse_state_subject("state_changed.nan.x") is None
    assert process_rpc_id(7) == "process.7"


# ---------------------------------------------------------------------------
# remote control through the broker (cross-client RPC forwarding)
# ---------------------------------------------------------------------------

def test_remote_pause_play_kill_through_broker(tmp_path):
    async def main():
        _, worker, control = await _broker_pair(tmp_path)
        store = configure_store(":memory:")
        runner_w = Runner(store=store, communicator=worker)
        handle = runner_w.submit(Spin, {})
        pk = handle.pk
        await asyncio.sleep(0.1)   # let the process start + register RPC

        assert await control.rpc_send_async(
            process_rpc_id(pk), {"intent": "pause"}) is True
        status = await _status_until(control, pk, "paused")
        assert status["paused"] is True
        assert store.get_node(pk)["process_state"] == "paused"

        assert await control.rpc_send_async(
            process_rpc_id(pk), {"intent": "play"}) is True
        await _status_until(control, pk, "running")

        assert await control.rpc_send_async(
            process_rpc_id(pk), {"intent": "kill", "message": "bye"}) is True
        await asyncio.wait_for(handle.process.wait_done(), 10)
        assert handle.process.state.value == "killed"
        node = store.get_node(pk)
        assert node["process_state"] == "killed"
        # the kill was recorded durably before it was executed
        assert json.loads(node["attributes"])["kill_requested"] == "bye"

    run(main())


def test_rpc_to_unknown_process_errors(tmp_path):
    async def main():
        _, _, control = await _broker_pair(tmp_path)
        with pytest.raises(KeyError):
            await control.rpc_send_async(process_rpc_id(404),
                                         {"intent": "status"})

    run(main())


def test_rpc_directory_lookup_and_sync_client(tmp_path):
    async def main():
        server, worker, control = await _broker_pair(tmp_path)
        worker.add_rpc_subscriber("worker.abc",
                                  lambda msg: {"pks": [1, 2], "slots": 4})
        worker.add_rpc_subscriber(process_rpc_id(7),
                                  lambda msg: {"state": "running"})
        await asyncio.sleep(0.05)
        assert await control.rpc_lookup("process.*") == ["process.7"]
        assert await control.rpc_lookup("worker.*") == ["worker.abc"]

        def sync_part():
            client = SyncBrokerClient(server.host, server.port)
            try:
                assert client.lookup("worker.*") == ["worker.abc"]
                assert client.rpc("worker.abc", {})["pks"] == [1, 2]
                with pytest.raises(KeyError):
                    client.rpc("process.404", {})
            finally:
                client.close()

        await asyncio.get_running_loop().run_in_executor(None, sync_part)

        # unregistering removes the directory entry
        worker.remove_rpc_subscriber(process_rpc_id(7))
        await asyncio.sleep(0.05)
        assert await control.rpc_lookup("process.*") == []

    run(main())


# ---------------------------------------------------------------------------
# event-driven waits (the no-poll-loop claim)
# ---------------------------------------------------------------------------

def test_runner_has_no_poll_interval():
    assert not hasattr(Runner(store=configure_store(":memory:")),
                       "poll_interval")


def test_remote_wait_is_event_driven(tmp_path):
    """A waiter with no local handle completes via the terminal broadcast
    well under the old 2 s poll floor."""

    async def main():
        _, worker, waiter = await _broker_pair(tmp_path)
        store = configure_store(":memory:")
        runner_w = Runner(store=store, communicator=worker)
        runner_c = Runner(store=store, communicator=waiter)
        handle = runner_w.submit(Quick, {})
        assert handle.pk not in runner_c._processes   # remote path

        t0 = time.monotonic()
        node = await runner_c.wait(handle.pk)
        elapsed = time.monotonic() - t0
        assert node["process_state"] == "finished"
        # the process itself sleeps 0.05 s; anything close to the old
        # 2 s poll interval means we are polling again
        assert elapsed < 1.0, f"wait took {elapsed:.3f}s — not event-driven"

    run(main())


def test_wait_all_waits_concurrently(tmp_path):
    async def main():
        _, worker, waiter = await _broker_pair(tmp_path)
        store = configure_store(":memory:")
        runner_w = Runner(store=store, communicator=worker)
        runner_c = Runner(store=store, communicator=waiter)
        handles = [runner_w.submit(Quick, {}) for _ in range(5)]
        t0 = time.monotonic()
        nodes = await runner_c.wait_all([h.pk for h in handles])
        elapsed = time.monotonic() - t0
        assert [n["process_state"] for n in nodes] == ["finished"] * 5
        # five concurrent 0.05 s processes must not take 5 × the serial time
        assert elapsed < 1.0

    run(main())


def test_wait_liveness_fallback_catches_silent_termination():
    """A worker that dies without broadcasting: the coarse store re-check
    (NOT a poll loop — interval is long in production) still unblocks."""

    async def main():
        store = configure_store(":memory:")
        runner = Runner(store=store, liveness_interval=0.1)
        pk = store.create_process_node(NodeType.PROCESS, "Ghost")

        async def terminate_silently():
            await asyncio.sleep(0.25)
            store.update_process(pk, state="finished")

        asyncio.ensure_future(terminate_silently())
        await asyncio.wait_for(runner.wait_for_process(pk), 5)

    run(main())


def test_wait_on_already_terminal_process_returns_immediately():
    async def main():
        store = configure_store(":memory:")
        runner = Runner(store=store)
        pk = store.create_process_node(NodeType.PROCESS, "Done")
        store.update_process(pk, state="finished")
        t0 = time.monotonic()
        await runner.wait_for_process(pk)
        assert time.monotonic() - t0 < 0.5

    run(main())


# ---------------------------------------------------------------------------
# durable kill: survives worker restarts, no resurrection
# ---------------------------------------------------------------------------

def test_kill_is_durable_across_worker_restart(tmp_path):
    db = str(tmp_path / "store.db")

    async def main():
        store = configure_store(db)
        runner1 = Runner(store=store)
        process = Spin(inputs={}, runner=runner1)
        pk = process.pk
        assert store.load_checkpoint(pk) is not None

        # the control plane records the kill while no worker runs the pk
        # (worker died mid-flight); only the durable marker remains
        process._control_handler({"intent": "kill", "message": "op kill"})

        # a restarted worker picks the task back up from the queue …
        runner2 = Runner(store=store)
        handler = make_process_task_handler(runner2, store)
        await handler({"pk": pk})

        # … and honours the kill instead of resurrecting the process
        node = store.get_node(pk)
        assert node["process_state"] == "killed"
        assert node["exit_status"] == 998
        assert store.load_checkpoint(pk) is None

        # duplicate redelivery after termination: a no-op, not an error
        await handler({"pk": pk})
        assert store.get_node(pk)["process_state"] == "killed"

    run(main())


def test_worker_handler_tracks_owned_pks(tmp_path):
    async def main():
        store = configure_store(":memory:")
        runner = Runner(store=store)
        process = Quick(inputs={}, runner=runner)
        owned: set = set()
        handler = make_process_task_handler(runner, store, owned)
        task = asyncio.ensure_future(handler({"pk": process.pk}))
        await asyncio.sleep(0.02)
        assert owned == {process.pk}
        await task
        assert owned == set()

    run(main())


def test_slot_queued_process_is_controllable():
    """A submitted process waiting for a slot already has its control
    endpoint: kill reaches it before it ever starts stepping."""

    async def main():
        store = configure_store(":memory:")
        runner = Runner(store=store, slots=1)
        blocker = runner.submit(Spin, {})
        queued = runner.submit(Spin, {})
        await asyncio.sleep(0.05)
        # both controllable; the queued one holds no slot yet
        runner.control(queued.pk, "kill", message="never ran")
        runner.control(blocker.pk, "kill", message="done blocking")
        await asyncio.wait_for(queued.process.wait_done(), 10)
        await asyncio.wait_for(blocker.process.wait_done(), 10)
        assert store.get_node(queued.pk)["process_state"] == "killed"

    run(main())


# ---------------------------------------------------------------------------
# durable broadcast log + replay
# ---------------------------------------------------------------------------

def test_event_log_replays_missed_broadcasts(tmp_path):
    async def main():
        server, worker, _ = await _broker_pair(tmp_path)
        for state in ("running", "finished"):
            worker.broadcast_send(state_subject(9, state), sender=9,
                                  body={"pk": 9, "state": state})
        await asyncio.sleep(0.1)    # let the broker log them

        def sync_part():
            # a watcher connecting AFTER the fact still sees the events
            client = SyncBrokerClient(server.host, server.port)
            try:
                events = list(client.events(
                    subject_filter="state_changed.9.*", timeout=1.0,
                    replay_since=0))
            finally:
                client.close()
            return events

        events = await asyncio.get_running_loop().run_in_executor(
            None, sync_part)
        states = [body["state"] for _, _, body in events]
        assert states == ["running", "finished"]

    run(main())


def test_broker_stops_after_a_client_it_already_dropped(tmp_path):
    """A client whose connection ended before ``stop()`` (the broker has
    seen its EOF and dropped it) does not keep ``stop()`` waiting: the
    broker closes its own end of every connection that ends. The
    reference's broker leaves that end open, and ``wait_closed()`` waits
    for it (Python 3.12.1+), which hung its saturation tests' sync-client
    cases whenever the client's EOF won the race with ``stop()``."""
    import socket

    async def main():
        server = BrokerServer(str(tmp_path / "broker.db"))
        await server.start()
        sock = socket.create_connection((server.host, server.port))
        t0 = time.monotonic()
        while not server._clients:
            assert time.monotonic() - t0 < 5, "the broker never saw the client"
            await asyncio.sleep(0.01)
        sock.close()
        while server._clients:
            assert time.monotonic() - t0 < 5, "the client was never dropped"
            await asyncio.sleep(0.01)
        assert server.stats["clients_dropped"] == 1
        await asyncio.wait_for(server.stop(), 5)

    run(main())


# ---------------------------------------------------------------------------
# the full stack: daemon worker + broker + controller kill (the daemon
# half of the reference's CLI case; the CLI itself is not ported)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_controller_kill_terminates_daemon_process(tmp_path):
    from repro_torch.calcjobs import GPUTrainJob
    from repro_torch.core import Dict as DictData
    from repro_torch.engine.controller import ProcessController
    from repro_torch.engine.daemon import Daemon

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

        with ProcessController.from_workdir(str(tmp_path)) as ctl:
            assert ctl.kill(pk, message="controller kill") is True

        t0 = time.time()
        while time.time() - t0 < 60:
            node = store.get_node(pk)
            if node["process_state"] in TERMINAL:
                break
            time.sleep(0.2)
        assert node["process_state"] == "killed", node
        assert node["exit_status"] == 998
        assert json.loads(node["attributes"])["kill_requested"] == \
            "controller kill"

        # the durable event log lets a late watcher see the whole story
        with ProcessController.from_workdir(str(tmp_path)) as ctl:
            events = list(ctl.watch(pk=pk, timeout=2.0, replay_since=0))
        assert any(body.get("state") == "killed"
                   for _, _, body in events), events
    finally:
        daemon.stop()


@pytest.mark.slow
def test_daemon_wait_latency_under_poll_floor(tmp_path):
    """Runner.wait on a daemon-run process completes via broadcast well
    under the old 2 s poll interval after the terminal transition."""
    from repro_torch.calcjobs import GPUTrainJob
    from repro_torch.core import Dict as DictData
    from repro_torch.engine.daemon import Daemon

    daemon = Daemon(str(tmp_path), workers=1, slots=4)
    daemon.start()
    try:
        pk = daemon.submit(GPUTrainJob, {"config": DictData(
            {"arch": "qwen2-0.5b", "steps": 1, "batch": 1, "seq": 8,
             "device": "cpu"})})
        store = configure_store(daemon.store_path)

        async def main():
            client = BrokerClient(daemon.host, daemon.port)
            await client.connect()
            terminal_seen_at = {}

            def stamp(subject, sender, body):
                parsed = parse_state_subject(subject)
                if parsed and parsed[1] in TERMINAL:
                    terminal_seen_at[parsed[0]] = time.monotonic()

            client.add_broadcast_subscriber(stamp, f"state_changed.{pk}.*")
            runner = Runner(store=store, communicator=client)
            node = await asyncio.wait_for(runner.wait(pk), 300)
            waited_until = time.monotonic()
            client.close()
            return node, terminal_seen_at.get(pk), waited_until

        node, seen_at, waited_until = run(main(), timeout=320)
        assert node["process_state"] == "finished"
        assert seen_at is not None, "terminal broadcast never arrived"
        # the wait unblocked promptly after the broadcast — not after a
        # poll interval tick
        assert waited_until - seen_at < 1.0
    finally:
        daemon.stop()


# ===========================================================================
# twins of tests/test_leases.py
# ===========================================================================


class _FakeWriter:
    def __init__(self):
        self.frames = []

    def is_closing(self):
        return False

    def write(self, data):
        self.frames.append(data)


def _server(tmp_path):
    return BrokerServer(str(tmp_path / "broker.db"))


# ---------------------------------------------------------------------------
# lease grant / renew / expire / epoch bump
# ---------------------------------------------------------------------------

def test_lease_grant_renew_and_handoff_bump(tmp_path):
    srv = _server(tmp_path)
    srv._names["c1"] = "wA"
    srv._names["c2"] = "wB"
    # first grant creates the lease at epoch 1
    assert srv._grant_lease(5, "c1") == 1
    # re-delivery to the SAME worker renews without bumping — a worker
    # that merely reconnected must not fence its own live coroutine
    assert srv._grant_lease(5, "c1") == 1
    assert srv.stats["leases_granted"] == 1
    # hand-off to a different worker arms the fence
    assert srv._grant_lease(5, "c2") == 2
    srv._commit_now()
    row = srv.conn().execute(
        "SELECT worker, epoch FROM leases WHERE pk=5").fetchone()
    assert row["worker"] == "wB" and row["epoch"] == 2


def test_drop_client_expires_lease_without_bump(tmp_path):
    srv = _server(tmp_path)
    srv._clients["c1"] = _FakeWriter()
    srv._names["c1"] = "wA"
    srv._grant_lease(9, "c1")

    srv._drop_client("c1")

    # expired: holder cleared, epoch NOT bumped (the bump happens at the
    # next grant to a different worker), durable row matches
    assert srv._leases[9] == [None, 1]
    assert srv.stats["leases_expired"] == 1
    row = srv.conn().execute(
        "SELECT worker, epoch FROM leases WHERE pk=9").fetchone()
    assert row["worker"] is None and row["epoch"] == 1


def test_reconnect_reowns_expired_lease_without_bump(tmp_path):
    srv = _server(tmp_path)
    srv._clients["c1"] = _FakeWriter()
    srv._names["c1"] = "wA"
    srv._grant_lease(9, "c1")
    srv._drop_client("c1")

    # the same worker NAME comes back under a fresh connection and
    # re-owns at the epoch it holds: restored, not refused, not bumped
    w = _FakeWriter()
    srv._clients["c2"] = w
    asyncio.run(srv._handle("c2", {"kind": "hello", "worker": "wA"}))
    asyncio.run(srv._handle("c2", {"kind": "own", "pks": [9],
                                   "epochs": {"9": 1}}))
    assert srv._leases[9] == ["wA", 1]
    assert srv._owners[9] == "c2"
    assert not any(b"own_refused" in f for f in w.frames)


def test_stale_own_claim_refused(tmp_path):
    srv = _server(tmp_path)
    w = _FakeWriter()
    srv._clients["c1"] = w
    srv._names["c1"] = "wA"
    srv._leases[7] = ["wB", 3]  # pk 7 was re-leased to wB at epoch 3

    asyncio.run(srv._handle("c1", {"kind": "own", "pks": [7],
                                   "epochs": {"7": 1}}))

    # the zombie's claim is refused: no ownership, counted, told why
    assert 7 not in srv._owners
    assert srv.stats["stale_claims"] == 1
    reply = json.loads(w.frames[-1].decode())
    assert reply["kind"] == "own_refused" and reply["pks"] == [7]


def test_zombie_ack_cannot_settle_requeued_task(tmp_path):
    srv = _server(tmp_path)
    srv.conn().execute(
        "INSERT INTO tasks (id, queue, payload, state, consumer,"
        " created_at) VALUES (1, 'q', '{}', 'inflight', 'c2', 0)")
    srv._commit_now()

    # c1 (the previous holder) acks a task that is now inflight to c2:
    # the consumer guard must leave the row untouched
    asyncio.run(srv._handle("c1", {"kind": "ack", "task_id": 1}))
    row = srv.conn().execute(
        "SELECT state, consumer FROM tasks WHERE id=1").fetchone()
    assert row["state"] == "inflight" and row["consumer"] == "c2"

    # the rightful holder settles it
    asyncio.run(srv._handle("c2", {"kind": "ack", "task_id": 1}))
    assert srv.conn().execute(
        "SELECT COUNT(*) FROM tasks").fetchone()[0] == 0


# ---------------------------------------------------------------------------
# broker crash recovery
# ---------------------------------------------------------------------------

def test_broker_restart_recovers_leases_and_requeues(tmp_path):
    db = str(tmp_path / "broker.db")
    srv1 = BrokerServer(db)
    srv1._names["c1"] = "wA"
    assert srv1._grant_lease(3, "c1") == 1
    srv1.conn().execute(
        "INSERT INTO tasks (queue, payload, state, consumer, created_at)"
        " VALUES ('process.queue', ?, 'inflight', 'c1', 0)",
        (json.dumps({"pk": 3}),))
    srv1._commit_now()
    srv1._conn.close()  # the old broker process is gone (kill -9)

    srv2 = BrokerServer(db)
    srv2._recover()
    # the lease survives verbatim: same holder name, same epoch — a
    # reconnecting wA is not fenced by the broker having died
    assert srv2._leases[3] == ["wA", 1]
    # the dead broker's inflight task is requeued (its consumer's
    # connection died with the old process)
    row = srv2.conn().execute(
        "SELECT state, consumer FROM tasks").fetchone()
    assert row["state"] == "ready" and row["consumer"] is None
    # renewal stamps were refreshed: reconnecting workers get a full
    # grace window before the reaper may expire anything
    renewed = srv2.conn().execute(
        "SELECT renewed_at FROM leases WHERE pk=3").fetchone()[0]
    assert renewed > time.time() - 5.0


# ---------------------------------------------------------------------------
# store epoch fencing
# ---------------------------------------------------------------------------

def test_fence_epoch_monotonic(store):
    pk = store.create_process_node(NodeType.CALC_FUNCTION, "P")
    store.fence_epoch(pk, None)   # broker-less runs: no-op
    store.fence_epoch(pk, 2)
    store.fence_epoch(pk, 2)      # same epoch: still the holder
    store.fence_epoch(pk, 5)      # monotonic advance
    with pytest.raises(StaleEpochError) as err:
        store.fence_epoch(pk, 3)
    assert err.value.pk == pk and err.value.epoch == 3
    with pytest.raises(KeyError):
        store.fence_epoch(999999, 1)


def test_stale_fence_rolls_back_whole_transaction(store):
    pk = store.create_process_node(NodeType.CALC_FUNCTION, "P")
    store.fence_epoch(pk, 2)
    # a zombie's unit of work: writes land in the txn, then its fence
    # assertion fails — EVERYTHING must roll back, not just the fence
    with pytest.raises(StaleEpochError):
        with store.transaction():
            store.update_process(pk, state="running")
            store.fence_epoch(pk, 1)
    node = store.get_node(pk)
    assert node["process_state"] != "running"


# ---------------------------------------------------------------------------
# fsck: detect + repair + idempotence
# ---------------------------------------------------------------------------

def _broker_db(tmp_path, *, lease_pks=()):
    db = str(tmp_path / "fsck-broker.db")
    conn = sqlite3.connect(db)
    conn.executescript(_TASKS_SCHEMA)
    for pk in lease_pks:
        conn.execute(
            "INSERT INTO leases (pk, worker, epoch, renewed_at)"
            " VALUES (?, 'w', 1, ?)", (pk, time.time()))
    conn.commit()
    conn.close()
    return db


def _task_pks(broker_db):
    conn = sqlite3.connect(broker_db)
    try:
        return sorted(
            json.loads(row[0])["pk"] for row in conn.execute(
                "SELECT payload FROM tasks WHERE state='ready'"))
    finally:
        conn.close()


def test_fsck_detects_and_repairs(store, tmp_path):
    from repro_torch.chaos.invariants import check_store
    from repro_torch.provenance.fsck import fsck

    # orphan with a checkpoint -> repair requeues it
    orphan_ckpt = store.create_process_node(NodeType.CALC_FUNCTION, "A")
    store.save_checkpoint(orphan_ckpt, {"pk": orphan_ckpt})
    # orphan without a checkpoint -> repair can only mark it excepted
    orphan_dead = store.create_process_node(NodeType.CALC_FUNCTION, "B")
    # held lease -> NOT an orphan, left alone
    live = store.create_process_node(NodeType.CALC_FUNCTION, "C")
    store.save_checkpoint(live, {"pk": live})
    # terminal process still carrying a checkpoint
    done = store.create_process_node(NodeType.CALC_FUNCTION, "D")
    store.update_process(done, state="finished", exit_status=0,
                         attributes={"state_history":
                                     [["finished", time.time()]]})
    store.save_checkpoint(done, {"pk": done})
    # dangling link
    with store._lock:
        store._conn().execute(
            "INSERT INTO links (in_id, out_id, link_type, label)"
            " VALUES (?, 999999, 'create', 'ghost')", (orphan_dead,))
        store._conn().commit()
    # unreferenced blob
    junk = store.repository.put(b"nobody references these bytes")

    broker_db = _broker_db(tmp_path, lease_pks=(live,))

    # -- detect-only: full census, nothing mutated
    report = fsck(store, broker_db=broker_db)
    assert report.counts() == {"orphan": 2, "stale-checkpoint": 1,
                               "dangling-link": 1, "unreferenced-blob": 1}
    assert store.repository.has(junk)
    assert store.load_checkpoint(done) is not None

    # -- repair
    repaired = fsck(store, repair=True, broker_db=broker_db)
    assert len(repaired.findings) == 5
    assert _task_pks(broker_db) == [orphan_ckpt]   # requeued
    node = store.get_node(orphan_dead)
    assert node["process_state"] == "excepted"
    assert node["exit_status"] == 999
    history = json.loads(node["attributes"])["state_history"]
    assert history[-1][0] == "excepted"
    assert store.load_checkpoint(done) is None
    assert not store.repository.has(junk)

    # -- idempotent: a second repair pass finds nothing (the requeued
    # orphan now has a pending task row, so it is no longer orphaned)
    assert fsck(store, repair=True, broker_db=broker_db).clean
    # and the repaired profile passes the chaos invariant checker
    assert check_store(store).ok


def test_fsck_without_broker_marks_orphans_excepted(store):
    from repro_torch.provenance.fsck import fsck

    pk = store.create_process_node(NodeType.CALC_FUNCTION, "A")
    store.save_checkpoint(pk, {"pk": pk})
    report = fsck(store, repair=True, broker_db=None)
    assert report.counts() == {"orphan": 1}
    node = store.get_node(pk)
    # no broker to requeue into: even a checkpointed orphan goes terminal
    assert node["process_state"] == "excepted"
    assert node["checkpoint"] is None
    assert fsck(store, repair=True, broker_db=None).clean


# ===========================================================================
# twins of tests/test_system.py's sweep and pause/play/kill cases
# ===========================================================================

class SweepWorkChain(WorkChain):
    """The canonical high-throughput pattern: fan out N training jobs with
    different seeds, collect the best."""

    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("n_jobs", valid_type=Int, default=Int(3))
        spec.input("config", valid_type=Dict)
        spec.output("best_loss", valid_type=Dict)
        spec.outline(cls.launch, cls.collect)

    def launch(self):
        base = dict(self.inputs["config"].value)
        for seed in range(self.inputs["n_jobs"].value):
            cfg = dict(base)
            cfg["seed"] = seed
            self.to_context(jobs=append_(
                self.submit(GPUTrainJob, config=Dict(cfg))))

    def collect(self):
        best = None
        for job in self.ctx.jobs:
            assert job.is_finished_ok
            m = job.outputs["metrics"].value
            if best is None or m["final_loss"] < best["final_loss"]:
                best = m
        self.out("best_loss", Dict(best))


def test_sweep_workchain_end_to_end(store, runner):
    outputs, proc = runner.run(SweepWorkChain, {
        "n_jobs": Int(3),
        "config": Dict({"arch": "qwen2-0.5b", "steps": 2, "batch": 1,
                        "seq": 16, "device": "cpu"}),
    })
    assert proc.is_finished_ok
    assert outputs["best_loss"].value["final_loss"] > 0
    # provenance: 1 workchain -> 3 calcjobs, each with retrieved+metrics
    assert QueryBuilder(store).nodes(NodeType.CALC_JOB).count() == 3
    calls = store.outgoing(proc.pk, LinkType.CALL_CALC)
    assert len(calls) == 3
    assert store.unfinished_processes() == []


def test_pause_play_kill_rpc(store, runner):
    """External control via RPC (paper §III.C.b)."""

    class Slow(WorkChain):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.outline(while_(cls.forever)(cls.tick))

        def forever(self):
            return True

        def tick(self):
            self.ctx["n"] = self.ctx.get("n", 0) + 1

    async def main():
        handle = runner.submit(Slow, {})
        await asyncio.sleep(0.05)
        runner.control(handle.pk, "kill", message="enough")
        await asyncio.wait_for(handle.process.wait_done(), timeout=10)
        return handle.process

    proc = runner.loop.run_until_complete(main())
    assert proc.state.value == "killed"
    assert store.get_node(proc.pk)["process_state"] == "killed"


# ===========================================================================
# the daemon cases of tests/test_builder.py and tests/test_caching.py
# ===========================================================================

def _wait_one(daemon, store, pk, timeout=150):
    t0 = time.time()
    while time.time() - t0 < timeout:
        node = store.get_node(pk)
        if node and node["process_state"] in TERMINAL:
            return node
        daemon.supervise()
        time.sleep(0.3)
    raise TimeoutError(f"process {pk} did not finish")


@pytest.mark.slow
def test_builder_roundtrip_through_daemon(tmp_path):
    daemon = Daemon(str(tmp_path), workers=1, slots=4)
    daemon.start()
    try:
        store = configure_store(daemon.store_path)
        b = GPUTrainJob.get_builder()
        b.config = Dict({**SMALL, "seed": 3})
        b.metadata.label = "builder-daemon-job"
        pk = daemon.submit(b)
        node = _wait_one(daemon, store, pk)
        assert node["process_state"] == "finished"
        assert node["exit_status"] == 0
        assert node["label"] == "builder-daemon-job"
        labels = {label for _, _, label in store.incoming(pk)}
        assert "config" in labels
    finally:
        daemon.stop()


@pytest.mark.slow
def test_daemon_worker_cache_hit_skips_execution(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHING", "GPUTrainJob")
    cfg = {**SMALL, "seed": 0}

    daemon = Daemon(str(tmp_path), workers=1, slots=8)
    daemon.start()
    try:
        store = configure_store(daemon.store_path)
        pk1 = daemon.submit(GPUTrainJob, {"config": Dict(cfg)})
        n1 = _wait_one(daemon, store, pk1)
        assert n1["process_state"] == "finished" and n1["exit_status"] == 0

        t0 = time.time()
        pk2 = daemon.submit(GPUTrainJob, {"config": Dict(cfg)})
        n2 = _wait_one(daemon, store, pk2)
        warm = time.time() - t0
        assert n2["process_state"] == "finished" and n2["exit_status"] == 0
        attrs = json.loads(n2["attributes"])
        assert attrs["cached_from_pk"] == pk1
        # executed runs log upload/submit reports; a cache hit only logs
        # the hit itself — proof the worker skipped execution
        messages = " ".join(l["message"] for l in store.get_logs(pk2))
        assert "cache hit" in messages
        assert "submitted as job" not in messages
        assert warm < 30
    finally:
        daemon.stop()


# ===========================================================================
# the port resumes only its own processes; its workers load no JAX
# ===========================================================================

def test_worker_settles_a_reference_checkpoint_as_failed(tmp_path):
    """A task whose checkpoint names a class of the reference package: the
    worker's handler returns (the task is acked, not requeued), counts a
    failed task, and leaves the process as the reference left it."""
    from repro.calcjobs import TPUTrainJob
    from repro.core import Dict as RefDict
    from repro.engine.runner import Runner as RefRunner
    from repro.provenance.store import configure_store as ref_configure

    db = str(tmp_path / "profile.db")
    ref_store = ref_configure(db)
    pk = TPUTrainJob(inputs={"config": RefDict(SMALL)},
                     runner=RefRunner(store=ref_store)).pk
    ref_store.close()
    ref_configure(":memory:")

    from repro_torch.observability.metrics import get_registry

    async def main():
        port_store = configure_store(db)
        handler = make_process_task_handler(Runner(store=port_store),
                                            port_store)
        await handler({"pk": pk})
        return port_store.get_node(pk)

    node = asyncio.run(main())
    assert get_registry().counter("daemon.failed_tasks").value == 1
    assert node["process_state"] not in TERMINAL
    assert node["checkpoint"] is not None


def test_daemon_worker_imports_load_neither_jax_nor_reference():
    """A fresh interpreter imports the daemon, the calcjobs and everything
    a worker imports before its first task: no jax, no repro."""
    code = (
        "import sys\n"
        "import repro_torch.engine.daemon, repro_torch.calcjobs\n"
        "import repro_torch.engine.broker, repro_torch.engine.runner\n"
        "import repro_torch.engine.controller, repro_torch.provenance.store\n"
        "import repro_torch.calcjobs.restart, repro_torch.provenance.fsck\n"
        "import repro_torch.chaos.invariants, repro_torch.core.workchain\n"
        "from repro_torch.calcjobs.gpujob import gpu_train_executable\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"
