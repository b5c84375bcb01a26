"""The port's engine saturation machinery (paper §III.C at scale):
batched control-plane traffic, subject-filter pushdown, multiplexed
process ownership, backpressure + fair dispatch, RPC deadlines, event-log
compaction, and slot-gated process materialization.

Twin of ``tests/test_saturation.py``, run against ``repro_torch``: the
same 11 cases, workloads, bars and timeouts."""

import asyncio
import time

import pytest

from repro_torch.core.process import Process
from repro_torch.engine.broker import (BrokerClient, BrokerServer,
                                       SyncBrokerClient)
from repro_torch.engine.communicator import process_rpc_id, state_subject
from repro_torch.engine.daemon import (PROCESS_QUEUE, Daemon,
                                       make_process_task_handler)
from repro_torch.engine.runner import Runner
from repro_torch.observability import metrics as _metrics
from repro_torch.provenance.store import configure_store


@pytest.fixture(autouse=True)
def _reset_port_state(monkeypatch):
    """The port's global state: caching policy, metrics registry, default
    runner and current store."""
    from repro_torch.caching.config import ENV_VAR, reset_policy
    from repro_torch.engine.runner import set_default_runner

    def reset():
        reset_policy()
        _metrics.reset_registry()
        set_default_runner(None)
        configure_store(":memory:")

    monkeypatch.delenv(ENV_VAR, raising=False)
    reset()
    yield
    reset()


class Spin(Process):
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


async def _server(tmp_path, **kw):
    server = BrokerServer(str(tmp_path / "broker.db"), **kw)
    await server.start()
    return server


async def _client(server):
    client = BrokerClient(server.host, server.port)
    await client.connect()
    return client


async def _settle(predicate, timeout=5.0, interval=0.01):
    t0 = time.monotonic()
    while not predicate():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition never settled")
        await asyncio.sleep(interval)


# ---------------------------------------------------------------------------
# batched submission (task_send_many) + the persistent daemon submitter
# ---------------------------------------------------------------------------

def test_task_send_many_delivers_each_exactly_once(tmp_path):
    async def main():
        server = await _server(tmp_path)
        producer = await _client(server)
        consumer = await _client(server)
        seen = []

        async def handle(payload):
            seen.append(payload["i"])

        consumer.add_task_subscriber("q", handle, prefetch=64)
        producer.task_send_many("q", [{"i": i} for i in range(25)])
        await _settle(lambda: len(seen) == 25)
        await asyncio.sleep(0.1)            # no late duplicates
        assert sorted(seen) == list(range(25))
        assert server.stats["tasks_enqueued"] == 25
        assert server.stats["tasks_delivered"] == 25
        producer.close()
        consumer.close()
        await server.stop()

    run(main())


def test_sync_client_batch_send_is_acked_durably(tmp_path):
    async def main():
        server = await _server(tmp_path)

        def sync_part():
            client = SyncBrokerClient(server.host, server.port)
            try:
                assert client.task_send_many(
                    "q", [{"i": i} for i in range(7)]) == 7
                client.task_send("q", {"i": 99})     # single-send ack path
            finally:
                client.close()

        await asyncio.get_running_loop().run_in_executor(None, sync_part)
        # the ack means the rows were committed before the reply
        rows = server.conn().execute(
            "SELECT COUNT(*) c FROM tasks WHERE queue='q'").fetchone()
        assert rows["c"] == 8
        await server.stop()

    run(main())


def test_daemon_submitter_is_one_persistent_connection(tmp_path):
    daemon = Daemon(str(tmp_path / "d"), workers=0, slots=1)
    daemon.start()
    try:
        store = configure_store(str(tmp_path / "d" / "provenance.db"))
        runner = Runner(store=store)
        pks = [Quick(inputs={}, runner=runner).pk for _ in range(3)]
        daemon.send_task(pks[0])
        first = daemon._submit_client
        assert first is not None
        assert daemon.send_tasks(pks[1:]) == 2
        # same connection reused; every send was acked (durable enqueue)
        assert daemon._submit_client is first
        stats = first.broker_stats()
        assert stats["tasks_enqueued"] == 3
        assert stats["queues"][PROCESS_QUEUE]["ready"] == 3
    finally:
        daemon.stop()


# ---------------------------------------------------------------------------
# subject-filter pushdown + broadcast batching
# ---------------------------------------------------------------------------

def test_subject_filter_pushdown_spares_uninterested_clients(tmp_path):
    async def main():
        server = await _server(tmp_path)
        emitter = await _client(server)
        interested = await _client(server)
        bystander = await _client(server)

        got, stray = [], []
        interested.add_broadcast_subscriber(
            lambda s, _, b: got.append(s), "state_changed.7.*")
        # the bystander never subscribes: with filter pushdown the broker
        # must not send it any broadcast frame at all
        bystander._broadcast_handlers[0] = (None,
                                            lambda s, _, b: stray.append(s))
        await asyncio.sleep(0.05)
        baseline_out = server.stats["messages_out"]

        emitter.broadcast_send(state_subject(7, "finished"), 7, {"pk": 7})
        emitter.broadcast_send(state_subject(8, "finished"), 8, {"pk": 8})
        await _settle(lambda: got == ["state_changed.7.finished"])
        await asyncio.sleep(0.1)
        assert stray == []
        # exactly one frame left the broker: the matching event to the
        # one interested client (nothing to the emitter or bystander)
        assert server.stats["messages_out"] - baseline_out == 1
        for c in (emitter, interested, bystander):
            c.close()
        await server.stop()

    run(main())


def test_broadcast_burst_coalesces_into_batch_frames(tmp_path):
    async def main():
        server = await _server(tmp_path)
        emitter = await _client(server)
        watcher = await _client(server)
        got = []
        watcher.add_broadcast_subscriber(lambda s, _, b: got.append(s),
                                         "state_changed.*")
        await asyncio.sleep(0.05)
        baseline_out = server.stats["messages_out"]
        n = 40
        for pk in range(n):
            emitter.broadcast_send(state_subject(pk, "finished"), pk,
                                   {"pk": pk})
        await _settle(lambda: len(got) == n)
        # a same-tick burst must reach the watcher in far fewer frames
        # than events (coalesced broadcast_batch), not one frame each
        frames = server.stats["messages_out"] - baseline_out
        assert frames < n / 4, f"{frames} frames for {n} events"
        emitter.close()
        watcher.close()
        await server.stop()

    run(main())


# ---------------------------------------------------------------------------
# multiplexed process ownership (O(workers) directory)
# ---------------------------------------------------------------------------

def test_process_control_is_multiplexed_not_per_pk(tmp_path):
    async def main():
        server = await _server(tmp_path)
        worker = await _client(server)
        control = await _client(server)
        store = configure_store(":memory:")
        runner = Runner(store=store, communicator=worker)
        handles = [runner.submit(Spin, {}) for _ in range(5)]
        pks = [h.pk for h in handles]
        await _settle(lambda: len(server._owners) == 5)

        # the broker directory holds NO per-pk rpc identifiers — just the
        # ownership map — yet per-pk lookup and rpc_send still work
        assert not any(i.startswith("process.") for i in server._rpc)
        found = await control.rpc_lookup("process.*")
        assert set(found) == {f"process.{pk}" for pk in pks}
        status = await control.rpc_send_async(process_rpc_id(pks[0]),
                                              {"intent": "status"})
        assert status["state"] == "running"
        assert await control.rpc_send_async(
            process_rpc_id(pks[0]), {"intent": "kill"}) is True
        await asyncio.wait_for(handles[0].process.wait_done(), 10)
        await _settle(lambda: len(server._owners) == 4)
        for h in handles[1:]:
            await control.rpc_send_async(process_rpc_id(h.pk),
                                         {"intent": "kill"})
            await asyncio.wait_for(h.process.wait_done(), 10)
        worker.close()
        control.close()
        await server.stop()

    run(main())


# ---------------------------------------------------------------------------
# backpressure: the prefetch high-water mark parks excess durably
# ---------------------------------------------------------------------------

def test_prefetch_hwm_bounds_inflight_and_parks_the_rest(tmp_path):
    async def main():
        server = await _server(tmp_path)
        producer = await _client(server)
        consumer = await _client(server)
        cur, peak, done, parked = 0, 0, [], []

        async def handle(payload):
            nonlocal cur, peak
            cur += 1
            peak = max(peak, cur)
            # while 2 are in flight, the rest must sit parked as durable
            # ready rows, not in this client's memory
            parked.append(server.conn().execute(
                "SELECT COUNT(*) c FROM tasks WHERE state='ready'"
            ).fetchone()["c"])
            await asyncio.sleep(0.01)
            cur -= 1
            done.append(payload["i"])

        consumer.add_task_subscriber("q", handle, prefetch=2)
        producer.task_send_many("q", [{"i": i} for i in range(20)])
        await _settle(lambda: len(done) == 20)
        await asyncio.sleep(0.05)
        assert sorted(done) == list(range(20))       # exactly once
        assert peak <= 2, f"prefetch=2 but {peak} handlers ran at once"
        assert max(parked) >= 10                     # backlog stayed parked
        producer.close()
        consumer.close()
        await server.stop()

    run(main())


def test_slot_gate_bounds_resident_processes(tmp_path):
    """Tasks delivered beyond the slot count wait as pk-only payloads:
    Process objects are only materialized once a slot frees (bounds
    worker RSS at saturation)."""
    async def main():
        _metrics.reset_registry()
        store = configure_store(":memory:")
        runner = Runner(store=store, slots=2)
        pks = [Quick(inputs={}, runner=runner).pk for _ in range(6)]
        owned = set()
        handler = make_process_task_handler(runner, store, owned)
        gauge = _metrics.get_registry().gauge("daemon.resident_processes")
        peak = 0

        async def watch():
            nonlocal peak
            while True:
                peak = max(peak, gauge.value)
                await asyncio.sleep(0.002)

        watcher = asyncio.ensure_future(watch())
        await asyncio.gather(*[handler({"pk": pk}) for pk in pks])
        watcher.cancel()
        assert peak == 2, f"slots=2 but {peak} processes were resident"
        for pk in pks:
            assert store.get_node(pk)["process_state"] == "finished"

    run(main())


# ---------------------------------------------------------------------------
# fairness: a bulk submitter cannot starve a trickle submitter
# ---------------------------------------------------------------------------

def test_trickle_submitter_not_starved_by_bulk_backlog(tmp_path):
    async def main():
        server = await _server(tmp_path)
        producer = await _client(server)
        consumer = await _client(server)
        order = []

        async def handle(payload):
            await asyncio.sleep(0.005)
            order.append(payload["who"])

        consumer.add_task_subscriber("q", handle, prefetch=1)
        producer.task_send_many("q", [{"who": "bulk", "i": i}
                                      for i in range(40)],
                                submitter="bulk")
        await asyncio.sleep(0.02)            # bulk backlog is queued first
        producer.task_send_many("q", [{"who": "trickle", "i": i}
                                      for i in range(4)],
                                submitter="trickle")
        await _settle(lambda: len(order) == 44, timeout=20)
        # round-robin across submitters: the trickle tasks complete long
        # before the bulk backlog drains instead of queueing behind it
        last_trickle = max(i for i, who in enumerate(order)
                           if who == "trickle")
        assert last_trickle < 24, (
            f"trickle task finished at position {last_trickle}/44")
        assert order.count("trickle") == 4 and order.count("bulk") == 40
        producer.close()
        consumer.close()
        await server.stop()

    run(main())


# ---------------------------------------------------------------------------
# RPC deadlines: a hung handler cannot wedge the caller (or the worker)
# ---------------------------------------------------------------------------

def test_rpc_deadline_cancels_hung_handler(tmp_path):
    async def main():
        server = await _server(tmp_path)
        worker = await _client(server)
        control = await _client(server)
        cancelled = asyncio.Event()

        async def hung(msg):
            try:
                await asyncio.sleep(3600)
            except asyncio.CancelledError:
                cancelled.set()
                raise

        worker.add_rpc_subscriber("svc.hung", hung)
        worker.add_rpc_subscriber("svc.ok", lambda msg: "fine")
        await asyncio.sleep(0.05)

        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            await control.rpc_send_async("svc.hung", {}, timeout=0.3)
        assert time.monotonic() - t0 < 5.0
        assert server.stats["rpc_cancelled"] == 1
        # the broker told the worker to abandon the handler task
        await asyncio.wait_for(cancelled.wait(), 5)
        # neither side is wedged: the same client/worker pair still works
        assert await control.rpc_send_async("svc.ok", {}) == "fine"
        worker.close()
        control.close()
        await server.stop()

    run(main())


# ---------------------------------------------------------------------------
# event-log compaction: terminal notifications survive the cap
# ---------------------------------------------------------------------------

def test_compaction_drops_superseded_not_terminal_events(tmp_path):
    async def main():
        server = await _server(tmp_path, event_log_cap=20)
        emitter = await _client(server)
        for pk in range(15):
            for state in ("created", "running", "finished"):
                emitter.broadcast_send(state_subject(pk, state), pk,
                                       {"pk": pk, "state": state})
        await _settle(lambda: server.stats["events_logged"] == 45)
        await asyncio.sleep(0.05)
        subjects = [r["subject"] for r in server.conn().execute(
            "SELECT subject FROM events ORDER BY seq")]
        assert len(subjects) <= 20 + 5   # cap, modulo the check interval
        # every terminal notification survived; the chatter it supersedes
        # was evicted first
        for pk in range(15):
            assert state_subject(pk, "finished") in subjects
        assert server.stats["events_compacted"] > 0
        assert sum(1 for s in subjects if s.endswith(".running")) < 15

        # a late watcher still learns every terminal outcome by replay
        def sync_part():
            client = SyncBrokerClient(server.host, server.port)
            try:
                return [b["pk"] for _, _, b in client.events(
                    subject_filter="state_changed.*.finished",
                    timeout=1.0, replay_since=0)]
            finally:
                client.close()

        replayed = await asyncio.get_running_loop().run_in_executor(
            None, sync_part)
        assert sorted(replayed) == list(range(15))
        emitter.close()
        await server.stop()

    run(main())
