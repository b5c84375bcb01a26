"""Durable cross-process message broker (the RabbitMQ role, paper §III.C).

A small asyncio TCP server backed by sqlite gives the three messaging
patterns with RabbitMQ-faithful guarantees:

* **task queues** — persistent messages (survive broker restarts), explicit
  acks, per-consumer heartbeats: a consumer that misses ``2 × heartbeat``
  is presumed dead and its un-acked tasks are requeued (paper: "upon
  missing two consecutive responses, RabbitMQ assumes the worker to be
  dead and triggers the rescheduling mechanism"). Consumers declare a
  **prefetch** (ready-queue high-water mark): excess tasks park in the
  durable queue, and delivery round-robins across distinct submitter ids
  so a bulk submitter cannot starve a trickle one.
* **RPC** — request/response routed by subscriber identifier, forwarded
  across OS processes. Process control is *multiplexed*: a worker claims
  the pks it runs with one ``own`` message instead of registering one
  identifier per process, so the broker directory stays O(workers) while
  ``rpc_send("process.<pk>")`` / ``rpc_lookup`` keep working unchanged.
  ``rpc_send`` takes an optional deadline the broker enforces with a
  ``cancelled`` reply plus a cancel notice to the (possibly hung) target.
* **broadcast** — subject-filtered fan-out: clients push their fnmatch
  patterns down with ``subscribe``/``unsubscribe`` and only matching
  events are sent (bursts are coalesced into one framed multi-event
  message). Every event is also appended to a sqlite log with a monotonic
  sequence number for replay (``events_since``); when the log exceeds its
  cap, compaction drops *superseded* state-change events of terminal
  processes first, so a terminal notification is never evicted while
  older chatter survives.

Protocol: newline-delimited JSON over TCP (loopback). This is deliberately
boring; the durability lives in sqlite (WAL), the liveness in heartbeats.
Submission paths batch: ``task_send_many`` enqueues many payloads in one
frame + one commit, and clients coalesce many frames per syscall.
"""

from __future__ import annotations

import asyncio
import fnmatch
import itertools
import json
import logging
import os
import re
import socket
import sqlite3
import time
import uuid
from typing import Any, Awaitable, Callable, Iterator

from repro_torch.chaos import faults as chaos
from repro_torch.core.statemachine import TERMINAL_STATES
from repro_torch.observability import metrics as _metrics
from repro_torch.observability import trace

logger = logging.getLogger("repro_torch.engine.broker")

_TASKS_SCHEMA = """
CREATE TABLE IF NOT EXISTS tasks (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    queue TEXT NOT NULL,
    payload TEXT NOT NULL,
    state TEXT NOT NULL DEFAULT 'ready',   -- ready | inflight
    consumer TEXT,
    delivered_at REAL,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_tasks_queue ON tasks(queue, state);
CREATE TABLE IF NOT EXISTS events (
    seq INTEGER PRIMARY KEY AUTOINCREMENT,
    subject TEXT NOT NULL,
    sender TEXT,
    body TEXT NOT NULL,
    ts REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS leases (
    pk INTEGER PRIMARY KEY,
    worker TEXT,                           -- NULL = expired, awaiting regrant
    epoch INTEGER NOT NULL DEFAULT 1,
    renewed_at REAL NOT NULL
);
"""

#: keep at most this many events in the durable broadcast log
EVENT_LOG_CAP = 10000
#: drop records the broker keeps for ``broker_stats``
DROPPED_KEPT = 64

_TERMINAL = tuple(s.value for s in TERMINAL_STATES)
_PROCESS_ID = re.compile(r"^process\.(\d+)$")
_STATE_SUBJECT = re.compile(r"^state_changed\.(\d+)\.([a-z_]+)$")


def _encode(msg: dict) -> bytes:
    return json.dumps(msg).encode() + b"\n"


class BrokerServer:
    """The broker daemon. One per deployment (like one RabbitMQ service)."""

    def __init__(self, db_path: str, host: str = "127.0.0.1", port: int = 0,
                 heartbeat: float = 5.0, event_log_cap: int = EVENT_LOG_CAP):
        self.db_path = db_path
        self.host = host
        self.port = port
        self.heartbeat = heartbeat
        self.event_log_cap = event_log_cap
        self._server: asyncio.AbstractServer | None = None
        self._clients: dict[str, asyncio.StreamWriter] = {}
        self._consumers: dict[str, set[str]] = {}      # queue -> client ids
        self._rpc: dict[str, str] = {}                 # identifier -> client id
        self._owners: dict[int, str] = {}              # pk -> owning client id
        self._names: dict[str, str] = {}               # client id -> worker name
        # pk -> [worker name | None, epoch]; mirrors the durable `leases`
        # table. Lease identity is the stable worker *name* (not the
        # per-connection client id), so a reconnect does not look like a
        # new owner — the epoch only bumps when a pk is granted to a
        # *different* worker (the fencing event).
        self._leases: dict[int, list] = {}
        self._subs: dict[str, set[str]] = {}           # client id -> patterns
        self._prefetch: dict[str, int] = {}            # client id -> HWM
        self._last_beat: dict[str, float] = {}
        self._pending_rpc: dict[str, tuple[str, Any]] = {}
        self._rpc_timers: dict[str, asyncio.TimerHandle] = {}
        self._bc_outbox: list[dict] = []
        self._bc_scheduled = False
        self._deliver_pending: set[str] = set()
        self._deliver_scheduled = False
        self._rr: dict[str, int] = {}                  # queue -> fair cursor
        self._events_uncommitted = 0
        self._dirty = 0
        self._conn = None
        self._reaper_task: asyncio.Task | None = None
        #: the clients dropped last (newest last), served by
        #: ``broker_stats`` as ``dropped``: each one's worker name (None
        #: for a client that never said hello, such as a sync client),
        #: why it was dropped and whether it consumed a task queue
        self.dropped: list[dict] = []
        #: control-plane traffic accounting, served by ``broker_stats``
        self.stats = {
            "messages_in": 0, "messages_out": 0, "tasks_enqueued": 0,
            "tasks_delivered": 0, "events_logged": 0, "events_compacted": 0,
            "rpc_cancelled": 0, "heartbeats": 0, "clients_dropped": 0,
            # fenced-ownership accounting: expired leases (epoch fence
            # armed) and refused stale re-claims from woken zombies
            "leases_granted": 0, "leases_expired": 0, "stale_claims": 0,
            # chaos-injected frame mutations (duplicate delivery /
            # dropped broadcasts) — the harness asserts these actually
            # fired instead of trusting the scenario spec
            "chaos_duplicated": 0, "chaos_dropped": 0,
        }

    # -- storage ------------------------------------------------------------
    def conn(self) -> sqlite3.Connection:
        if self._conn is None:
            os.makedirs(os.path.dirname(os.path.abspath(self.db_path)),
                        exist_ok=True)
            self._conn = sqlite3.connect(self.db_path)
            self._conn.row_factory = sqlite3.Row
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.executescript(_TASKS_SCHEMA)
            cols = [r[1] for r in self._conn.execute(
                "PRAGMA table_info(tasks)")]
            if "submitter" not in cols:
                self._conn.execute("ALTER TABLE tasks ADD COLUMN submitter "
                                   "TEXT NOT NULL DEFAULT ''")
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_tasks_fair ON "
                "tasks(queue, state, submitter)")
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_events_ts ON events(ts)")
            self._conn.commit()
        return self._conn

    def _maybe_commit(self, n: int = 1) -> None:
        """Batch task-table commits: at-least-once delivery means losing an
        uncommitted state flip only causes a redelivery, never a loss."""
        self._dirty += n
        if self._dirty >= 200:
            chaos.fault_point("broker.commit.pre")
            self.conn().commit()
            self._dirty = 0

    def _commit_now(self) -> None:
        if self._dirty or self._events_uncommitted:
            chaos.fault_point("broker.commit.pre")
            self.conn().commit()
            self._dirty = 0
            self._events_uncommitted = 0

    # -- lifecycle -----------------------------------------------------------
    def _recover(self) -> None:
        """Rebuild in-memory state from sqlite after a (re)start. Tasks a
        dead broker had marked inflight are requeued — their consumers'
        connections died with the old process, so at-least-once semantics
        demand redelivery. Leases survive verbatim (same worker name ⇒ no
        epoch bump when its task is redelivered to it) with a fresh
        renewal stamp so the reaper gives reconnecting workers a full
        grace window before expiring anything."""
        conn = self.conn()
        requeued = conn.execute(
            "UPDATE tasks SET state='ready', consumer=NULL"
            " WHERE state='inflight'").rowcount
        now = time.time()
        conn.execute("UPDATE leases SET renewed_at=?", (now,))
        conn.commit()
        self._leases = {
            row["pk"]: [row["worker"], row["epoch"]]
            for row in conn.execute("SELECT pk, worker, epoch FROM leases")}
        if requeued or self._leases:
            logger.info("broker recovery: requeued %d inflight task(s), "
                        "%d lease(s) loaded", requeued, len(self._leases))

    async def start(self) -> tuple[str, int]:
        self._recover()
        self._server = await asyncio.start_server(self._on_client, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._reaper_task = asyncio.ensure_future(self._reaper())
        logger.info("broker listening on %s:%d", self.host, self.port)
        return self.host, self.port

    async def stop(self) -> None:
        if self._reaper_task is not None:
            self._reaper_task.cancel()
            self._reaper_task = None
        for timer in self._rpc_timers.values():
            timer.cancel()
        self._rpc_timers.clear()
        # closing the writers EOFs each _on_client loop so the per-client
        # handler tasks finish instead of lingering past the server
        for writer in list(self._clients.values()):
            writer.close()
        self._clients.clear()
        self._last_beat.clear()
        if self._conn is not None:
            self._commit_now()
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        await asyncio.sleep(0)  # let client tasks observe the EOF
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    # -- client handling ---------------------------------------------------------
    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        cid = str(uuid.uuid4())
        self._clients[cid] = writer
        self._last_beat[cid] = time.monotonic()
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                await self._handle(cid, msg)
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            self._drop_client(cid)
            # close this end too: a connection the peer ended stays open
            # here (asyncio keeps a half-closed stream), and ``stop()``'s
            # ``wait_closed()`` waits for every connection (Python 3.12.1+)
            writer.close()

    def _drop_client(self, cid: str, reason: str = "disconnected") -> None:
        """Full disconnect cleanup, run the moment a client's connection
        dies (EOF/reset — a SIGKILLed worker's sockets close immediately)
        or its heartbeats lapse. Auto-disowns every pk the client claimed
        and fails every RPC routed to or awaited by it, so
        ``rpc_lookup``/``rpc_send`` never route to a dead worker in the
        window between its crash and the tasks' redelivery. Idempotent —
        the reaper and the connection handler can both call it."""
        had_conn = self._clients.pop(cid, None) is not None
        had_beat = self._last_beat.pop(cid, None) is not None
        if had_conn or had_beat:
            self.stats["clients_dropped"] += 1
            self.dropped.append({
                "client": cid[:8], "worker": self._names.get(cid),
                "reason": reason,
                "consumer": any(cid in members
                                for members in self._consumers.values())})
            del self.dropped[:-DROPPED_KEPT]
        self._subs.pop(cid, None)
        self._prefetch.pop(cid, None)
        for consumers in self._consumers.values():
            consumers.discard(cid)
        for ident in [k for k, v in self._rpc.items() if v == cid]:
            del self._rpc[ident]
        # auto-disown: a dead worker's pks leave the directory at once,
        # so `process.<pk>` stops resolving until a new worker owns it
        for pk in [p for p, v in self._owners.items() if v == cid]:
            del self._owners[pk]
        # expire the dead worker's leases (unless the same worker *name*
        # is still connected under another client id — a reconnect is not
        # a death). The epoch is NOT bumped here: the fence arms only
        # when the pk is re-granted to a different worker, so a worker
        # that merely reconnects keeps writing under its old epoch.
        name = self._names.pop(cid, None)
        if name is not None and name not in self._names.values():
            for pk, lease in self._leases.items():
                if lease[0] == name:
                    chaos.fault_point("lease.expire", pk=pk)
                    lease[0] = None
                    self.conn().execute(
                        "UPDATE leases SET worker=NULL, renewed_at=?"
                        " WHERE pk=?", (time.time(), pk))
                    self.stats["leases_expired"] += 1
        # fail RPCs whose target just died — callers must not hang forever
        for rid in [r for r, (_, target) in self._pending_rpc.items()
                    if target == cid]:
            origin, _ = self._pending_rpc.pop(rid)
            timer = self._rpc_timers.pop(rid, None)
            if timer is not None:
                timer.cancel()
            self._send(origin, {"kind": "rpc_reply", "rid": rid,
                                "error": "rpc target disconnected"})
        # ...and discard replies queued FOR the dead client: nobody is
        # listening, and a lingering timer would fire into the void
        for rid in [r for r, (origin, _) in self._pending_rpc.items()
                    if origin == cid]:
            self._pending_rpc.pop(rid)
            timer = self._rpc_timers.pop(rid, None)
            if timer is not None:
                timer.cancel()
        # requeue this consumer's inflight tasks immediately...
        self.conn().execute(
            "UPDATE tasks SET state='ready', consumer=NULL WHERE "
            "state='inflight' AND consumer=?", (cid,))
        self._commit_now()
        # ...and push them to surviving/new consumers right away
        for queue in list(self._consumers):
            self._deliver(queue)

    def _send(self, cid: str, msg: dict) -> None:
        writer = self._clients.get(cid)
        if writer is None:
            return
        if writer.is_closing():
            self._drop_client(cid)
            return
        try:
            writer.write(_encode(msg))
            self.stats["messages_out"] += 1
        except Exception:  # noqa: BLE001
            self._drop_client(cid)

    # -- message dispatch ------------------------------------------------------------
    async def _handle(self, cid: str, msg: dict) -> None:
        kind = msg.get("kind")
        self.stats["messages_in"] += 1
        if kind == "heartbeat":
            self.stats["heartbeats"] += 1
            self._last_beat[cid] = time.monotonic()
        elif kind == "task_send":
            self._enqueue_tasks(msg["queue"], [msg["payload"]],
                                msg.get("submitter"))
            if msg.get("rid"):
                # submitter asked for a delivery ack: make the row durable
                # before confirming (replaces the old fire-and-sleep path)
                self._commit_now()
                self._send(cid, {"kind": "rpc_reply", "rid": msg["rid"],
                                 "result": 1})
            self._schedule_deliver(msg["queue"])
        elif kind == "task_send_many":
            payloads = msg.get("payloads", [])
            self._enqueue_tasks(msg["queue"], payloads, msg.get("submitter"))
            if msg.get("rid"):
                self._commit_now()
                self._send(cid, {"kind": "rpc_reply", "rid": msg["rid"],
                                 "result": len(payloads)})
            self._schedule_deliver(msg["queue"])
        elif kind == "consume":
            self._consumers.setdefault(msg["queue"], set()).add(cid)
            self._prefetch[cid] = max(1, int(msg.get("prefetch", 1)))
            self._deliver(msg["queue"])
        elif kind == "ack":
            # consumer guard: only the client a task is inflight to may
            # settle it — a woken zombie's stale ack must not delete a
            # row that was requeued (and possibly redelivered) while it
            # was unresponsive
            self.conn().execute(
                "DELETE FROM tasks WHERE id=? AND state='inflight'"
                " AND consumer=?", (msg["task_id"], cid))
            self._maybe_commit()
            # deliver further work to this consumer
            for queue, members in self._consumers.items():
                if cid in members:
                    self._schedule_deliver(queue)
        elif kind == "nack":
            self.conn().execute(
                "UPDATE tasks SET state='ready', consumer=NULL WHERE id=?"
                " AND state='inflight' AND consumer=?",
                (msg["task_id"], cid))
            self._maybe_commit()
            self._schedule_deliver(msg["queue"])
        elif kind == "rpc_register":
            self._rpc[msg["identifier"]] = cid
        elif kind == "rpc_unregister":
            if self._rpc.get(msg["identifier"]) == cid:
                del self._rpc[msg["identifier"]]
        elif kind == "hello":
            # a worker announces its stable name; lease identity hangs
            # off this, not the per-connection client id
            self._names[cid] = str(msg.get("worker", cid))
        elif kind == "own":
            # multiplexed process control: one frame claims many pks; the
            # directory stays O(workers) instead of O(live processes).
            # Claims carry the epoch the worker believes it holds — a
            # claim older than the lease table's epoch is a zombie
            # re-asserting ownership it already lost, and is refused.
            epochs = msg.get("epochs") or {}
            refused: list[int] = []
            for pk in msg.get("pks", []):
                pk = int(pk)
                lease = self._leases.get(pk)
                claimed = epochs.get(str(pk))
                if (lease is not None and claimed is not None
                        and int(claimed) < lease[1]):
                    self.stats["stale_claims"] += 1
                    refused.append(pk)
                    continue
                self._owners[pk] = cid
                if lease is not None and lease[0] is None:
                    # expired lease re-claimed by its last valid holder
                    # (same epoch): restore without bumping the fence
                    name = self._names.get(cid)
                    if name is not None:
                        lease[0] = name
                        self.conn().execute(
                            "UPDATE leases SET worker=?, renewed_at=?"
                            " WHERE pk=?", (name, time.time(), pk))
                        self._maybe_commit()
            if refused:
                logger.warning("refused stale ownership claim for pks %s",
                               refused)
                self._send(cid, {"kind": "own_refused", "pks": refused})
        elif kind == "disown":
            for pk in msg.get("pks", []):
                pk = int(pk)
                if self._owners.get(pk) == cid:
                    del self._owners[pk]
                # the process reached a terminal state under this worker:
                # its lease is spent — drop the row so the table tracks
                # only live ownership
                lease = self._leases.get(pk)
                if lease is not None and lease[0] == self._names.get(cid):
                    del self._leases[pk]
                    self.conn().execute("DELETE FROM leases WHERE pk=?",
                                        (pk,))
                    self._maybe_commit()
        elif kind == "subscribe":
            self._subs.setdefault(cid, set()).update(
                msg.get("patterns", []))
        elif kind == "unsubscribe":
            patterns = msg.get("patterns")
            if patterns is None:
                self._subs.pop(cid, None)
            else:
                subs = self._subs.get(cid)
                if subs is not None:
                    subs.difference_update(patterns)
                    if not subs:
                        self._subs.pop(cid, None)
        elif kind == "sub_sync":
            # barrier: replying proves every earlier frame on this
            # connection (e.g. a subscribe) has been processed
            self._send(cid, {"kind": "rpc_reply", "rid": msg["rid"],
                             "result": True})
        elif kind == "rpc_lookup":
            # the live-identifier directory: how clients discover which
            # processes/workers are reachable right now. Owned pks are
            # synthesized back into per-pk identifiers for compatibility.
            pattern = msg.get("pattern", "*")
            idents = set(self._rpc)
            idents.update(f"process.{pk}" for pk in self._owners)
            self._send(cid, {"kind": "rpc_reply", "rid": msg["rid"],
                             "result": sorted(
                                 i for i in idents
                                 if fnmatch.fnmatch(i, pattern))})
        elif kind == "rpc_send":
            target = self._rpc.get(msg["identifier"])
            if target is None:
                m = _PROCESS_ID.match(msg["identifier"])
                if m is not None:
                    target = self._owners.get(int(m.group(1)))
            if target is None:
                self._send(cid, {"kind": "rpc_reply", "rid": msg["rid"],
                                 "error": f"no subscriber "
                                          f"{msg['identifier']!r}"})
            else:
                rid = msg["rid"]
                self._pending_rpc[rid] = (cid, target)
                timeout = msg.get("timeout")
                if timeout is not None:
                    self._rpc_timers[rid] = (
                        asyncio.get_running_loop().call_later(
                            float(timeout), self._cancel_rpc, rid))
                self._send(target, {"kind": "rpc_request", "rid": rid,
                                    "identifier": msg["identifier"],
                                    "msg": msg["msg"]})
        elif kind == "rpc_reply":
            timer = self._rpc_timers.pop(msg["rid"], None)
            if timer is not None:
                timer.cancel()
            origin = self._pending_rpc.pop(msg["rid"], None)
            if origin is not None:
                self._send(origin[0], msg)
        elif kind == "broadcast":
            seq = self._log_event(msg)
            self._bc_outbox.append({"seq": seq, "subject": msg["subject"],
                                    "sender": msg.get("sender"),
                                    "body": msg.get("body", {})})
            if not self._bc_scheduled:
                self._bc_scheduled = True
                asyncio.get_running_loop().call_soon(self._flush_broadcasts)
        elif kind == "broker_stats":
            queues: dict[str, dict] = {}
            for row in self.conn().execute(
                    "SELECT queue, state, COUNT(*) c FROM tasks"
                    " GROUP BY queue, state"):
                queues.setdefault(row["queue"], {})[row["state"]] = row["c"]
            n_events = self.conn().execute(
                "SELECT COUNT(*) c FROM events").fetchone()["c"]
            self._send(cid, {"kind": "rpc_reply", "rid": msg["rid"],
                             "result": {**self.stats,
                                        "clients": len(self._clients),
                                        "owned_pks": len(self._owners),
                                        "rpc_identifiers": len(self._rpc),
                                        "leases": len(self._leases),
                                        "event_log_size": n_events,
                                        "queues": queues,
                                        "dropped": list(self.dropped)}})
        elif kind == "events_since":
            # durable replay: stream the logged events this client missed
            pattern = msg.get("pattern")
            rows = self.conn().execute(
                "SELECT seq, subject, sender, body FROM events WHERE seq>?"
                " ORDER BY seq", (msg.get("seq", 0),)).fetchall()
            last = msg.get("seq", 0)
            for row in rows:
                last = row["seq"]
                if pattern and not fnmatch.fnmatch(row["subject"], pattern):
                    continue
                self._send(cid, {"kind": "broadcast", "seq": row["seq"],
                                 "subject": row["subject"],
                                 "sender": json.loads(row["sender"] or "null"),
                                 "body": json.loads(row["body"]),
                                 "replay": True})
            self._send(cid, {"kind": "events_caught_up", "seq": last})

    def _cancel_rpc(self, rid: str) -> None:
        """Deadline enforcement: tell the caller the RPC is cancelled and
        the (possibly hung) target to abandon the handler."""
        self._rpc_timers.pop(rid, None)
        entry = self._pending_rpc.pop(rid, None)
        if entry is None:
            return
        origin, target = entry
        self.stats["rpc_cancelled"] += 1
        self._send(origin, {"kind": "rpc_reply", "rid": rid,
                            "cancelled": True,
                            "error": "cancelled: rpc deadline exceeded"})
        self._send(target, {"kind": "rpc_cancel", "rid": rid})

    # -- task ingest -------------------------------------------------------------
    def _enqueue_tasks(self, queue: str, payloads: list,
                       submitter: str | None) -> None:
        now = time.time()
        rows = []
        for payload in payloads:
            sub = submitter
            if sub is None and isinstance(payload, dict):
                sub = payload.get("submitter")
            rows.append((queue, json.dumps(payload), sub or "", now))
        self.conn().executemany(
            "INSERT INTO tasks (queue, payload, submitter, created_at)"
            " VALUES (?,?,?,?)", rows)
        self.stats["tasks_enqueued"] += len(rows)
        self._maybe_commit(len(rows))

    # -- broadcast fan-out -------------------------------------------------------
    def _flush_broadcasts(self) -> None:
        """Coalesced, subject-filtered fan-out: a burst of broadcasts that
        arrived in one scheduling tick goes to each interested client as a
        single ``broadcast_batch`` frame; clients without a matching
        subscription get nothing at all."""
        self._bc_scheduled = False
        events, self._bc_outbox = self._bc_outbox, []
        if not events:
            return
        for cid, patterns in list(self._subs.items()):
            if cid not in self._clients:
                continue
            matched = [ev for ev in events
                       if any(fnmatch.fnmatch(ev["subject"], p)
                              for p in patterns)]
            if not matched:
                continue
            # chaos: a partition between broker and this client — the
            # frames vanish, the durable event log keeps them for replay,
            # and waiters must fall back to their liveness re-check
            if chaos.fault_point("broker.broadcast.pre") == "drop":
                self.stats["chaos_dropped"] += len(matched)
                continue
            if len(matched) == 1:
                self._send(cid, {"kind": "broadcast", **matched[0]})
            else:
                self._send(cid, {"kind": "broadcast_batch",
                                 "events": matched})

    def _log_event(self, msg: dict) -> int:
        """Append a broadcast to the durable event log; returns its seq.
        Commits are batched (every 50 events + the reaper tick): replay
        reads go through the same connection and therefore see uncommitted
        rows, so fan-out latency never waits on fsync."""
        conn = self.conn()
        cur = conn.execute(
            "INSERT INTO events (subject, sender, body, ts) VALUES (?,?,?,?)",
            (msg["subject"], json.dumps(msg.get("sender")),
             json.dumps(msg.get("body", {})), time.time()))
        seq = cur.lastrowid
        self.stats["events_logged"] += 1
        every = max(1, min(1000, self.event_log_cap // 4))
        if seq % every == 0:
            self._compact_events()
        self._events_uncommitted += 1
        if self._events_uncommitted >= 50:
            conn.commit()
            self._events_uncommitted = 0
        return seq

    def _compact_events(self) -> None:
        """Shrink the event log to its cap, *least-valuable first*:

        1. superseded ``state_changed`` events of pks that already have a
           later terminal event (a replaying waiter only needs the
           terminal one),
        2. oldest remaining non-terminal events,
        3. only then — still over cap — oldest terminal notifications.
        """
        conn = self.conn()
        excess = (conn.execute("SELECT COUNT(*) c FROM events").fetchone()
                  ["c"]) - self.event_log_cap
        if excess <= 0:
            return
        rows = conn.execute(
            "SELECT seq, subject FROM events ORDER BY seq").fetchall()
        latest: dict[int, tuple[int, str]] = {}
        for row in rows:
            m = _STATE_SUBJECT.match(row["subject"])
            if m is not None:
                latest[int(m.group(1))] = (row["seq"], m.group(2))
        terminal_seqs = {seq for seq, state in latest.values()
                         if state in _TERMINAL}
        doomed: list[int] = []
        superseded_of_terminal = []
        other_non_terminal = []
        for row in rows:
            m = _STATE_SUBJECT.match(row["subject"])
            if row["seq"] in terminal_seqs:
                continue
            pk = int(m.group(1)) if m is not None else None
            if pk is not None and latest[pk][0] in terminal_seqs:
                superseded_of_terminal.append(row["seq"])
            else:
                other_non_terminal.append(row["seq"])
        for pool in (superseded_of_terminal, other_non_terminal,
                     sorted(terminal_seqs)):
            for seq in pool:
                if len(doomed) >= excess:
                    break
                doomed.append(seq)
            if len(doomed) >= excess:
                break
        conn.executemany("DELETE FROM events WHERE seq=?",
                         [(s,) for s in doomed])
        self.stats["events_compacted"] += len(doomed)

    # -- delivery ---------------------------------------------------------------------
    def _schedule_deliver(self, queue: str) -> None:
        """Debounce: a burst of sends/acks in one tick triggers a single
        delivery round per queue instead of one O(capacity) pass each."""
        self._deliver_pending.add(queue)
        if self._deliver_scheduled:
            return
        self._deliver_scheduled = True
        try:
            asyncio.get_running_loop().call_soon(self._flush_deliveries)
        except RuntimeError:
            self._deliver_scheduled = False
            self._flush_deliveries()

    def _flush_deliveries(self) -> None:
        self._deliver_scheduled = False
        pending, self._deliver_pending = self._deliver_pending, set()
        for queue in pending:
            self._deliver(queue)

    def _ready_rows(self, queue: str, limit: int) -> list:
        """Up to ``limit`` ready rows, FIFO — but interleaved round-robin
        across distinct submitter ids so one bulk submitter's backlog
        cannot starve a trickle submitter (fair scheduling)."""
        conn = self.conn()
        subs = [r["s"] for r in conn.execute(
            "SELECT DISTINCT submitter s FROM tasks"
            " WHERE queue=? AND state='ready'", (queue,))]
        if len(subs) <= 1:
            return conn.execute(
                "SELECT id, payload FROM tasks WHERE queue=? AND"
                " state='ready' ORDER BY id LIMIT ?",
                (queue, limit)).fetchall()
        cursor = self._rr.get(queue, 0) % len(subs)
        self._rr[queue] = cursor + 1
        subs = subs[cursor:] + subs[:cursor]
        per_sub = [conn.execute(
            "SELECT id, payload FROM tasks WHERE queue=? AND state='ready'"
            " AND submitter=? ORDER BY id LIMIT ?",
            (queue, s, limit)).fetchall() for s in subs]
        out: list = []
        for batch in itertools.zip_longest(*per_sub):
            for row in batch:
                if row is not None:
                    out.append(row)
                    if len(out) >= limit:
                        return out
        return out

    def _grant_lease(self, pk: int, cid: str) -> int:
        """Grant (or renew) the durable ``(pk, worker, epoch)`` lease at
        delivery time; returns the epoch the delivery is fenced under.
        The epoch bumps exactly when the pk moves to a *different* worker
        than the lease's holder — that bump is what lets the store refuse
        a write from the previous holder should it turn out to be a
        still-running zombie rather than a corpse."""
        name = self._names.get(cid, cid)
        lease = self._leases.get(pk)
        if lease is None:
            lease = self._leases[pk] = [name, 1]
        elif lease[0] != name:
            lease[0] = name
            lease[1] += 1
        else:
            return lease[1]
        self.conn().execute(
            "INSERT INTO leases (pk, worker, epoch, renewed_at)"
            " VALUES (?,?,?,?) ON CONFLICT(pk) DO UPDATE SET"
            " worker=excluded.worker, epoch=excluded.epoch,"
            " renewed_at=excluded.renewed_at",
            (pk, name, lease[1], time.time()))
        self.stats["leases_granted"] += 1
        self._maybe_commit()
        return lease[1]

    def _deliver(self, queue: str) -> None:
        consumers = sorted(c for c in self._consumers.get(queue, set())
                           if c in self._clients)
        if not consumers:
            return
        conn = self.conn()
        inflight = {
            r["consumer"]: r["c"] for r in conn.execute(
                "SELECT consumer, COUNT(*) c FROM tasks WHERE queue=? AND"
                " state='inflight' GROUP BY consumer", (queue,))}
        # per-consumer capacity = declared prefetch (the ready-queue
        # high-water mark) minus what it already holds; anything beyond
        # total capacity stays parked in the durable queue (backpressure)
        capacity = {c: max(0, self._prefetch.get(c, 1) - inflight.get(c, 0))
                    for c in consumers}
        total = sum(capacity.values())
        if total <= 0:
            return
        rows = self._ready_rows(queue, total)
        if not rows:
            return
        ring = itertools.cycle(consumers)
        delivered = 0
        now = time.time()
        for row in rows:
            target = None
            for _ in range(len(consumers)):
                cand = next(ring)
                if capacity.get(cand, 0) > 0:
                    target = cand
                    break
            if target is None:
                break
            capacity[target] -= 1
            conn.execute(
                "UPDATE tasks SET state='inflight', consumer=?, delivered_at=?"
                " WHERE id=?", (target, now, row["id"]))
            payload = json.loads(row["payload"])
            if isinstance(payload, dict) and "pk" in payload:
                # fenced ownership: the frame carries the lease epoch the
                # target may write the store under
                payload["epoch"] = self._grant_lease(int(payload["pk"]),
                                                     target)
            frame = {"kind": "task", "queue": queue, "task_id": row["id"],
                     "payload": payload}
            self._send(target, frame)
            # chaos: an at-least-once transport may hand the same frame
            # over twice — consumers must dedup on task_id
            if chaos.fault_point("broker.deliver.pre",
                                 queue=queue) == "duplicate":
                self._send(target, frame)
                self.stats["chaos_duplicated"] += 1
            delivered += 1
        self.stats["tasks_delivered"] += delivered
        self._maybe_commit(delivered)

    # -- liveness ----------------------------------------------------------------------
    async def _reaper(self) -> None:
        """Requeue tasks of consumers that missed two heartbeats, and keep
        the lease table honest: renew leases whose holder is still
        beating, expire leases whose holder has vanished (e.g. it was
        connected to a previous broker incarnation and never came back)."""
        while True:
            await asyncio.sleep(self.heartbeat)
            self._commit_now()
            deadline = time.monotonic() - 2 * self.heartbeat
            dead = [cid for cid, beat in self._last_beat.items()
                    if beat < deadline]
            for cid in dead:
                logger.warning("consumer %s (%s) missed heartbeats; "
                               "requeueing", cid[:8],
                               self._names.get(cid, "no worker name"))
                writer = self._clients.get(cid)
                if writer is not None:
                    writer.close()
                self._drop_client(cid, reason="missed heartbeats")
            if dead:
                for queue in list(self._consumers):
                    self._deliver(queue)
            self._sweep_leases()

    def _sweep_leases(self) -> None:
        live_names = set(self._names.values())
        now = time.time()
        renew: list[int] = []
        for pk, lease in self._leases.items():
            if lease[0] is None:
                continue
            if lease[0] in live_names:
                renew.append(pk)
            else:
                # holder is gone with no connection to observe dying —
                # after the grace window stamped at recovery, the reaper
                # is what expires it
                row = self.conn().execute(
                    "SELECT renewed_at FROM leases WHERE pk=?",
                    (pk,)).fetchone()
                if row is not None and row["renewed_at"] < (
                        now - 2 * self.heartbeat):
                    chaos.fault_point("lease.expire", pk=pk)
                    lease[0] = None
                    self.conn().execute(
                        "UPDATE leases SET worker=NULL, renewed_at=?"
                        " WHERE pk=?", (now, pk))
                    self.stats["leases_expired"] += 1
        if renew:
            self.conn().executemany(
                "UPDATE leases SET renewed_at=? WHERE pk=?",
                [(now, pk) for pk in renew])
        if renew or self._dirty:
            self._commit_now()


class BrokerClient:
    """Communicator-compatible client for the broker (kiwiPy role).

    Runs its protocol on the caller's event loop; heartbeats are sent from
    a background task so a busy worker still responds (kiwiPy runs a
    separate thread for the same reason — see paper §III.C.a).

    Writes are coalesced: frames queued in one scheduling tick leave in a
    single syscall. Process-control registrations (``process.<pk>``) are
    *not* sent as per-pk ``rpc_register`` frames — the client keeps the
    handler locally and claims the pk via a batched ``own`` message, so
    10k live processes cost the broker one directory entry, not 10k."""

    def __init__(self, host: str, port: int, worker_name: str | None = None):
        self.host = host
        self.port = port
        #: stable identity for fenced ownership; a daemon worker sets
        #: this to its `worker.<pid>-<nonce>` id so leases survive
        #: reconnects (lease identity is the name, not the connection)
        self.worker_name = worker_name
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._rpc_handlers: dict[str, Callable] = {}
        self._task_handlers: dict[str, Callable[[dict], Awaitable]] = {}
        self._task_prefetch: dict[str, int] = {}
        self._broadcast_handlers: dict[int, tuple[str | None, Callable]] = {}
        self._bc_counter = itertools.count()
        self._bc_patterns: dict[str, int] = {}        # pattern -> refcount
        self._rpc_waiters: dict[str, asyncio.Future] = {}
        self._rpc_tasks: dict[str, asyncio.Task] = {}
        self._outbox: list[bytes] = []
        self._flush_scheduled = False
        self._pending_own: set[int] = set()
        self._pending_disown: set[int] = set()
        self._pk_epochs: dict[int, int] = {}          # pk -> lease epoch
        self._active_tasks: set[int] = set()
        self._tasks: list[asyncio.Task] = []
        self.heartbeat = 1.0

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        if self.worker_name is not None:
            # announce identity before anything else: ownership claims
            # and lease grants key off this name
            self._send({"kind": "hello", "worker": self.worker_name})
        # re-register any existing subscriptions (reconnect path)
        self._pending_disown.clear()
        for identifier in self._rpc_handlers:
            m = _PROCESS_ID.match(identifier)
            if m is not None:
                self._pending_own.add(int(m.group(1)))
            else:
                self._send({"kind": "rpc_register", "identifier": identifier})
        if self._pending_own:
            self._schedule_flush()
        for queue in self._task_handlers:
            self._send({"kind": "consume", "queue": queue,
                        "prefetch": self._task_prefetch.get(queue, 1)})
        for pattern in self._bc_patterns:
            self._send({"kind": "subscribe", "patterns": [pattern]})
        if not self._tasks:
            self._tasks.append(asyncio.ensure_future(self._recv_loop()))
            self._tasks.append(asyncio.ensure_future(self._heartbeat_loop()))

    # -- outgoing frames: write coalescing --------------------------------------
    def _send(self, msg: dict) -> bool:
        """Best-effort write; False when the connection is down (the
        reconnect loop will recover subscriptions, but a caller awaiting
        a reply must fail fast rather than wait on a message never sent).
        Frames are staged in an outbox and flushed once per scheduling
        tick — many messages per syscall."""
        if self._writer is None or self._writer.is_closing():
            return False
        self._outbox.append(_encode(msg))
        self._schedule_flush()
        return True

    def _schedule_flush(self) -> None:
        if self._flush_scheduled:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._flush_outbox()
            return
        self._flush_scheduled = True
        loop.call_soon(self._flush_outbox)

    def _flush_outbox(self) -> None:
        self._flush_scheduled = False
        frames: list[bytes] = []
        if self._pending_own:
            pks = sorted(self._pending_own)
            frames.append(_encode({
                "kind": "own", "pks": pks,
                # epoch-validated re-claim: the broker refuses claims
                # whose epoch is older than the lease table's (a zombie
                # trying to re-assert ownership it already lost)
                "epochs": {str(pk): self._pk_epochs[pk] for pk in pks
                           if pk in self._pk_epochs}}))
            self._pending_own.clear()
        if self._pending_disown:
            frames.append(_encode({"kind": "disown",
                                   "pks": sorted(self._pending_disown)}))
            self._pending_disown.clear()
        frames.extend(self._outbox)
        self._outbox = []
        if not frames:
            return
        writer = self._writer
        if writer is None or writer.is_closing():
            return
        try:
            writer.write(b"".join(frames))
        except Exception:  # noqa: BLE001 — reconnect loop will recover
            pass

    def _queue_ownership(self, pk: int, owned: bool) -> None:
        if owned:
            self._pending_own.add(pk)
            self._pending_disown.discard(pk)
        else:
            self._pending_disown.add(pk)
            self._pending_own.discard(pk)
            self._pk_epochs.pop(pk, None)
        self._schedule_flush()

    async def _heartbeat_loop(self) -> None:
        while True:
            self._send({"kind": "heartbeat"})
            await asyncio.sleep(self.heartbeat)

    async def _reconnect(self) -> None:
        delay = 0.2
        while True:
            try:
                await self.connect()
                logger.info("broker client reconnected")
                return
            except OSError:
                await asyncio.sleep(delay)
                delay = min(delay * 2, 5.0)

    async def _recv_loop(self) -> None:
        while True:
            assert self._reader is not None
            line = await self._reader.readline()
            if not line:
                # connection lost (e.g. broker reaped us while busy, or
                # broker restarted): reconnect and resubscribe. In-flight
                # RPC replies died with the connection — fail their
                # waiters instead of leaving callers awaiting forever.
                if self._writer is not None:
                    self._writer.close()
                self._reader = self._writer = None
                self._outbox.clear()
                waiters, self._rpc_waiters = self._rpc_waiters, {}
                for fut in waiters.values():
                    if not fut.done():
                        fut.set_exception(
                            ConnectionError("broker connection lost"))
                await self._reconnect()
                continue
            msg = json.loads(line)
            kind = msg.get("kind")
            if kind == "task":
                asyncio.ensure_future(self._run_task(msg))
            elif kind == "rpc_request":
                # run the handler in its own task: a hung handler must not
                # wedge this receive loop (and the broker can cancel it)
                rid = msg["rid"]
                task = asyncio.ensure_future(self._run_rpc(msg))
                self._rpc_tasks[rid] = task
                task.add_done_callback(
                    lambda _t, rid=rid: self._rpc_tasks.pop(rid, None))
            elif kind == "rpc_cancel":
                task = self._rpc_tasks.pop(msg["rid"], None)
                if task is not None:
                    task.cancel()
            elif kind == "rpc_reply":
                fut = self._rpc_waiters.pop(msg["rid"], None)
                if fut and not fut.done():
                    if msg.get("cancelled"):
                        fut.set_exception(TimeoutError(
                            msg.get("error", "rpc cancelled")))
                    elif "error" in msg:
                        fut.set_exception(KeyError(msg["error"]))
                    else:
                        fut.set_result(msg.get("result"))
            elif kind == "own_refused":
                # another worker holds a newer lease on these pks — our
                # in-memory copies are zombies and will self-fence at
                # their next store write; stop claiming them
                _metrics.get_registry().counter(
                    "broker.own_refused").inc(len(msg.get("pks", [])))
                for pk in msg.get("pks", []):
                    self._pk_epochs.pop(int(pk), None)
                logger.warning("ownership claim refused (stale epoch) for"
                               " pks %s", msg.get("pks"))
            elif kind == "broadcast":
                self._dispatch_broadcast(msg)
            elif kind == "broadcast_batch":
                for event in msg.get("events", []):
                    self._dispatch_broadcast(event)

    def _dispatch_broadcast(self, msg: dict) -> None:
        _metrics.get_registry().counter("broker.broadcasts_received").inc()
        for filt, handler in list(self._broadcast_handlers.values()):
            if filt and not fnmatch.fnmatch(msg["subject"], filt):
                continue
            try:
                handler(msg["subject"], msg.get("sender"),
                        msg.get("body", {}))
            except Exception:  # noqa: BLE001
                logger.exception("broadcast handler failed")

    async def _run_task(self, msg: dict) -> None:
        handler = self._task_handlers.get(msg["queue"])
        task_id = msg["task_id"]
        if handler is None:
            self._send({"kind": "nack", "task_id": task_id,
                        "queue": msg["queue"]})
            return
        if task_id in self._active_tasks:
            # duplicated frame of a task we are already running (an
            # at-least-once transport is allowed to do this): drop it —
            # the original execution's eventual ack/nack settles the row
            _metrics.get_registry().counter("broker.duplicate_frames").inc()
            return
        self._active_tasks.add(task_id)
        payload = msg["payload"]
        if isinstance(payload, dict) and "epoch" in payload and \
                "pk" in payload:
            # remember the lease epoch this frame was fenced under so a
            # reconnect re-claims ownership with a validated epoch
            self._pk_epochs[int(payload["pk"])] = int(payload["epoch"])
        try:
            await handler(msg["payload"])
            # crash seam: the work is done (and durable) but the broker
            # does not know — dying here forces a redelivery that the
            # task handler must recognise as already-finished
            chaos.fault_point("broker.ack.pre", task_id=task_id)
            self._send({"kind": "ack", "task_id": task_id})
        except Exception:  # noqa: BLE001
            logger.exception("task failed; nacking for requeue")
            self._send({"kind": "nack", "task_id": task_id,
                        "queue": msg["queue"]})
        finally:
            self._active_tasks.discard(task_id)

    async def _run_rpc(self, msg: dict) -> None:
        handler = self._rpc_handlers.get(msg["identifier"])
        reply: dict = {"kind": "rpc_reply", "rid": msg["rid"]}
        if handler is None:
            reply["error"] = f"no handler {msg['identifier']!r}"
        else:
            try:
                res = handler(msg["msg"])
                if asyncio.iscoroutine(res):
                    res = await res
                reply["result"] = res
            except asyncio.CancelledError:
                # broker-side deadline fired: it already answered the
                # caller with `cancelled`; nothing to reply
                return
            except Exception as exc:  # noqa: BLE001
                reply["error"] = repr(exc)
        self._send(reply)

    # -- Communicator interface ---------------------------------------------------
    def add_rpc_subscriber(self, identifier: str, handler: Callable) -> None:
        self._rpc_handlers[identifier] = handler
        m = _PROCESS_ID.match(identifier)
        if m is not None:
            self._queue_ownership(int(m.group(1)), True)
        else:
            self._send({"kind": "rpc_register", "identifier": identifier})

    def remove_rpc_subscriber(self, identifier: str) -> None:
        self._rpc_handlers.pop(identifier, None)
        m = _PROCESS_ID.match(identifier)
        if m is not None:
            self._queue_ownership(int(m.group(1)), False)
        else:
            self._send({"kind": "rpc_unregister", "identifier": identifier})

    async def rpc_lookup(self, pattern: str = "*") -> list[str]:
        """Query the broker's live RPC-identifier directory."""
        rid = str(uuid.uuid4())
        fut = asyncio.get_running_loop().create_future()
        self._rpc_waiters[rid] = fut
        if not self._send({"kind": "rpc_lookup", "rid": rid,
                           "pattern": pattern}):
            self._rpc_waiters.pop(rid, None)
            raise ConnectionError("broker connection lost")
        return await fut

    async def subscription_barrier(self) -> None:
        """Resolve once every frame already sent on this connection (e.g.
        a ``subscribe``) has been processed by the broker. Waiters use
        this to close the subscribe-then-check race under subject-filter
        pushdown."""
        rid = str(uuid.uuid4())
        fut = asyncio.get_running_loop().create_future()
        self._rpc_waiters[rid] = fut
        if not self._send({"kind": "sub_sync", "rid": rid}):
            self._rpc_waiters.pop(rid, None)
            raise ConnectionError("broker connection lost")
        await fut

    async def rpc_send_async(self, identifier: str, msg: dict,
                             timeout: float | None = None) -> Any:
        rid = str(uuid.uuid4())
        fut = asyncio.get_running_loop().create_future()
        self._rpc_waiters[rid] = fut
        frame = {"kind": "rpc_send", "rid": rid,
                 "identifier": identifier, "msg": msg}
        if timeout is not None:
            # server-side deadline: the broker cancels the handler and
            # replies `cancelled` (surfaced here as TimeoutError)
            frame["timeout"] = timeout
        t0 = time.perf_counter()
        with trace.span("broker.rpc", identifier=identifier):
            if not self._send(frame):
                self._rpc_waiters.pop(rid, None)
                raise ConnectionError("broker connection lost")
            result = await fut
        _metrics.get_registry().histogram("broker.rpc_seconds").observe(
            time.perf_counter() - t0)
        return result

    def rpc_send(self, identifier: str, msg: dict,
                 timeout: float | None = None) -> Any:
        return self.rpc_send_async(identifier, msg, timeout=timeout)

    def add_broadcast_subscriber(self, handler: Callable,
                                 subject_filter: str | None = None) -> int:
        token = next(self._bc_counter)
        self._broadcast_handlers[token] = (subject_filter, handler)
        pattern = subject_filter or "*"
        self._bc_patterns[pattern] = self._bc_patterns.get(pattern, 0) + 1
        if self._bc_patterns[pattern] == 1:
            # push the filter down: the broker only fans matching events
            self._send({"kind": "subscribe", "patterns": [pattern]})
        return token

    def remove_broadcast_subscriber(self, token: int) -> None:
        entry = self._broadcast_handlers.pop(token, None)
        if entry is None:
            return
        pattern = entry[0] or "*"
        count = self._bc_patterns.get(pattern, 0) - 1
        if count <= 0:
            self._bc_patterns.pop(pattern, None)
            self._send({"kind": "unsubscribe", "patterns": [pattern]})
        else:
            self._bc_patterns[pattern] = count

    def broadcast_send(self, subject: str, sender: Any = None,
                       body: dict | None = None) -> None:
        _metrics.get_registry().counter("broker.broadcasts_sent").inc()
        self._send({"kind": "broadcast", "subject": subject,
                    "sender": sender, "body": body or {}})

    def task_send(self, queue: str, payload: dict) -> None:
        self._send({"kind": "task_send", "queue": queue, "payload": payload})

    def task_send_many(self, queue: str, payloads: list[dict],
                       submitter: str | None = None) -> None:
        """Enqueue many payloads in one frame (one insert batch + one
        delivery round server-side)."""
        self._send({"kind": "task_send_many", "queue": queue,
                    "payloads": list(payloads), "submitter": submitter})

    def add_task_subscriber(self, queue: str,
                            handler: Callable[[dict], Awaitable],
                            prefetch: int = 1) -> None:
        self._task_handlers[queue] = handler
        self._task_prefetch[queue] = max(1, prefetch)
        self._send({"kind": "consume", "queue": queue,
                    "prefetch": self._task_prefetch[queue]})

    def close(self) -> None:
        try:
            self._flush_outbox()
        except Exception:  # noqa: BLE001
            pass
        for t in self._tasks:
            t.cancel()
        for t in list(self._rpc_tasks.values()):
            t.cancel()
        self._rpc_tasks.clear()
        if self._writer is not None:
            self._writer.close()


class SyncBrokerClient:
    """Blocking broker client for non-async callers (the CLI, tests).

    Speaks the same newline-JSON protocol as :class:`BrokerClient` but over
    a plain socket, sending heartbeats while idle so the broker's reaper
    does not presume it dead during a long ``watch``."""

    def __init__(self, host: str, port: int, connect_timeout: float = 10.0):
        self.host = host
        self.port = port
        self.connect_timeout = connect_timeout
        self._sock: socket.socket | None = None
        self._buf = b""
        self._last_beat = 0.0
        # broadcasts that arrived interleaved with an RPC reply; a later
        # events() call must still see them
        self._pending: list[dict] = []
        self._connect()

    def _connect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout)
        self._sock.settimeout(0.25)
        self._buf = b""
        self._last_beat = 0.0

    def _send(self, msg: dict) -> None:
        try:
            self._sock.sendall(_encode(msg))
        except OSError as exc:
            raise ConnectionError("broker connection lost") from exc

    def _heartbeat(self) -> None:
        now = time.monotonic()
        if now - self._last_beat >= 0.5:
            self._send({"kind": "heartbeat"})
            self._last_beat = now

    def _recv(self, deadline: float | None) -> dict | None:
        """Next message, or None once the deadline passes."""
        while True:
            # heartbeat even while draining buffered lines (e.g. a long
            # replay): the broker's reaper must keep seeing us alive
            self._heartbeat()
            if b"\n" in self._buf:
                line, self._buf = self._buf.split(b"\n", 1)
                if line.strip():
                    return json.loads(line)
                continue
            if deadline is not None and time.monotonic() > deadline:
                return None
            try:
                chunk = self._sock.recv(65536)
            except TimeoutError:
                continue
            except OSError as exc:
                raise ConnectionError("broker connection lost") from exc
            if not chunk:
                raise ConnectionError("broker closed the connection")
            self._buf += chunk

    def _stash_broadcast(self, msg: dict) -> None:
        if msg.get("kind") == "broadcast":
            self._pending.append(msg)
        elif msg.get("kind") == "broadcast_batch":
            self._pending.extend({"kind": "broadcast", **event}
                                 for event in msg.get("events", []))

    def _await_reply(self, rid: str, timeout: float) -> Any:
        deadline = time.monotonic() + timeout
        while True:
            msg = self._recv(deadline)
            if msg is None:
                raise TimeoutError(f"no broker reply within {timeout}s")
            if msg.get("kind") == "rpc_reply" and msg.get("rid") == rid:
                if msg.get("cancelled"):
                    raise TimeoutError(msg.get("error", "rpc cancelled"))
                if "error" in msg:
                    raise KeyError(msg["error"])
                return msg.get("result")
            # e.g. the state change a control intent provoked landing
            # before its rpc_reply — keep it for the next events() call
            self._stash_broadcast(msg)

    def _request(self, build_msg, timeout: float) -> Any:
        """Send a request and await its reply, reconnecting under a
        full-jitter backoff schedule (engine/backoff.py) on connection
        loss — this covers both the broker reaping an idle client (2
        missed heartbeats) and a broker *restart window*, during which
        connects are refused until the supervising daemon brings it back.
        Control intents are idempotent, so the retry is safe."""
        from repro_torch.engine.backoff import (
            TransportTaskExhausted, retry_sync,
        )
        state = {"fresh": self._sock is not None}

        def attempt():
            if not state["fresh"]:
                self._connect()
                state["fresh"] = True
            rid = str(uuid.uuid4())
            try:
                self._send(build_msg(rid))
                return self._await_reply(rid, timeout)
            except ConnectionError:
                state["fresh"] = False
                raise

        try:
            return retry_sync(attempt, initial_interval=0.2, max_attempts=6,
                              name="sync-broker-request",
                              non_retryable=(TimeoutError, KeyError))
        except TransportTaskExhausted as exc:
            # callers' error handling predates the backoff wrapper: keep
            # surfacing the underlying connection failure
            raise exc.last from exc

    def rpc(self, identifier: str, msg: dict, timeout: float = 10.0) -> Any:
        # the broker enforces the deadline server-side (cancelled reply);
        # the local await gets slack so the server verdict wins the race
        return self._request(
            lambda rid: {"kind": "rpc_send", "rid": rid,
                         "identifier": identifier, "msg": msg,
                         "timeout": timeout}, timeout + 2.0)

    def lookup(self, pattern: str = "*", timeout: float = 10.0) -> list[str]:
        return self._request(
            lambda rid: {"kind": "rpc_lookup", "rid": rid,
                         "pattern": pattern}, timeout)

    def task_send(self, queue: str, payload: dict,
                  submitter: str | None = None,
                  timeout: float = 30.0) -> int:
        """Enqueue one task and wait for the broker's durable-delivery
        ack (replaces the old fire-and-sleep submission path)."""
        return self._request(
            lambda rid: {"kind": "task_send", "rid": rid, "queue": queue,
                         "payload": payload, "submitter": submitter},
            timeout)

    def task_send_many(self, queue: str, payloads: list[dict],
                       submitter: str | None = None,
                       timeout: float = 60.0) -> int:
        """Enqueue many tasks in one frame; returns the acked count."""
        payloads = list(payloads)
        return self._request(
            lambda rid: {"kind": "task_send_many", "rid": rid,
                         "queue": queue, "payloads": payloads,
                         "submitter": submitter}, timeout)

    def broker_stats(self, timeout: float = 10.0) -> dict:
        """The broker's control-plane traffic counters + queue depths."""
        return self._request(
            lambda rid: {"kind": "broker_stats", "rid": rid}, timeout)

    def broadcast_send(self, subject: str, sender: Any = None,
                       body: dict | None = None) -> None:
        self._send({"kind": "broadcast", "subject": subject,
                    "sender": sender, "body": body or {}})

    def events(self, subject_filter: str | None = None,
               timeout: float | None = None,
               replay_since: int | None = None
               ) -> Iterator[tuple[str, Any, dict]]:
        """Yield ``(subject, sender, body)`` broadcasts as they arrive;
        stops after ``timeout`` seconds of total watching (None = forever).
        ``replay_since`` first replays logged events with seq > the given
        value (0 = everything the broker still remembers)."""
        pattern = subject_filter or "*"
        # subject-filter pushdown: tell the broker to fan matching live
        # events to us (without this, it sends nothing at all)
        self._send({"kind": "subscribe", "patterns": [pattern]})
        if replay_since is not None:
            self._send({"kind": "events_since", "seq": replay_since,
                        "pattern": subject_filter})
        deadline = None if timeout is None else time.monotonic() + timeout
        # replay + live can overlap around the events_since request; the
        # broker stamps every event with a unique seq — dedup on it, but
        # only until the replay catches up (keeps `seen` bounded on
        # long-lived watches)
        seen: set[int] = set()
        replaying = replay_since is not None
        try:
            while True:
                if self._pending:
                    msg = self._pending.pop(0)
                else:
                    msg = self._recv(deadline)
                if msg is None:
                    return
                if msg.get("kind") == "events_caught_up":
                    replaying = False
                    seen.clear()
                    continue
                if msg.get("kind") == "broadcast_batch":
                    self._pending = [
                        {"kind": "broadcast", **event}
                        for event in msg.get("events", [])] + self._pending
                    continue
                if msg.get("kind") != "broadcast":
                    continue
                seq = msg.get("seq")
                if replaying and seq is not None:
                    if seq in seen:
                        continue
                    seen.add(seq)
                subject = msg["subject"]
                if subject_filter and not fnmatch.fnmatch(subject,
                                                          subject_filter):
                    continue
                yield subject, msg.get("sender"), msg.get("body", {})
        finally:
            try:
                self._send({"kind": "unsubscribe", "patterns": [pattern]})
            except ConnectionError:
                pass

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
