"""The provenance graph store (paper §I, §III.B.1).

AiiDA uses PostgreSQL plus a file repository; the storage backend here is
sqlite (stdlib) behind the same narrow API, with WAL journaling so that
multiple daemon workers (OS processes) can share one database file, and a
content-addressed :class:`~repro_torch.provenance.repository.BlobRepository`
next to the database so bulk payloads (arrays, retrieved files) never
enter the ``nodes`` table. Swapping in Postgres means reimplementing the
~15 SQL statements in this file.

Graph model:
  nodes  — data values and process executions (CalcFunctionNode,
           WorkFunctionNode, WorkChainNode, CalcJobNode, DataNode …)
  links  — typed, labelled edges: INPUT_CALC/INPUT_WORK (data -> process),
           CREATE (calc -> data), RETURN (work -> data),
           CALL_CALC/CALL_WORK (workflow -> subprocess)
  logs   — the WorkChain.report() records (REPORT log level), attached to
           their emitting process node

Write model (the criterion-(v) hot path):
  * every mutating call commits on its own **unless** it runs inside a
    ``store.transaction()`` block — the engine wraps each process step
    (state transition + data storing + checkpoint) in one transaction, so
    provenance costs ~2 commits per process instead of ~12;
  * ``store_data_many`` / ``add_links`` / ``add_logs`` /
    ``insert_node_rows`` are the bulk (``executemany``) mutators;
  * payload documents whose bulk content exceeds ``inline_threshold``
    (default 4 KiB, env ``REPRO_REPO_INLINE_MAX``) are transparently
    routed to the blob repository and rehydrated on ``load_data``.

Read model:
  * ``get_nodes`` / ``links_for`` / ``logs_for`` are the batched readers
    (chunked ``IN (…)`` queries) that graph traversals use instead of
    per-node queries;
  * ``SUMMARY_COLUMNS`` is the projection hot reads use so listing or
    waiting on processes never fetches ``payload``/``checkpoint`` text.
"""

from __future__ import annotations

import base64
import contextlib
import enum
import json
import os
import sqlite3
import threading
import time
import uuid as uuid_mod
from typing import TYPE_CHECKING, Any, Iterable, Sequence

from repro_torch.chaos import faults as chaos
from repro_torch.observability import trace
from repro_torch.observability.metrics import StatsDict
from repro_torch.provenance.repository import BlobRepository

if TYPE_CHECKING:  # imported lazily at runtime (core <-> provenance cycle)
    from repro_torch.core.datatypes import DataValue


class NodeType(str, enum.Enum):
    DATA = "data"
    CALC_FUNCTION = "process.calcfunction"
    WORK_FUNCTION = "process.workfunction"
    WORK_CHAIN = "process.workchain"
    CALC_JOB = "process.calcjob"
    PROCESS = "process.process"

    @property
    def is_process(self) -> bool:
        return self.value.startswith("process")


class LinkType(str, enum.Enum):
    INPUT_CALC = "input_calc"
    INPUT_WORK = "input_work"
    CREATE = "create"
    RETURN = "return"
    CALL_CALC = "call_calc"
    CALL_WORK = "call_work"


_SCHEMA = """
CREATE TABLE IF NOT EXISTS nodes (
    pk INTEGER PRIMARY KEY AUTOINCREMENT,
    uuid TEXT UNIQUE NOT NULL,
    node_type TEXT NOT NULL,
    process_type TEXT,
    label TEXT DEFAULT '',
    description TEXT DEFAULT '',
    attributes TEXT DEFAULT '{}',
    payload TEXT,
    process_state TEXT,
    exit_status INTEGER,
    exit_message TEXT,
    checkpoint TEXT,
    node_hash TEXT,
    ctime REAL NOT NULL,
    mtime REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS links (
    pk INTEGER PRIMARY KEY AUTOINCREMENT,
    in_id INTEGER NOT NULL REFERENCES nodes(pk),
    out_id INTEGER NOT NULL REFERENCES nodes(pk),
    link_type TEXT NOT NULL,
    label TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS logs (
    pk INTEGER PRIMARY KEY AUTOINCREMENT,
    node_id INTEGER NOT NULL REFERENCES nodes(pk),
    levelname TEXT NOT NULL,
    message TEXT NOT NULL,
    time REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS meta (
    key TEXT PRIMARY KEY,
    value TEXT
);
CREATE INDEX IF NOT EXISTS idx_links_in ON links(in_id);
CREATE INDEX IF NOT EXISTS idx_links_out ON links(out_id);
CREATE INDEX IF NOT EXISTS idx_nodes_type ON nodes(node_type);
CREATE INDEX IF NOT EXISTS idx_nodes_state ON nodes(process_state);
CREATE INDEX IF NOT EXISTS idx_logs_node ON logs(node_id);
"""

#: every nodes column except the two bulk-text ones (payload, checkpoint) —
#: the projection for listings, waits and traversals
SUMMARY_COLUMNS = ("pk", "uuid", "node_type", "process_type", "label",
                   "description", "attributes", "process_state",
                   "exit_status", "exit_message", "node_hash", "ctime",
                   "mtime")

_NODE_COLUMNS = frozenset(SUMMARY_COLUMNS) | {"payload", "checkpoint",
                                              "lease_epoch"}


class StaleEpochError(RuntimeError):
    """A write arrived bearing a lease epoch older than one the store has
    already accepted for that pk: the writer is a zombie whose lease
    expired and whose process was re-granted to another worker. The write
    is refused (fencing token, Kleppmann-style); the zombie must abandon
    the process without touching the store."""

    def __init__(self, pk: int, epoch: int):
        super().__init__(
            f"stale lease epoch {epoch} for pk={pk}: the store has "
            "accepted writes from a newer lease holder")
        self.pk = pk
        self.epoch = epoch

#: sqlite's default bound-variable limit is 999; stay well under it
_SQL_CHUNK = 500


def _chunks(seq: Sequence, size: int = _SQL_CHUNK):
    for i in range(0, len(seq), size):
        yield seq[i:i + size]


def _cols_sql(columns: Sequence[str] | None) -> str:
    if columns is None:
        return "*"
    unknown = set(columns) - _NODE_COLUMNS
    if unknown:
        raise ValueError(f"unknown node column(s): {sorted(unknown)}")
    return ", ".join(columns)


#: seconds a new connection retries switching a fresh profile to WAL
_WAL_TIMEOUT_S = 30.0


def _set_wal(conn: sqlite3.Connection) -> None:
    """Put the database in WAL mode. On a fresh profile that several
    processes open at once, SQLite refuses the switch at once with
    ``database is locked`` (it calls no busy handler for it) while
    another connection holds its lock: retry until
    :data:`_WAL_TIMEOUT_S`."""
    deadline = time.monotonic() + _WAL_TIMEOUT_S
    while True:
        try:
            conn.execute("PRAGMA journal_mode=WAL")
            return
        except sqlite3.OperationalError as exc:
            if "locked" not in str(exc) or time.monotonic() > deadline:
                raise
            time.sleep(0.005)


class ProvenanceStore:
    def __init__(self, path: str = ":memory:", *,
                 inline_threshold: int | None = None):
        self.path = path
        if inline_threshold is None:
            inline_threshold = int(
                os.environ.get("REPRO_REPO_INLINE_MAX", "4096"))
        #: payload bulk content above this many bytes goes to the blob
        #: repository instead of the nodes table
        self.inline_threshold = inline_threshold
        #: observability counters; ``commits`` is the unit-of-work metric
        #: benchmarks and CI assert on (one commit per engine step).
        #: A StatsDict behaves exactly like the old plain dict but also
        #: feeds the process-wide metrics registry (`repro stats`).
        self.stats: dict[str, int] = StatsDict("store", {"commits": 0})
        self._local = threading.local()
        self._lock = threading.RLock()
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            repo_root = os.path.abspath(path) + ".repo"
        else:
            repo_root = None
        self.repository = BlobRepository(repo_root)
        self._conn().executescript(_SCHEMA)
        self._migrate(self._conn())
        self._conn().commit()
        self._migrate_payloads()

    @staticmethod
    def _migrate(conn: sqlite3.Connection) -> None:
        """Bring pre-existing databases up to the current schema. The read
        of the columns and the ``ALTER``s run in one write transaction:
        processes that open one fresh profile at once would otherwise each
        read the column as missing and all but the first fail to add it
        (``duplicate column name``). The caller commits."""
        conn.execute("BEGIN IMMEDIATE")
        cols = {r[1] for r in conn.execute("PRAGMA table_info(nodes)")}
        if "node_hash" not in cols:
            conn.execute("ALTER TABLE nodes ADD COLUMN node_hash TEXT")
        if "lease_epoch" not in cols:
            # fencing-token watermark: the highest lease epoch whose
            # writes this row has accepted (NULL for data nodes and
            # processes never driven through the broker)
            conn.execute("ALTER TABLE nodes ADD COLUMN lease_epoch INTEGER")
        # created here (not in _SCHEMA) so it runs after the column exists
        conn.execute("CREATE INDEX IF NOT EXISTS idx_nodes_hash"
                     " ON nodes(process_type, node_hash)")
        # legacy profiles predate the logs index (get_logs full-scanned)
        conn.execute("CREATE INDEX IF NOT EXISTS idx_logs_node"
                     " ON logs(node_id)")

    def _migrate_payloads(self, batch_size: int = 200) -> None:
        """One-shot data migration: move legacy inline bulk payloads
        (base64 arrays/folders stored as JSON text in the nodes table)
        out to the blob repository. Idempotent — stamped in ``meta`` —
        and safe under concurrent opens: externalizing the same content
        twice yields the same digests and identical row updates. Runs in
        batches (payload text is fetched ``batch_size`` rows at a time,
        one commit each) so a huge legacy profile neither loads every
        payload into memory at once nor holds the write lock for the
        whole scan."""
        if self.get_meta("repo_version") is not None:
            return
        conn = self._conn()
        pks = [r["pk"] for r in conn.execute(
            "SELECT pk FROM nodes WHERE payload IS NOT NULL"
            " AND length(payload) > ?", (self.inline_threshold,))]
        for chunk in _chunks(pks, batch_size):
            marks = ",".join("?" * len(chunk))
            rows = conn.execute(
                f"SELECT pk, payload FROM nodes WHERE pk IN ({marks})",
                chunk).fetchall()
            with self.transaction():
                for row in rows:
                    try:
                        doc = json.loads(row["payload"])
                    except ValueError:
                        continue
                    ext = self._externalize_payload(doc)
                    if ext is not doc:
                        conn.execute(
                            "UPDATE nodes SET payload=? WHERE pk=?",
                            (json.dumps(ext), row["pk"]))
        self.set_meta("repo_version", "1")

    # -- connection handling (per-thread) -------------------------------------
    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0)
            conn.row_factory = sqlite3.Row
            _set_wal(conn)
            conn.execute("PRAGMA busy_timeout=30000")
            conn.execute("PRAGMA synchronous=NORMAL")
            # hot-path tuning: a 16 MB page cache and a larger WAL before
            # auto-checkpointing shave ~15% off commit latency (the
            # checkpoint fsync amortizes over more commits)
            conn.execute("PRAGMA cache_size=-16000")
            conn.execute("PRAGMA wal_autocheckpoint=4000")
            self._local.conn = conn
        return conn

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    # -- batched writes ---------------------------------------------------------
    @contextlib.contextmanager
    def transaction(self):
        """Group many mutating calls into one atomic commit — the engine's
        unit of work (one commit per process step) and the archive-import
        envelope. Inside the block the per-call commits become no-ops; the
        lock is held throughout, and an exception rolls everything back
        (running any ``on_rollback`` hooks, e.g. un-assigning pks handed
        out for rows that never became durable). ``after_commit`` hooks
        run once the commit lands and the lock is released — that is how
        terminal-state broadcasts stay *after* the durable write."""
        with self._lock:
            if getattr(self._local, "in_txn", False):
                yield  # nested: the outermost frame owns the commit
                return
            self._local.in_txn = True
            try:
                yield
                # crash seam: everything this unit of work wrote is still
                # un-fsynced here — dying now must lose the whole step,
                # never half of it. Inside the try so an injected *raise*
                # takes the rollback path like any mid-transaction failure.
                chaos.fault_point("store.commit.pre")
                with trace.span("store.commit"):
                    self._conn().commit()
                self.stats["commits"] += 1
            except BaseException:
                self._conn().rollback()
                for fn in getattr(self._local, "rollback_cbs", []):
                    try:
                        fn()
                    except Exception:  # noqa: BLE001 — cleanup best effort
                        pass
                self._local.post_commit = []
                self._local.rollback_cbs = []
                raise
            finally:
                self._local.in_txn = False
        # outside the lock: observers woken by these callbacks may read
        # the store from other threads/processes immediately
        callbacks = getattr(self._local, "post_commit", [])
        self._local.post_commit = []
        self._local.rollback_cbs = []
        for fn in callbacks:
            fn()
        # durable, observers notified — but the caller has not continued
        chaos.fault_point("store.commit.post")

    def after_commit(self, fn) -> None:
        """Run ``fn`` after the enclosing transaction commits; immediately
        when no transaction is open (the write is already durable)."""
        if getattr(self._local, "in_txn", False):
            if not hasattr(self._local, "post_commit"):
                self._local.post_commit = []
            self._local.post_commit.append(fn)
        else:
            fn()

    def on_rollback(self, fn) -> None:
        """Register cleanup to run if the enclosing transaction rolls
        back; a no-op when no transaction is open (nothing to undo)."""
        if getattr(self._local, "in_txn", False):
            if not hasattr(self._local, "rollback_cbs"):
                self._local.rollback_cbs = []
            self._local.rollback_cbs.append(fn)

    def _commit(self) -> None:
        if not getattr(self._local, "in_txn", False):
            try:
                chaos.fault_point("store.commit.pre")
                with trace.span("store.commit"):
                    self._conn().commit()
                self.stats["commits"] += 1
            except BaseException:
                # an injected (or real) failure must not leave the write
                # pending on the connection — the unit of work dies whole
                self._conn().rollback()
                raise
            chaos.fault_point("store.commit.post")

    # -- payload routing (blob repository) --------------------------------------
    def _externalize_payload(self, doc: Any) -> Any:
        """Route bulk content of a payload document to the repository.
        Returns a *new* dict when anything moved, the same object when
        the document stays inline (identity is the changed signal)."""
        if not isinstance(doc, dict):
            return doc
        limit = self.inline_threshold
        if doc.get("type") == "array" and "npy_b64" in doc:
            # b64 length * 3/4 is the decoded size; avoid decoding to test
            if len(doc["npy_b64"]) * 3 // 4 > limit:
                raw = base64.b64decode(doc["npy_b64"])
                return {"type": "array", "blob": self.repository.put(raw)}
        elif doc.get("type") == "folder" and doc.get("files"):
            inline: dict[str, str] = {}
            blobs: dict[str, str] = dict(doc.get("blobs") or {})
            moved = False
            for name, b64 in doc["files"].items():
                if len(b64) * 3 // 4 > limit:
                    blobs[name] = self.repository.put(base64.b64decode(b64))
                    moved = True
                else:
                    inline[name] = b64
            if moved:
                return {"type": "folder", "files": inline, "blobs": blobs}
        return doc

    def materialize_payload(self, doc: Any) -> Any:
        """Resolve repository references back to the inline payload form
        that :meth:`DataValue.from_payload` understands."""
        if not isinstance(doc, dict):
            return doc
        if doc.get("type") == "array" and "blob" in doc:
            raw = self.repository.get(doc["blob"])
            return {"type": "array",
                    "npy_b64": base64.b64encode(raw).decode()}
        if doc.get("type") == "folder" and doc.get("blobs"):
            files = dict(doc.get("files") or {})
            for name, digest in doc["blobs"].items():
                files[name] = base64.b64encode(
                    self.repository.get(digest)).decode()
            return {"type": "folder", "files": files}
        return doc

    @staticmethod
    def _unassign_on_rollback(values: "list[DataValue]"):
        """Rollback hook: a DataValue must not keep a pk whose row was
        rolled back — a later store would silently skip re-storing it and
        links would point at nonexistent rows."""
        def _undo():
            for value in values:
                value.pk = None
                value.uuid = None
        return _undo

    def _pks_by_uuid(self, uuids: Sequence[str]) -> dict[str, int]:
        pk_of: dict[str, int] = {}
        conn = self._conn()
        for chunk in _chunks(uuids):
            marks = ",".join("?" * len(chunk))
            for r in conn.execute(
                    f"SELECT pk, uuid FROM nodes WHERE uuid IN ({marks})",
                    chunk):
                pk_of[r["uuid"]] = r["pk"]
        return pk_of

    # -- node creation -----------------------------------------------------------
    def store_data(self, value: "DataValue", label: str = "") -> "DataValue":
        """Persist a DataValue; idempotent if already stored."""
        if value.is_stored:
            return value
        now = time.time()
        u = str(uuid_mod.uuid4())
        payload = json.dumps(self._externalize_payload(value.to_payload()))
        with self._lock:
            cur = self._conn().execute(
                "INSERT INTO nodes (uuid, node_type, label, payload, ctime,"
                " mtime) VALUES (?,?,?,?,?,?)",
                (u, NodeType.DATA.value, label, payload, now, now))
            self._commit()
        value.pk = cur.lastrowid
        value.uuid = u
        self.on_rollback(self._unassign_on_rollback([value]))
        return value

    def store_data_many(self, values: Iterable["DataValue"], label: str = ""
                        ) -> list["DataValue"]:
        """Bulk ``store_data``: one executemany + one commit for the whole
        batch. Already-stored values (and repeated occurrences of the same
        object) are skipped, matching sequential ``store_data`` calls."""
        values = list(values)
        now = time.time()
        rows: list[tuple] = []
        fresh: list[tuple["DataValue", str]] = []
        seen_objs: set[int] = set()
        for value in values:
            if value.is_stored or id(value) in seen_objs:
                continue
            seen_objs.add(id(value))
            u = str(uuid_mod.uuid4())
            payload = json.dumps(
                self._externalize_payload(value.to_payload()))
            rows.append((u, NodeType.DATA.value, label, payload, now, now))
            fresh.append((value, u))
        if not rows:
            return values
        with self.transaction():
            self._conn().executemany(
                "INSERT INTO nodes (uuid, node_type, label, payload, ctime,"
                " mtime) VALUES (?,?,?,?,?,?)", rows)
            pk_of = self._pks_by_uuid([u for _v, u in fresh])
        for value, u in fresh:
            value.pk = pk_of[u]
            value.uuid = u
        self.on_rollback(
            self._unassign_on_rollback([v for v, _u in fresh]))
        return values

    def create_process_node(self, node_type: NodeType, process_type: str,
                            label: str = "", description: str = "",
                            attributes: dict | None = None,
                            node_hash: str | None = None) -> int:
        now = time.time()
        u = str(uuid_mod.uuid4())
        with self._lock:
            cur = self._conn().execute(
                "INSERT INTO nodes (uuid, node_type, process_type, label,"
                " description, attributes, process_state, node_hash, ctime,"
                " mtime) VALUES (?,?,?,?,?,?,?,?,?,?)",
                (u, node_type.value, process_type, label, description,
                 json.dumps(attributes or {}), "created", node_hash, now,
                 now))
            self._commit()
        return cur.lastrowid

    # -- node updates ----------------------------------------------------------
    def update_process(self, pk: int, *, state: str | None = None,
                       exit_status: int | None = None,
                       exit_message: str | None = None,
                       attributes: dict | None = None) -> None:
        sets, vals = ["mtime=?"], [time.time()]
        if state is not None:
            sets.append("process_state=?")
            vals.append(state)
        if exit_status is not None:
            sets.append("exit_status=?")
            vals.append(exit_status)
        if exit_message is not None:
            sets.append("exit_message=?")
            vals.append(exit_message)
        if attributes is not None:
            # merge, don't replace — e.g. `cached_from` (and the durable
            # `kill_requested` control marker) must survive the
            # state-transition attribute writes. Merge in SQL, in the same
            # statement as the other column writes: a python
            # read-modify-write would race against writers in OTHER OS
            # processes (daemon workers vs a control CLI) and lose keys.
            # NB json_patch treats a null value as key deletion; no
            # caller stores None attribute values.
            sets.append("attributes="
                        "json_patch(COALESCE(attributes,'{}'),?)")
            vals.append(json.dumps(attributes))
        vals.append(pk)
        with self._lock:
            try:
                self._conn().execute(
                    f"UPDATE nodes SET {', '.join(sets)} WHERE pk=?", vals)
            except sqlite3.OperationalError:
                if attributes is None:
                    raise
                # sqlite built without JSON1: best-effort python merge
                row = self._conn().execute(
                    "SELECT attributes FROM nodes WHERE pk=?",
                    (pk,)).fetchone()
                merged = (json.loads(row["attributes"] or "{}")
                          if row else {})
                merged.update(attributes)
                sets[-1] = "attributes=?"
                vals[-2] = json.dumps(merged)
                self._conn().execute(
                    f"UPDATE nodes SET {', '.join(sets)} WHERE pk=?", vals)
            self._commit()

    # -- lease fencing (split-brain protection) --------------------------------
    def fence_epoch(self, pk: int, epoch: int | None) -> None:
        """Record that writes for ``pk`` now happen under lease ``epoch``,
        refusing the call with :class:`StaleEpochError` if the store has
        already accepted a newer epoch. A no-op for ``epoch=None`` (local,
        broker-less runs pay nothing).

        The check is an UPDATE, not a SELECT: it takes sqlite's write
        lock, so two workers racing to fence the same pk from different
        OS processes serialize here and exactly one of them loses.
        Called inside a ``transaction()`` block it joins that unit of
        work (a fenced flush rolls back whole); standalone it commits."""
        if epoch is None:
            return
        with self._lock:
            cur = self._conn().execute(
                "UPDATE nodes SET lease_epoch=? WHERE pk=?"
                " AND COALESCE(lease_epoch, 0) <= ?", (epoch, pk, epoch))
            if cur.rowcount == 0:
                exists = self._conn().execute(
                    "SELECT 1 FROM nodes WHERE pk=?", (pk,)).fetchone()
                if exists is None:
                    raise KeyError(f"no node with pk={pk}")
                raise StaleEpochError(pk, epoch)
            self._commit()

    # -- store-level counters/metadata (telemetry, e.g. hash collisions) -------
    def incr_meta(self, key: str, by: int = 1) -> int:
        """Atomically increment a store-level integer counter; returns the
        new value. Safe across OS processes (single UPSERT statement)."""
        with self._lock:
            self._conn().execute(
                "INSERT INTO meta (key, value) VALUES (?, ?)"
                " ON CONFLICT(key) DO UPDATE SET"
                " value = CAST(CAST(value AS INTEGER) + ? AS TEXT)",
                (key, str(by), by))
            self._commit()
            row = self._conn().execute(
                "SELECT value FROM meta WHERE key=?", (key,)).fetchone()
        return int(row["value"])

    def get_meta(self, key: str, default: Any = None) -> Any:
        row = self._conn().execute(
            "SELECT value FROM meta WHERE key=?", (key,)).fetchone()
        return row["value"] if row is not None else default

    def set_meta(self, key: str, value: str) -> None:
        with self._lock:
            self._conn().execute(
                "INSERT INTO meta (key, value) VALUES (?, ?)"
                " ON CONFLICT(key) DO UPDATE SET value=excluded.value",
                (key, str(value)))
            self._commit()

    def all_meta(self, prefix: str = "") -> dict[str, str]:
        rows = self._conn().execute(
            "SELECT key, value FROM meta WHERE key LIKE ?"
            " ORDER BY key", (prefix + "%",)).fetchall()
        return {r["key"]: r["value"] for r in rows}

    def set_node_hash(self, pk: int, node_hash: str | None) -> None:
        with self._lock:
            self._conn().execute(
                "UPDATE nodes SET node_hash=?, mtime=? WHERE pk=?",
                (node_hash, time.time(), pk))
            self._commit()

    def save_checkpoint(self, pk: int, checkpoint: dict | str) -> None:
        """Persist a checkpoint; accepts the dict or its pre-serialized
        JSON text (the engine serializes once for its dirty-flag check)."""
        if not isinstance(checkpoint, str):
            checkpoint = json.dumps(checkpoint)
        with self._lock:
            self._conn().execute(
                "UPDATE nodes SET checkpoint=?, mtime=? WHERE pk=?",
                (checkpoint, time.time(), pk))
            self._commit()

    def load_checkpoint(self, pk: int) -> dict | None:
        row = self._conn().execute(
            "SELECT checkpoint FROM nodes WHERE pk=?", (pk,)).fetchone()
        if row is None or row["checkpoint"] is None:
            return None
        return json.loads(row["checkpoint"])

    def delete_checkpoint(self, pk: int) -> None:
        with self._lock:
            self._conn().execute(
                "UPDATE nodes SET checkpoint=NULL WHERE pk=?", (pk,))
            self._commit()

    # -- bulk insertion (archive import) ---------------------------------------
    def insert_node_row(self, record: dict) -> int:
        """Insert a complete node row (archive import path): the caller
        supplies the uuid and timestamps, so identity and history survive
        the trip between profiles. Returns the assigned pk."""
        return self.insert_node_rows([record])[0]

    def insert_node_rows(self, records: Sequence[dict]) -> list[int]:
        """Bulk ``insert_node_row``: one executemany + one commit.
        ``payload`` may be a document (dict) or pre-serialized JSON text;
        either way bulk content above the inline threshold is routed to
        the blob repository. Returns the assigned pks, in input order."""
        now = time.time()
        rows: list[tuple] = []
        uuids: list[str] = []
        for record in records:
            payload = record.get("payload")
            if isinstance(payload, dict):
                payload = json.dumps(self._externalize_payload(payload),
                                     sort_keys=True, separators=(",", ":"))
            elif isinstance(payload, str) and \
                    len(payload) > self.inline_threshold:
                try:
                    doc = json.loads(payload)
                except ValueError:
                    doc = None
                if isinstance(doc, dict):
                    ext = self._externalize_payload(doc)
                    if ext is not doc:
                        payload = json.dumps(ext, sort_keys=True,
                                             separators=(",", ":"))
            uuids.append(record["uuid"])
            rows.append((record["uuid"], record["node_type"],
                         record.get("process_type"),
                         record.get("label", ""),
                         record.get("description", ""),
                         json.dumps(record.get("attributes") or {}),
                         payload, record.get("process_state"),
                         record.get("exit_status"),
                         record.get("exit_message"),
                         record.get("node_hash"),
                         record.get("ctime", now),
                         record.get("mtime", now)))
        if not rows:
            return []
        with self.transaction():
            self._conn().executemany(
                "INSERT INTO nodes (uuid, node_type, process_type, label,"
                " description, attributes, payload, process_state,"
                " exit_status, exit_message, node_hash, ctime, mtime)"
                " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)", rows)
            pk_of = self._pks_by_uuid(uuids)
        return [pk_of[u] for u in uuids]

    def get_node_by_uuid(self, uuid: str) -> dict | None:
        row = self._conn().execute(
            "SELECT * FROM nodes WHERE uuid=?", (uuid,)).fetchone()
        return dict(row) if row else None

    # -- links -------------------------------------------------------------------
    def add_link(self, in_pk: int, out_pk: int, link_type: LinkType,
                 label: str) -> None:
        with self._lock:
            self._conn().execute(
                "INSERT INTO links (in_id, out_id, link_type, label)"
                " VALUES (?,?,?,?)", (in_pk, out_pk, link_type.value, label))
            self._commit()

    def add_links(self, rows: Iterable[tuple[int, int, "LinkType | str",
                                             str]]) -> None:
        """Bulk ``add_link``: one executemany + one commit."""
        data = [(in_pk, out_pk,
                 lt.value if isinstance(lt, LinkType) else lt, label)
                for in_pk, out_pk, lt, label in rows]
        if not data:
            return
        with self.transaction():
            self._conn().executemany(
                "INSERT INTO links (in_id, out_id, link_type, label)"
                " VALUES (?,?,?,?)", data)

    def has_link(self, in_pk: int, out_pk: int, link_type: LinkType,
                 label: str) -> bool:
        row = self._conn().execute(
            "SELECT 1 FROM links WHERE in_id=? AND out_id=? AND link_type=?"
            " AND label=? LIMIT 1",
            (in_pk, out_pk, link_type.value, label)).fetchone()
        return row is not None

    def delete_outgoing_links(self, in_pk: int,
                              link_types: Iterable[LinkType]) -> None:
        """Remove typed edges leaving a node (cache-clone rollback)."""
        types = [lt.value for lt in link_types]
        marks = ",".join("?" * len(types))
        with self._lock:
            self._conn().execute(
                f"DELETE FROM links WHERE in_id=? AND link_type IN ({marks})",
                [in_pk, *types])
            self._commit()

    # -- logs ----------------------------------------------------------------------
    def add_log(self, node_pk: int, levelname: str, message: str,
                ts: float | None = None) -> None:
        """Attach a log record; ``ts`` overrides the wall clock so imported
        logs keep their original emission time."""
        with self._lock:
            self._conn().execute(
                "INSERT INTO logs (node_id, levelname, message, time)"
                " VALUES (?,?,?,?)",
                (node_pk, levelname, message,
                 time.time() if ts is None else ts))
            self._commit()

    def add_logs(self, rows: Iterable[tuple[int, str, str, float]]) -> None:
        """Bulk ``add_log``: (node_pk, levelname, message, ts) tuples,
        one executemany + one commit."""
        data = list(rows)
        if not data:
            return
        with self.transaction():
            self._conn().executemany(
                "INSERT INTO logs (node_id, levelname, message, time)"
                " VALUES (?,?,?,?)", data)

    def get_logs(self, node_pk: int) -> list[dict]:
        rows = self._conn().execute(
            "SELECT levelname, message, time FROM logs WHERE node_id=?"
            " ORDER BY pk", (node_pk,)).fetchall()
        return [dict(r) for r in rows]

    def logs_for(self, pks: Iterable[int]) -> dict[int, list[dict]]:
        """Batched ``get_logs`` over many nodes (chunked IN queries);
        returns {node_pk: [log, …]} with each list in emission order."""
        pks = [int(p) for p in pks]
        acc: list[tuple[int, int, dict]] = []
        conn = self._conn()
        for chunk in _chunks(pks):
            marks = ",".join("?" * len(chunk))
            for r in conn.execute(
                    "SELECT pk, node_id, levelname, message, time FROM logs"
                    f" WHERE node_id IN ({marks})", chunk):
                acc.append((r["node_id"], r["pk"],
                            {"levelname": r["levelname"],
                             "message": r["message"], "time": r["time"]}))
        acc.sort(key=lambda t: t[1])
        out: dict[int, list[dict]] = {}
        for node_id, _log_pk, entry in acc:
            out.setdefault(node_id, []).append(entry)
        return out

    # -- reads -----------------------------------------------------------------------
    def get_node(self, pk: int, columns: Sequence[str] | None = None
                 ) -> dict | None:
        """One node row; pass ``columns`` (e.g. ``SUMMARY_COLUMNS``) to
        skip the bulk ``payload``/``checkpoint`` text on hot reads."""
        row = self._conn().execute(
            f"SELECT {_cols_sql(columns)} FROM nodes WHERE pk=?",
            (pk,)).fetchone()
        return dict(row) if row else None

    def get_nodes(self, pks: Iterable[int],
                  columns: Sequence[str] | None = None) -> dict[int, dict]:
        """Batched ``get_node`` (chunked IN queries) -> {pk: row}.
        Missing pks are simply absent from the result. ``columns`` must
        include ``pk`` when given (it keys the result)."""
        pks = [int(p) for p in pks]
        if columns is not None and "pk" not in columns:
            columns = ("pk", *columns)
        cols = _cols_sql(columns)
        out: dict[int, dict] = {}
        conn = self._conn()
        for chunk in _chunks(pks):
            marks = ",".join("?" * len(chunk))
            for r in conn.execute(
                    f"SELECT {cols} FROM nodes WHERE pk IN ({marks})",
                    chunk):
                d = dict(r)
                out[d["pk"]] = d
        return out

    def load_data(self, pk: int) -> "DataValue":
        from repro_torch.core.datatypes import DataValue

        node = self.get_node(pk)
        if node is None or node["node_type"] != NodeType.DATA.value:
            raise KeyError(f"no data node with pk={pk}")
        doc = self.materialize_payload(json.loads(node["payload"]))
        value = DataValue.from_payload(doc)
        value.pk = pk
        value.uuid = node["uuid"]
        return value

    def incoming(self, pk: int, link_type: LinkType | None = None
                 ) -> list[tuple[int, str, str]]:
        q = "SELECT in_id, link_type, label FROM links WHERE out_id=?"
        args: list[Any] = [pk]
        if link_type:
            q += " AND link_type=?"
            args.append(link_type.value)
        return [(r["in_id"], r["link_type"], r["label"])
                for r in self._conn().execute(q, args)]

    def outgoing(self, pk: int, link_type: LinkType | None = None
                 ) -> list[tuple[int, str, str]]:
        q = "SELECT out_id, link_type, label FROM links WHERE in_id=?"
        args: list[Any] = [pk]
        if link_type:
            q += " AND link_type=?"
            args.append(link_type.value)
        return [(r["out_id"], r["link_type"], r["label"])
                for r in self._conn().execute(q, args)]

    def links_for(self, pks: Iterable[int], direction: str = "both"
                  ) -> list[tuple[int, int, str, str]]:
        """Every link touching the given nodes, as (in_id, out_id, type,
        label) tuples — the batched traversal primitive that replaces
        per-node ``incoming``/``outgoing`` calls. ``direction`` is
        ``"in"`` (links *into* the pks), ``"out"`` (links *out of* them)
        or ``"both"``; each link appears once even when both endpoints
        are in the selection."""
        if direction not in ("in", "out", "both"):
            raise ValueError(f"bad direction {direction!r}")
        pks = list({int(p) for p in pks})
        match_cols = {"in": ("out_id",), "out": ("in_id",),
                      "both": ("in_id", "out_id")}[direction]
        seen: dict[int, tuple[int, int, str, str]] = {}
        conn = self._conn()
        for col in match_cols:
            for chunk in _chunks(pks):
                marks = ",".join("?" * len(chunk))
                for r in conn.execute(
                        "SELECT pk, in_id, out_id, link_type, label"
                        f" FROM links WHERE {col} IN ({marks})", chunk):
                    seen[r["pk"]] = (r["in_id"], r["out_id"],
                                     r["link_type"], r["label"])
        return [seen[k] for k in sorted(seen)]

    def count_nodes(self, node_type: NodeType | None = None) -> int:
        if node_type is None:
            return self._conn().execute(
                "SELECT COUNT(*) c FROM nodes").fetchone()["c"]
        return self._conn().execute(
            "SELECT COUNT(*) c FROM nodes WHERE node_type=?",
            (node_type.value,)).fetchone()["c"]

    def count_links(self) -> int:
        return self._conn().execute(
            "SELECT COUNT(*) c FROM links").fetchone()["c"]

    def unfinished_processes(self) -> list[dict]:
        rows = self._conn().execute(
            f"SELECT {', '.join(SUMMARY_COLUMNS)} FROM nodes"
            " WHERE node_type LIKE 'process%' AND"
            " process_state NOT IN ('finished','excepted','killed')"
        ).fetchall()
        return [dict(r) for r in rows]


class QueryBuilder:
    """Minimal, composable query interface over the provenance graph —
    the criterion-(iv) 'easily queryable' surface."""

    def __init__(self, store: ProvenanceStore):
        self.store = store
        self._wheres: list[str] = []
        self._args: list[Any] = []
        self._order = "pk"
        self._limit: int | None = None
        self._cols: tuple[str, ...] | None = None

    def nodes(self, node_type: NodeType | str | None = None) -> "QueryBuilder":
        if node_type is not None:
            t = node_type.value if isinstance(node_type, NodeType) else node_type
            self._wheres.append("node_type LIKE ?")
            self._args.append(f"{t}%")
        return self

    def with_node_types(self, node_types: Iterable[NodeType | str]
                        ) -> "QueryBuilder":
        """Exact node-type membership (no prefix matching)."""
        types = [t.value if isinstance(t, NodeType) else t
                 for t in node_types]
        marks = ",".join("?" * len(types))
        self._wheres.append(f"node_type IN ({marks})")
        self._args.extend(types)
        return self

    def with_null_hash(self) -> "QueryBuilder":
        """Nodes with no input fingerprint (legacy / invalidated)."""
        self._wheres.append("node_hash IS NULL")
        return self

    def with_process_type(self, process_type: str) -> "QueryBuilder":
        self._wheres.append("process_type=?")
        self._args.append(process_type)
        return self

    def with_hash(self, node_hash: str) -> "QueryBuilder":
        self._wheres.append("node_hash=?")
        self._args.append(node_hash)
        return self

    def with_state(self, state: str) -> "QueryBuilder":
        self._wheres.append("process_state=?")
        self._args.append(state)
        return self

    def with_exit_status(self, status: int) -> "QueryBuilder":
        self._wheres.append("exit_status=?")
        self._args.append(status)
        return self

    def with_label(self, label: str) -> "QueryBuilder":
        self._wheres.append("label=?")
        self._args.append(label)
        return self

    def created_after(self, ts: float) -> "QueryBuilder":
        self._wheres.append("ctime>=?")
        self._args.append(ts)
        return self

    def order_by(self, field: str, desc: bool = False) -> "QueryBuilder":
        assert field in ("pk", "ctime", "mtime")
        self._order = field + (" DESC" if desc else "")
        return self

    def limit(self, n: int) -> "QueryBuilder":
        self._limit = n
        return self

    def project(self, *columns: str) -> "QueryBuilder":
        """Fetch only these columns (``pk`` is always included) — hot
        listings skip the bulk ``payload``/``checkpoint`` text."""
        if not columns:
            raise ValueError("project() needs at least one column")
        cols = columns if "pk" in columns else ("pk", *columns)
        _cols_sql(cols)  # validate names
        self._cols = cols
        return self

    def all(self) -> list[dict]:
        q = f"SELECT {_cols_sql(self._cols)} FROM nodes"
        if self._wheres:
            q += " WHERE " + " AND ".join(self._wheres)
        q += f" ORDER BY {self._order}"
        # `is not None`, not truthiness: limit(0) means "no rows", not
        # "no limit"
        if self._limit is not None:
            q += f" LIMIT {int(self._limit)}"
        return [dict(r) for r in self.store._conn().execute(q, self._args)]

    def count(self) -> int:
        q = "SELECT COUNT(*) c FROM nodes"
        if self._wheres:
            q += " WHERE " + " AND ".join(self._wheres)
        return self.store._conn().execute(q, self._args).fetchone()["c"]

    def first(self) -> dict | None:
        """The first matching row (or None) — does not clobber a limit
        set earlier on this builder."""
        saved = self._limit
        try:
            self._limit = 1
            res = self.all()
        finally:
            self._limit = saved
        return res[0] if res else None


# ---------------------------------------------------------------------------
# Global store configuration (one per python instance, like AiiDA profiles)
# ---------------------------------------------------------------------------

_STORE: ProvenanceStore | None = None


def configure_store(path: str = ":memory:") -> ProvenanceStore:
    global _STORE
    _STORE = ProvenanceStore(path)
    return _STORE


def current_store() -> ProvenanceStore:
    global _STORE
    if _STORE is None:
        _STORE = ProvenanceStore(":memory:")
    return _STORE
