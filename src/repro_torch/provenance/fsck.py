"""``fsck(store, repair=...)`` — offline self-healing for a profile.

The chaos invariant checker (:mod:`repro_torch.chaos.invariants`) *judges* a
store; this module *fixes* one. It covers the corruption classes a
half-dead deployment can leave behind — a worker fleet wiped out past the
broker's requeue horizon, a broker database deleted, a kill -9 landing
between two stores' commits — and the housekeeping debt the engine never
pays on the hot path (unreferenced repository blobs).

Findings and repairs:

``orphan``
    A non-terminal process with no live lease and no pending task row in
    the broker database (or no broker database at all): nothing will ever
    run it again. Repair: if it still has a checkpoint AND a broker
    database was given, enqueue a fresh ``ready`` task row — the next
    daemon delivers it at a bumped epoch and the process resumes; without
    a checkpoint (or without a broker) it is marked ``excepted`` with
    exit status 999 and a terminal state-history entry, so waiters and
    queries see a truthful terminal record instead of a forever-pending
    ghost.

``stale-checkpoint``
    A terminal process still carrying a checkpoint (the terminal
    transaction tore before checkpoint removal landed, or a legacy bug).
    Repair: NULL the checkpoint — a terminal process must never be
    resumable.

``dangling-link``
    A link row whose endpoint node does not exist. Repair: delete the
    link row.

``unreferenced-blob``
    A repository blob no payload references (deleted nodes, crashed
    half-writes, superseded cache clones). Repair: delete the blob —
    closes the ROADMAP blob-GC follow-up. Reference scanning walks every
    payload's ``blob`` / ``blobs`` fields, so a blob is only collected
    when *no* row points at it.

Everything runs as raw SQL over the store (and optionally the broker
sqlite), independent of the engine code paths being repaired, and is
idempotent: a second ``fsck --repair`` over a repaired profile finds
nothing.
"""

from __future__ import annotations

import json
import os
import sqlite3
import time
from dataclasses import dataclass, field

from repro_torch.core.statemachine import TERMINAL_STATES

#: mirror of repro_torch.engine.daemon.PROCESS_QUEUE without importing the
#: engine (fsck must work on a profile with no engine running)
PROCESS_QUEUE = "process.queue"

STATE_HISTORY_ATTR = "state_history"

_TERMINAL = tuple(s.value for s in TERMINAL_STATES)


@dataclass
class FsckFinding:
    kind: str
    pk: int | None
    detail: str
    #: what --repair did ("" when running detect-only)
    action: str = ""

    def __str__(self) -> str:  # pragma: no cover - formatting
        where = f"pk={self.pk}: " if self.pk is not None else ""
        fixed = f" -> {self.action}" if self.action else ""
        return f"[{self.kind}] {where}{self.detail}{fixed}"


@dataclass
class FsckReport:
    findings: list[FsckFinding] = field(default_factory=list)
    repaired: bool = False
    checked_processes: int = 0
    checked_links: int = 0
    checked_blobs: int = 0
    notes: list[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    def add(self, kind: str, pk: int | None, detail: str,
            action: str = "") -> FsckFinding:
        finding = FsckFinding(kind, pk, detail, action)
        self.findings.append(finding)
        return finding

    def summary(self) -> str:
        verb = "repaired" if self.repaired else "found"
        lines = [
            f"processes checked : {self.checked_processes}",
            f"links checked     : {self.checked_links}",
            f"blobs checked     : {self.checked_blobs}",
            f"findings ({verb}) : {len(self.findings)}"
            + ("  " + ", ".join(f"{k}={v}"
                                for k, v in sorted(self.counts().items()))
               if self.findings else ""),
        ]
        for note in self.notes:
            lines.append(f"note: {note}")
        for f in self.findings[:100]:
            lines.append(f"  - {f}")
        if len(self.findings) > 100:
            lines.append(f"  ... and {len(self.findings) - 100} more")
        return "\n".join(lines)


def _live_pks_from_broker(broker_db: str) -> tuple[set[int], bool]:
    """pks the broker still intends to run: held leases + any pending
    (ready or inflight) task row in the process queue. Returns
    ``(pks, available)`` — ``available=False`` when the broker database
    could not be read (fsck then assumes nothing is live)."""
    if not broker_db or not os.path.exists(broker_db):
        return set(), False
    live: set[int] = set()
    try:
        conn = sqlite3.connect(broker_db, timeout=10.0)
        conn.row_factory = sqlite3.Row
        try:
            for row in conn.execute(
                    "SELECT pk FROM leases WHERE worker IS NOT NULL"):
                live.add(int(row["pk"]))
            for row in conn.execute(
                    "SELECT payload FROM tasks WHERE queue=?",
                    (PROCESS_QUEUE,)):
                try:
                    payload = json.loads(row["payload"])
                except ValueError:
                    continue
                if isinstance(payload, dict) and "pk" in payload:
                    live.add(int(payload["pk"]))
        finally:
            conn.close()
    except sqlite3.Error:
        return set(), False
    return live, True


def _requeue(broker_db: str, pk: int) -> None:
    """Insert one fresh ready task row — the standard delivery path then
    grants a (bumped) lease epoch when a worker picks it up."""
    conn = sqlite3.connect(broker_db, timeout=10.0)
    try:
        conn.execute(
            "INSERT INTO tasks (queue, payload, state, created_at)"
            " VALUES (?, ?, 'ready', ?)",
            (PROCESS_QUEUE, json.dumps({"pk": pk, "ts": time.time()}),
             time.time()))
        conn.commit()
    finally:
        conn.close()


def _mark_excepted(conn: sqlite3.Connection, pk: int, attrs: dict,
                   detail: str) -> None:
    """Terminal-ize an unrecoverable orphan: excepted, exit 999, history
    closed with a terminal entry, checkpoint removed — the same shape a
    live EXCEPTED transition writes, so every invariant holds after."""
    history = list(attrs.get(STATE_HISTORY_ATTR) or [])
    history.append(["excepted", time.time()])
    attrs = dict(attrs)
    attrs[STATE_HISTORY_ATTR] = history
    attrs.pop("paused", None)
    conn.execute(
        "UPDATE nodes SET process_state='excepted', exit_status=999,"
        " exit_message=?, checkpoint=NULL, attributes=? WHERE pk=?",
        (f"fsck: {detail}", json.dumps(attrs), pk))


def fsck(store, *, repair: bool = False,
         broker_db: str | None = None) -> FsckReport:
    """Scan ``store`` for the four corruption classes; with ``repair``,
    fix each finding in place. ``broker_db`` (the daemon's broker sqlite)
    enables live-lease detection and checkpoint requeue — without it
    every non-terminal process counts as orphaned and repair can only
    mark them excepted."""
    report = FsckReport(repaired=repair)
    live, broker_ok = _live_pks_from_broker(broker_db or "")
    if broker_db and not broker_ok:
        report.notes.append(
            f"broker db {broker_db!r} unreadable; assuming no live leases")
    if not broker_db:
        report.notes.append(
            "no broker db given: every non-terminal process counts as "
            "orphaned and repair marks them excepted (no requeue target)")

    with store._lock:
        conn = store._conn()

        # -- 1. orphaned non-terminal processes ----------------------------
        rows = conn.execute(
            "SELECT pk, process_state, checkpoint, attributes FROM nodes"
            " WHERE node_type LIKE 'process%'").fetchall()
        report.checked_processes = len(rows)
        marks = ",".join("?" * len(_TERMINAL))
        for row in rows:
            state = row["process_state"]
            if state in _TERMINAL:
                continue
            pk = row["pk"]
            if pk in live:
                continue
            has_ckpt = row["checkpoint"] is not None
            detail = (f"non-terminal (state={state!r}) with no live lease "
                      f"and no pending task")
            finding = report.add("orphan", pk, detail)
            if not repair:
                continue
            if has_ckpt and broker_ok:
                _requeue(broker_db, pk)
                finding.action = "requeued from checkpoint"
            else:
                try:
                    attrs = json.loads(row["attributes"] or "{}")
                except ValueError:
                    attrs = {}
                _mark_excepted(conn, pk, attrs,
                               "orphaned with no recoverable checkpoint"
                               if not has_ckpt else
                               "orphaned and no broker to requeue into")
                finding.action = "marked excepted (exit 999)"

        # -- 2. stale checkpoints of terminal processes --------------------
        for row in conn.execute(
                f"SELECT pk, process_state FROM nodes WHERE node_type LIKE"
                f" 'process%' AND process_state IN ({marks})"
                " AND checkpoint IS NOT NULL", list(_TERMINAL)).fetchall():
            finding = report.add(
                "stale-checkpoint", row["pk"],
                f"terminal (state={row['process_state']!r}) but still "
                "checkpointed")
            if repair:
                conn.execute("UPDATE nodes SET checkpoint=NULL WHERE pk=?",
                             (row["pk"],))
                finding.action = "checkpoint removed"

        # -- 3. dangling links ---------------------------------------------
        report.checked_links = conn.execute(
            "SELECT COUNT(*) AS n FROM links").fetchone()["n"]
        for col in ("in_id", "out_id"):
            for row in conn.execute(
                    f"SELECT l.rowid AS rid, l.{col} AS pk, l.link_type"
                    f" FROM links l LEFT JOIN nodes n ON n.pk = l.{col}"
                    " WHERE n.pk IS NULL").fetchall():
                finding = report.add(
                    "dangling-link", row["pk"],
                    f"{row['link_type']} link references missing node "
                    f"via {col}")
                if repair:
                    conn.execute("DELETE FROM links WHERE rowid=?",
                                 (row["rid"],))
                    finding.action = "link deleted"

        # -- 4. unreferenced repository blobs ------------------------------
        referenced: set[str] = set()
        for row in conn.execute(
                "SELECT payload FROM nodes WHERE payload IS NOT NULL"
                " AND payload LIKE '%blob%'"):
            try:
                doc = json.loads(row["payload"])
            except ValueError:
                continue
            if not isinstance(doc, dict):
                continue
            digest = doc.get("blob")
            if isinstance(digest, str):
                referenced.add(digest)
            blobs = doc.get("blobs")
            if isinstance(blobs, dict):
                referenced.update(d for d in blobs.values()
                                  if isinstance(d, str))
        for digest in list(store.repository.digests()):
            report.checked_blobs += 1
            if digest in referenced:
                continue
            finding = report.add(
                "unreferenced-blob", None,
                f"blob {digest[:12]}… referenced by no payload")
            if repair:
                store.repository.delete(digest)
                finding.action = "blob deleted"

        if repair:
            conn.commit()
    return report
