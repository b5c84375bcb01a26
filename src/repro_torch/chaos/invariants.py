"""Post-chaos provenance invariant checker (the paper's robustness claim,
made checkable).

After any amount of fault injection — kill -9 mid-step, crashes inside
store transactions, dropped broker frames, duplicated deliveries — the
provenance store must still satisfy a fixed set of invariants. A scenario
"passes" only if every one of them holds:

1. **No lost processes** — every submitted pk exists and (once the system
   quiesces) is in a terminal state.
2. **No resurrected processes** — a process's recorded state history never
   contains an entry after a terminal state.
3. **Terminal ⇒ no checkpoint** — the terminal transaction removes the
   checkpoint atomically with the final state; a terminal node with a
   checkpoint means that transaction tore.
4. **Outputs exactly once** — no output label emitted twice by the same
   process, no data node created by two processes, no child called by two
   parents (the duplicated-delivery scenarios aim squarely at this).
5. **Referential integrity** — every link endpoint is an existing node.
6. **Monotone history** — state-history timestamps are non-decreasing
   (small tolerance for cross-worker clock jitter).
7. **Finished ⇒ exit_status recorded**; **kill_requested ⇒ terminal**.

All checks run as raw SQL/JSON over the store — independent of the engine
code paths whose correctness they judge.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from repro_torch.engine.runner import TERMINAL

STATE_HISTORY_ATTR = "state_history"

#: allowed backwards clock drift between consecutive history entries
#: (entries are stamped by different OS processes across restarts)
_CLOCK_TOLERANCE = 0.25


@dataclass
class Violation:
    invariant: str
    pk: int | None
    detail: str

    def __str__(self) -> str:  # pragma: no cover - formatting
        where = f"pk={self.pk}: " if self.pk is not None else ""
        return f"[{self.invariant}] {where}{self.detail}"


@dataclass
class InvariantReport:
    violations: list[Violation] = field(default_factory=list)
    checked_processes: int = 0
    checked_links: int = 0
    expected: int = 0
    states: dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def add(self, invariant: str, pk: int | None, detail: str) -> None:
        self.violations.append(Violation(invariant, pk, detail))

    def summary(self) -> str:
        lines = [
            f"processes checked : {self.checked_processes}"
            + (f" (expected {self.expected})" if self.expected else ""),
            f"links checked     : {self.checked_links}",
            "states            : " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.states.items())),
            f"violations        : {len(self.violations)}",
        ]
        for v in self.violations[:50]:
            lines.append(f"  - {v}")
        if len(self.violations) > 50:
            lines.append(f"  ... and {len(self.violations) - 50} more")
        return "\n".join(lines)


def check_store(store, expected_pks=None, *,
                expect_terminal: bool = True) -> InvariantReport:
    """Run every invariant against ``store``. ``expected_pks`` are the
    processes the caller submitted (lost-process detection); with
    ``expect_terminal`` they must also have reached a terminal state."""
    report = InvariantReport()
    expected = sorted(set(expected_pks or ()))
    report.expected = len(expected)
    with store._lock:
        conn = store._conn()

        # -- process census -------------------------------------------------
        rows = conn.execute(
            "SELECT pk, node_type, process_state, exit_status, checkpoint,"
            " attributes FROM nodes WHERE node_type LIKE 'process%'"
        ).fetchall()
        procs = {r["pk"]: r for r in rows}
        report.checked_processes = len(procs)
        for row in rows:
            state = row["process_state"] or "?"
            report.states[state] = report.states.get(state, 0) + 1

        # 1. no lost processes
        for pk in expected:
            row = procs.get(pk)
            if row is None:
                report.add("lost", pk, "submitted process has no node")
            elif expect_terminal and row["process_state"] not in TERMINAL:
                report.add("lost", pk,
                           f"not terminal: state={row['process_state']!r}")

        for pk, row in procs.items():
            state = row["process_state"]
            terminal = state in TERMINAL

            # 3. terminal ⇒ checkpoint removed
            if terminal and row["checkpoint"] is not None:
                report.add("terminal-checkpoint", pk,
                           f"state={state!r} but checkpoint survives")

            # 7a. finished ⇒ exit_status recorded
            if state == "finished" and row["exit_status"] is None:
                report.add("exit-status", pk, "finished with NULL exit_status")

            try:
                attrs = json.loads(row["attributes"] or "{}")
            except ValueError:
                report.add("attributes", pk, "attributes not valid JSON")
                continue

            # 7b. durably-requested kill must not be outrun
            if attrs.get("kill_requested") is not None and not terminal:
                report.add("kill-durability", pk,
                           f"kill requested but state={state!r}")

            # 2 + 6. state history: monotone, nothing after terminal
            history = attrs.get(STATE_HISTORY_ATTR) or []
            seen_terminal = None
            last_ts = None
            for entry in history:
                st, ts = entry[0], entry[1]
                if seen_terminal is not None:
                    report.add("resurrected", pk,
                               f"state {st!r} recorded after terminal "
                               f"{seen_terminal!r}")
                    break
                if st in TERMINAL:
                    seen_terminal = st
                if last_ts is not None and ts < last_ts - _CLOCK_TOLERANCE:
                    report.add("history-monotone", pk,
                               f"timestamp regressed {last_ts:.3f} -> {ts:.3f}")
                last_ts = ts
            if terminal and history and seen_terminal is None:
                report.add("resurrected", pk,
                           f"state={state!r} but history never records a "
                           "terminal entry")

        # -- link integrity ------------------------------------------------
        report.checked_links = conn.execute(
            "SELECT COUNT(*) AS n FROM links").fetchone()["n"]

        # 5. every endpoint exists
        for col in ("in_id", "out_id"):
            for row in conn.execute(
                    f"SELECT l.{col} AS pk, l.link_type FROM links l "
                    f"LEFT JOIN nodes n ON n.pk = l.{col} "
                    "WHERE n.pk IS NULL").fetchall():
                report.add("dangling-link", row["pk"],
                           f"{row['link_type']} link references missing "
                           f"node via {col}")

        # 4a. same process emits the same output label twice
        for row in conn.execute(
                "SELECT in_id, link_type, label, COUNT(*) AS n FROM links "
                "WHERE link_type IN ('create', 'return') "
                "GROUP BY in_id, link_type, label HAVING n > 1").fetchall():
            report.add("duplicate-output", row["in_id"],
                       f"{row['link_type']} link {row['label']!r} emitted "
                       f"{row['n']} times")

        # 4b. a data node created by more than one process
        for row in conn.execute(
                "SELECT out_id, COUNT(*) AS n FROM links "
                "WHERE link_type = 'create' "
                "GROUP BY out_id HAVING n > 1").fetchall():
            report.add("duplicate-create", row["out_id"],
                       f"data node created by {row['n']} processes")

        # 4c. a child process called by more than one parent
        for row in conn.execute(
                "SELECT out_id, COUNT(*) AS n FROM links "
                "WHERE link_type IN ('call_calc', 'call_work') "
                "GROUP BY out_id HAVING n > 1").fetchall():
            report.add("duplicate-call", row["out_id"],
                       f"process called by {row['n']} parents")

    return report
