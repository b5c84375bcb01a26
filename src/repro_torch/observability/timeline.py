"""Persisted process timelines: span storage + wall-clock rendering.

A finished process's spans are serialized into ONE log row (levelname
``TRACE``) written inside the process's terminal store transaction — the
timeline rides the existing unit of work, so the ~2-commits-per-process
budget (asserted by ``store_bench --smoke``) is unchanged, and archives
carry timelines for free because log rows already travel.

``repro process report <pk>`` renders two views from here:

* the **span timeline** — an indented tree with per-span bars positioned
  on the process's wall clock (where did the time go?);
* the **state dwell table** — per-state residence times computed from the
  ``state_history`` attribute every process now records at each state
  transition (and, for legacy rows without it, a ctime→mtime total), so
  duration information exists even for runs traced with ``REPRO_TRACE=0``.
"""

from __future__ import annotations

import json
from typing import Any, Mapping, Sequence

TRACE_LEVELNAME = "TRACE"
STATE_HISTORY_ATTR = "state_history"


# ---------------------------------------------------------------------------
# Persistence (the TRACE log row)
# ---------------------------------------------------------------------------

def serialize_spans(spans: Sequence[Mapping[str, Any]]) -> str:
    """Normalize drained span dicts to a compact document: starts become
    offsets (seconds) from the earliest span, so the perf-counter origin
    never leaks out of the producing OS process."""
    if not spans:
        return json.dumps({"v": 1, "spans": []})
    t0 = min(s["start"] for s in spans)
    norm = []
    for s in spans:
        d = {"name": s["name"], "id": s["id"], "parent": s.get("parent"),
             "start": round(s["start"] - t0, 6),
             "dur": round(max(0.0, s["end"] - s["start"]), 6)}
        if s.get("attrs"):
            d["attrs"] = s["attrs"]
        norm.append(d)
    return json.dumps({"v": 1, "spans": norm}, separators=(",", ":"))


def load_spans(store, pk: int) -> list[dict]:
    """The persisted timeline of a process (last TRACE row wins), as
    normalized span dicts; [] when the process was never traced."""
    doc = None
    for log in store.get_logs(pk):
        if log["levelname"] == TRACE_LEVELNAME:
            doc = log["message"]
    if doc is None:
        return []
    try:
        return json.loads(doc).get("spans", [])
    except (ValueError, AttributeError):
        return []


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def _fmt_dur(seconds: float) -> str:
    if seconds < 0.001:
        return f"{seconds * 1e6:.0f}us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.1f}ms"
    return f"{seconds:.2f}s"


def render_timeline(spans: Sequence[Mapping[str, Any]],
                    width: int = 30) -> str:
    """ASCII tree of spans with bars on the process's wall clock."""
    if not spans:
        return "(no spans recorded — run with REPRO_TRACE=1)"
    total = max(s["start"] + s["dur"] for s in spans) or 1e-9
    children: dict[Any, list[dict]] = {}
    ids = {s["id"] for s in spans}
    roots: list[dict] = []
    for s in sorted(spans, key=lambda s: (s["start"], s["id"])):
        parent = s.get("parent")
        if parent in ids:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    lines: list[str] = []

    def emit(s: Mapping[str, Any], depth: int) -> None:
        label = ("  " * depth + s["name"])[:38]
        lo = int(s["start"] / total * width)
        hi = max(lo + 1, int((s["start"] + s["dur"]) / total * width))
        bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
        lines.append(f"  {label:38} {_fmt_dur(s['dur']):>8} |{bar}|")
        for c in children.get(s["id"], []):
            emit(c, depth + 1)

    for root in roots:
        emit(root, 0)
    lines.append(f"  {'total':38} {_fmt_dur(total):>8}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# State dwell times
# ---------------------------------------------------------------------------

def state_dwell(node: Mapping[str, Any]) -> list[tuple[str, float]]:
    """Per-state residence times for one node row, from its recorded
    ``state_history`` attribute ([state, wall-ts] pairs). Falls back to a
    single ctime→mtime total for legacy rows that predate the attribute.
    Repeated visits to a state (pause/play cycles) are summed."""
    try:
        attrs = node.get("attributes")
        if isinstance(attrs, str):
            attrs = json.loads(attrs or "{}")
        history = (attrs or {}).get(STATE_HISTORY_ATTR)
    except ValueError:
        history = None
    if not history:
        total = max(0.0, (node.get("mtime") or 0) - (node.get("ctime") or 0))
        state = node.get("process_state") or "?"
        return [(f"(total, ending {state})", total)]
    entries = [(str(s), float(ts)) for s, ts in history]
    # the first recorded transition closes the CREATED dwell
    if node.get("ctime") and entries and entries[0][1] > node["ctime"]:
        entries.insert(0, ("created", float(node["ctime"])))
    out: dict[str, float] = {}
    order: list[str] = []
    for i, (state, ts) in enumerate(entries):
        nxt = entries[i + 1][1] if i + 1 < len(entries) else ts
        if state not in out:
            order.append(state)
        out[state] = out.get(state, 0.0) + max(0.0, nxt - ts)
    return [(s, out[s]) for s in order]


def render_dwell(node: Mapping[str, Any]) -> str:
    rows = state_dwell(node)
    total = sum(d for _s, d in rows) or 1e-9
    lines = []
    for state, dur in rows:
        lines.append(f"  {state:24} {_fmt_dur(dur):>8}  "
                     f"{dur / total * 100:5.1f}%")
    return "\n".join(lines)
