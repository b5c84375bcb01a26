"""Fault-point registry: deterministic, seeded fault injection.

A *fault point* is a named seam in the engine where the paper claims the
system survives a failure (``store.commit.pre``, ``broker.ack.pre``, …).
The instrumented code calls :func:`fault_point` at each seam; when a
:class:`ChaosPlan` is active and one of its rules matches, the plan fires
an *action*:

``crash``      ``os._exit`` — the seam's OS process dies instantly, like
               a kill -9 at exactly that instruction.
``raise``      raise :class:`ChaosInjected` — exercises exception paths
               (e.g. a store transaction rollback mid-commit).
``delay``      sleep for ``delay`` seconds — simulates a stalled fsync or
               a slow network without killing anything.
``duplicate``  *cooperative*: :func:`fault_point` returns the string
               ``"duplicate"`` and the seam re-sends the frame (broker
               task delivery).
``drop``       *cooperative*: returns ``"drop"`` and the seam swallows
               the frame (broker broadcast fan-out — a partition).

Triggers are deterministic under a seed: ``nth`` fires on exactly the
n-th hit of the rule, ``once`` on the first, ``p`` fires per-hit from a
``random.Random(seed)`` stream (optionally capped with ``max``), and no
trigger at all means every hit fires.

Activation: programmatic (``activate(plan)``) or the ``REPRO_CHAOS`` env
spec, which is how the harness arms *spawned daemon workers* — they
inherit the environment across the multiprocessing spawn boundary and
resolve their own plan on first hit:

    REPRO_CHAOS="seed=7;store.commit.pre:crash:nth=5;broker.broadcast.pre:drop:p=0.5,max=40"

Disabled path: one module-global load + ``None`` check (the tracer's
trick), so the seams stay in the hot paths permanently. obs_bench.py
asserts the overhead bar in CI.
"""

from __future__ import annotations

import fnmatch
import os
import random
import sys
import time
from typing import Any

ENV_VAR = "REPRO_CHAOS"

#: default exit code for crash actions — distinctive in worker exitcodes
CRASH_EXIT_CODE = 113

#: every fault point threaded through the codebase. The lint
#: (scripts/check_fault_points.py) asserts this catalog, the
#: ``fault_point("…")`` call sites and docs/chaos.md all agree, so a seam
#: rename cannot silently orphan a scenario.
CATALOG: dict[str, str] = {
    "store.commit.pre": (
        "inside ProvenanceStore just before a transaction (or standalone "
        "write) commits — a crash here loses the whole unit of work"),
    "store.commit.post": (
        "immediately after a store commit returns — durable, but nothing "
        "downstream (broadcast, ack) has happened yet"),
    "process.flush.pre": (
        "engine-step-vs-store-flush seam: the step mutated in-memory "
        "state but _flush_provenance has not written it yet"),
    "process.flush.post": (
        "after a checkpoint flush committed — the narrow window between "
        "durability and the process continuing"),
    "process.terminal.pre": (
        "process body finished, terminal transaction (outputs + final "
        "state + checkpoint removal) not yet started"),
    "daemon.checkpoint.pre": (
        "daemon task handler about to load the checkpoint for a "
        "delivered pk"),
    "daemon.checkpoint.post": (
        "checkpoint loaded and process rematerialized, stepping about "
        "to begin — the canonical kill-9-mid-step moment"),
    "broker.ack.pre": (
        "worker finished a task but has not acked it — a crash here "
        "forces redelivery of an already-completed process"),
    "broker.commit.pre": (
        "broker server about to commit its batched task-table state"),
    "broker.deliver.pre": (
        "broker server delivering one task frame; supports the "
        "'duplicate' directive (same frame sent twice)"),
    "broker.broadcast.pre": (
        "broker server fanning one broadcast batch to one client; "
        "supports the 'drop' directive (a partition)"),
    "lease.expire": (
        "broker reaper (or client drop) expiring a lapsed process lease — "
        "the pk is about to be requeued and its next grant epoch-bumped"),
    "broker.restart": (
        "daemon supervisor about to respawn a dead broker process on its "
        "old port; the replacement rebuilds state from the broker sqlite"),
}

_ACTIONS = ("crash", "raise", "delay", "duplicate", "drop")


class ChaosInjected(RuntimeError):
    """The exception a ``raise`` action throws at a fault point."""


class _Rule:
    __slots__ = ("point", "action", "nth", "prob", "once", "max_fires",
                 "delay", "exit_code", "hits", "fires")

    def __init__(self, point: str, action: str, *, nth: int | None = None,
                 p: float | None = None, once: bool = False,
                 max_fires: int | None = None, delay: float = 0.05,
                 exit_code: int = CRASH_EXIT_CODE):
        if action not in _ACTIONS:
            raise ValueError(f"unknown chaos action {action!r}; "
                             f"expected one of {_ACTIONS}")
        is_pattern = any(ch in point for ch in "*?[")
        if not is_pattern and point not in CATALOG:
            raise ValueError(f"unknown fault point {point!r}; known: "
                             f"{sorted(CATALOG)}")
        if is_pattern and not any(fnmatch.fnmatch(n, point)
                                  for n in CATALOG):
            raise ValueError(f"pattern {point!r} matches no fault point")
        self.point = point
        self.action = action
        self.nth = nth
        self.prob = p
        self.once = once
        self.max_fires = max_fires
        self.delay = delay
        self.exit_code = exit_code
        self.hits = 0
        self.fires = 0

    def matches(self, point: str) -> bool:
        return self.point == point or fnmatch.fnmatch(point, self.point)

    def should_fire(self, rng: random.Random) -> bool:
        self.hits += 1
        if self.once and self.fires:
            return False
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.nth is not None:
            return self.hits == self.nth
        if self.prob is not None:
            # one draw per hit keeps the stream deterministic per seed
            return rng.random() < self.prob
        return True

    def spec(self) -> str:
        opts = []
        if self.nth is not None:
            opts.append(f"nth={self.nth}")
        if self.prob is not None:
            opts.append(f"p={self.prob}")
        if self.once:
            opts.append("once")
        if self.max_fires is not None:
            opts.append(f"max={self.max_fires}")
        if self.action == "delay" and self.delay != 0.05:
            opts.append(f"delay={self.delay}")
        if self.exit_code != CRASH_EXIT_CODE:
            opts.append(f"exit={self.exit_code}")
        clause = f"{self.point}:{self.action}"
        return clause + (":" + ",".join(opts) if opts else "")


class ChaosPlan:
    """A seeded set of fault rules. Deterministic: the same plan spec +
    seed makes the same fire/no-fire decisions in the same hit order."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rules: list[_Rule] = []
        self._rng = random.Random(seed)
        #: point -> number of times a rule fired there (any action)
        self.fired: dict[str, int] = {}

    def on(self, point: str, action: str, **kw) -> "ChaosPlan":
        """Add a rule (chainable). Keywords: ``nth``, ``p``, ``once``,
        ``max`` (alias ``max_fires``), ``delay``, ``exit_code``."""
        if "max" in kw:  # mirror the env-spec option name
            kw["max_fires"] = kw.pop("max")
        self.rules.append(_Rule(point, action, **kw))
        return self

    # -- the hot call ------------------------------------------------------
    def hit(self, point: str, ctx: dict) -> str | None:
        directive = None
        for rule in self.rules:
            if not rule.matches(point):
                continue
            if not rule.should_fire(self._rng):
                continue
            rule.fires += 1
            self.fired[point] = self.fired.get(point, 0) + 1
            if rule.action == "crash":
                sys.stderr.write(
                    f"CHAOS: crash at {point} (pid {os.getpid()}, "
                    f"ctx {ctx})\n")
                sys.stderr.flush()
                os._exit(rule.exit_code)
            elif rule.action == "raise":
                raise ChaosInjected(f"chaos: injected failure at {point}")
            elif rule.action == "delay":
                time.sleep(rule.delay)
            else:  # duplicate / drop — cooperative, the seam acts on it
                directive = rule.action
        return directive

    # -- (de)serialization -------------------------------------------------
    def spec(self) -> str:
        return ";".join([f"seed={self.seed}"] +
                        [r.spec() for r in self.rules])

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        """Parse a ``REPRO_CHAOS`` spec string; see the module docstring
        for the grammar."""
        seed = 0
        clauses = []
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed="):
                seed = int(raw[5:])
            else:
                clauses.append(raw)
        plan = cls(seed=seed)
        for clause in clauses:
            parts = clause.split(":")
            if len(parts) not in (2, 3):
                raise ValueError(f"bad chaos clause {clause!r}; expected "
                                 "point:action[:k=v,...]")
            point, action = parts[0], parts[1]
            kw: dict[str, Any] = {}
            if len(parts) == 3:
                for opt in parts[2].split(","):
                    opt = opt.strip()
                    if not opt:
                        continue
                    if opt == "once":
                        kw["once"] = True
                        continue
                    key, _, val = opt.partition("=")
                    if key == "nth":
                        kw["nth"] = int(val)
                    elif key == "p":
                        kw["p"] = float(val)
                    elif key == "max":
                        kw["max_fires"] = int(val)
                    elif key == "delay":
                        kw["delay"] = float(val)
                    elif key == "exit":
                        kw["exit_code"] = int(val)
                    else:
                        raise ValueError(f"unknown chaos option {opt!r}")
            plan.on(point, action, **kw)
        return plan


# ---------------------------------------------------------------------------
# Module-level activation (the near-zero disabled path)
# ---------------------------------------------------------------------------

_PLAN: ChaosPlan | None = None
_resolved = False


def _resolve() -> ChaosPlan | None:
    global _PLAN, _resolved
    _resolved = True
    spec = os.environ.get(ENV_VAR)
    if spec:
        _PLAN = ChaosPlan.parse(spec)
    return _PLAN


def fault_point(name: str, **ctx: Any) -> str | None:
    """The seam hook. Returns a cooperative directive (``"duplicate"`` /
    ``"drop"``) when a matching rule fired with one, else None; may also
    raise :class:`ChaosInjected`, sleep, or never return (crash).

    Disabled (no plan, no ``REPRO_CHAOS``): one global load, one ``if``,
    one return — safe to leave on every hot path."""
    plan = _PLAN
    if plan is None:
        if _resolved:
            return None
        plan = _resolve()
        if plan is None:
            return None
    return plan.hit(name, ctx)


def activate(plan: ChaosPlan) -> None:
    """Arm a plan in this process (overrides the env)."""
    global _PLAN, _resolved
    _PLAN = plan
    _resolved = True


def deactivate() -> None:
    """Disarm chaos in this process *even if* ``REPRO_CHAOS`` is set —
    the harness calls this so only its spawned workers are armed."""
    global _PLAN, _resolved
    _PLAN = None
    _resolved = True


def reset() -> None:
    """Back to lazy env-resolved state (tests)."""
    global _PLAN, _resolved
    _PLAN = None
    _resolved = False


def active_plan() -> ChaosPlan | None:
    return _PLAN
