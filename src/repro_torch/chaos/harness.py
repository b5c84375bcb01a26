"""Chaos scenario runner: real daemon workers, real kill -9, real faults.

Each scenario spawns an actual :class:`repro_torch.engine.daemon.Daemon` (broker
process + worker OS processes), submits checkpoint-heavy workloads, then
hurts the system in a seeded, reproducible way:

* ``REPRO_CHAOS`` is exported before the daemon starts, so every spawned
  child (broker and workers) arms the same deterministic fault plan while
  the harness process itself stays disarmed (`faults.deactivate()`).
* SIGKILLs are scheduled from ``random.Random(seed)`` — same seed, same
  kill times, same victim indices.
* Durable kills follow the CLI pattern: write the ``kill_requested``
  marker first, then best-effort the live RPC.

The daemon supervisor restarts dead workers; after ``heal_restarts``
restarts the harness pops ``REPRO_CHAOS`` from the environment so
replacement workers come up clean and the system can drain. When every
submitted pk is terminal (or the timeout passes), the invariant checker
judges the store.

A scenario's clock (every offset, its timeout and its elapsed time)
starts once all of its workers have connected to the broker, not when
the daemon starts, and the workload is submitted from there: a worker
of this package imports torch and initialises CUDA before it connects,
which takes seconds, so a fault scheduled inside that start would hit
a worker that holds no lease, and the first worker up would take the
whole workload before the others connect. Waiting longer than
``WORKER_CONNECT_TIMEOUT`` fails the scenario. A scheduled SIGKILL picks
its victim among the workers that hold leases, where there are any, and
the harness reaps what it killed, so the supervisor's next pass counts
the restart. The loop wakes at each scheduled fault's offset, not at the
next quarter-second tick after it.

These four departures from ``repro.chaos.harness`` are approved; each is
needed because this package's workers take seconds to import torch and
start CUDA. The scenarios are the reference's but for one field: the
``pause`` of ``fleet-churn`` (1.0 s, so its calcs outlast the kill
window) and of ``broker-kill9`` (0.4 s, so its calcs outlast the broker
kill at 1.0 s). Their calcs drained before the first fault fired at the
reference's pauses once the clock starts at the workers' connect.
"""

from __future__ import annotations

import os
import re
import signal
import sqlite3
import random
import tempfile
import time
from dataclasses import dataclass, field

from repro_torch.chaos import faults
from repro_torch.chaos.invariants import InvariantReport, check_store
from repro_torch.engine.runner import TERMINAL

__all__ = ["Scenario", "ScenarioResult", "SCENARIOS", "run_scenario",
           "list_scenarios"]

#: seconds a scenario waits for all of its workers to connect
WORKER_CONNECT_TIMEOUT = 120.0


@dataclass
class Scenario:
    name: str
    description: str
    #: fault clauses (without the seed= prefix); None = no injected faults
    chaos: str | None = None
    workload: str = "calc"  # "calc" | "chain"
    n: int = 4
    steps: int = 4
    pause: float = 0.1
    children: int = 2  # chain workload: children per chain
    workers: int = 2
    slots: int = 10
    #: SIGKILL schedule: ``sigkills`` kills at seeded times in the window
    sigkills: int = 0
    sigkill_window: tuple[float, float] = (0.4, 2.5)
    #: zombie schedule: SIGSTOP one live worker at ``sigstop_at`` (it
    #: keeps its OS pid — the supervisor does NOT restart it), then
    #: SIGCONT it at ``sigcont_at``, after its leases lapsed and its pks
    #: were requeued — the woken zombie must fence itself on the store
    sigstop_at: float | None = None
    sigcont_at: float | None = None
    #: SIGKILL the broker OS process at this offset; the daemon
    #: supervisor must restart it on the same port
    broker_kill_at: float | None = None
    #: durable kill_requested markers written against this many pks
    durable_kills: int = 0
    kill_at: float = 0.4
    #: pop REPRO_CHAOS after this many worker restarts so the system heals
    heal_restarts: int | None = None
    env: dict = field(default_factory=dict)
    timeout: float = 90.0
    #: scenario-level expectations, checked on top of the invariants
    expect_restarts: bool = False
    expect_stats: dict = field(default_factory=dict)
    expect_killed: bool = False
    expect_broker_restarts: bool = False
    #: minimum values for durable store meta counters, e.g.
    #: {"lease.fenced_writes": 1} — proof the fencing actually fired
    expect_meta: dict = field(default_factory=dict)


@dataclass
class ScenarioResult:
    name: str
    seed: int
    workdir: str
    report: InvariantReport
    restarts: int
    broker_stats: dict
    states: dict
    elapsed: float
    failures: list = field(default_factory=list)
    broker_restarts: int = 0
    meta: dict = field(default_factory=dict)
    #: seconds from ``daemon.start()`` until all workers were connected
    #: (the scenario's clock starts there)
    connect_wait: float = 0.0

    @property
    def ok(self) -> bool:
        return self.report.ok and not self.failures

    def summary(self) -> str:
        head = "PASS" if self.ok else "FAIL"
        lines = [
            f"scenario {self.name!r} seed={self.seed}: {head} "
            f"({self.elapsed:.1f}s, {self.restarts} restarts, "
            f"{self.broker_restarts} broker restarts)",
            self.report.summary(),
        ]
        for key, val in sorted(self.meta.items()):
            lines.append(f"store meta {key:<18}: {val}")
        for key in ("chaos_duplicated", "chaos_dropped", "clients_dropped",
                    "tasks_delivered", "leases_granted", "leases_expired",
                    "stale_claims"):
            if key in self.broker_stats:
                lines.append(f"broker {key:<17}: {self.broker_stats[key]}")
        for f in self.failures:
            lines.append(f"  - [scenario] {f}")
        return "\n".join(lines)


SCENARIOS: dict[str, Scenario] = {s.name: s for s in [
    Scenario(
        name="kill9-midstep",
        description="SIGKILL live workers mid-step; supervisor restarts "
                    "them and replacements resume from checkpoints.",
        n=6, steps=6, pause=0.15,
        sigkills=3, sigkill_window=(0.5, 2.5),
        expect_restarts=True),
    Scenario(
        name="crash-in-txn",
        description="Worker dies inside a store transaction (just before "
                    "commit); WAL rollback + redelivery must leave no "
                    "half-written provenance.",
        chaos="store.commit.pre:crash:nth=3",
        n=4, steps=5, pause=0.1,
        heal_restarts=2, expect_restarts=True),
    Scenario(
        name="crash-before-ack",
        description="Worker finishes a process (terminal state durable) "
                    "but dies before acking the task; the redelivered "
                    "task must be recognised as already finished.",
        chaos="broker.ack.pre:crash:nth=1",
        n=3, steps=3, pause=0.08,
        heal_restarts=2, expect_restarts=True),
    Scenario(
        name="dup-delivery",
        description="Broker hands the same task frame over twice "
                    "(at-least-once transport); outputs must still land "
                    "exactly once.",
        chaos="broker.deliver.pre:duplicate:nth=2;"
              "broker.deliver.pre:duplicate:p=0.4,max=4",
        n=6, steps=3, pause=0.08,
        expect_stats={"chaos_duplicated": 1}),
    Scenario(
        name="broker-partition",
        description="Terminal broadcasts dropped while workchain parents "
                    "wait on children; the liveness re-check must wake "
                    "the parents anyway.",
        chaos="broker.broadcast.pre:drop:nth=1;"
              "broker.broadcast.pre:drop:p=0.5,max=5",
        workload="chain", n=2, steps=3, pause=0.08, children=2,
        env={"REPRO_LIVENESS_INTERVAL": "1.0"},
        expect_stats={"chaos_dropped": 1}),
    Scenario(
        name="kill-during-crash",
        description="Durable kill requests race worker crashes; the kill "
                    "marker must survive the restart and land.",
        chaos="process.flush.post:crash:nth=4",
        n=4, steps=10, pause=0.2,
        durable_kills=2, kill_at=0.4,
        heal_restarts=2, expect_restarts=True, expect_killed=True),
    Scenario(
        name="slow-io",
        description="Injected latency on store and broker commits; "
                    "everything still completes, just slower.",
        chaos="store.commit.pre:delay:delay=0.03,p=0.5;"
              "broker.commit.pre:delay:delay=0.02,p=0.3",
        n=4, steps=3, pause=0.05),
    Scenario(
        name="zombie-worker",
        description="SIGSTOP a live worker across lease expiry (a GC "
                    "pause / partition stand-in); its pks are requeued at "
                    "a bumped epoch, and when SIGCONT wakes the zombie "
                    "its stale writes must be fenced by the store — "
                    "outputs land exactly once, from the new holder.",
        n=4, steps=6, pause=0.25, workers=2,
        sigstop_at=0.8, sigcont_at=3.5,
        expect_stats={"leases_expired": 1},
        expect_meta={"lease.fenced_writes": 1}),
    Scenario(
        name="broker-kill9",
        description="kill -9 the broker mid-delivery; the daemon "
                    "supervisor restarts it on the same port, the "
                    "replacement rebuilds leases/tasks from sqlite, "
                    "workers reconnect and re-own — exactly-once holds.",
        n=6, steps=5, pause=0.4, workers=2,
        broker_kill_at=1.0,
        expect_broker_restarts=True),
    Scenario(
        name="fleet-churn",
        description="Rolling SIGKILLs across a 3-worker fleet under "
                    "load; leases expire, epochs advance, replacements "
                    "resume from checkpoints — no duplicated outputs.",
        n=8, steps=5, pause=1.0, workers=3,
        sigkills=5, sigkill_window=(0.5, 4.0),
        expect_restarts=True),
]}


def list_scenarios() -> list[Scenario]:
    return list(SCENARIOS.values())


def _leased_worker_pids(broker_db: str) -> set[int]:
    """OS pids of workers currently holding process leases, parsed from
    the broker's durable lease table (worker names embed the pid). Used
    to pick a SIGSTOP victim that actually owns in-flight work — a
    zombie with nothing to write can never demonstrate fencing.
    Best-effort: the broker batches commits, so this lags grants by up
    to one reaper tick."""
    try:
        conn = sqlite3.connect(broker_db, timeout=0.2)
        try:
            rows = conn.execute(
                "SELECT DISTINCT worker FROM leases"
                " WHERE worker IS NOT NULL").fetchall()
        finally:
            conn.close()
    except sqlite3.Error:
        return set()
    pids = set()
    for (name,) in rows:
        match = re.match(r"worker\.(\d+)-", name or "")
        if match:
            pids.add(int(match.group(1)))
    return pids


def _reap(daemon, pid: int) -> None:
    """Wait for a SIGKILLed worker to be gone, so the next supervise()
    sees it dead."""
    for proc in list(daemon._workers):
        if proc.pid == pid:
            proc.join(timeout=5)


def _sleep_until_next(tick: float, *deadlines: float | None) -> None:
    """Sleep ``tick`` seconds, or less if a deadline comes first."""
    now = time.time()
    time.sleep(min([tick, *(t - now for t in deadlines
                            if t is not None and t > now)]))


def _await_workers(daemon, n: int, timeout: float) -> tuple[bool, int]:
    """Supervise the daemon until ``n`` workers are connected to its
    broker or ``timeout`` seconds pass; returns (connected, restarts)."""
    restarts = 0
    deadline = time.time() + timeout
    while time.time() < deadline:
        restarts += daemon.supervise()
        try:
            idents = daemon._submitter().lookup("worker.*", timeout=2.0)
        except Exception:  # noqa: BLE001 - broker may be restarting
            idents = []
        if len(idents) >= n:
            return True, restarts
        time.sleep(0.05)
    return False, restarts


def _poll_states(store, pks) -> dict:
    qs = ",".join("?" for _ in pks)
    with store._lock:
        rows = store._conn().execute(
            f"SELECT pk, process_state FROM nodes WHERE pk IN ({qs})",
            list(pks)).fetchall()
    return {r["pk"]: r["process_state"] for r in rows}


def run_scenario(name: str, seed: int = 1,
                 workdir: str | None = None) -> ScenarioResult:
    """Run one named scenario end to end and return its judged result."""
    from repro_torch.chaos.workloads import ChaosCalc, ChaosChain
    from repro_torch.core import Float, Int
    from repro_torch.engine.daemon import Daemon
    from repro_torch.provenance.store import configure_store

    sc = SCENARIOS[name]
    rng = random.Random(seed)
    workdir = workdir or tempfile.mkdtemp(prefix=f"chaos-{name}-")

    # the harness process must never trip its own seams — only spawned
    # daemon children re-resolve the plan from the environment
    faults.deactivate()
    saved_env = {}
    env = dict(sc.env)
    if sc.chaos:
        env[faults.ENV_VAR] = f"seed={seed};{sc.chaos}"
    for key, value in env.items():
        saved_env[key] = os.environ.get(key)
        os.environ[key] = value

    t_start = time.time()
    daemon = Daemon(workdir, workers=sc.workers, slots=sc.slots,
                    heartbeat=0.5)
    restarts = 0
    broker_stats: dict = {}
    states: dict = {}
    failures: list[str] = []
    stopped_pid: int | None = None
    try:
        daemon.start()
        store = configure_store(daemon.store_path)
        connected, restarts = _await_workers(daemon, sc.workers,
                                             WORKER_CONNECT_TIMEOUT)
        t0 = time.time()
        if not connected:
            failures.append(
                f"fewer than {sc.workers} workers connected within "
                f"{WORKER_CONNECT_TIMEOUT:.0f}s of the daemon's start")

        pks = []
        for _ in range(sc.n):
            if sc.workload == "chain":
                pks.append(daemon.submit(ChaosChain, {
                    "n": Int(sc.children), "steps": Int(sc.steps),
                    "pause": Float(sc.pause)}))
            else:
                pks.append(daemon.submit(ChaosCalc, {
                    "steps": Int(sc.steps), "pause": Float(sc.pause)}))

        # seeded schedules, fixed before the loop: reproducibility means
        # the same seed produces the same kill times and victims
        lo, hi = sc.sigkill_window
        sigkill_plan = sorted(
            (t0 + rng.uniform(lo, hi), rng.randrange(1000))
            for _ in range(sc.sigkills))
        kill_pks = rng.sample(pks, sc.durable_kills) if sc.durable_kills else []
        kill_deadline = t0 + sc.kill_at
        kills_done = False
        armed = sc.chaos is not None
        stop_deadline = (t0 + sc.sigstop_at
                         if sc.sigstop_at is not None else None)
        cont_deadline = (t0 + sc.sigcont_at
                         if sc.sigcont_at is not None else None)
        broker_kill_deadline = (t0 + sc.broker_kill_at
                                if sc.broker_kill_at is not None else None)

        deadline = t0 + sc.timeout if connected else t0
        pending = set(pks)
        while time.time() < deadline:
            restarts += daemon.supervise()
            if (armed and sc.heal_restarts is not None
                    and restarts >= sc.heal_restarts):
                # replacement workers from here on spawn clean — the
                # system must now drain to quiescence
                os.environ.pop(faults.ENV_VAR, None)
                armed = False
            now = time.time()
            while sigkill_plan and now >= sigkill_plan[0][0]:
                _, victim = sigkill_plan.pop(0)
                live = daemon.worker_pids()
                # the broker hands single submissions to one worker, so
                # aim at the workers that hold leases, as the SIGSTOP
                # below does: a kill of an idle worker tests nothing
                leased = _leased_worker_pids(daemon.broker_db)
                live = [pid for pid in live if pid in leased] or live
                if live and pending:
                    pid = live[victim % len(live)]
                    os.kill(pid, signal.SIGKILL)
                    _reap(daemon, pid)
            if (stop_deadline is not None and stopped_pid is None
                    and now >= stop_deadline):
                # only stop a worker that holds a lease: under load
                # workers can spawn slowly, and a victim with no
                # in-flight work has no stale write to fence — defer to
                # the next tick until one qualifies
                leased = _leased_worker_pids(daemon.broker_db)
                victims = [pid for pid in daemon.worker_pids()
                           if pid in leased]
                if victims:
                    # the victim keeps its pid (is_alive() stays True, no
                    # supervisor restart) — only the broker reaper notices
                    stopped_pid = victims[0]
                    os.kill(stopped_pid, signal.SIGSTOP)
                    if sc.sigcont_at is not None:
                        # hold the zombie for the scenario's window
                        # measured from the ACTUAL stop — slow startup
                        # must not shrink the lease-expiry window
                        cont_deadline = time.time() + (sc.sigcont_at
                                                       - sc.sigstop_at)
            if (cont_deadline is not None and stopped_pid is not None
                    and now >= cont_deadline):
                os.kill(stopped_pid, signal.SIGCONT)
                cont_deadline = None
            if broker_kill_deadline is not None and now >= broker_kill_deadline:
                broker_kill_deadline = None
                proc = daemon._broker_proc
                if proc is not None and proc.is_alive():
                    os.kill(proc.pid, signal.SIGKILL)
                    # reap it, so the next supervise() sees it dead
                    proc.join(timeout=5)
            if kill_pks and not kills_done and now >= kill_deadline:
                kills_done = True
                from repro_torch.engine.controller import ProcessController
                controller = ProcessController(daemon.host, daemon.port,
                                               timeout=2.0)
                for pk in kill_pks:
                    # durable-first (CLI pattern): marker lands even if no
                    # worker currently owns the process
                    store.update_process(
                        pk, attributes={"kill_requested": "chaos kill"})
                    try:
                        controller.kill(pk, "chaos kill")
                    except Exception:  # noqa: BLE001 - worker may be dead
                        pass
            states = _poll_states(store, pks)
            pending = {pk for pk in pks
                       if states.get(pk) not in TERMINAL}
            if not pending:
                if stopped_pid is not None and cont_deadline is not None:
                    # the fleet drained before the scheduled wake-up: wake
                    # the zombie NOW — the scenario's point is what it does
                    # next (its stale writes must fence), so it needs to be
                    # running before teardown
                    os.kill(stopped_pid, signal.SIGCONT)
                    cont_deadline = None
                if sc.expect_meta and not all(
                        int(store.get_meta(key) or 0) >= minimum
                        for key, minimum in sc.expect_meta.items()):
                    time.sleep(0.1)  # zombie awake, fence not recorded yet
                    continue
                break
            # wake at the next scheduled fault, not up to a tick after
            # it: a fault fires at its offset
            _sleep_until_next(
                0.25, sigkill_plan[0][0] if sigkill_plan else None,
                stop_deadline if stopped_pid is None else None,
                cont_deadline, broker_kill_deadline,
                kill_deadline if kill_pks and not kills_done else None)

        if pending:
            failures.append(
                f"timeout: {len(pending)} of {len(pks)} processes never "
                f"reached a terminal state: {sorted(pending)}")
        # a broker or worker killed in the loop's last tick is restarted
        # before the judge reads the broker's stats
        restarts += daemon.supervise()
        try:
            broker_stats = daemon._submitter().broker_stats()
        except Exception:  # noqa: BLE001 - broker may have been killed
            broker_stats = {}
    finally:
        if stopped_pid is not None:
            try:  # never leave a SIGSTOPped child behind
                os.kill(stopped_pid, signal.SIGCONT)
            except OSError:
                pass
        daemon.stop()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        faults.reset()

    # judge: global invariants first, then scenario-level expectations
    report = check_store(store, expected_pks=pks)
    if sc.expect_restarts and restarts < 1:
        failures.append("expected at least one worker restart; saw none")
    if sc.expect_broker_restarts and daemon.broker_restarts < 1:
        failures.append("expected the supervisor to restart the broker; "
                        "it never did")
    for key, minimum in sc.expect_stats.items():
        if broker_stats.get(key, 0) < minimum:
            failures.append(
                f"expected broker stat {key} >= {minimum}, "
                f"got {broker_stats.get(key, 0)}")
    meta = {key: int(store.get_meta(key) or 0) for key in sc.expect_meta}
    for key, minimum in sc.expect_meta.items():
        if meta.get(key, 0) < minimum:
            failures.append(
                f"expected store meta {key} >= {minimum}, "
                f"got {meta.get(key, 0)}")
    if sc.expect_killed:
        killed = [pk for pk in kill_pks if states.get(pk) == "killed"]
        if not killed:
            failures.append(
                f"expected durably-killed pks {kill_pks} to end in state "
                f"'killed'; states: { {pk: states.get(pk) for pk in kill_pks} }")

    return ScenarioResult(
        name=name, seed=seed, workdir=workdir, report=report,
        restarts=restarts, broker_stats=broker_stats, states=states,
        elapsed=time.time() - t0, failures=failures,
        broker_restarts=daemon.broker_restarts, meta=meta,
        connect_wait=t0 - t_start)
