"""The port's chaos subsystem on the CPU: fault plans, seam behaviour,
the invariant checker, and the end-to-end scenarios (daemon workers +
kill -9 + invariants).

Twins of ``tests/test_chaos.py``, run against ``repro_torch``, with the
reference's ``slow`` markers and its scenarios' offsets, expectations
and seeds. A worker of this package imports torch before it connects, so
the harness starts a scenario's clock once every worker has connected;
two cases hold that, and that ``kill9-midstep`` kills a worker holding
leases (its tasks are delivered again). Every scenario equals the
reference's, field by field, but the pause of ``fleet-churn`` and
``broker-kill9``, whose calcs must outlast their faults: two cases hold
that a ``fleet-churn`` kill lands on a lease holder and that the broker
dies before ``broker-kill9``'s last calc finishes.
"""

import dataclasses
import json
import time

import pytest

from repro_torch.chaos import faults
from repro_torch.chaos.faults import ChaosInjected, ChaosPlan
from repro_torch.chaos.harness import SCENARIOS, run_scenario
from repro_torch.chaos.invariants import check_store
from repro_torch.core import Float, Int
from repro_torch.provenance.store import NodeType


@pytest.fixture(autouse=True)
def _reset_port_state(monkeypatch):
    """The port's global state: caching policy, metrics registry, default
    runner and current store."""
    from repro_torch.caching.config import ENV_VAR, reset_policy
    from repro_torch.engine.runner import set_default_runner
    from repro_torch.observability.metrics import reset_registry
    from repro_torch.provenance.store import configure_store

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
    from repro_torch.provenance.store import configure_store

    st = configure_store(":memory:")
    set_default_runner(None)
    yield st
    set_default_runner(None)


@pytest.fixture()
def runner(store):
    from repro_torch.engine.runner import Runner, set_default_runner

    r = Runner(store=store)
    set_default_runner(r)
    yield r


@pytest.fixture(autouse=True)
def _disarm_chaos():
    """Every test starts and ends with fault injection disabled."""
    faults.deactivate()
    yield
    faults.deactivate()


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

def test_plan_spec_roundtrip():
    spec = ("seed=7;store.commit.pre:raise:nth=2;"
            "broker.deliver.pre:duplicate:p=0.5,max=3;"
            "process.flush.pre:delay:delay=0.1,once")
    plan = ChaosPlan.parse(spec)
    assert ChaosPlan.parse(plan.spec()).spec() == plan.spec()


def test_unknown_point_and_action_rejected():
    with pytest.raises(ValueError):
        ChaosPlan(seed=1).on("no.such.point", "raise")
    with pytest.raises(ValueError):
        ChaosPlan(seed=1).on("store.commit.pre", "segfault")
    # glob patterns are fine as long as they match something registered
    ChaosPlan(seed=1).on("broker.*", "delay", delay=0.01)


def test_nth_fires_exactly_once():
    plan = ChaosPlan(seed=1).on("store.commit.pre", "raise", nth=3)
    faults.activate(plan)
    faults.fault_point("store.commit.pre")
    faults.fault_point("store.commit.pre")
    with pytest.raises(ChaosInjected):
        faults.fault_point("store.commit.pre")
    for _ in range(10):
        faults.fault_point("store.commit.pre")  # never again
    assert plan.fired["store.commit.pre"] == 1


def test_probability_stream_deterministic():
    def fire_pattern(seed):
        plan = ChaosPlan(seed=seed).on("broker.deliver.pre", "duplicate",
                                       p=0.5)
        faults.activate(plan)
        pattern = [faults.fault_point("broker.deliver.pre") == "duplicate"
                   for _ in range(32)]
        faults.deactivate()
        return pattern

    assert fire_pattern(11) == fire_pattern(11)
    assert fire_pattern(11) != fire_pattern(12)


def test_max_caps_fires():
    plan = ChaosPlan(seed=1).on("broker.deliver.pre", "duplicate",
                                p=1.0, max=2)
    faults.activate(plan)
    results = [faults.fault_point("broker.deliver.pre")
               for _ in range(10)]
    assert results.count("duplicate") == 2


def test_delay_action_sleeps():
    plan = ChaosPlan(seed=1).on("store.commit.post", "delay", delay=0.05,
                                once=True)
    faults.activate(plan)
    t0 = time.monotonic()
    faults.fault_point("store.commit.post")
    assert time.monotonic() - t0 >= 0.04


def test_env_spec_resolution(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR,
                       "seed=3;store.commit.pre:raise:nth=1")
    faults.reset()  # back to lazy env resolution
    with pytest.raises(ChaosInjected):
        faults.fault_point("store.commit.pre")
    # deactivate() disarms even while the env var is still set — this is
    # what keeps the harness process itself out of the blast radius
    faults.deactivate()
    assert faults.fault_point("store.commit.pre") is None


def test_disabled_fault_point_returns_none():
    assert faults.fault_point("store.commit.pre") is None
    assert faults.active_plan() is None


# ---------------------------------------------------------------------------
# seams
# ---------------------------------------------------------------------------

def test_raise_in_commit_rolls_back_transaction(store):
    before = store._conn().execute("SELECT COUNT(*) FROM nodes").fetchone()[0]
    faults.activate(ChaosPlan(seed=1).on("store.commit.pre", "raise", nth=1))
    with pytest.raises(ChaosInjected):
        store.create_process_node(NodeType.CALC_FUNCTION, "Doomed",
                                  label="doomed")
    faults.deactivate()
    after = store._conn().execute("SELECT COUNT(*) FROM nodes").fetchone()[0]
    assert after == before  # the unit of work rolled back whole
    # and the store is healthy again afterwards
    pk = store.create_process_node(NodeType.CALC_FUNCTION, "Fine",
                                   label="fine")
    assert store.get_node(pk) is not None


def test_chaos_calc_runs_clean(store, runner):
    from repro_torch.chaos.workloads import ChaosCalc

    outputs, proc = runner.run(ChaosCalc, {"steps": Int(2),
                                           "pause": Float(0.01)})
    assert proc.is_finished_ok
    assert outputs["result"].value == 2


# ---------------------------------------------------------------------------
# broker disconnect cleanup (fail-fast routing to dead workers)
# ---------------------------------------------------------------------------

class _FakeWriter:
    def __init__(self):
        self.frames = []

    def is_closing(self):
        return False

    def write(self, data):
        self.frames.append(data)


class _FakeTimer:
    def __init__(self):
        self.cancelled = False

    def cancel(self):
        self.cancelled = True


def test_drop_client_disowns_and_fails_rpcs(tmp_path):
    from repro_torch.engine.broker import BrokerServer

    srv = BrokerServer(str(tmp_path / "broker.db"))
    dead, alive = "worker-dead", "worker-alive"
    w_alive = _FakeWriter()
    srv._clients[dead] = _FakeWriter()
    srv._clients[alive] = w_alive
    srv._last_beat[dead] = 0.0
    srv._rpc["process.7"] = dead
    srv._owners[7] = dead
    srv._owners[8] = alive
    t_to_dead, t_from_dead = _FakeTimer(), _FakeTimer()
    srv._pending_rpc["r1"] = (alive, dead)   # alive is awaiting dead
    srv._rpc_timers["r1"] = t_to_dead
    srv._pending_rpc["r2"] = (dead, alive)   # dead was awaiting alive
    srv._rpc_timers["r2"] = t_from_dead

    srv._drop_client(dead)

    # pks auto-disowned, live worker untouched
    assert 7 not in srv._owners and srv._owners[8] == alive
    assert "process.7" not in srv._rpc
    # both directions of pending RPC cleaned up, timers cancelled
    assert srv._pending_rpc == {}
    assert t_to_dead.cancelled and t_from_dead.cancelled
    # the surviving origin got a fail-fast error instead of a hang
    reply = json.loads(w_alive.frames[0].decode().strip())
    assert reply["rid"] == "r1"
    assert "disconnected" in reply["error"]
    # idempotent: the reaper and the connection handler may both fire
    assert srv.stats["clients_dropped"] == 1
    srv._drop_client(dead)
    assert srv.stats["clients_dropped"] == 1


def test_drop_records_name_the_client(tmp_path):
    """``broker_stats`` says whom the broker dropped: a daemon worker by
    its name, or a client that never said hello (a sync client)."""
    from repro_torch.engine.broker import BrokerServer

    srv = BrokerServer(str(tmp_path / "broker.db"))
    worker, sync = "a1b2c3d4e5", "f6e7d8c9b0"
    for cid in (worker, sync):
        srv._clients[cid] = _FakeWriter()
        srv._last_beat[cid] = 0.0
    srv._names[worker] = "worker.4711-abcdef"
    srv._consumers["process.queue"] = {worker}

    srv._drop_client(worker, reason="missed heartbeats")
    srv._drop_client(sync)
    srv._drop_client(sync)              # idempotent: recorded once

    assert srv.dropped == [
        {"client": worker[:8], "worker": "worker.4711-abcdef",
         "reason": "missed heartbeats", "consumer": True},
        {"client": sync[:8], "worker": None, "reason": "disconnected",
         "consumer": False}]
    assert srv.stats["clients_dropped"] == 2


# ---------------------------------------------------------------------------
# invariant checker
# ---------------------------------------------------------------------------

def _raw_process(store, state, *, checkpoint=None, exit_status=0,
                 attributes="{}"):
    with store._lock:
        cur = store._conn().execute(
            "INSERT INTO nodes (uuid, node_type, process_state, exit_status,"
            " checkpoint, attributes, ctime, mtime) VALUES (hex(randomblob("
            "16)), 'process.calcfunction', ?, ?, ?, ?, 0, 0)",
            (state, exit_status, checkpoint, attributes))
        store._conn().commit()
        return cur.lastrowid


def test_invariants_detect_injected_corruption(store):
    # terminal node with a surviving checkpoint (torn terminal txn)
    torn = _raw_process(store, "finished", checkpoint='{"x": 1}')
    # finished without an exit status
    _raw_process(store, "finished", exit_status=None)
    # resurrected: state recorded after a terminal entry
    _raw_process(store, "finished", attributes=json.dumps({
        "state_history": [["created", 1.0], ["finished", 2.0],
                          ["running", 3.0]]}))
    # kill requested but never honoured
    _raw_process(store, "running", attributes=json.dumps(
        {"kill_requested": "die"}))
    # dangling link + duplicate create links
    data = _raw_process(store, None)
    with store._lock:
        store._conn().execute(
            "INSERT INTO links (in_id, out_id, link_type, label) VALUES"
            f" ({torn}, 999999, 'create', 'ghost')")
        store._conn().executemany(
            "INSERT INTO links (in_id, out_id, link_type, label) VALUES"
            " (?, ?, 'create', 'result')",
            [(torn, data), (torn, data)])
        store._conn().commit()

    report = check_store(store, expected_pks=[torn, 12345])
    assert not report.ok
    kinds = {v.invariant for v in report.violations}
    assert {"terminal-checkpoint", "exit-status", "resurrected",
            "kill-durability", "dangling-link", "duplicate-output",
            "duplicate-create", "lost"} <= kinds


def test_invariants_pass_on_clean_run(store, runner):
    from repro_torch.chaos.workloads import ChaosCalc

    _, proc = runner.run(ChaosCalc, {"steps": Int(1), "pause": Float(0.0)})
    report = check_store(store, expected_pks=[proc.pk])
    assert report.ok, report.summary()


#: scenarios whose calcs take longer here, and the least run time
#: (steps x pause, seconds) each calc must have: past fleet-churn's kill
#: window (0.5-4.0 s) and past broker-kill9's broker kill (1.0 s)
LONGER_PAUSE = {"fleet-churn": 5.0, "broker-kill9": 2.0}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_the_reference(name):
    """Every scenario is the reference's, field by field, but the pause of
    the two in ``LONGER_PAUSE``: once the clock starts at the workers'
    connect, their calcs drained at the reference's pause before the
    first fault fired."""
    from repro.chaos.harness import SCENARIOS as REFERENCE

    assert sorted(SCENARIOS) == sorted(REFERENCE)
    mine = dataclasses.asdict(SCENARIOS[name])
    ref = dataclasses.asdict(REFERENCE[name])
    if name in LONGER_PAUSE:
        sc = SCENARIOS[name]
        assert sc.steps * sc.pause >= LONGER_PAUSE[name]
        assert mine.pop("pause") != ref.pop("pause")
    assert mine == ref


# ---------------------------------------------------------------------------
# end-to-end scenarios (real daemon workers, real kill -9)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_end_to_end(name, tmp_path):
    result = run_scenario(name, seed=1, workdir=str(tmp_path / name))
    assert result.ok, result.summary()


@pytest.mark.slow
def test_scenario_reproducible_under_fixed_seed(tmp_path):
    a = run_scenario("crash-in-txn", seed=42, workdir=str(tmp_path / "a"))
    b = run_scenario("crash-in-txn", seed=42, workdir=str(tmp_path / "b"))
    assert a.ok, a.summary()
    assert b.ok, b.summary()
    # the seeded plan is byte-identical across runs; outcomes agree
    assert a.report.states == b.report.states


# ---------------------------------------------------------------------------
# the harness's clock (this package's workers start slowly)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_scenario_clock_starts_after_every_worker_connected(tmp_path,
                                                           monkeypatch):
    from repro_torch.engine.daemon import Daemon

    seen = []
    submit = Daemon.submit

    def watched_submit(self, process_class, inputs=None):
        # by the first submission every worker is a broker client
        seen.append(len(self._submitter().lookup("worker.*")))
        return submit(self, process_class, inputs)

    monkeypatch.setattr(Daemon, "submit", watched_submit)
    t0 = time.time()
    result = run_scenario("dup-delivery", seed=1,
                          workdir=str(tmp_path / "dup"))
    wall = time.time() - t0
    assert result.ok, result.summary()
    sc = SCENARIOS["dup-delivery"]
    assert seen == [sc.workers] * sc.n
    # the workers' start (torch imported first) is outside the clock
    assert result.connect_wait > 0.0
    assert result.elapsed <= wall - result.connect_wait


@pytest.mark.slow
def test_kill9_midstep_kills_a_worker_holding_leases(tmp_path):
    result = run_scenario("kill9-midstep", seed=1,
                          workdir=str(tmp_path / "kill9"))
    assert result.ok, result.summary()
    stats = result.broker_stats
    # a killed lease holder's tasks go out again
    assert stats["tasks_delivered"] - stats["tasks_enqueued"] >= 1, stats
    assert stats["leases_expired"] >= 1, stats


@pytest.mark.slow
def test_fleet_churn_kills_land_on_lease_holders(tmp_path):
    result = run_scenario("fleet-churn", seed=1,
                          workdir=str(tmp_path / "churn"))
    assert result.ok, result.summary()
    stats = result.broker_stats
    # at least one kill landed on a worker holding work: its tasks went
    # out again
    assert stats["tasks_delivered"] - stats["tasks_enqueued"] >= 1, stats


@pytest.mark.slow
def test_broker_kill9_fires_before_the_last_calc_finishes(tmp_path,
                                                         monkeypatch):
    import os
    import signal
    import sqlite3

    kills = []
    kill = os.kill

    def watched_kill(pid, sig):
        if sig == signal.SIGKILL:
            kills.append(time.time())
        return kill(pid, sig)

    monkeypatch.setattr(os, "kill", watched_kill)
    workdir = tmp_path / "broker"
    result = run_scenario("broker-kill9", seed=1, workdir=str(workdir))
    assert result.ok, result.summary()
    assert result.broker_restarts >= 1
    # the scenario schedules no worker kill: the first SIGKILL is the
    # broker's
    broker_killed_at = kills[0]
    conn = sqlite3.connect(str(workdir / "provenance.db"))
    try:
        rows = conn.execute(
            "SELECT attributes FROM nodes WHERE pk IN (%s)"
            % ",".join("?" * len(result.states)),
            list(result.states)).fetchall()
    finally:
        conn.close()
    finished = [t for (attrs,) in rows
                for state, t in json.loads(attrs)["state_history"]
                if state == "finished"]
    assert len(finished) == SCENARIOS["broker-kill9"].n
    assert broker_killed_at < max(finished)
