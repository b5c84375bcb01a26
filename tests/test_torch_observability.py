"""The port's observability layer on the CPU: span tracer, metrics
registry, persisted process timelines, namespaced logging (the
``repro_torch`` logger), and the stats/top CLI surface.

Twins of ``tests/test_observability.py``, run against ``repro_torch``;
the daemon round trip trains its ``GPUTrainJob`` on the CPU.
"""

import asyncio
import json
import logging
import time

import pytest

from repro_torch import cli
from repro_torch.core import Int, calcfunction
from repro_torch.observability import logs as obs_logs
from repro_torch.observability import metrics, trace
from repro_torch.observability.timeline import (
    TRACE_LEVELNAME, load_spans, render_timeline, serialize_spans,
    state_dwell,
)


@pytest.fixture(autouse=True)
def _reset_port_state(monkeypatch):
    """The port's caching policy, default runner and current store (the
    tracer and registry are reset by ``_obs_reset`` below)."""
    from repro_torch.caching.config import ENV_VAR, reset_policy
    from repro_torch.engine.runner import set_default_runner
    from repro_torch.provenance.store import configure_store

    def reset():
        reset_policy()
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
def _obs_reset():
    """Isolate tracer + registry global state per test."""
    trace.reset()
    metrics.reset_registry()
    yield
    trace.reset()
    metrics.reset_registry()


@pytest.fixture()
def _clean_repro_logger():
    logger = logging.getLogger("repro_torch")
    saved = (list(logger.handlers), logger.level, logger.propagate)
    for h in list(logger.handlers):
        logger.removeHandler(h)
    yield logger
    for h in list(logger.handlers):
        logger.removeHandler(h)
    logger.handlers[:] = saved[0]
    logger.setLevel(saved[1])
    logger.propagate = saved[2]


# ---------------------------------------------------------------------------
# Span tracer
# ---------------------------------------------------------------------------

class TestSpans:
    def test_nesting_records_parent_ids(self):
        trace.enable()
        with trace.capture() as tl:
            with trace.span("outer") as outer:
                with trace.span("inner") as inner:
                    pass
        assert inner.parent_id == outer.span_id
        assert outer.parent_id is None
        names = [s.name for s in tl.spans]
        assert names == ["inner", "outer"]  # finish order
        assert all(s.end >= s.start for s in tl.spans)

    def test_contextvar_propagation_across_async_tasks(self):
        trace.enable()
        parent_of_task_span = {}

        async def child():
            with trace.span("in_task") as s:
                await asyncio.sleep(0)
            parent_of_task_span["id"] = s.parent_id

        async def main():
            with trace.span("root") as root:
                # tasks inherit the context of their creation point
                task = asyncio.ensure_future(child())
                await task
            return root.span_id

        with trace.capture():
            root_id = asyncio.new_event_loop().run_until_complete(main())
        assert parent_of_task_span["id"] == root_id

    def test_disabled_fast_path_returns_shared_singleton(self):
        trace.disable()
        a = trace.span("a")
        b = trace.span("b", pk=42)
        assert a is b  # the no-op singleton: no allocation per call
        with trace.capture() as tl:
            with trace.span("x"):
                pass
        assert tl.spans == []
        assert trace.start_timeline() is None

    def test_traced_decorator_sync_and_async(self):
        trace.enable()

        @trace.traced("named")
        def f(x):
            return x + 1

        @trace.traced()
        async def g(x):
            return x * 2

        with trace.capture() as tl:
            assert f(1) == 2
            assert asyncio.new_event_loop().run_until_complete(g(3)) == 6
        assert [s.name for s in tl.spans][0] == "named"
        assert len(tl.spans) == 2

    def test_timeline_drain_stamps_open_spans_and_closes(self):
        trace.enable()
        tl = trace.start_timeline()
        token = trace.push_sink(tl)
        try:
            root = trace.span("root")
            root.__enter__()
            with trace.span("done"):
                pass
            drained = tl.drain(stamp_open=True)
        finally:
            root.__exit__(None, None, None)
            trace.pop_sink(token)
        names = {s["name"] for s in drained}
        assert names == {"root", "done"}
        root_dict = next(s for s in drained if s["name"] == "root")
        assert root_dict["end"] >= root_dict["start"]
        # root exited after the drain: its append was dropped (closed
        # timeline), so a re-drain sees only the originally recorded span
        assert [s["name"] for s in tl.drain()] == ["done"]

    def test_sampling_keeps_fraction_of_root_spans(self):
        trace.enable(sample=0.0)
        assert trace.span("root") is not None
        with trace.capture() as tl:
            with trace.span("root"):
                pass
        assert tl.spans == []
        assert trace.start_timeline() is None
        trace.enable(sample=1.0)
        assert trace.start_timeline() is not None


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

class TestMetrics:
    def test_counter_gauge_histogram_semantics(self):
        reg = metrics.MetricsRegistry()
        reg.counter("c").inc()
        reg.counter("c").inc(4)
        reg.gauge("g").set(2.0)
        reg.gauge("g").dec()
        h = reg.histogram("h")
        for v in (0.0005, 0.02, 100.0):
            h.observe(v)
        snap = reg.snapshot()
        assert snap["counters"]["c"] == 5
        assert snap["gauges"]["g"] == 1.0
        assert snap["histograms"]["h"]["count"] == 3
        assert snap["histograms"]["h"]["counts"][0] == 1   # < 1ms
        assert snap["histograms"]["h"]["counts"][-1] == 1  # overflow

    def test_concurrent_asyncio_writers(self):
        reg = metrics.MetricsRegistry()

        async def writer(i):
            for _ in range(100):
                reg.counter("hits").inc()
                reg.histogram("lat").observe(0.001 * i)
                await asyncio.sleep(0)

        async def main():
            await asyncio.gather(*[writer(i) for i in range(10)])

        asyncio.new_event_loop().run_until_complete(main())
        snap = reg.snapshot()
        assert snap["counters"]["hits"] == 1000
        assert snap["histograms"]["lat"]["count"] == 1000

    def test_statsdict_is_backcompat_dict_and_feeds_registry(self):
        reg = metrics.MetricsRegistry()
        stats = metrics.StatsDict("store", {"commits": 0}, registry=reg)
        assert isinstance(stats, dict)
        stats["commits"] += 2         # the legacy hot-path idiom
        assert stats.get("commits") == 2
        other = metrics.StatsDict("store", {"commits": 3}, registry=reg)
        assert other["commits"] == 3
        # snapshot sums instances sharing a prefix
        assert reg.snapshot()["counters"]["store.commits"] == 5

    def test_merge_snapshots_sums_counters_and_histograms(self):
        reg1, reg2 = metrics.MetricsRegistry(), metrics.MetricsRegistry()
        reg1.counter("n").inc(2)
        reg2.counter("n").inc(3)
        reg2.counter("only2").inc()
        reg1.gauge("g").set(1)
        reg2.gauge("g").set(7)
        reg1.histogram("h").observe(0.01)
        reg2.histogram("h").observe(0.02)
        merged = metrics.merge_snapshots(
            [reg1.snapshot(), reg2.snapshot(), None])
        assert merged["counters"] == {"n": 5, "only2": 1}
        assert merged["gauges"]["g"] == 7  # last wins
        assert merged["histograms"]["h"]["count"] == 2


# ---------------------------------------------------------------------------
# Timeline persistence + dwell times
# ---------------------------------------------------------------------------

def _creator_pk(store, result):
    """The calcfunction process node that CREATEd this data node."""
    from repro_torch.provenance.store import LinkType
    return store.incoming(result.pk, LinkType.CREATE)[0][0]


class TestTimelinePersistence:
    def test_calcfunction_persists_timeline_within_commit_budget(
            self, runner, store):
        trace.enable()

        @calcfunction
        def add(a, b):
            return a + b

        add(Int(1), Int(2))          # warm spec/import caches
        commits0 = store.stats["commits"]
        result = add(Int(3), Int(4))
        assert (store.stats["commits"] - commits0) <= 3
        pk = _creator_pk(store, result)
        spans = load_spans(store, pk)
        names = {s["name"] for s in spans}
        assert "process.run" in names
        # the timeline rides the terminal transaction as ONE TRACE row
        trace_rows = [log for log in store.get_logs(pk)
                      if log["levelname"] == TRACE_LEVELNAME]
        assert len(trace_rows) == 1
        rendered = render_timeline(spans)
        assert "process.run" in rendered and "total" in rendered

    def test_untraced_run_stores_no_trace_rows(self, runner, store):
        trace.disable()

        @calcfunction
        def add(a, b):
            return a + b

        result = add(Int(1), Int(2))
        pk = _creator_pk(store, result)
        assert load_spans(store, pk) == []
        assert "no spans recorded" in render_timeline([])

    def test_serialize_normalizes_starts_to_offsets(self):
        doc = serialize_spans([
            {"name": "a", "id": 1, "parent": None,
             "start": 1000.5, "end": 1000.9},
            {"name": "b", "id": 2, "parent": 1,
             "start": 1000.6, "end": 1000.7, "attrs": {"pk": 3}},
        ])
        spans = json.loads(doc)["spans"]
        assert spans[0]["start"] == 0.0
        assert spans[1]["start"] == pytest.approx(0.1)
        assert spans[1]["attrs"] == {"pk": 3}

    def test_state_dwell_from_state_history(self, runner, store):
        @calcfunction
        def add(a, b):
            return a + b

        pk = _creator_pk(store, add(Int(1), Int(2)))
        node = store.get_node(pk)
        rows = dict(state_dwell(node))
        assert "running" in rows and "finished" in rows

    def test_state_dwell_legacy_fallback(self):
        node = {"attributes": "{}", "ctime": 100.0, "mtime": 103.5,
                "process_state": "finished"}
        rows = state_dwell(node)
        assert len(rows) == 1
        assert rows[0][0].startswith("(total")
        assert rows[0][1] == pytest.approx(3.5)


# ---------------------------------------------------------------------------
# Logging configuration
# ---------------------------------------------------------------------------

class TestLogs:
    def test_configure_touches_only_repro_namespace(self, _clean_repro_logger):
        root_handlers = list(logging.getLogger().handlers)
        logger = obs_logs.configure(level="INFO")
        assert logger.name == "repro_torch"
        assert logging.getLogger().handlers == root_handlers
        assert logger.level == logging.INFO
        assert logger.propagate is False

    def test_configure_is_idempotent(self, _clean_repro_logger):
        obs_logs.configure(level="INFO")
        obs_logs.configure(level="DEBUG")
        logger = logging.getLogger("repro_torch")
        ours = [h for h in logger.handlers
                if getattr(h, "_repro_obs", False)]
        assert len(ours) == 1
        assert logger.level == logging.DEBUG

    def test_env_var_sets_level(self, _clean_repro_logger, monkeypatch):
        monkeypatch.setenv(obs_logs.ENV_VAR, "debug")
        assert obs_logs.configure().level == logging.DEBUG
        with pytest.raises(ValueError):
            obs_logs._resolve_level("NOT_A_LEVEL")

    def test_records_carry_worker_and_pk_context(self, _clean_repro_logger):
        import io

        stream = io.StringIO()
        obs_logs.configure(level="INFO", worker_id="worker.1-abc",
                           stream=stream)
        logger = logging.getLogger("repro_torch.test")
        try:
            with obs_logs.pk_context(42):
                logger.info("inside")
            logger.info("outside")
        finally:
            obs_logs.set_worker_id(None)
        out = stream.getvalue()
        assert "[worker.1-abc pk=42]: inside" in out
        assert "[worker.1-abc]: outside" in out


# ---------------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------------

@pytest.fixture()
def profile(tmp_path):
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.provenance.store import configure_store

    db = str(tmp_path / "profile.db")
    st = configure_store(db)
    set_default_runner(Runner(store=st))
    trace.enable()

    @calcfunction
    def add(a, b):
        return a + b

    add(Int(1), Int(2))
    trace.disable()
    st.close()
    set_default_runner(None)
    return db


class TestCli:
    def test_stats_json_schema(self, profile, capsys):
        cli.main(["-p", profile, "stats", "--json"])
        doc = json.loads(capsys.readouterr().out)
        assert set(doc) == {"nodes", "unfinished", "metrics", "repository",
                            "workers"}
        assert doc["nodes"].get("process.calcfunction") == 1
        assert doc["unfinished"] == 0
        assert doc["workers"] == []  # no daemon running
        assert "counters" in doc["metrics"]
        assert set(doc["repository"]) == {"blobs", "bytes"}

    def test_stats_plain_lists_counters(self, profile, capsys):
        cli.main(["-p", profile, "stats"])
        out = capsys.readouterr().out
        assert "repository:" in out
        assert "counters:" in out

    def test_report_renders_dwell_and_timeline(self, profile, capsys):
        cli.main(["-p", profile, "process", "report", "1"])
        out = capsys.readouterr().out
        assert "state dwell times:" in out
        assert "running" in out
        assert "span timeline:" in out
        assert "process.run" in out
        # the raw TRACE json row must not leak into the log listing
        assert '"spans"' not in out

    def test_top_once_without_daemon_is_an_answer(self, profile, tmp_path,
                                                  capsys):
        cli.main(["-p", profile, "process", "top", "--once",
                  "-w", str(tmp_path / "nodaemon")])
        out = capsys.readouterr().out
        assert "nothing running" in out


# ---------------------------------------------------------------------------
# Daemon round-trip (spans recorded by a worker OS process, read here)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_daemon_roundtrip_persists_timeline(tmp_path, monkeypatch, capsys):
    from repro_torch.calcjobs import GPUTrainJob
    from repro_torch.core import Dict
    from repro_torch.engine.daemon import Daemon
    from repro_torch.provenance.store import configure_store

    monkeypatch.setenv(trace.ENV_VAR, "1")  # inherited by spawned workers
    daemon = Daemon(str(tmp_path), workers=1, slots=4)
    daemon.start()
    try:
        pk = daemon.submit(GPUTrainJob, {"config": Dict(
            {"arch": "qwen2-0.5b", "steps": 1, "batch": 1, "seq": 8,
             "device": "cpu"})})
        store = configure_store(daemon.store_path)
        deadline = time.time() + 150
        while time.time() < deadline:
            node = store.get_node(pk)
            if node and node.get("process_state") in ("finished", "excepted",
                                                      "killed"):
                break
            daemon.supervise()
            time.sleep(0.4)
        assert node["process_state"] == "finished", node
        spans = load_spans(store, pk)
        assert spans, "worker did not persist a span timeline"
        assert {"process.run"} <= {s["name"] for s in spans}
        cli.main(["-p", daemon.store_path, "process", "report", str(pk)])
        out = capsys.readouterr().out
        assert "span timeline:" in out and "process.run" in out
    finally:
        daemon.stop()
