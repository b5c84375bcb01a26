"""The port's provenance store, blob repository and QueryBuilder, on
the CPU.

Twins of ``tests/test_store.py`` (blob repository, payload routing, bulk
writes and reads, transaction hooks, legacy migration, the unit of work,
checkpoints by reference, cache hits on blobs), ``tests/test_querybuilder.py``
and ``tests/test_provenance.py`` run against ``repro_torch``; the archive
and multi-writer cases are in ``tests/test_torch_archive.py``. The parity
cases hold the port's schema and a profile it writes to the reference's
store.
"""

import json
import os
import sqlite3

import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as st  # noqa: E501

from repro_torch.core import ArrayData, Dict, Float, Int, Str
from repro_torch.core.datatypes import DataValue, FolderData, to_data_value
from repro_torch.provenance.repository import BlobNotFound, BlobRepository
from repro_torch.provenance.store import (
    SUMMARY_COLUMNS, LinkType, NodeType, ProvenanceStore, QueryBuilder,
)


@pytest.fixture(autouse=True)
def _reset_port_state(monkeypatch):
    """The port's global state: caching policy, metrics registry, default
    runner, current store and serving engine memo."""
    from repro_torch.caching.config import ENV_VAR, reset_policy
    from repro_torch.engine.runner import set_default_runner
    from repro_torch.observability.metrics import reset_registry
    from repro_torch.provenance.store import configure_store
    from repro_torch.serving.inference import reset_engines

    def reset():
        reset_policy()
        reset_registry()
        set_default_runner(None)
        configure_store(":memory:")
        reset_engines()

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


# ===========================================================================
# twins of tests/test_store.py
# ===========================================================================

# ---------------------------------------------------------------------------
# BlobRepository
# ---------------------------------------------------------------------------

class TestBlobRepository:
    def test_put_get_roundtrip(self, tmp_path):
        repo = BlobRepository(str(tmp_path / "repo"))
        digest = repo.put(b"hello world")
        assert repo.get(digest) == b"hello world"
        assert repo.has(digest)
        assert not repo.has("0" * 64)

    def test_content_addressing_dedups(self, tmp_path):
        repo = BlobRepository(str(tmp_path / "repo"))
        d1 = repo.put(b"same bytes")
        d2 = repo.put(b"same bytes")
        assert d1 == d2
        assert list(repo.digests()) == [d1]
        assert repo.stats() == {"blobs": 1, "bytes": len(b"same bytes")}

    def test_missing_blob_raises(self, tmp_path):
        repo = BlobRepository(str(tmp_path / "repo"))
        with pytest.raises(BlobNotFound):
            repo.get("ab" * 32)

    def test_in_memory_repo(self):
        repo = BlobRepository(None)
        d = repo.put(b"x" * 100)
        assert repo.get(d) == b"x" * 100
        assert repo.stats()["blobs"] == 1


# ---------------------------------------------------------------------------
# payload routing through the repository
# ---------------------------------------------------------------------------

class TestPayloadRouting:
    def test_small_array_stays_inline(self, tmp_path):
        st = ProvenanceStore(str(tmp_path / "p.db"), inline_threshold=4096)
        v = st.store_data(ArrayData(np.arange(8)))
        row = st.get_node(v.pk)
        assert "npy_b64" in json.loads(row["payload"])
        assert st.repository.stats()["blobs"] == 0
        assert np.array_equal(st.load_data(v.pk).value, np.arange(8))

    def test_large_array_goes_to_blob(self, tmp_path):
        st = ProvenanceStore(str(tmp_path / "p.db"), inline_threshold=256)
        arr = np.arange(1024, dtype=np.float64)
        v = st.store_data(ArrayData(arr))
        doc = json.loads(st.get_node(v.pk)["payload"])
        assert set(doc) == {"type", "blob"}
        assert st.repository.has(doc["blob"])
        # transparent rehydration
        assert np.array_equal(st.load_data(v.pk).value, arr)

    def test_equal_arrays_share_one_blob(self, tmp_path):
        st = ProvenanceStore(str(tmp_path / "p.db"), inline_threshold=256)
        arr = np.arange(1024, dtype=np.float64)
        a = st.store_data(ArrayData(arr))
        b = st.store_data(ArrayData(arr.copy()))
        assert a.pk != b.pk
        docs = [json.loads(st.get_node(pk)["payload"])
                for pk in (a.pk, b.pk)]
        assert docs[0]["blob"] == docs[1]["blob"]
        assert st.repository.stats()["blobs"] == 1

    def test_folder_mixed_inline_and_blob(self, tmp_path):
        st = ProvenanceStore(str(tmp_path / "p.db"), inline_threshold=64)
        files = {"small.txt": b"tiny", "big.bin": os.urandom(500)}
        v = st.store_data(FolderData(files))
        doc = json.loads(st.get_node(v.pk)["payload"])
        assert "small.txt" in doc["files"]
        assert "big.bin" in doc["blobs"]
        loaded = st.load_data(v.pk)
        assert loaded.get_bytes("small.txt") == b"tiny"
        assert loaded.get_bytes("big.bin") == files["big.bin"]

    def test_threshold_env_var(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_REPO_INLINE_MAX", "128")
        st = ProvenanceStore(str(tmp_path / "p.db"))
        assert st.inline_threshold == 128


# ---------------------------------------------------------------------------
# bulk write APIs
# ---------------------------------------------------------------------------

class TestBulkWrites:
    def test_store_data_many_assigns_pks(self, store):
        values = [Int(i) for i in range(10)]
        store.store_data_many(values)
        assert all(v.is_stored for v in values)
        assert len({v.pk for v in values}) == 10
        assert store.load_data(values[3].pk).value == 3

    def test_store_data_many_skips_stored_and_duplicates(self, store):
        a = store.store_data(Int(1))
        b = Int(2)
        before = store.count_nodes()
        store.store_data_many([a, b, b])   # stored + same object twice
        assert store.count_nodes() == before + 1
        assert b.is_stored

    def test_add_links_and_links_for(self, store):
        p = store.create_process_node(NodeType.CALC_FUNCTION, "F")
        vals = store.store_data_many([Int(i) for i in range(4)])
        store.add_links([(v.pk, p, LinkType.INPUT_CALC, f"x{i}")
                         for i, v in enumerate(vals)])
        links = store.links_for([p])
        assert len(links) == 4
        assert {l[3] for l in links} == {"x0", "x1", "x2", "x3"}
        # direction filters
        assert store.links_for([p], direction="in") == links
        assert store.links_for([p], direction="out") == []
        # each link appears once even when both endpoints are selected
        both = store.links_for([p, vals[0].pk])
        assert len(both) == 4

    def test_add_logs_bulk_and_logs_for(self, store):
        p1 = store.create_process_node(NodeType.WORK_CHAIN, "W1")
        p2 = store.create_process_node(NodeType.WORK_CHAIN, "W2")
        store.add_logs([(p1, "REPORT", "first", 1.0),
                        (p2, "REPORT", "other", 2.0),
                        (p1, "REPORT", "second", 3.0)])
        by_node = store.logs_for([p1, p2])
        assert [e["message"] for e in by_node[p1]] == ["first", "second"]
        assert by_node[p2][0]["message"] == "other"
        assert store.get_logs(p1)[0]["message"] == "first"

    def test_insert_node_rows_bulk(self, store):
        records = [{"uuid": f"u-{i}", "node_type": "data",
                    "payload": {"type": "int", "value": i},
                    "ctime": 1.0, "mtime": 1.0} for i in range(5)]
        pks = store.insert_node_rows(records)
        assert len(pks) == 5
        assert store.load_data(pks[2]).value == 2
        assert store.get_node_by_uuid("u-4")["pk"] == pks[4]

    def test_transaction_batches_commits(self, store):
        c0 = store.stats["commits"]
        with store.transaction():
            store.store_data(Int(1))
            store.store_data(Int(2))
            p = store.create_process_node(NodeType.CALC_FUNCTION, "F")
            store.add_log(p, "REPORT", "hi")
        assert store.stats["commits"] == c0 + 1


# ---------------------------------------------------------------------------
# transaction hooks: rollback identity cleanup, post-commit ordering
# ---------------------------------------------------------------------------

class TestTransactionHooks:
    def test_rollback_unassigns_bulk_pks(self, store):
        v = Int(5)
        with pytest.raises(RuntimeError):
            with store.transaction():
                store.store_data_many([v])
                assert v.is_stored
                raise RuntimeError("boom")
        # the row was rolled back, so the value must not keep its pk —
        # otherwise a later store would skip it and links would dangle
        assert not v.is_stored and v.pk is None and v.uuid is None
        store.store_data(v)
        assert store.load_data(v.pk).value == 5

    def test_rollback_unassigns_single_pk(self, store):
        v = Int(7)
        with pytest.raises(RuntimeError):
            with store.transaction():
                store.store_data(v)
                raise RuntimeError("boom")
        assert v.pk is None and v.uuid is None

    def test_after_commit_defers_until_commit(self, store):
        fired = []
        with store.transaction():
            store.after_commit(lambda: fired.append(store.count_nodes()))
            store.store_data(Int(1))
            assert fired == []          # not yet: txn still open
        assert fired == [1]             # ran post-commit, sees the row

    def test_after_commit_immediate_outside_txn(self, store):
        fired = []
        store.after_commit(lambda: fired.append(1))
        assert fired == [1]

    def test_after_commit_dropped_on_rollback(self, store):
        fired = []
        with pytest.raises(RuntimeError):
            with store.transaction():
                store.after_commit(lambda: fired.append(1))
                raise RuntimeError("boom")
        assert fired == []

    def test_terminal_broadcast_after_durable_write(self, tmp_path):
        """The state_changed terminal broadcast must not beat the commit:
        an observer in another OS process reads the store the moment the
        broadcast lands and must see the final state and output links."""
        from repro_torch.core import calcfunction
        from repro_torch.engine.runner import Runner, set_default_runner

        @calcfunction
        def add(a, b):
            return a + b

        db = str(tmp_path / "p.db")
        st = ProvenanceStore(db)
        runner = Runner(store=st)
        set_default_runner(runner)
        observed = []
        orig = runner.communicator.broadcast_send

        def spy(subject=None, sender=None, body=None, **kw):
            if body and body.get("state") == "finished":
                # a fresh connection sees only *committed* state, exactly
                # like a waiter in another OS process would
                conn = sqlite3.connect(db)
                try:
                    row = conn.execute(
                        "SELECT process_state FROM nodes WHERE pk=?",
                        (body["pk"],)).fetchone()
                    n_out = conn.execute(
                        "SELECT COUNT(*) FROM links WHERE in_id=?"
                        " AND link_type='create'",
                        (body["pk"],)).fetchone()[0]
                    observed.append((row[0] if row else None, n_out))
                finally:
                    conn.close()
            return orig(subject=subject, sender=sender, body=body, **kw)

        runner.communicator.broadcast_send = spy
        try:
            add(Int(1), Int(2))
        finally:
            set_default_runner(None)
            st.close()
        assert observed == [("finished", 1)]


# ---------------------------------------------------------------------------
# bulk/projected reads
# ---------------------------------------------------------------------------

class TestBulkReads:
    def test_get_nodes_batched(self, store):
        vals = store.store_data_many([Int(i) for i in range(7)])
        rows = store.get_nodes([v.pk for v in vals] + [99999])
        assert set(rows) == {v.pk for v in vals}   # missing pk absent

    def test_get_nodes_projection_adds_pk(self, store):
        v = store.store_data(Int(5))
        rows = store.get_nodes([v.pk], columns=("uuid",))
        assert set(rows[v.pk]) == {"pk", "uuid"}

    def test_get_node_projection(self, store):
        p = store.create_process_node(NodeType.CALC_FUNCTION, "F")
        row = store.get_node(p, columns=SUMMARY_COLUMNS)
        assert "payload" not in row and "checkpoint" not in row
        assert row["process_type"] == "F"

    def test_unknown_column_rejected(self, store):
        with pytest.raises(ValueError):
            store.get_node(1, columns=("pk", "evil; DROP TABLE nodes"))

    def test_unfinished_excludes_bulk_text(self, store):
        store.create_process_node(NodeType.CALC_FUNCTION, "F")
        rows = store.unfinished_processes()
        assert rows and "payload" not in rows[0]


# ---------------------------------------------------------------------------
# QueryBuilder satellites
# ---------------------------------------------------------------------------

class TestQueryBuilderFixes:
    def _fill(self, store, n=5):
        for i in range(n):
            store.create_process_node(NodeType.CALC_FUNCTION, f"T{i}")

    def test_limit_zero_returns_no_rows(self, store):
        self._fill(store)
        assert QueryBuilder(store).limit(0).all() == []

    def test_first_does_not_clobber_limit(self, store):
        self._fill(store)
        qb = QueryBuilder(store).limit(3)
        first = qb.first()
        assert first["process_type"] == "T0"
        assert len(qb.all()) == 3   # limit(3) survived first()

    def test_first_without_limit(self, store):
        self._fill(store)
        qb = QueryBuilder(store)
        assert qb.first()["process_type"] == "T0"
        assert len(qb.all()) == 5   # still unlimited

    def test_project(self, store):
        self._fill(store, 2)
        rows = QueryBuilder(store).project("process_type").all()
        assert set(rows[0]) == {"pk", "process_type"}


# ---------------------------------------------------------------------------
# schema migration: legacy profile (inline payloads, no logs index)
# ---------------------------------------------------------------------------

def _legacy_profile(path: str, arr: np.ndarray) -> None:
    """Build a pre-overhaul profile with raw SQL: inline base64 array
    payload, no logs index, no repo, no meta stamp."""
    import base64
    import io

    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    payload = json.dumps({"type": "array",
                          "npy_b64": base64.b64encode(
                              buf.getvalue()).decode()})
    conn = sqlite3.connect(path)
    conn.executescript("""
    CREATE TABLE nodes (
        pk INTEGER PRIMARY KEY AUTOINCREMENT, uuid TEXT UNIQUE NOT NULL,
        node_type TEXT NOT NULL, process_type TEXT, label TEXT DEFAULT '',
        description TEXT DEFAULT '', attributes TEXT DEFAULT '{}',
        payload TEXT, process_state TEXT, exit_status INTEGER,
        exit_message TEXT, checkpoint TEXT, node_hash TEXT,
        ctime REAL NOT NULL, mtime REAL NOT NULL);
    CREATE TABLE links (
        pk INTEGER PRIMARY KEY AUTOINCREMENT, in_id INTEGER NOT NULL,
        out_id INTEGER NOT NULL, link_type TEXT NOT NULL,
        label TEXT NOT NULL);
    CREATE TABLE logs (
        pk INTEGER PRIMARY KEY AUTOINCREMENT, node_id INTEGER NOT NULL,
        levelname TEXT NOT NULL, message TEXT NOT NULL, time REAL NOT NULL);
    CREATE TABLE meta (key TEXT PRIMARY KEY, value TEXT);
    """)
    conn.execute(
        "INSERT INTO nodes (uuid, node_type, payload, ctime, mtime)"
        " VALUES ('data-u1', 'data', ?, 1.0, 1.0)", (payload,))
    conn.execute(
        "INSERT INTO nodes (uuid, node_type, process_type, process_state,"
        " exit_status, node_hash, ctime, mtime) VALUES ('proc-u1',"
        " 'process.calcfunction', 'legacy_fn', 'finished', 0, 'hash-1',"
        " 2.0, 2.0)")
    conn.execute("INSERT INTO links (in_id, out_id, link_type, label)"
                 " VALUES (2, 1, 'create', 'result')")
    conn.execute("INSERT INTO logs (node_id, levelname, message, time)"
                 " VALUES (2, 'REPORT', 'legacy log', 2.0)")
    conn.commit()
    conn.close()


class TestLegacyMigration:
    def test_legacy_profile_migrates_on_open(self, tmp_path):
        db = str(tmp_path / "legacy.db")
        arr = np.arange(2048, dtype=np.float64)
        _legacy_profile(db, arr)

        st = ProvenanceStore(db, inline_threshold=1024)
        # payload moved out of the nodes table into the repository
        doc = json.loads(st.get_node(1)["payload"])
        assert "blob" in doc and st.repository.has(doc["blob"])
        # content identical after the move
        assert np.array_equal(st.load_data(1).value, arr)
        # logs index created
        idx = {r["name"] for r in st._conn().execute(
            "PRAGMA index_list(logs)")}
        assert "idx_logs_node" in idx
        # graph untouched
        assert st.get_logs(2) == [
            {"levelname": "REPORT", "message": "legacy log", "time": 2.0}]
        assert st.outgoing(2) == [(1, "create", "result")]

    def test_migration_is_one_shot(self, tmp_path):
        db = str(tmp_path / "legacy.db")
        _legacy_profile(db, np.arange(2048, dtype=np.float64))
        st = ProvenanceStore(db, inline_threshold=1024)
        assert st.get_meta("repo_version") == "1"
        st.close()
        # reopening does not re-scan (stamp present) and changes nothing
        st2 = ProvenanceStore(db, inline_threshold=1024)
        assert "blob" in json.loads(st2.get_node(1)["payload"])

    def test_legacy_cache_hits_unchanged_after_migration(self, tmp_path):
        """The acceptance flow: a profile written with inline payloads
        keeps serving cache hits after the payloads move to blobs."""
        from repro_torch.caching.config import enable_caching
        from repro_torch.engine.runner import Runner, set_default_runner

        db = str(tmp_path / "prof.db")
        code_common = """
from repro_torch.core import calcfunction, ArrayData
import numpy as np

@calcfunction
def make_big(seed):
    rng = np.random.default_rng(int(seed))
    return ArrayData(rng.normal(size=2048))
"""
        ns: dict = {}
        exec(code_common, ns)
        make_big = ns["make_big"]

        # 'legacy' era: huge threshold => payloads inline, like the seed
        st = ProvenanceStore(db, inline_threshold=10**9)
        set_default_runner(Runner(store=st))
        cold = make_big(Int(7))
        cold_pk = cold.pk
        st.close()
        set_default_runner(None)
        # strip the migration stamp: a real legacy profile has none
        conn = sqlite3.connect(db)
        conn.execute("DELETE FROM meta WHERE key='repo_version'")
        conn.commit()
        conn.close()

        # reopen with the real threshold: migration moves the payload out
        st2 = ProvenanceStore(db, inline_threshold=4096)
        assert "blob" in json.loads(st2.get_node(cold_pk)["payload"])
        set_default_runner(Runner(store=st2))
        with enable_caching():
            warm = make_big(Int(7))
        node = st2.get_node(warm.pk if hasattr(warm, "pk") else cold_pk)
        # the creating process of `warm` must be a cache clone
        creators = st2.incoming(warm.pk, LinkType.CREATE)
        attrs = json.loads(
            st2.get_node(creators[0][0])["attributes"] or "{}")
        assert "cached_from" in attrs
        assert np.array_equal(warm.value, cold.value)
        set_default_runner(None)
        st2.close()
        assert node is not None


# ---------------------------------------------------------------------------
# engine unit of work: commits per process
# ---------------------------------------------------------------------------

class TestUnitOfWork:
    def test_calcfunction_costs_two_commits(self, tmp_path):
        from repro_torch.core import calcfunction
        from repro_torch.engine.runner import Runner, set_default_runner

        @calcfunction
        def add(a, b):
            return a + b

        st = ProvenanceStore(str(tmp_path / "p.db"))
        set_default_runner(Runner(store=st))
        try:
            add(Int(1), Int(2))     # warm spec/import caches
            c0 = st.stats["commits"]
            add(Int(3), Int(4))
            per_process = st.stats["commits"] - c0
            # creation txn + terminal txn; allow 3 for safety margin
            assert per_process <= 3, per_process
        finally:
            set_default_runner(None)
            st.close()

    def test_checkpoint_dirty_skip(self, store, runner):
        """An unchanged checkpoint is not rewritten (dirty-flag check)."""
        from repro_torch.core import Int as _Int
        from repro_torch.core import Process

        # a plain Process body (the WorkChain twin is in
        # tests/test_torch_workchain.py)
        class Chain(Process):
            @classmethod
            def define(cls, spec):
                super().define(spec)
                spec.input("n", valid_type=_Int, default=_Int(0))
                spec.output("r", valid_type=_Int)

            async def run(self):
                self.out("r", _Int(1))

        h = runner.submit(Chain, {"n": _Int(1)})
        runner.loop.run_until_complete(h.process.wait_done())
        assert h.process.exit_code.status == 0
        # terminal: checkpoint removed, one row, outputs linked
        assert store.load_checkpoint(h.pk) is None


# ---------------------------------------------------------------------------
# checkpoints reference stored payloads instead of embedding them
# ---------------------------------------------------------------------------

class TestCheckpointByReference:
    def test_checkpoint_has_no_payload_copy(self, store, runner):
        from repro_torch.core import Process

        # a plain Process (the WorkChain twin is in
        # tests/test_torch_workchain.py)
        class Hold(Process):
            @classmethod
            def define(cls, spec):
                super().define(spec)
                spec.input("arr", valid_type=ArrayData)

            async def run(self):
                pass

        arr = np.arange(4096, dtype=np.float64)
        proc = Hold({"arr": ArrayData(arr)}, runner=runner)
        ckpt = store.load_checkpoint(proc.pk)
        entry = ckpt["inputs"]["arr"]
        assert "__data_ref__" in entry          # reference, not a copy
        assert "npy_b64" not in json.dumps(ckpt)
        # recreation rehydrates the reference through the store
        from repro_torch.core.process import _deserialize_inputs
        vals = _deserialize_inputs(ckpt["inputs"], store)
        assert np.array_equal(vals["arr"].value, arr)

    def test_legacy_inline_checkpoint_still_loads(self, store, runner):
        """Pre-overhaul checkpoints embed payloads; they must resume."""
        from repro_torch.core.process import _deserialize_inputs

        inline = {"x": {"__data__": {"type": "int", "value": 9}, "pk": 1}}
        vals = _deserialize_inputs(inline, store)
        assert vals["x"].value == 9


# ---------------------------------------------------------------------------
# cache hits on blob-backed arrays
# ---------------------------------------------------------------------------

class TestBlobCacheHit:
    def test_cache_hit_reuses_blob(self, tmp_path):
        from repro_torch.caching.config import enable_caching
        from repro_torch.core import calcfunction
        from repro_torch.engine.runner import Runner, set_default_runner

        @calcfunction
        def expensive(seed):
            rng = np.random.default_rng(int(seed))
            return ArrayData(rng.normal(size=4096))

        st = ProvenanceStore(str(tmp_path / "p.db"), inline_threshold=1024)
        set_default_runner(Runner(store=st))
        try:
            with enable_caching():
                cold = expensive(Int(3))
                blobs_after_cold = st.repository.stats()["blobs"]
                warm = expensive(Int(3))
            assert np.array_equal(cold.value, warm.value)
            assert warm.pk != cold.pk          # clone, new node
            # clone's payload dedups onto the same blob — no new content
            assert st.repository.stats()["blobs"] == blobs_after_cold
            creators = st.incoming(warm.pk, LinkType.CREATE)
            attrs = json.loads(
                st.get_node(creators[0][0])["attributes"] or "{}")
            assert "cached_from" in attrs
        finally:
            set_default_runner(None)
            st.close()


# ===========================================================================
# twins of tests/test_querybuilder.py
# ===========================================================================

@pytest.fixture()
def populated():
    store = ProvenanceStore(":memory:")
    pks = {}
    for i in range(5):
        pks[f"calc{i}"] = store.create_process_node(
            NodeType.CALC_FUNCTION, process_type="Adder",
            label=f"calc-{i}", node_hash=f"hash-{i % 2}")
    pks["work"] = store.create_process_node(
        NodeType.WORK_CHAIN, process_type="Chain", label="chain",
        node_hash=None)
    store.update_process(pks["calc0"], state="finished", exit_status=0)
    store.update_process(pks["calc1"], state="finished", exit_status=0)
    store.update_process(pks["calc2"], state="excepted", exit_status=999)
    return store, pks


class TestQueryBuilder:
    def test_count(self, populated):
        store, _ = populated
        assert QueryBuilder(store).count() == 6
        assert QueryBuilder(store).nodes("process").count() == 6
        assert QueryBuilder(store).nodes(NodeType.CALC_FUNCTION).count() == 5
        assert QueryBuilder(store).nodes(NodeType.DATA).count() == 0

    def test_order_by_pk_desc(self, populated):
        store, pks = populated
        rows = QueryBuilder(store).order_by("pk", desc=True).all()
        assert [r["pk"] for r in rows] == sorted(
            (r["pk"] for r in rows), reverse=True)
        assert rows[0]["pk"] == pks["work"]

    def test_order_by_rejects_unknown_field(self, populated):
        store, _ = populated
        with pytest.raises(AssertionError):
            QueryBuilder(store).order_by("attributes; DROP TABLE nodes")

    def test_order_by_mtime(self, populated):
        store, pks = populated
        # update_process bumps mtime, so the excepted node sorts last
        rows = QueryBuilder(store).order_by("mtime", desc=True).all()
        assert rows[0]["pk"] == pks["calc2"]

    def test_limit(self, populated):
        store, _ = populated
        assert len(QueryBuilder(store).limit(2).all()) == 2
        assert len(QueryBuilder(store).limit(100).all()) == 6

    def test_first(self, populated):
        store, pks = populated
        first = QueryBuilder(store).nodes(NodeType.CALC_FUNCTION) \
            .order_by("pk").first()
        assert first["pk"] == pks["calc0"]
        assert QueryBuilder(store).with_state("nonexistent").first() is None

    def test_filter_chaining(self, populated):
        store, _ = populated
        n = (QueryBuilder(store).nodes(NodeType.CALC_FUNCTION)
             .with_state("finished").with_exit_status(0).count())
        assert n == 2

    def test_with_label(self, populated):
        store, pks = populated
        rows = QueryBuilder(store).with_label("chain").all()
        assert [r["pk"] for r in rows] == [pks["work"]]

    # -- node_hash column ----------------------------------------------------
    def test_with_hash(self, populated):
        store, _ = populated
        rows = QueryBuilder(store).with_hash("hash-0").all()
        assert len(rows) == 3
        assert all(r["node_hash"] == "hash-0" for r in rows)
        assert QueryBuilder(store).with_hash("hash-1").count() == 2
        assert QueryBuilder(store).with_hash("missing").count() == 0

    def test_with_process_type_and_hash(self, populated):
        store, pks = populated
        row = (QueryBuilder(store).with_process_type("Adder")
               .with_hash("hash-0").with_state("finished")
               .with_exit_status(0).order_by("pk", desc=True).first())
        assert row["pk"] == pks["calc0"]

    def test_hash_column_survives_roundtrip(self, tmp_path):
        path = str(tmp_path / "qb.db")
        store = ProvenanceStore(path)
        pk = store.create_process_node(NodeType.CALC_JOB, "Job",
                                       node_hash="abc123")
        store.close()
        reopened = ProvenanceStore(path)
        assert reopened.get_node(pk)["node_hash"] == "abc123"
        assert QueryBuilder(reopened).with_hash("abc123").count() == 1

    def test_set_node_hash_and_invalidation_query(self, populated):
        store, pks = populated
        store.set_node_hash(pks["calc0"], None)
        assert QueryBuilder(store).with_hash("hash-0").count() == 2
        store.set_node_hash(pks["calc3"], "rehashed")
        assert QueryBuilder(store).with_hash("rehashed").count() == 1


def test_migration_adds_node_hash_to_legacy_db(tmp_path):
    """A database created before the caching subsystem gains the column
    (and index) on open."""
    import sqlite3

    path = str(tmp_path / "legacy.db")
    conn = sqlite3.connect(path)
    conn.executescript("""
        CREATE TABLE nodes (
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
            ctime REAL NOT NULL,
            mtime REAL NOT NULL
        );
        INSERT INTO nodes (uuid, node_type, process_type, process_state,
                           ctime, mtime)
        VALUES ('u-1', 'process.calcjob', 'OldJob', 'finished', 1.0, 1.0);
    """)
    conn.commit()
    conn.close()

    store = ProvenanceStore(path)
    node = store.get_node(1)
    assert node["node_hash"] is None           # legacy rows: no fingerprint
    store.set_node_hash(1, "backfilled")
    assert QueryBuilder(store).with_hash("backfilled").count() == 1
    indexes = {r[1] for r in
               store._conn().execute("PRAGMA index_list(nodes)")}
    assert "idx_nodes_hash" in indexes


# ===========================================================================
# twins of tests/test_provenance.py
# ===========================================================================

def test_store_and_load_roundtrip(store):
    for value in (Int(7), Float(2.5), Str("hi"), Dict({"a": 1}),
                  ArrayData(np.arange(6).reshape(2, 3))):
        store.store_data(value)
        loaded = store.load_data(value.pk)
        assert loaded == value
        assert loaded.uuid == value.uuid


def test_folder_data_roundtrip(store):
    f = FolderData({"metrics.json": b"{}", "log.txt": b"hello"})
    store.store_data(f)
    loaded = store.load_data(f.pk)
    assert loaded.names() == ["log.txt", "metrics.json"]
    assert loaded.get_bytes("log.txt") == b"hello"


def test_store_is_idempotent(store):
    v = Int(3)
    store.store_data(v)
    pk1 = v.pk
    store.store_data(v)
    assert v.pk == pk1
    assert store.count_nodes(NodeType.DATA) == 1


def test_links_and_traversal(store):
    a, b = Int(1), Int(2)
    store.store_data(a)
    store.store_data(b)
    proc = store.create_process_node(NodeType.CALC_FUNCTION, "add")
    store.add_link(a.pk, proc, LinkType.INPUT_CALC, "x")
    store.add_link(b.pk, proc, LinkType.INPUT_CALC, "y")
    out = Int(3)
    store.store_data(out)
    store.add_link(proc, out.pk, LinkType.CREATE, "result")
    assert {p for p, _, _ in store.incoming(proc)} == {a.pk, b.pk}
    assert [p for p, _, _ in store.outgoing(proc)] == [out.pk]


def test_querybuilder_filters(store):
    for i in range(5):
        pk = store.create_process_node(NodeType.WORK_CHAIN, "WC",
                                       label=f"wc{i}")
        store.update_process(pk, state="finished", exit_status=i % 2)
    qb = QueryBuilder(store).nodes(NodeType.WORK_CHAIN).with_exit_status(0)
    assert qb.count() == 3
    assert QueryBuilder(store).nodes(NodeType.WORK_CHAIN) \
        .with_label("wc3").first()["label"] == "wc3"
    assert QueryBuilder(store).nodes("process").count() == 5


def test_logs(store):
    pk = store.create_process_node(NodeType.WORK_CHAIN, "WC")
    store.add_log(pk, "REPORT", "hello world")
    store.add_log(pk, "ERROR", "boom")
    logs = store.get_logs(pk)
    assert [l["levelname"] for l in logs] == ["REPORT", "ERROR"]


def test_unfinished_processes(store):
    p1 = store.create_process_node(NodeType.CALC_JOB, "J")
    p2 = store.create_process_node(NodeType.CALC_JOB, "J")
    store.update_process(p2, state="finished", exit_status=0)
    unfinished = [n["pk"] for n in store.unfinished_processes()]
    assert p1 in unfinished and p2 not in unfinished


def test_checkpoint_roundtrip(store):
    pk = store.create_process_node(NodeType.WORK_CHAIN, "WC")
    assert store.load_checkpoint(pk) is None
    store.save_checkpoint(pk, {"stage": "submit", "ctx": {"n": 3}})
    assert store.load_checkpoint(pk)["ctx"]["n"] == 3
    store.delete_checkpoint(pk)
    assert store.load_checkpoint(pk) is None


@given(st.one_of(
    st.integers(min_value=-10**9, max_value=10**9),
    st.floats(allow_nan=False, allow_infinity=False, width=32),
    st.text(max_size=40),
    st.booleans(),
    st.lists(st.integers(min_value=0, max_value=100), max_size=10),
))
@settings(max_examples=40, deadline=None)
def test_datavalue_payload_roundtrip_property(value):
    dv = to_data_value(value)
    back = DataValue.from_payload(dv.to_payload())
    assert back == dv


@given(st.integers(min_value=1, max_value=12))
@settings(max_examples=10, deadline=None)
def test_provenance_graph_acyclic_property(n_calls):
    """Chained calcfunction executions form a DAG: no pk is reachable from
    itself following link direction."""
    from repro_torch.core import calcfunction
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.provenance.store import configure_store

    store = configure_store(":memory:")
    set_default_runner(Runner(store=store))

    @calcfunction
    def inc(a):
        return Int(a.value + 1)

    v = Int(0)
    for _ in range(n_calls):
        v = inc(v)
    assert v.value == n_calls

    # BFS over outgoing links from every node; no cycles
    edges = {}
    total = store.count_nodes()
    for pk in range(1, total + 1):
        edges[pk] = [o for o, _, _ in store.outgoing(pk)]
    seen_order = {}

    def dfs(u, stack):
        assert u not in stack, "cycle in provenance graph"
        if u in seen_order:
            return
        seen_order[u] = True
        for w in edges.get(u, []):
            dfs(w, stack | {u})

    for pk in edges:
        dfs(pk, frozenset())
    set_default_runner(None)


# ===========================================================================
# parity with the reference: schema and profiles
# ===========================================================================

def _ddl(store_cls, path):
    st = store_cls(str(path))
    st.close()
    conn = sqlite3.connect(str(path))
    try:
        return sorted(conn.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master"))
    finally:
        conn.close()


def test_schema_matches_reference(tmp_path):
    from repro.provenance.store import ProvenanceStore as JStore

    port = _ddl(ProvenanceStore, tmp_path / "port.db")
    assert port == _ddl(JStore, tmp_path / "ref.db")
    assert {name for kind, name, _, _ in port if kind == "table"} >= {
        "nodes", "links", "logs", "meta"}


def _data_values(qb_cls, st):
    return {r["pk"]: st.load_data(r["pk"]).value
            for r in qb_cls(st).nodes("data").project("pk").all()}


def _write_profile(core, runner_mod, store_cls, qb_cls, path):
    """Run a few calcfunctions (one output a blob-sized array) into a file
    profile with one package's engine; return (node count, data values by
    pk)."""
    @core.calcfunction
    def scale(x, arr):
        return {"y": core.Int(x.value * 3),
                "big": core.ArrayData(np.asarray(arr.value) * x.value)}

    st = store_cls(str(path), inline_threshold=1024)
    runner_mod.set_default_runner(runner_mod.Runner(store=st))
    try:
        for i in range(3):
            scale(core.Int(i), core.ArrayData(np.arange(512, dtype=np.float64)))
        return st.count_nodes(), _data_values(qb_cls, st)
    finally:
        runner_mod.set_default_runner(None)
        st.close()


def _read_profile(store_cls, qb_cls, path):
    """Open a profile with the other package's store: (node count,
    finished-ok CalcFunctionNodes, data values by pk)."""
    st = store_cls(str(path), inline_threshold=1024)
    try:
        n_proc = qb_cls(st).nodes(NodeType.CALC_FUNCTION.value) \
            .with_state("finished").with_exit_status(0).count()
        return qb_cls(st).count(), n_proc, _data_values(qb_cls, st)
    finally:
        st.close()


def _same_values(a, b):
    assert a.keys() == b.keys()
    for pk, value in a.items():
        np.testing.assert_array_equal(np.asarray(b[pk]), np.asarray(value))


def test_port_profile_reads_back_in_reference(tmp_path):
    import repro_torch.core as core
    import repro_torch.engine.runner as runner_mod
    from repro.provenance.store import ProvenanceStore as JStore
    from repro.provenance.store import QueryBuilder as JQueryBuilder

    db = tmp_path / "port.db"
    n, data = _write_profile(core, runner_mod, ProvenanceStore, QueryBuilder,
                             db)
    n_ref, n_proc, data_ref = _read_profile(JStore, JQueryBuilder, db)
    assert n_ref == n and n_proc == 3
    _same_values(data, data_ref)


def test_reference_profile_reads_back_in_port(tmp_path):
    import repro.core as j_core
    import repro.engine.runner as j_runner
    from repro.provenance.store import ProvenanceStore as JStore
    from repro.provenance.store import QueryBuilder as JQueryBuilder

    db = tmp_path / "ref.db"
    n, data = _write_profile(j_core, j_runner, JStore, JQueryBuilder, db)
    n_port, n_proc, data_port = _read_profile(ProvenanceStore, QueryBuilder,
                                              db)
    assert n_port == n and n_proc == 3
    _same_values(data, data_port)


MIGRATION_PROCESSES, MIGRATION_ROUNDS = 8, 6


def test_fresh_profile_opened_by_many_processes_at_once(tmp_path):
    """Processes released together by a barrier open one fresh profile:
    none raises (each runs the schema migration; with the read of the
    columns and the ``ALTER`` apart, all but the first failed with
    ``duplicate column name: lease_epoch``), and the profile has one
    ``lease_epoch`` column. Repeated on a new profile each round."""
    import multiprocessing as mp
    import queue
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    import _torch_store_race as race

    ctx = mp.get_context("spawn")
    for rnd in range(MIGRATION_ROUNDS):
        path = str(tmp_path / f"fresh{rnd}.db")
        barrier, errors = ctx.Barrier(MIGRATION_PROCESSES), ctx.Queue()
        procs = [ctx.Process(target=race.open_profile,
                             args=(path, barrier, errors))
                 for _ in range(MIGRATION_PROCESSES)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=120)
        raised = []
        while True:
            try:
                raised.append(errors.get(timeout=0.5))
            except queue.Empty:
                break
        assert [p.exitcode for p in procs] == [0] * len(procs)
        assert not raised, (rnd, raised)
        conn = sqlite3.connect(path)
        cols = [r[1] for r in conn.execute("PRAGMA table_info(nodes)")]
        conn.close()
        assert cols.count("lease_epoch") == 1, cols
