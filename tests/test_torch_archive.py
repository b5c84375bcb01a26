"""The port's provenance archives and cache backfill, on the CPU.

Twins of ``tests/test_archive.py`` (closure traversal, versioned
export/import with pk remapping and content-hash dedup, cross-profile
cache sharing, the legacy-node hash backfill and the archive CLI) and of
``tests/test_store.py::TestConcurrentWriters``, run against
``repro_torch``. The parity cases run the same processes, defined here,
in both packages: each package's archive imports into the other's store,
and the importing package re-exports it byte for byte.
"""

import importlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.caching import backfill_hashes, enable_caching
from repro_torch.caching.registry import CacheRegistry
from repro_torch.core import (
    ArrayData, Int, Process, ProcessSpec, WorkChain,
    calcfunction,
)
from repro_torch.provenance import (
    ArchiveError, ProvenanceStore, compute_closure, export_archive,
    import_archive, read_manifest,
)
from repro_torch.provenance.store import LinkType, NodeType, QueryBuilder

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


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


# ---------------------------------------------------------------------------
# graph fixtures
# ---------------------------------------------------------------------------

def _data(store, value=0):
    from repro_torch.core.datatypes import Int as IntData

    return store.store_data(IntData(value)).pk


def _proc(store, name="Calc", state="finished", exit_status=0,
          node_type=NodeType.CALC_FUNCTION, node_hash=None):
    pk = store.create_process_node(node_type, process_type=name,
                                   node_hash=node_hash)
    store.update_process(pk, state=state, exit_status=exit_status)
    return pk


def build_diamond(store):
    """d0 feeds calcs A and B; calc C consumes both of their outputs.

            d0
           /  \\
          A    B
          |    |
          dA   dB
           \\  /
            C
            |
            dC
    """
    d0 = _data(store, 0)
    a, b = _proc(store, "A"), _proc(store, "B")
    store.add_link(d0, a, LinkType.INPUT_CALC, "x")
    store.add_link(d0, b, LinkType.INPUT_CALC, "x")
    da, db = _data(store, 1), _data(store, 2)
    store.add_link(a, da, LinkType.CREATE, "out")
    store.add_link(b, db, LinkType.CREATE, "out")
    c = _proc(store, "C")
    store.add_link(da, c, LinkType.INPUT_CALC, "left")
    store.add_link(db, c, LinkType.INPUT_CALC, "right")
    dc = _data(store, 3)
    store.add_link(c, dc, LinkType.CREATE, "out")
    return {"d0": d0, "a": a, "b": b, "da": da, "db": db, "c": c, "dc": dc}


def build_workchains(store):
    """Two sibling workchains under one parent, each calling a calc."""
    parent = _proc(store, "Parent", node_type=NodeType.WORK_CHAIN)
    w1 = _proc(store, "W1", node_type=NodeType.WORK_CHAIN)
    w2 = _proc(store, "W2", node_type=NodeType.WORK_CHAIN)
    store.add_link(parent, w1, LinkType.CALL_WORK, "CALL_1")
    store.add_link(parent, w2, LinkType.CALL_WORK, "CALL_2")
    c1, c2 = _proc(store, "C1"), _proc(store, "C2")
    store.add_link(w1, c1, LinkType.CALL_CALC, "CALL_3")
    store.add_link(w2, c2, LinkType.CALL_CALC, "CALL_4")
    din = _data(store, 0)
    store.add_link(din, c1, LinkType.INPUT_CALC, "x")
    store.add_link(din, c2, LinkType.INPUT_CALC, "x")
    d1, d2 = _data(store, 1), _data(store, 2)
    store.add_link(c1, d1, LinkType.CREATE, "out")
    store.add_link(c2, d2, LinkType.CREATE, "out")
    store.add_link(w1, d1, LinkType.RETURN, "result")
    return {"parent": parent, "w1": w1, "w2": w2, "c1": c1, "c2": c2,
            "din": din, "d1": d1, "d2": d2}


# ---------------------------------------------------------------------------
# closure traversal
# ---------------------------------------------------------------------------

class TestClosure:
    def test_diamond_from_sink_pulls_all_ancestors(self, store):
        g = build_diamond(store)
        assert compute_closure(store, [g["c"]]) == set(g.values())

    def test_diamond_from_source_pulls_all_descendants(self, store):
        g = build_diamond(store)
        # d0's creators: none; its consumers are reached because the
        # descendant sweep starts from the selection's processes only —
        # a data seed alone must NOT drag in its consumers
        assert compute_closure(store, [g["d0"]]) == {g["d0"]}

    def test_process_seed_descends_and_closes_inputs(self, store):
        g = build_diamond(store)
        got = compute_closure(store, [g["a"]], ancestors=False)
        # A's inputs (always), its output, but not B's branch; C is not
        # reached because data nodes do not traverse to consumers
        assert got == {g["d0"], g["a"], g["da"]}

    def test_inputs_included_even_without_ancestors(self, store):
        g = build_diamond(store)
        got = compute_closure(store, [g["c"]], ancestors=False,
                              descendants=False)
        assert got == {g["c"], g["da"], g["db"]}

    def test_ancestors_only(self, store):
        g = build_diamond(store)
        got = compute_closure(store, [g["c"]], descendants=False)
        assert got == set(g.values()) - {g["dc"]}

    def test_workchain_seed_exports_whole_call_tree(self, store):
        g = build_workchains(store)
        assert compute_closure(store, [g["parent"]]) == set(g.values())

    def test_child_seed_pulls_caller_not_sibling(self, store):
        g = build_workchains(store)
        got = compute_closure(store, [g["c1"]], descendants=False)
        assert g["w1"] in got and g["parent"] in got
        assert g["c2"] not in got and g["w2"] not in got

    def test_sibling_reached_through_caller_descent(self, store):
        g = build_workchains(store)
        # with both directions on, the caller chain re-descends into the
        # sibling branch: the export is the full connected call tree
        assert compute_closure(store, [g["c1"]]) == set(g.values())

    def test_unknown_pk_raises(self, store):
        with pytest.raises(KeyError):
            compute_closure(store, [999])


# ---------------------------------------------------------------------------
# export / import round trip
# ---------------------------------------------------------------------------

@calcfunction
def add(a, b):
    return a + b


@calcfunction
def norm(arr):
    return ArrayData(np.linalg.norm(arr.value, axis=-1))


def _volatile(manifest):
    return {k: v for k, v in manifest.items() if k != "source"}


class TestRoundTrip:
    def test_manifest_counts(self, store, runner, tmp_path):
        add(Int(1), Int(2))
        manifest = export_archive(store, str(tmp_path / "a.zip"))
        assert manifest["archive_version"] == 1
        assert manifest["nodes"] == 4
        assert manifest["links"] == 3
        assert manifest["node_types"] == {"data": 3,
                                          "process.calcfunction": 1}

    def test_export_import_export_identical_manifests(self, store, runner,
                                                      tmp_path):
        add(Int(1), Int(2))
        add(Int(5), Int(6))
        norm(ArrayData(np.arange(12.0).reshape(3, 4)))
        m1 = export_archive(store, str(tmp_path / "a.zip"))

        target = ProvenanceStore(str(tmp_path / "b.db"))
        import_archive(target, str(tmp_path / "a.zip"))
        m2 = export_archive(target, str(tmp_path / "b.zip"))
        assert _volatile(m1) == _volatile(m2)
        assert m1["content_digest"] == m2["content_digest"]

    def test_random_graphs_round_trip(self, store, tmp_path):
        """Property-style: archives of randomly shaped DAGs survive the
        trip bit-identically (pk-free content digest)."""
        rng = np.random.default_rng(42)
        for trial in range(5):
            src = ProvenanceStore(":memory:")
            data = [_data(src, int(v)) for v in rng.integers(0, 99, 6)]
            for i in range(int(rng.integers(2, 6))):
                p = _proc(src, f"P{i}", node_hash=f"h{trial}-{i}")
                for d in rng.choice(data, 2, replace=False):
                    src.add_link(int(d), p, LinkType.INPUT_CALC,
                                 f"in{int(d)}")
                out = _data(src, i)
                src.add_link(p, out, LinkType.CREATE, "out")
                src.add_log(p, "REPORT", f"ran P{i}")
            a = str(tmp_path / f"t{trial}a.zip")
            b = str(tmp_path / f"t{trial}b.zip")
            m1 = export_archive(src, a)
            dst = ProvenanceStore(":memory:")
            import_archive(dst, a)
            m2 = export_archive(dst, b)
            assert _volatile(m1) == _volatile(m2)
            with open(a, "rb") as f1, open(b, "rb") as f2:
                assert f1.read() == f2.read()  # byte-identical zips

    def test_array_payload_round_trip(self, store, runner, tmp_path):
        arr = np.arange(24.0).reshape(4, 6)
        _res, node, _ec = norm.run_get_node(ArrayData(arr))
        export_archive(store, str(tmp_path / "a.zip"), [node.pk])
        target = ProvenanceStore(":memory:")
        result = import_archive(target, str(tmp_path / "a.zip"))
        proc_pk = result.pk_map[store.get_node(node.pk)["uuid"]]
        inputs = {label: target.load_data(pk)
                  for pk, _lt, label in target.incoming(proc_pk)}
        assert np.array_equal(inputs["arr"].value, arr)
        outputs = {label: target.load_data(pk)
                   for pk, _lt, label in target.outgoing(proc_pk)}
        assert np.allclose(outputs["result"].value,
                           np.linalg.norm(arr, axis=-1))

    def test_logs_and_attributes_travel(self, store, tmp_path):
        p = _proc(store, "Noisy")
        store.add_log(p, "REPORT", "hello from A")
        store.update_process(p, attributes={"custom": "kept"})
        export_archive(store, str(tmp_path / "a.zip"), [p])
        target = ProvenanceStore(":memory:")
        result = import_archive(target, str(tmp_path / "a.zip"))
        new_pk = result.pk_map[store.get_node(p)["uuid"]]
        logs = target.get_logs(new_pk)
        assert [(entry["levelname"], entry["message"]) for entry in logs] \
            == [("REPORT", "hello from A")]
        attrs = json.loads(target.get_node(new_pk)["attributes"])
        assert attrs["custom"] == "kept"

    def test_uuid_and_times_preserved(self, store, tmp_path):
        p = _proc(store, "Keeper")
        node = store.get_node(p)
        export_archive(store, str(tmp_path / "a.zip"), [p])
        target = ProvenanceStore(":memory:")
        result = import_archive(target, str(tmp_path / "a.zip"))
        imported = target.get_node(result.pk_map[node["uuid"]])
        assert imported["uuid"] == node["uuid"]
        assert imported["ctime"] == node["ctime"]
        assert imported["node_hash"] == node["node_hash"]

    def test_not_an_archive(self, store, tmp_path):
        bogus = tmp_path / "bogus.zip"
        import zipfile

        with zipfile.ZipFile(bogus, "w") as zf:
            zf.writestr("unrelated.txt", "nope")
        with pytest.raises(ArchiveError):
            read_manifest(str(bogus))

    def test_non_zip_and_missing_file_raise_archive_error(self, store,
                                                          tmp_path):
        not_zip = tmp_path / "plain.txt"
        not_zip.write_text("not a zip at all")
        with pytest.raises(ArchiveError):
            read_manifest(str(not_zip))
        with pytest.raises(ArchiveError):
            import_archive(store, str(tmp_path / "does_not_exist.zip"))

    def test_corrupt_archive_import_rolls_back(self, store, runner,
                                               tmp_path):
        """A missing payload member aborts the import atomically: the
        target store is left exactly as it was."""
        import zipfile

        arr = ArrayData(np.arange(6.0))
        _res, node, _ec = norm.run_get_node(arr)
        good = tmp_path / "good.zip"
        export_archive(store, str(good), [node.pk])
        bad = tmp_path / "bad.zip"
        with zipfile.ZipFile(good) as src, \
                zipfile.ZipFile(bad, "w") as dst:
            for info in src.infolist():
                if not info.filename.startswith("payloads/"):
                    dst.writestr(info, src.read(info))
        target = ProvenanceStore(":memory:")
        with pytest.raises(ArchiveError):
            import_archive(target, str(bad))
        assert target.count_nodes() == 0
        assert target._conn().execute(
            "SELECT COUNT(*) c FROM links").fetchone()["c"] == 0

    def test_version_gate(self, store, tmp_path):
        import zipfile

        bad = tmp_path / "future.zip"
        with zipfile.ZipFile(bad, "w") as zf:
            zf.writestr("manifest.json",
                        json.dumps({"archive_version": 99}))
        with pytest.raises(ArchiveError):
            import_archive(store, str(bad))


# ---------------------------------------------------------------------------
# import semantics: idempotence and dedup
# ---------------------------------------------------------------------------

class TestImportMerge:
    def test_reimport_is_noop(self, store, runner, tmp_path):
        add(Int(1), Int(2))
        export_archive(store, str(tmp_path / "a.zip"))
        target = ProvenanceStore(":memory:")
        first = import_archive(target, str(tmp_path / "a.zip"))
        again = import_archive(target, str(tmp_path / "a.zip"))
        assert first.nodes_imported == 4
        assert again.nodes_imported == 0
        assert again.nodes_existing == 4
        assert again.links_imported == 0
        assert target.count_nodes() == 4

    def test_hash_dedup_maps_to_existing_equivalent(self, store, runner,
                                                    tmp_path):
        """B already computed the same calculation: the archive node is
        not duplicated, its uuid maps onto B's own node."""
        _res, node, _ec = add.run_get_node(Int(1), Int(2))
        src_hash = store.get_node(node.pk)["node_hash"]
        assert src_hash
        export_archive(store, str(tmp_path / "a.zip"))

        # profile B independently ran the identical calc (same class,
        # same inputs -> same node_hash), under different uuids
        from repro_torch.engine.runner import Runner, set_default_runner
        from repro_torch.provenance.store import configure_store

        target = configure_store(":memory:")
        set_default_runner(Runner(store=target))
        _res2, node_b, _ec2 = add.run_get_node(Int(1), Int(2))
        assert target.get_node(node_b.pk)["node_hash"] == src_hash
        before = target.count_nodes()

        result = import_archive(target, str(tmp_path / "a.zip"))
        assert result.nodes_deduped == 1
        assert result.pk_map[store.get_node(node.pk)["uuid"]] == node_b.pk
        # the deduped process's links were dropped, and its private
        # input/output data nodes — which would have imported with no
        # edges at all — were skipped with it: no orphan pollution
        assert result.links_imported == 0
        assert result.nodes_skipped_orphaned == 3
        assert target.count_nodes() == before

    def test_shared_input_of_deduped_calc_still_imports(self, store,
                                                        tmp_path):
        """A data node feeding both a deduped calc and a fresh calc must
        be imported (only its deduped-side link is dropped)."""
        shared = _data(store, 7)
        p1 = _proc(store, "Dup", node_hash="same")
        p2 = _proc(store, "Fresh", node_hash="other")
        store.add_link(shared, p1, LinkType.INPUT_CALC, "x")
        store.add_link(shared, p2, LinkType.INPUT_CALC, "x")
        export_archive(store, str(tmp_path / "a.zip"), [p1, p2],
                       descendants=False)

        target = ProvenanceStore(":memory:")
        _proc(target, "Dup", node_hash="same")  # pre-existing equivalent
        result = import_archive(target, str(tmp_path / "a.zip"))
        assert result.nodes_deduped == 1
        assert result.nodes_skipped_orphaned == 0
        shared_pk = result.pk_map[store.get_node(shared)["uuid"]]
        # exactly the fresh-side link survives
        assert [lt for _pk, lt, _l in target.outgoing(shared_pk)] \
            == [LinkType.INPUT_CALC.value]

    def test_no_dedup_flag_imports_duplicate(self, store, runner, tmp_path):
        from repro_torch.engine.runner import Runner, set_default_runner
        from repro_torch.provenance.store import configure_store

        add.run_get_node(Int(1), Int(2))
        export_archive(store, str(tmp_path / "a.zip"))
        target = configure_store(":memory:")
        set_default_runner(Runner(store=target))
        add.run_get_node(Int(1), Int(2))
        result = import_archive(target, str(tmp_path / "a.zip"),
                                dedup=False)
        assert result.nodes_deduped == 0
        assert result.nodes_imported == 4

    def test_failed_nodes_are_not_dedup_targets(self, store, tmp_path):
        failed = _proc(store, "F", state="excepted", exit_status=1,
                       node_hash="hf")
        export_archive(store, str(tmp_path / "a.zip"), [failed])
        target = ProvenanceStore(":memory:")
        t = _proc(target, "F", state="excepted", exit_status=1,
                  node_hash="hf")
        result = import_archive(target, str(tmp_path / "a.zip"))
        assert result.nodes_deduped == 0
        assert result.nodes_imported == 1
        assert target.get_node(t) is not None

    def test_cached_from_pk_remapped(self, store, runner, tmp_path):
        _r1, n1, _e1 = add.run_get_node(Int(3), Int(4))
        with enable_caching():
            _r2, n2, _e2 = add.run_get_node(Int(3), Int(4))
        attrs = json.loads(store.get_node(n2.pk)["attributes"])
        assert attrs["cached_from_pk"] == n1.pk
        export_archive(store, str(tmp_path / "a.zip"))
        target = ProvenanceStore(":memory:")
        result = import_archive(target, str(tmp_path / "a.zip"),
                                dedup=False)
        clone_pk = result.pk_map[store.get_node(n2.pk)["uuid"]]
        src_pk = result.pk_map[store.get_node(n1.pk)["uuid"]]
        imported = json.loads(target.get_node(clone_pk)["attributes"])
        assert imported["cached_from"] == store.get_node(n1.pk)["uuid"]
        assert imported["cached_from_pk"] == src_pk


# ---------------------------------------------------------------------------
# the acceptance demo: cross-profile cache sharing
# ---------------------------------------------------------------------------

class Grind(Process):
    NODE_TYPE = NodeType.CALC_FUNCTION
    executions = 0

    @classmethod
    def define(cls, spec: ProcessSpec) -> None:
        super().define(spec)
        spec.input("x", valid_type=Int, serializer=Int)
        spec.output("y", valid_type=Int)

    async def run(self):
        type(self).executions += 1
        self.out("y", Int(self.inputs["x"].value * 10))


@pytest.fixture(autouse=True)
def _reset_grind():
    Grind.executions = 0


class TestCrossProfileSharing:
    def test_imported_nodes_serve_cache_hits(self, store, runner, tmp_path):
        """Export finished-ok nodes from profile A, import into fresh B,
        relaunch in B with caching -> no recompute, `cached_from` points
        at the imported node."""
        from repro_torch.engine.launch import run_get_node
        from repro_torch.engine.runner import Runner, set_default_runner
        from repro_torch.provenance.store import configure_store

        _res, node_a = run_get_node(Grind, x=3)
        assert Grind.executions == 1
        a_uuid = store.get_node(node_a.pk)["uuid"]
        export_archive(store, str(tmp_path / "results.zip"), [node_a.pk])

        store_b = configure_store(str(tmp_path / "b.db"))
        set_default_runner(Runner(store=store_b))
        result = import_archive(store_b, str(tmp_path / "results.zip"))
        imported_pk = result.pk_map[a_uuid]

        with enable_caching(Grind):
            res_b, node_b = run_get_node(Grind, x=3)
        assert Grind.executions == 1, "imported result must short-circuit"
        assert res_b["y"].value == 30
        attrs = json.loads(store_b.get_node(node_b.pk)["attributes"])
        assert attrs["cached_from"] == a_uuid
        assert attrs["cached_from_pk"] == imported_pk
        # and it shows up in the registry's stats as a hit
        assert CacheRegistry(store_b).stats()["cache_hits"] == 1

    def test_different_inputs_still_compute(self, store, runner, tmp_path):
        from repro_torch.engine.launch import run_get_node
        from repro_torch.engine.runner import Runner, set_default_runner
        from repro_torch.provenance.store import configure_store

        _res, node_a = run_get_node(Grind, x=3)
        export_archive(store, str(tmp_path / "results.zip"), [node_a.pk])
        store_b = configure_store(":memory:")
        set_default_runner(Runner(store=store_b))
        import_archive(store_b, str(tmp_path / "results.zip"))
        with enable_caching(Grind):
            res, _node = run_get_node(Grind, x=4)
        assert Grind.executions == 2, "different fingerprint: no hit"
        assert res["y"].value == 40


# ---------------------------------------------------------------------------
# hash backfill
# ---------------------------------------------------------------------------

def _wipe_hashes(store):
    """Simulate a legacy pre-caching profile."""
    store._conn().execute("UPDATE nodes SET node_hash=NULL")
    store._conn().commit()


class TestBackfill:
    def test_legacy_node_becomes_cache_hittable(self, store, runner):
        from repro_torch.engine.launch import run_get_node

        run_get_node(Grind, x=5)
        _wipe_hashes(store)
        with enable_caching(Grind):
            run_get_node(Grind, x=5)
        assert Grind.executions == 2, "no hash, no hit"
        _wipe_hashes(store)  # both nodes are now hash-less "legacy" rows

        stats = backfill_hashes(store, classes={"Grind": Grind})
        assert stats.hashed == 2 and stats.scanned == 2
        with enable_caching(Grind):
            _res, node = run_get_node(Grind, x=5)
        assert Grind.executions == 2, "backfilled node now serves the hit"
        attrs = json.loads(store.get_node(node.pk)["attributes"])
        assert "cached_from" in attrs

    def test_backfilled_hash_matches_fresh_launch_hash(self, store, runner):
        from repro_torch.engine.launch import run_get_node

        _res, node = run_get_node(Grind, x=7)
        fresh = store.get_node(node.pk)["node_hash"]
        _wipe_hashes(store)
        backfill_hashes(store, classes={"Grind": Grind})
        assert store.get_node(node.pk)["node_hash"] == fresh

    def test_idempotent(self, store, runner):
        from repro_torch.engine.launch import run_get_node

        run_get_node(Grind, x=1)
        _wipe_hashes(store)
        first = backfill_hashes(store, classes={"Grind": Grind})
        second = backfill_hashes(store, classes={"Grind": Grind})
        assert first.hashed == 1
        assert second.scanned == 0 and second.hashed == 0

    def test_dry_run_writes_nothing(self, store, runner):
        from repro_torch.engine.launch import run_get_node

        _res, node = run_get_node(Grind, x=2)
        _wipe_hashes(store)
        before = {r["pk"]: (r["attributes"], r["mtime"])
                  for r in store._conn().execute("SELECT * FROM nodes")}
        stats = backfill_hashes(store, classes={"Grind": Grind},
                                dry_run=True)
        assert stats.hashed == 1 and stats.dry_run
        assert store.get_node(node.pk)["node_hash"] is None
        assert store.get_meta("cache_backfill.hashed") is None
        assert store.get_meta("cache_backfill.runs") is None
        # a dry run must not touch the database at all
        after = {r["pk"]: (r["attributes"], r["mtime"])
                 for r in store._conn().execute("SELECT * FROM nodes")}
        assert after == before

    def test_unresolvable_type_counted_not_fatal(self, store):
        _proc(store, "NoSuchClassAnywhere")
        stats = backfill_hashes(store)
        assert stats.skipped_unresolvable == 1 and stats.hashed == 0

    def test_invalidated_nodes_respected(self, store, runner):
        from repro_torch.engine.launch import run_get_node

        _res, node = run_get_node(Grind, x=9)
        CacheRegistry(store).invalidate(pk=node.pk)
        stats = backfill_hashes(store, classes={"Grind": Grind})
        assert stats.skipped_invalidated == 1
        assert store.get_node(node.pk)["node_hash"] is None
        stats = backfill_hashes(store, classes={"Grind": Grind},
                                include_invalidated=True)
        assert stats.hashed == 1
        assert store.get_node(node.pk)["node_hash"]

    def test_workchains_not_backfilled(self, store, runner):
        class Chain(WorkChain):
            @classmethod
            def define(cls, spec):
                super().define(spec)
                spec.input("x", valid_type=Int, serializer=Int)
                spec.outline(cls.step)

            def step(self):
                pass

        from repro_torch.engine.launch import run_get_node

        run_get_node(Chain, x=1)
        _wipe_hashes(store)
        stats = backfill_hashes(store, classes={"Chain": Chain})
        assert stats.scanned == 0

    def test_batched_progress(self, store, runner):
        from repro_torch.engine.launch import run_get_node

        for i in range(5):
            run_get_node(Grind, x=i)
        _wipe_hashes(store)
        messages = []
        stats = backfill_hashes(store, classes={"Grind": Grind},
                                batch_size=2, progress=messages.append)
        assert stats.hashed == 5
        assert len(messages) == 3  # ceil(5/2) batches reported

    def test_namespaced_inputs_rehash_correctly(self, store, runner):
        """Backfill must un-flatten `ns__key` link labels through the
        port tree so the recomputed hash matches a fresh launch."""

        class Nested(Process):
            NODE_TYPE = NodeType.CALC_FUNCTION

            @classmethod
            def define(cls, spec):
                super().define(spec)
                spec.input_namespace("params")
                spec.input("params.alpha", valid_type=Int, serializer=Int)
                spec.input("params.beta", valid_type=Int, serializer=Int)
                spec.input("x", valid_type=Int, serializer=Int)
                spec.output("y", valid_type=Int)

            async def run(self):
                self.out("y", Int(self.inputs["x"].value))

        from repro_torch.engine.launch import run_get_node

        _res, node = run_get_node(
            Nested, {"params": {"alpha": 1, "beta": 2}, "x": 3})
        fresh = store.get_node(node.pk)["node_hash"]
        assert fresh
        _wipe_hashes(store)
        stats = backfill_hashes(store, classes={"Nested": Nested})
        assert stats.hashed == 1
        assert store.get_node(node.pk)["node_hash"] == fresh


# ---------------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------------

class TestArchiveCli:
    @pytest.fixture()
    def profile(self, tmp_path):
        from repro_torch.engine.runner import Runner, set_default_runner
        from repro_torch.provenance.store import configure_store

        db = str(tmp_path / "a.db")
        st = configure_store(db)
        set_default_runner(Runner(store=st))

        @calcfunction
        def plus(a, b):
            return a + b

        plus(Int(1), Int(2))
        st.close()
        set_default_runner(None)
        return db

    def test_create_inspect_import(self, profile, tmp_path, capsys):
        from repro_torch import cli

        archive = str(tmp_path / "out.zip")
        cli.main(["-p", profile, "archive", "create", "-o", archive,
                  "--all"])
        out = capsys.readouterr().out
        assert "wrote" in out and "4 node(s)" in out

        cli.main(["-p", profile, "archive", "inspect", archive])
        out = capsys.readouterr().out
        assert "archive version 1" in out and "process.calcfunction" in out

        target = str(tmp_path / "b.db")
        cli.main(["-p", target, "archive", "import", archive])
        out = capsys.readouterr().out
        assert "imported 4 node(s)" in out

        cli.main(["-p", target, "archive", "import", archive])
        out = capsys.readouterr().out
        assert "nothing new to import" in out

    def test_create_requires_selection(self, profile, tmp_path):
        from repro_torch import cli

        with pytest.raises(SystemExit):
            cli.main(["-p", profile, "archive", "create", "-o",
                      str(tmp_path / "x.zip")])

    def test_backfill_cli(self, profile, capsys):
        from repro_torch import cli
        from repro_torch.provenance.store import ProvenanceStore

        st = ProvenanceStore(profile)
        _wipe_hashes(st)
        st.close()
        cli.main(["-p", profile, "cache", "backfill", "--dry-run"])
        out = capsys.readouterr().out
        assert "would hash" in out


# ---------------------------------------------------------------------------
# concurrent writers (separate OS processes) + live reader
# (twin of tests/test_store.py::TestConcurrentWriters)
# ---------------------------------------------------------------------------

_WRITER = textwrap.dedent("""
    import sys
    import numpy as np
    from repro_torch.core import Int, ArrayData, calcfunction
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.provenance.store import ProvenanceStore

    @calcfunction
    def work(seed, arr):
        return ArrayData(np.asarray(arr.value) + int(seed))

    store = ProvenanceStore(sys.argv[1], inline_threshold=1024)
    set_default_runner(Runner(store=store))
    base = int(sys.argv[2])
    for i in range(int(sys.argv[3])):
        work(Int(base + i), ArrayData(np.arange(512, dtype=np.float64)))
    store.close()
    print("done", base)
""")


@pytest.mark.slow
class TestConcurrentWriters:
    def test_two_writers_one_reader(self, tmp_path):
        db = str(tmp_path / "shared.db")
        per_writer = 8
        env = dict(os.environ,
                   PYTHONPATH=SRC + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs = [subprocess.Popen(
                    [sys.executable, "-c", _WRITER, db, str(base),
                     str(per_writer)],
                    env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE)
                 for base in (1000, 2000)]

        # reader: traverse through WAL while both writers are live
        reader = ProvenanceStore(db, inline_threshold=1024)
        reads = 0
        while any(p.poll() is None for p in procs):
            rows = reader.unfinished_processes()
            procs_now = [r["pk"] for r in QueryBuilder(reader)
                         .nodes("process").project("pk").all()]
            if procs_now:
                closure = compute_closure(reader, procs_now[:3])
                assert closure
            reads += 1
            assert rows is not None
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err.decode()

        # all writes landed: 2 writers x N calcs, each calc = 1 process
        # node + 2 input data + 1 output data
        n_procs = QueryBuilder(reader).nodes("process").count()
        assert n_procs == 2 * per_writer
        assert reader.count_nodes() == 2 * per_writer * 4
        assert reads > 0
        # every payload rehydrates (blobs written by other OS processes)
        for r in (QueryBuilder(reader).nodes("data")
                  .project("pk", "node_type").all()):
            if r["node_type"] == "data":
                reader.load_data(r["pk"])
        reader.close()


# ---------------------------------------------------------------------------
# parity: one archive format for both packages
# ---------------------------------------------------------------------------

PACKAGES = ("repro", "repro_torch")


def _lift(pkg):
    """The same calcfunctions, lifted by ``pkg``'s decorator (one source
    text, so both packages salt their hashes alike)."""
    core = importlib.import_module(f"{pkg}.core")

    @core.calcfunction
    def add(a, b):
        return a + b

    @core.calcfunction
    def norm(arr):
        return core.ArrayData(np.linalg.norm(arr.value, axis=-1))

    return core, add, norm


def _profile_in(pkg, db):
    """Run the module's processes through ``pkg`` into the profile ``db``;
    returns the node hashes of the processes, in run order."""
    runner_mod = importlib.import_module(f"{pkg}.engine.runner")
    store_mod = importlib.import_module(f"{pkg}.provenance.store")
    store = store_mod.ProvenanceStore(db)
    runner_mod.set_default_runner(runner_mod.Runner(store=store))
    try:
        core, add, norm = _lift(pkg)
        nodes = [add.run_get_node(core.Int(1), core.Int(2))[1],
                 add.run_get_node(core.Int(5), core.Int(6))[1],
                 norm.run_get_node(core.ArrayData(
                     np.arange(12.0).reshape(3, 4)))[1]]
        hashes = [store.get_node(n.pk)["node_hash"] for n in nodes]
    finally:
        runner_mod.set_default_runner(None)
        store.close()
    return hashes


def _archive_api(pkg):
    return (importlib.import_module(f"{pkg}.provenance.archive"),
            importlib.import_module(f"{pkg}.provenance.store"))


@pytest.mark.parametrize("exporter,importer",
                         [("repro", "repro_torch"), ("repro_torch", "repro")])
def test_archive_imports_across_packages_and_reexports_identically(
        exporter, importer, tmp_path):
    _profile_in(exporter, str(tmp_path / "src.db"))
    ex_archive, ex_store = _archive_api(exporter)
    im_archive, im_store = _archive_api(importer)

    first = str(tmp_path / "first.zip")
    src = ex_store.ProvenanceStore(str(tmp_path / "src.db"))
    m1 = ex_archive.export_archive(src, first)
    src.close()
    assert m1["nodes"] == 11 and m1["links"] == 8

    target = im_store.ProvenanceStore(str(tmp_path / "dst.db"))
    result = im_archive.import_archive(target, first)
    assert result.nodes_imported == m1["nodes"]
    assert result.links_imported == m1["links"]
    again = str(tmp_path / "again.zip")
    m2 = im_archive.export_archive(target, again)
    target.close()
    assert m2["content_digest"] == m1["content_digest"]
    with open(first, "rb") as f1, open(again, "rb") as f2:
        assert f1.read() == f2.read()


def test_same_processes_hash_alike_in_both_packages(tmp_path):
    """A process defined outside both packages fingerprints by its own
    module and source alone, so the two packages dedup each other's
    archived results."""
    ref = _profile_in("repro", str(tmp_path / "ref.db"))
    port = _profile_in("repro_torch", str(tmp_path / "port.db"))
    assert all(ref) and ref == port

    from repro.provenance.archive import export_archive as ref_export
    from repro.provenance.store import ProvenanceStore as RefStore

    src = RefStore(str(tmp_path / "ref.db"))
    ref_export(src, str(tmp_path / "ref.zip"))
    src.close()
    target = ProvenanceStore(str(tmp_path / "port.db"))
    before = target.count_nodes()
    result = import_archive(target, str(tmp_path / "ref.zip"))
    assert result.nodes_deduped == 3
    assert target.count_nodes() == before
    target.close()
