"""The port's content-addressed process caching, on the CPU.

Twins of ``tests/test_caching.py`` (hash stability and sensitivity,
cache-hit output cloning with ``cached_from`` provenance, policy scoping,
invalidation, collision telemetry) run against ``repro_torch``; the
CalcJob and daemon cases are in ``tests/test_torch_{calcjob,daemon}.py``. The parity cases hold the
port's ``hash_data_value`` and ``to_payload`` to the reference's.
"""

import json

import numpy as np
import pytest

from repro_torch.caching import (
    CacheRegistry, compute_input_hash, disable_caching, enable_caching,
    get_policy, hash_data_value,
)
from repro_torch.core import (
    ArrayData, Bool, Dict, Float, FolderData, Int, List, Process,
    ProcessSpec, Str, calcfunction, workfunction,
)
from repro_torch.provenance.store import LinkType, NodeType


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


class Doubler(Process):
    NODE_TYPE = NodeType.CALC_FUNCTION
    executions = 0

    @classmethod
    def define(cls, spec: ProcessSpec) -> None:
        super().define(spec)
        spec.input("x", valid_type=Int)
        spec.output("y", valid_type=Int)

    async def run(self):
        type(self).executions += 1
        self.out("y", Int(self.inputs["x"].value * 2))


@pytest.fixture(autouse=True)
def _reset_counter():
    Doubler.executions = 0


# ---------------------------------------------------------------------------
# hashing: stability and sensitivity
# ---------------------------------------------------------------------------

class TestHashing:
    def test_same_inputs_same_hash(self, store):
        h1 = compute_input_hash(Doubler, {"x": Int(3)})
        h2 = compute_input_hash(Doubler, {"x": Int(3)})
        assert h1 == h2

    def test_changed_port_value_changes_hash(self, store):
        assert compute_input_hash(Doubler, {"x": Int(3)}) != \
            compute_input_hash(Doubler, {"x": Int(4)})

    def test_value_type_is_part_of_hash(self, store):
        assert hash_data_value(Int(1)) != hash_data_value(Float(1.0))
        assert hash_data_value(Bool(True)) != hash_data_value(Int(1))

    def test_scalar_hashes_stable_across_instances(self):
        for make in (lambda: Int(7), lambda: Float(2.5), lambda: Str("a"),
                     lambda: Bool(True), lambda: Dict({"k": [1, 2]}),
                     lambda: List([1, "x"])):
            assert hash_data_value(make()) == hash_data_value(make())

    def test_array_hash_covers_dtype_shape_bytes(self):
        a = ArrayData(np.arange(6, dtype=np.float32))
        same = ArrayData(np.arange(6, dtype=np.float32))
        assert hash_data_value(a) == hash_data_value(same)
        # any changed byte
        flipped = np.arange(6, dtype=np.float32)
        flipped[3] += 1e-6
        assert hash_data_value(a) != hash_data_value(ArrayData(flipped))
        # dtype
        assert hash_data_value(a) != \
            hash_data_value(ArrayData(np.arange(6, dtype=np.float64)))
        # shape (same bytes)
        assert hash_data_value(ArrayData(np.zeros((2, 3)))) != \
            hash_data_value(ArrayData(np.zeros((3, 2))))

    def test_folder_hash(self):
        f1 = FolderData({"a.txt": b"xx", "b.txt": b"yy"})
        f2 = FolderData({"b.txt": b"yy", "a.txt": b"xx"})
        assert hash_data_value(f1) == hash_data_value(f2)
        assert hash_data_value(f1) != \
            hash_data_value(FolderData({"a.txt": b"xy", "b.txt": b"yy"}))

    def test_process_version_salts_hash(self, store, monkeypatch):
        h1 = compute_input_hash(Doubler, {"x": Int(3)})
        monkeypatch.setattr(Doubler, "CACHE_VERSION", 2)
        assert compute_input_hash(Doubler, {"x": Int(3)}) != h1

    def test_same_name_different_module_distinct(self, store):
        class Doppel(Doubler):
            pass

        Doppel.__name__ = Doubler.__name__
        Doppel.__qualname__ = Doubler.__qualname__
        Doppel.__module__ = "somewhere.else"
        assert compute_input_hash(Doubler, {"x": Int(3)}) != \
            compute_input_hash(Doppel, {"x": Int(3)})

    def test_process_type_in_hash(self, store):
        class Tripler(Doubler):
            pass

        assert compute_input_hash(Doubler, {"x": Int(3)}) != \
            compute_input_hash(Tripler, {"x": Int(3)})

    def test_metadata_and_non_db_excluded(self, store):
        class WithMeta(Doubler):
            @classmethod
            def define(cls, spec):
                super().define(spec)
                spec.input("opts", valid_type=dict, non_db=True,
                           required=False, default=dict)

        h1 = compute_input_hash(WithMeta, {"x": Int(1), "opts": {"a": 1},
                                           "metadata": {"label": "l1"}})
        h2 = compute_input_hash(WithMeta, {"x": Int(1), "opts": {"a": 2},
                                           "metadata": {"label": "l2"}})
        assert h1 == h2

    def test_function_source_salts_hash(self, store):
        @calcfunction
        def body_a(x):
            return x.value + 1

        @calcfunction
        def body_b(x):
            return x.value + 2

        body_b.process_class.__name__ = body_a.process_class.__name__
        assert compute_input_hash(body_a.process_class, {"x": Int(1)}) != \
            compute_input_hash(body_b.process_class, {"x": Int(1)})

    def test_exclude_from_hash_port_not_fingerprinted(self, store):
        """Ports declared exclude_from_hash (tolerances/thresholds) do not
        affect the cache fingerprint, while normal ports do."""

        class Tolerant(Process):
            NODE_TYPE = NodeType.CALC_FUNCTION
            executions = 0

            @classmethod
            def define(cls, spec: ProcessSpec) -> None:
                super().define(spec)
                spec.input("x", valid_type=Int)
                spec.input("tol", valid_type=Float, required=False,
                           exclude_from_hash=True)
                spec.output("y", valid_type=Int)

            async def run(self):
                type(self).executions += 1
                self.out("y", Int(self.inputs["x"].value * 2))

        h_base = compute_input_hash(Tolerant, {"x": Int(1),
                                               "tol": Float(1e-6)})
        h_tol = compute_input_hash(Tolerant, {"x": Int(1),
                                              "tol": Float(1e-3)})
        h_x = compute_input_hash(Tolerant, {"x": Int(2),
                                            "tol": Float(1e-6)})
        assert h_base == h_tol      # tolerance change: same fingerprint
        assert h_base != h_x        # real input change: different

        # end to end: a different tolerance still takes the cache hit,
        # and the tolerance IS linked in provenance (unlike non_db)
        from repro_torch.engine.runner import default_runner
        runner = default_runner()
        with enable_caching():
            _, p1 = runner.run(Tolerant, {"x": Int(5), "tol": Float(1e-6)})
            _, p2 = runner.run(Tolerant, {"x": Int(5), "tol": Float(1e-3)})
        assert Tolerant.executions == 1
        attrs = json.loads(store.get_node(p2.pk)["attributes"])
        assert attrs["cached_from_pk"] == p1.pk
        labels = {lbl for _, _, lbl in store.incoming(p2.pk)}
        assert "tol" in labels

    def test_nested_metadata_key_is_hashed(self, store):
        class DynIn(Doubler):
            @classmethod
            def define(cls, spec):
                super().define(spec)
                spec.inputs.dynamic = True

        h1 = compute_input_hash(DynIn, {"x": Int(1),
                                        "cfg": {"metadata": Str("v1")}})
        h2 = compute_input_hash(DynIn, {"x": Int(1),
                                        "cfg": {"metadata": Str("v2")}})
        assert h1 != h2   # only the *top-level* metadata ns is excluded

    def test_hash_persisted_on_node(self, store, runner):
        outputs, proc = runner.run(Doubler, {"x": Int(5)})
        node = store.get_node(proc.pk)
        assert node["node_hash"] == proc._input_hash
        assert node["node_hash"] is not None


# ---------------------------------------------------------------------------
# cache hits: cloning + provenance
# ---------------------------------------------------------------------------

class TestCacheHit:
    def test_hit_skips_execution_and_clones_outputs(self, store, runner):
        with enable_caching():
            out1, p1 = runner.run(Doubler, {"x": Int(21)})
            out2, p2 = runner.run(Doubler, {"x": Int(21)})
        assert Doubler.executions == 1
        assert p2.is_finished_ok
        assert out2["y"].value == 42
        # outputs are fresh nodes, not shared with the original
        assert out2["y"].pk != out1["y"].pk
        # linked with the normal CREATE edge
        created = store.outgoing(p2.pk, LinkType.CREATE)
        assert [(lbl, pk) for pk, _, lbl in created] == [("y", out2["y"].pk)]

    def test_cached_from_metadata(self, store, runner):
        with enable_caching():
            _, p1 = runner.run(Doubler, {"x": Int(1)})
            _, p2 = runner.run(Doubler, {"x": Int(1)})
        attrs = json.loads(store.get_node(p2.pk)["attributes"])
        assert attrs["cached_from_pk"] == p1.pk
        assert attrs["cached_from"] == store.get_node(p1.pk)["uuid"]
        src = store.get_node(p1.pk)
        assert src["process_state"] == "finished"
        assert src["exit_status"] == 0
        # the original was computed, not cloned
        assert "cached_from" not in json.loads(src["attributes"])

    def test_miss_on_different_inputs(self, store, runner):
        with enable_caching():
            runner.run(Doubler, {"x": Int(1)})
            _, p2 = runner.run(Doubler, {"x": Int(2)})
        assert Doubler.executions == 2
        assert "cached_from" not in \
            json.loads(store.get_node(p2.pk)["attributes"])

    def test_failed_processes_are_not_cache_sources(self, store, runner):
        class Flaky(Doubler):
            fail = True

            async def run(self):
                type(self).executions += 1
                if type(self).fail:
                    return 7
                self.out("y", Int(self.inputs["x"].value * 2))

        with enable_caching():
            _, p1 = runner.run(Flaky, {"x": Int(1)})
            assert p1.exit_code.status == 7
            Flaky.fail = False
            _, p2 = runner.run(Flaky, {"x": Int(1)})
        assert Flaky.executions == 2   # failure was not reused
        assert p2.is_finished_ok

    def test_calcfunction_hit_returns_cloned_result(self, store, runner):
        calls = []

        @calcfunction
        def add(a, b):
            calls.append(1)
            return a.value + b.value

        with enable_caching():
            r1 = add(Int(2), Int(3))
            r2 = add(Int(2), Int(3))
        assert len(calls) == 1
        assert r1.value == r2.value == 5
        assert r2.pk != r1.pk

    def test_calcfunction_hit_preserves_dict_return_shape(self, store,
                                                          runner):
        @calcfunction
        def wrapped(x):
            return {"result": Int(x.value + 1)}

        @calcfunction
        def multi(x):
            return {"a": Int(x.value), "b": Int(-x.value)}

        with enable_caching():
            cold = wrapped(Int(1))
            warm = wrapped(Int(1))
            assert isinstance(cold, dict) and isinstance(warm, dict)
            assert warm["result"].value == 2

            cold_m = multi(Int(3))
            warm_m = multi(Int(3))
        assert set(cold_m) == set(warm_m) == {"a", "b"}
        assert warm_m["a"].value == 3 and warm_m["b"].value == -3

    def test_flat_label_containing_dunder_stays_flat(self, store, runner):
        @calcfunction
        def dyn(x):
            return {"a__b": Int(x.value)}

        with enable_caching():
            cold = dyn(Int(4))
            warm = dyn(Int(4))
        assert set(cold) == set(warm) == {"a__b"}
        assert warm["a__b"].value == 4

    def test_run_get_node_shape_on_hit(self, store, runner):
        @calcfunction
        def pair(x):
            return {"a": x.value, "b": x.value + 1}

        with enable_caching():
            r1, p1, _ = pair.run_get_node(Int(1))
            r2, p2, _ = pair.run_get_node(Int(1))
        assert isinstance(r1, Dict) and isinstance(r2, Dict)
        assert r1.value == r2.value == {"a": 1, "b": 2}
        assert "cached_from" in json.loads(
            store.get_node(p2.pk)["attributes"])

    def test_invalidate_stops_reuse(self, store, runner):
        reg = CacheRegistry(store)
        with enable_caching():
            _, p1 = runner.run(Doubler, {"x": Int(9)})
            assert reg.invalidate(pk=p1.pk) == 1
            runner.run(Doubler, {"x": Int(9)})
        assert Doubler.executions == 2

    def test_invalidate_by_process_type(self, store, runner):
        with enable_caching():
            runner.run(Doubler, {"x": Int(1)})
            runner.run(Doubler, {"x": Int(2)})
            n = CacheRegistry(store).invalidate(process_type="Doubler")
            assert n == 2
            runner.run(Doubler, {"x": Int(1)})
        assert Doubler.executions == 3

    def test_stats(self, store, runner):
        reg = CacheRegistry(store)
        with enable_caching():
            runner.run(Doubler, {"x": Int(1)})
            runner.run(Doubler, {"x": Int(1)})
            runner.run(Doubler, {"x": Int(2)})
        s = reg.stats()
        row = s["process_types"]["Doubler"]
        assert row["hashed_nodes"] == 3
        assert row["distinct_hashes"] == 2
        assert row["cache_hits"] == 1


# ---------------------------------------------------------------------------
# policy scoping
# ---------------------------------------------------------------------------

class TestPolicy:
    def test_caching_off_by_default(self, store, runner):
        runner.run(Doubler, {"x": Int(3)})
        runner.run(Doubler, {"x": Int(3)})
        assert Doubler.executions == 2

    def test_enable_caching_scopes(self, store, runner):
        with enable_caching():
            runner.run(Doubler, {"x": Int(3)})
            runner.run(Doubler, {"x": Int(3)})
        assert Doubler.executions == 1
        runner.run(Doubler, {"x": Int(3)})   # outside the scope
        assert Doubler.executions == 2

    def test_enable_caching_for_specific_type(self, store, runner):
        class Other(Doubler):
            executions = 0

        with enable_caching("Other"):
            runner.run(Doubler, {"x": Int(1)})
            runner.run(Doubler, {"x": Int(1)})
            runner.run(Other, {"x": Int(1)})
            runner.run(Other, {"x": Int(1)})
        assert Doubler.executions == 2
        assert Other.executions == 1

    def test_disable_overrides_inner_scope(self, store, runner):
        with enable_caching():
            with disable_caching(Doubler):
                runner.run(Doubler, {"x": Int(1)})
                runner.run(Doubler, {"x": Int(1)})
        assert Doubler.executions == 2

    def test_env_var_enables(self, store, runner, monkeypatch):
        monkeypatch.setenv("REPRO_CACHING", "1")
        runner.run(Doubler, {"x": Int(1)})
        runner.run(Doubler, {"x": Int(1)})
        assert Doubler.executions == 1

    def test_env_var_type_list(self, store, runner, monkeypatch):
        class Other(Doubler):
            executions = 0

        monkeypatch.setenv("REPRO_CACHING", "Other,SomethingElse")
        runner.run(Doubler, {"x": Int(1)})
        runner.run(Doubler, {"x": Int(1)})
        runner.run(Other, {"x": Int(1)})
        runner.run(Other, {"x": Int(1)})
        assert Doubler.executions == 2
        assert Other.executions == 1

    def test_policy_object_opt_in(self, store, runner):
        get_policy().enable("Doubler")
        runner.run(Doubler, {"x": Int(1)})
        runner.run(Doubler, {"x": Int(1)})
        assert Doubler.executions == 1

    def test_workflows_never_cached(self, store, runner):
        ran = []

        # a work-like node type (the WorkChain twin is in
        # tests/test_torch_workchain.py)
        class Chain(Process):
            NODE_TYPE = NodeType.WORK_CHAIN

            @classmethod
            def define(cls, spec):
                super().define(spec)
                spec.input("x", valid_type=Int)
                spec.output("y", valid_type=Int)

            async def run(self):
                ran.append(1)
                self.out("y", Int(self.inputs["x"].value))

        with enable_caching():
            runner.run(Chain, {"x": Int(1)})
            runner.run(Chain, {"x": Int(1)})
        assert len(ran) == 2

        @workfunction
        def orchestrate(x):
            ran.append(1)
            return x

        with enable_caching():
            orchestrate(Int(1))
            orchestrate(Int(1))
        assert len(ran) == 4

    def test_cacheable_false_opts_out(self, store, runner):
        class NonDeterministic(Doubler):
            CACHEABLE = False
            executions = 0

        with enable_caching():
            runner.run(NonDeterministic, {"x": Int(1)})
            runner.run(NonDeterministic, {"x": Int(1)})
        assert NonDeterministic.executions == 2


# ---------------------------------------------------------------------------
# hash-collision telemetry (same fingerprint, different outputs)
# ---------------------------------------------------------------------------

class TestCollisionTelemetry:
    def _make_hidden_input_cls(self):
        class HiddenInput(Process):
            """Output depends on class state the fingerprint cannot see —
            the canonical way a hash collision arises in practice."""
            NODE_TYPE = NodeType.CALC_FUNCTION
            bump = 0

            @classmethod
            def define(cls, spec):
                super().define(spec)
                spec.input("x", valid_type=Int)
                spec.output("y", valid_type=Int)

            async def run(self):
                self.out("y", Int(self.inputs["x"].value + HiddenInput.bump))

        return HiddenInput

    def test_collision_counted_on_hit_path(self, store, runner):
        HiddenInput = self._make_hidden_input_cls()
        # two cold runs, same fingerprint, different outputs
        runner.run(HiddenInput, {"x": Int(1)})
        HiddenInput.bump = 100
        runner.run(HiddenInput, {"x": Int(1)})

        registry = CacheRegistry(store)
        with enable_caching():
            _, proc = runner.run(HiddenInput, {"x": Int(1)})
        assert proc.is_finished_ok
        counts = registry.collision_counts()
        assert counts.get("HiddenInput") == 1
        assert registry.stats()["hash_collisions"] == 1
        per_type = registry.stats()["process_types"]["HiddenInput"]
        assert per_type["hash_collisions"] == 1

    def test_no_collision_when_outputs_agree(self, store, runner):
        runner.run(Doubler, {"x": Int(2)})
        runner.run(Doubler, {"x": Int(2)})
        registry = CacheRegistry(store)
        with enable_caching():
            runner.run(Doubler, {"x": Int(2)})
        assert registry.collision_counts() == {}
        assert registry.stats()["hash_collisions"] == 0

    def test_counter_is_durable_and_cumulative(self, store, runner):
        HiddenInput = self._make_hidden_input_cls()
        runner.run(HiddenInput, {"x": Int(1)})
        HiddenInput.bump = 7
        runner.run(HiddenInput, {"x": Int(1)})
        with enable_caching():
            runner.run(HiddenInput, {"x": Int(1)})
            runner.run(HiddenInput, {"x": Int(1)})
        # each cache-hit lookup that saw the mismatch counts once
        assert CacheRegistry(store).collision_counts()["HiddenInput"] >= 2


# ---------------------------------------------------------------------------
# parity with the reference: digests and payloads
# ---------------------------------------------------------------------------

def _values(pkg):
    rng = np.random.default_rng(19)
    ints = rng.integers(-2**31, 2**31 - 1, (3, 5)).astype(np.int32)
    floats = rng.standard_normal((4, 2, 3)).astype(np.float32)
    return [pkg.Int(int(rng.integers(-1000, 1000))),
            pkg.Float(float(rng.standard_normal())),
            pkg.Str("prompt-%d" % rng.integers(1000)),
            pkg.Dict({"a": 1, "b": [1.5, "x"], "c": {"d": None}}),
            pkg.List([3, "four", 5.0]),
            pkg.ArrayData(ints), pkg.ArrayData(floats)]


def test_digests_and_payloads_match_reference():
    import repro.core.datatypes as j_dt
    import repro_torch.core.datatypes as t_dt
    from repro.caching.hashing import hash_data_value as j_hash

    for jv, tv in zip(_values(j_dt), _values(t_dt)):
        assert type(jv).__name__ == type(tv).__name__
        assert hash_data_value(tv) == j_hash(jv), type(tv).__name__
        assert tv.to_payload() == jv.to_payload(), type(tv).__name__


def test_tensor_array_data_hashes_like_numpy():
    import torch
    from repro.caching.hashing import hash_data_value as j_hash
    from repro.core.datatypes import ArrayData as JArrayData

    rng = np.random.default_rng(20)
    for arr in (rng.integers(0, 512, 37).astype(np.int32),
                rng.standard_normal((2, 3)).astype(np.float32)):
        t = torch.from_numpy(arr.copy())
        assert hash_data_value(ArrayData(t)) == j_hash(JArrayData(arr))
        assert ArrayData(t).value.dtype == arr.dtype
