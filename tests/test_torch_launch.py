"""The port's unified launchers (``engine/launch.py``): run /
run_get_node / run_get_pk / submit over classes and builders, on the CPU.

Twins of ``tests/test_launch.py``, run against ``repro_torch``.
"""

import pytest

from repro_torch.core import Int, Process, ProcessState, WorkChain
from repro_torch.engine.launch import (
    instantiate, run, run_get_node, run_get_pk, submit,
)


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


class AddChain(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("a", valid_type=Int, serializer=Int)
        spec.input("b", valid_type=Int, serializer=Int)
        spec.output("sum", valid_type=Int)
        spec.outline(cls.go)

    def go(self):
        self.out("sum", Int(self.inputs["a"].value + self.inputs["b"].value))


def test_run_returns_outputs(store, runner):
    results = run(AddChain, a=Int(1), b=Int(2))
    assert results["sum"].value == 3


def test_run_serializes_raw_kwargs(store, runner):
    results = run(AddChain, a=1, b=2)
    assert results["sum"].value == 3


def test_run_get_node_returns_named_tuple(store, runner):
    out = run_get_node(AddChain, a=1, b=41)
    assert out.results["sum"].value == 42
    assert out.node.is_finished_ok
    # tuple unpacking works too
    results, node = out
    assert results is out.results and node is out.node


def test_run_get_pk(store, runner):
    results, pk = run_get_pk(AddChain, a=2, b=3)
    assert results["sum"].value == 5
    node = store.get_node(pk)
    assert node["process_state"] == "finished"


def test_run_accepts_builder_with_overrides(store, runner):
    b = AddChain.get_builder()
    b.a = 10
    b.b = 1
    # keyword arguments override builder values at launch time
    results = run(b, b=Int(20))
    assert results["sum"].value == 30


def test_override_semantics_identical_for_dict_and_kwargs(store, runner):
    """run(builder, {'x': v}) and run(builder, x=v) must produce the same
    merged inputs — both flow through the same builder-merge path."""
    class NestedChain(WorkChain):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.inputs.create_namespace("cfg")
            spec.input("cfg.a", valid_type=Int, serializer=Int)
            spec.input("cfg.b", valid_type=Int, serializer=Int)
            spec.output("sum", valid_type=Int)
            spec.outline(cls.go)

        def go(self):
            self.out("sum", Int(self.inputs["cfg"]["a"].value +
                                self.inputs["cfg"]["b"].value))

    b1 = NestedChain.get_builder()
    b1.cfg = {"a": 1, "b": 2}
    r1 = run(b1, {"cfg": {"b": 40}})     # positional-dict override
    b2 = NestedChain.get_builder()
    b2.cfg = {"a": 1, "b": 2}
    r2 = run(b2, cfg={"b": 40})          # kwargs override
    assert r1["sum"].value == r2["sum"].value == 41


def test_submit_returns_waitable_handle(store, runner):
    handle = submit(AddChain, a=1, b=1)
    assert handle.pk > 0
    node = runner.run_until_complete(runner.wait(handle))
    assert node["process_state"] == "finished"
    assert node["exit_status"] == 0


def test_submit_builder(store, runner):
    b = AddChain.get_builder()
    b.a = 5
    b.b = 6
    handle = submit(b)
    node = runner.run_until_complete(runner.wait(handle))
    assert node["exit_status"] == 0


def test_invalid_inputs_fail_at_launch_with_path(store, runner):
    with pytest.raises(ValueError, match="'inputs.a'"):
        run(AddChain, b=Int(1))


def test_launcher_rejects_non_process(store, runner):
    with pytest.raises(TypeError, match="Process class or a ProcessBuilder"):
        run("not-a-process")


def test_instantiate_creates_node_without_running(store, runner):
    proc = instantiate(AddChain, a=1, b=2)
    assert isinstance(proc, Process)
    assert proc.state is ProcessState.CREATED
    node = store.get_node(proc.pk)
    assert node["process_state"] == "created"
    assert store.load_checkpoint(proc.pk) is not None


def test_explicit_runner_is_honoured(store):
    from repro_torch.engine.runner import Runner

    r = Runner(store=store)
    results, node = run_get_node(AddChain, a=3, b=4, runner=r)
    assert node.runner is r
    assert results["sum"].value == 7
