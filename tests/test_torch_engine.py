"""The port's process engine on the CPU: ports, the state machine, the
process builder, process functions, the communicator and transports.

Twins of ``tests/test_ports.py``, ``tests/test_statemachine.py``,
``tests/test_builder.py``, ``tests/test_process_functions.py`` and
``tests/test_engine.py`` run against ``repro_torch``. Where the reference
builds a WorkChain, a plain Process with the same spec stands in (the
WorkChain versions are in ``tests/test_torch_workchain.py``, the daemon,
back-off and job-manager cases in ``tests/test_torch_{daemon,calcjob}.py``). The parity cases hold one lifted function's input
hash and provenance rows to the reference's, and the branches this slice
leaves out to raising.
"""

import asyncio
import json
import time

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, strategies as st

from repro_torch.core import (
    Bool, ExitCode, Float, Int, PortValidationError, Process,
    ProcessBuilder, ProcessSpec, Str, calcfunction, workfunction,
)
from repro_torch.core.builder import expand_launch_target
from repro_torch.core.ports import UNSPECIFIED, InputPort, PortNamespace
from repro_torch.core.statemachine import (
    InvalidTransitionError, ProcessState, StateMachine, TERMINAL_STATES,
    TRANSITIONS,
)
from repro_torch.engine.communicator import LocalCommunicator
from repro_torch.engine.transport import (
    FlakyTransport, LocalTransport, TransportQueue,
)
from repro_torch.provenance.store import LinkType, NodeType, QueryBuilder


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
# twins of tests/test_ports.py
# ===========================================================================

def test_port_validation_type():
    p = InputPort("a", valid_type=Int)
    assert p.validate(Int(3)) is None
    err = p.validate(Float(3.0))
    assert err is not None and "a" in err


def test_port_custom_validator():
    p = InputPort("a", valid_type=Int,
                  validator=lambda v: None if v.value > 0 else "not positive")
    assert p.validate(Int(1)) is None
    assert "not positive" in p.validate(Int(-1))


def test_port_default_and_required():
    p = InputPort("a", valid_type=Int, default=Int(2))
    assert not p.required
    assert p.default.value == 2
    q = InputPort("b", valid_type=Int)
    assert q.required
    assert "required" in q.validate(UNSPECIFIED)


def test_explicit_none_distinguished_from_absent():
    """A provided None is not the same as an absent key: optional typed
    ports must reject it, and required ports must say which happened."""
    req = InputPort("r", valid_type=Int)
    assert "was not provided" in req.validate(UNSPECIFIED)
    assert "explicitly passed None" in req.validate(None)

    opt = InputPort("o", valid_type=Int, required=False)
    assert opt.validate(UNSPECIFIED) is None          # absent: fine
    err = opt.validate(None)                          # explicit None: not an Int
    assert err is not None and "explicitly passed None" in err

    # untyped optional ports still accept an explicit None
    free = InputPort("f", required=False)
    assert free.validate(None) is None

    # NoneType in valid_type opts in to explicit None
    nullable = InputPort("n", valid_type=(Int, type(None)), required=False)
    assert nullable.validate(None) is None


def test_namespace_distinguishes_none_from_absent():
    ns = PortNamespace("inputs")
    ns["a"] = InputPort("a", valid_type=Int, required=False)
    ns["b"] = InputPort("b", valid_type=Int)
    assert ns.validate({"b": Int(1)}) is None                 # a absent: ok
    err = ns.validate({"a": None, "b": Int(1)})               # a explicit None
    assert err is not None and "explicitly passed None" in err and "a" in err
    err = ns.validate({"b": None})
    assert "required" in err and "explicitly passed None" in err


def test_port_serializer_wraps_raw_values():
    p = InputPort("n", valid_type=Int, serializer=Int)
    wrapped = p.serialize(3)
    assert isinstance(wrapped, Int) and wrapped.value == 3
    # already-valid values pass through untouched
    v = Int(5)
    assert p.serialize(v) is v
    # namespace-level walk serializes leaves, passes undeclared through
    ns = PortNamespace("inputs", dynamic=True)
    ns["n"] = p
    out = ns.serialize({"n": 7, "free": "x"})
    assert isinstance(out["n"], Int) and out["free"] == "x"


def test_absorb_deep_copies_ports():
    """expose_inputs must not alias Port objects between specs: mutating
    the exposing spec cannot leak into the source class (regression).
    Plain Processes stand in for the reference's WorkChains."""

    class Source(Process):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.input("x", valid_type=Int)
            spec.input("nested.y", valid_type=Int, default=Int(1))

    class Exposer(Process):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.expose_inputs(Source, namespace="src")
            # override the exposed port after absorbing — must be local
            spec.input("src.x", valid_type=Str)

    exposed = Exposer.spec().inputs["src"]
    source = Source.spec().inputs
    assert exposed["x"] is not source["x"]
    assert exposed["nested"] is not source["nested"]
    assert exposed["nested.y"] is not source["nested.y"]
    # the override changed only the exposing spec
    assert Exposer.spec().inputs["src.x"].valid_type == (Str,)
    assert source["x"].valid_type == (Int,)
    # mutating a copied port does not touch the source either
    exposed["nested.y"].required = True
    assert source["nested.y"].required is False
    # deep-copied sentinel defaults survive with identity intact
    assert not exposed["x"].has_default
    assert exposed["nested.y"].default == Int(1)


def test_nested_namespace_creation():
    ns = PortNamespace("inputs")
    ns["nested.input.namespace"] = InputPort("x", valid_type=Int)
    assert isinstance(ns["nested"], PortNamespace)
    assert isinstance(ns["nested.input"], PortNamespace)
    assert isinstance(ns["nested.input.namespace"], InputPort)


def test_namespace_rejects_undeclared():
    ns = PortNamespace("inputs")
    ns["a"] = InputPort("a", valid_type=Int, required=False)
    assert ns.validate({"a": Int(1), "zz": Int(2)}) is not None
    ns.dynamic = True
    assert ns.validate({"a": Int(1), "zz": Int(2)}) is None


def test_spec_declarative_override():
    """Paper listing 3: later declarations override earlier ones."""
    spec = ProcessSpec()
    spec.input("a", valid_type=Int)
    spec.input("a", valid_type=Float)
    assert spec.inputs["a"].valid_type == (Float,)
    assert spec.validate_inputs({"a": Float(1.0)}) is None
    assert spec.validate_inputs({"a": Int(1)}) is not None


def test_spec_exit_codes():
    spec = ProcessSpec()
    spec.exit_code(418, "ERROR_I_AM_A_TEAPOT",
                   "the workchain experienced an identity crisis")
    ec = spec.exit_codes.ERROR_I_AM_A_TEAPOT
    assert ec.status == 418
    assert "identity crisis" in ec.message
    with pytest.raises(AttributeError):
        spec.exit_codes.NOPE
    with pytest.raises(ValueError):
        spec.exit_code(-1, "BAD", "negative")


def test_non_db_ports_excluded_from_projection():
    ns = PortNamespace("inputs")
    ns["a"] = InputPort("a", valid_type=Int)
    ns["meta"] = InputPort("meta", non_db=True, required=False)
    proj = ns.project({"a": Int(1), "meta": {"x": 1}})
    assert "meta" not in proj and "a" in proj


@given(st.lists(st.sampled_from("abcdefgh"), min_size=1, max_size=5,
                unique=True),
       st.sets(st.sampled_from("abcdefgh")))
def test_namespace_validate_required_property(declared, provided):
    """Validation fails iff some declared required port is missing."""
    ns = PortNamespace("inputs")
    for name in declared:
        ns[name] = InputPort(name, valid_type=Int)
    values = {name: Int(1) for name in provided if name in declared}
    err = ns.validate(values)
    missing = set(declared) - set(values)
    assert (err is None) == (not missing)


@given(st.integers(min_value=0, max_value=3),
       st.integers(min_value=1, max_value=4))
def test_namespace_nesting_depth_property(depth, width):
    ns = PortNamespace("root")
    path = ".".join(f"lvl{i}" for i in range(depth + 1))
    for w in range(width):
        ns[f"{path}.p{w}"] = InputPort(f"p{w}", valid_type=Int,
                                       required=False)
    node = ns
    for i in range(depth + 1):
        node = node[f"lvl{i}"]
        assert isinstance(node, PortNamespace)
    assert len(node) == width


# ===========================================================================
# twins of tests/test_statemachine.py
# ===========================================================================

class Recorder(StateMachine):
    def __init__(self):
        super().__init__()
        self.events = []

    def on_exiting(self):
        self.events.append(("exiting", self.state))

    def on_entering(self, state):
        self.events.append(("entering", state))

    def on_entered(self, from_state):
        self.events.append(("entered", from_state, self.state))


def test_happy_path_hook_order():
    sm = Recorder()
    sm.transition_to(ProcessState.RUNNING)
    assert sm.events == [
        ("exiting", ProcessState.CREATED),
        ("entering", ProcessState.RUNNING),
        ("entered", ProcessState.CREATED, ProcessState.RUNNING),
    ]


def test_terminal_states_allow_nothing():
    for terminal in TERMINAL_STATES:
        assert TRANSITIONS[terminal] == frozenset()


def test_invalid_transition_raises_and_preserves_state():
    sm = Recorder()
    with pytest.raises(InvalidTransitionError):
        sm.transition_to(ProcessState.FINISHED)   # CREATED -/-> FINISHED
    assert sm.state is ProcessState.CREATED


def test_pause_resume_returns_to_interrupted_state():
    sm = Recorder()
    sm.transition_to(ProcessState.RUNNING)
    sm.transition_to(ProcessState.WAITING)
    sm.transition_to(ProcessState.PAUSED)
    assert sm.resume_from_pause() is ProcessState.WAITING


@given(st.lists(st.sampled_from(list(ProcessState)), max_size=12))
def test_random_walk_respects_transition_table(targets):
    """Any sequence of attempted transitions either follows the table or
    raises, and the machine never leaves a terminal state."""
    sm = Recorder()
    for tgt in targets:
        current = sm.state
        if tgt in TRANSITIONS[current]:
            sm.transition_to(tgt)
            assert sm.state is tgt
        else:
            with pytest.raises(InvalidTransitionError):
                sm.transition_to(tgt)
            assert sm.state is current
        if sm.is_terminated:
            assert sm.state in TERMINAL_STATES


@given(st.lists(st.sampled_from(list(ProcessState)), max_size=12))
def test_entered_hook_fires_exactly_once_per_transition(targets):
    sm = Recorder()
    transitions = 0
    for tgt in targets:
        if tgt in TRANSITIONS[sm.state]:
            sm.transition_to(tgt)
            transitions += 1
    entered = [e for e in sm.events if e[0] == "entered"]
    assert len(entered) == transitions


# ===========================================================================
# twins of tests/test_builder.py
# ===========================================================================

# the reference's SubChain and TopChain are WorkChains; here plain
# Processes with the same specs stand in (the WorkChain versions are in
# tests/test_torch_workchain.py): TopChain
# submits SubChain with its exposed inputs and waits for it
class SubChain(Process):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("n", valid_type=Int, serializer=Int,
                   help="how many units to process")
        spec.input("tag", valid_type=Str, serializer=Str, required=False)
        spec.output("doubled", valid_type=Int)

    async def run(self):
        self.out("doubled", Int(self.inputs["n"].value * 2))


class TopChain(Process):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.expose_inputs(SubChain, namespace="sub")
        spec.input("flag", valid_type=Bool, serializer=Bool,
                   default=lambda: Bool(False))
        spec.output("result", valid_type=Int)

    async def run(self):
        child = self.runner.submit(SubChain, dict(self.inputs["sub"]),
                                   parent_pk=self.pk)
        await self.interruptible(child.wait())
        self.out("result", child.process.outputs["doubled"])


# ---------------------------------------------------------------------------
# construction and attribute access
# ---------------------------------------------------------------------------

def test_get_builder_mirrors_port_tree():
    b = TopChain.get_builder()
    assert isinstance(b, ProcessBuilder)
    assert b.process_class is TopChain
    # nested namespaces pre-exist as sub-builders; leaves are unset
    assert "sub" in dir(b)
    assert "n" in dir(b.sub)
    with pytest.raises(AttributeError):
        b.sub.n  # unset leaf

    b.sub.n = Int(3)
    assert b.sub.n.value == 3


def test_builder_doc_carries_help_text():
    b = TopChain.get_builder()
    assert "flag" in b.__doc__
    assert "how many units to process" in b.sub.__doc__
    assert "sub" in repr(b) or "ProcessBuilder" in repr(b)


def test_unknown_port_rejected_at_assignment():
    b = TopChain.get_builder()
    with pytest.raises(AttributeError, match="not a declared input port"):
        b.bogus = 1
    with pytest.raises(AttributeError, match="sub.bogus"):
        b.sub.bogus = 1


def test_type_rejected_at_assignment_with_path():
    b = TopChain.get_builder()
    with pytest.raises(PortValidationError, match="sub.n"):
        b.sub.n = Str("nope")   # Str is a DataValue: serializer skipped,
                                # valid_type check fails with the full path


def test_serializer_wraps_raw_python_on_assignment():
    b = TopChain.get_builder()
    b.sub.n = 3
    assert isinstance(b.sub.n, Int) and b.sub.n.value == 3
    b.flag = True
    assert isinstance(b.flag, Bool)
    with pytest.raises(PortValidationError, match="sub.n"):
        b.sub.n = "not-a-number"


def test_dotted_path_get_set():
    b = TopChain.get_builder()
    b["sub.n"] = 5
    assert b["sub.n"].value == 5
    assert b.sub.n.value == 5


def test_merge_of_nested_dicts():
    b = TopChain.get_builder()
    b._merge({"sub": {"n": 4}, "metadata": {"label": "merged"}})
    assert b.sub.n.value == 4
    assert b.metadata.label == "merged"
    # merge does not clear siblings
    b._merge({"sub": {"tag": "t"}})
    assert b.sub.n.value == 4 and b.sub.tag.value == "t"


def test_namespace_dict_assignment_replaces_contents():
    b = TopChain.get_builder()
    b.sub.n = 1
    b.sub.tag = "old"
    b.sub = {"n": 9}
    assert b.sub.n.value == 9
    with pytest.raises(AttributeError):
        b.sub.tag


def test_namespace_dict_assignment_is_atomic():
    """A failed namespace replacement must leave the previous contents
    untouched — no partial write, no lost values."""
    b = TopChain.get_builder()
    b.sub.n = 1
    b.sub.tag = "keep"
    with pytest.raises(PortValidationError):
        b.sub = {"n": 2, "bogus": 3}    # bogus is undeclared → fails
    assert b.sub.n.value == 1           # old state fully intact
    assert b.sub.tag.value == "keep"


def test_unknown_port_error_catchable_both_ways():
    """Undeclared-port assignment is catchable as the documented
    PortValidationError AND as the pythonic AttributeError, through
    attribute, mapping and _merge entry points alike."""
    b = TopChain.get_builder()
    with pytest.raises(PortValidationError):
        b.bogus = 1
    with pytest.raises(PortValidationError):
        b["bogus"] = 1
    with pytest.raises(PortValidationError):
        b._merge({"bogus": 1})


def test_inputs_prunes_unset_optionals_and_empty_namespaces():
    b = TopChain.get_builder()
    b.sub.n = 2
    inputs = b._inputs(prune=True)
    assert inputs == {"sub": {"n": Int(2)}}
    assert "metadata" not in inputs and "flag" not in inputs
    # unpruned keeps the empty namespaces
    assert "metadata" in b._inputs(prune=False)


def test_dynamic_namespace_accepts_undeclared_keys():
    b = TopChain.get_builder()
    b.metadata.description = "free-form"
    b.metadata.custom_key = {"arbitrary": 1}   # metadata is dynamic
    assert b.metadata.custom_key == {"arbitrary": 1}


def test_expand_launch_target_shapes():
    b = TopChain.get_builder()
    b.sub.n = 3
    cls, inputs = expand_launch_target(b, {"flag": Bool(True)})
    assert cls is TopChain
    assert inputs["sub"]["n"].value == 3 and inputs["flag"].value is True
    cls2, inputs2 = expand_launch_target(TopChain, {"sub": {"n": Int(1)}})
    assert cls2 is TopChain and inputs2["sub"]["n"].value == 1
    with pytest.raises(TypeError):
        expand_launch_target(42)


# ---------------------------------------------------------------------------
# end-to-end: builder → run, provenance, exposed namespaces
# ---------------------------------------------------------------------------

def test_builder_run_end_to_end_with_provenance(store, runner):
    from repro_torch.engine.launch import run_get_node

    b = TopChain.get_builder()
    b.sub.n = 3          # raw int: serialized to Int(3)
    results, node = run_get_node(b)
    assert node.is_finished_ok
    assert results["result"].value == 6
    # the serialized raw int is a real linked input node on the child
    child_pk = store.outgoing(node.pk, LinkType.CALL_WORK)[0][0]
    inputs = {label: store.load_data(pk)
              for pk, _, label in store.incoming(child_pk, LinkType.INPUT_WORK)}
    assert inputs["n"] == Int(3)


def test_exposed_namespace_builder_roundtrip(store, runner):
    """Builder assignment into an exposed namespace reaches the child —
    the full expose/builder round-trip."""
    from repro_torch.engine.launch import run_get_node

    b = TopChain.get_builder()
    b.sub.n = 10
    b.sub.tag = "exposed"
    results, node = run_get_node(b)
    assert results["result"].value == 20
    child_pk = store.outgoing(node.pk, LinkType.CALL_WORK)[0][0]
    labels = {label for _, _, label in store.incoming(child_pk)}
    assert {"n", "tag"} <= labels


def test_callable_default_with_serializer_per_instantiation(store, runner):
    class LambdaDefault(Process):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.input("n", valid_type=Int, serializer=Int,
                       default=lambda: 7)
            spec.output("n_out", valid_type=Int)

        async def run(self):
            self.out("n_out", self.inputs["n"])

    p1 = LambdaDefault(inputs={}, runner=runner)
    p2 = LambdaDefault(inputs={}, runner=runner)
    # each instantiation evaluates the lambda and serializes it freshly
    assert isinstance(p1.inputs["n"], Int) and p1.inputs["n"].value == 7
    assert p1.inputs["n"] is not p2.inputs["n"]


def test_construction_serializes_raw_dict_inputs(store, runner):
    """The serializer contract holds for plain-dict launches too — the
    construction path serializes before validating."""
    outputs, proc = runner.run(SubChain, {"n": 21})
    assert proc.is_finished_ok
    assert outputs["doubled"].value == 42


def test_builder_submit_local(store, runner):
    from repro_torch.engine.launch import submit

    b = SubChain.get_builder()
    b.n = 4
    handle = submit(b)
    node = runner.run_until_complete(runner.wait(handle))
    assert node["process_state"] == "finished"
    assert node["exit_status"] == 0


# ===========================================================================
# twins of tests/test_process_functions.py
# ===========================================================================

@calcfunction
def add(a, b):
    return a + b


@calcfunction
def multiply(a, b):
    return a * b


@workfunction
def add_multiply(x, y, z):
    return multiply(add(x, y), z)


def test_calcfunction_result_and_provenance(store, runner):
    res = multiply(add(Int(3), Int(4)), Int(5))
    assert res.value == 35
    assert QueryBuilder(store).nodes(NodeType.CALC_FUNCTION).count() == 2
    # fig 1: each calc has 2 inputs and 1 created output
    for node in QueryBuilder(store).nodes(NodeType.CALC_FUNCTION).all():
        ins = store.incoming(node["pk"], LinkType.INPUT_CALC)
        outs = store.outgoing(node["pk"], LinkType.CREATE)
        assert len(ins) == 2 and len(outs) == 1


def test_workfunction_call_links(store, runner):
    res = add_multiply(Int(1), Int(2), Int(3))
    assert res.value == 9
    wf = QueryBuilder(store).nodes(NodeType.WORK_FUNCTION).first()
    calls = store.outgoing(wf["pk"], LinkType.CALL_CALC)
    assert len(calls) == 2                       # fig 2: two CALL links
    rets = store.outgoing(wf["pk"], LinkType.RETURN)
    assert len(rets) == 1
    # the RETURN target is the same node CREATEd by the inner multiply —
    # workfunctions return existing data, they do not create copies
    ret_pk = rets[0][0]
    created_by = store.incoming(ret_pk, LinkType.CREATE)
    assert len(created_by) == 1


def test_exceptions_mark_node_excepted(store, runner):
    @calcfunction
    def boom(a):
        raise RuntimeError("bang")

    with pytest.raises(RuntimeError, match="bang"):
        boom(Int(1))
    node = QueryBuilder(store).nodes(NodeType.CALC_FUNCTION) \
        .with_state("excepted").first()
    assert node is not None
    logs = store.get_logs(node["pk"])
    assert any("bang" in l["message"] for l in logs)


def test_exit_code_return(store, runner):
    @calcfunction
    def refuses(a):
        return ExitCode(410, "nope", "ERROR_NOPE")

    out = refuses(Int(1))
    assert isinstance(out, ExitCode)
    node = QueryBuilder(store).nodes(NodeType.CALC_FUNCTION).first()
    assert node["exit_status"] == 410


def test_dict_outputs(store, runner):
    @calcfunction
    def split(a):
        return {"half": Int(a.value // 2), "rest": Int(a.value % 2)}

    out = split(Int(7))
    assert out["half"].value == 3 and out["rest"].value == 1
    node = QueryBuilder(store).nodes(NodeType.CALC_FUNCTION).first()
    outs = store.outgoing(node["pk"], LinkType.CREATE)
    assert {label for _, _, label in outs} == {"half", "rest"}


def test_nested_workfunctions_nest_call_links(store, runner):
    @workfunction
    def outer(x):
        return add_multiply(x, Int(1), Int(2))

    res = outer(Int(5))
    assert res.value == 12
    wfs = QueryBuilder(store).nodes(NodeType.WORK_FUNCTION).all()
    assert len(wfs) == 2
    outer_node = next(n for n in wfs if n["process_type"] == "outer")
    calls = store.outgoing(outer_node["pk"], LinkType.CALL_WORK)
    assert len(calls) == 1


def test_run_get_node(store, runner):
    result, proc, exit_code = add.run_get_node(Int(2), Int(3))
    assert result.value == 5
    assert exit_code.status == 0
    assert store.get_node(proc.pk)["process_state"] == "finished"


# ===========================================================================
# twins of tests/test_engine.py
# ===========================================================================

def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# transport queue (paper §II.B.4.b)
# ---------------------------------------------------------------------------

def test_transport_queue_bundles_connections():
    """N concurrent requests share O(1) connection opens."""

    async def main():
        tq = TransportQueue(safe_interval=0.01)
        t = LocalTransport("hpc")
        tq.register_transport(t)

        async def use():
            tr = await tq.request_transport("hpc")
            assert tr.is_open
            return tr

        await asyncio.gather(*[use() for _ in range(50)])
        return t.open_count, tq.stats

    opens, stats = run(main())
    assert stats["requests"] == 50
    assert opens == 1          # one connection served all 50 requests


def test_transport_queue_safe_interval_enforced():
    import time

    async def main():
        tq = TransportQueue(safe_interval=0.05)
        t = LocalTransport("hpc")
        tq.register_transport(t)
        tr = await tq.request_transport("hpc")
        await tr.close()
        t0 = time.monotonic()
        tr = await tq.request_transport("hpc")   # must wait out the interval
        return time.monotonic() - t0

    elapsed = run(main())
    assert elapsed >= 0.04


# ---------------------------------------------------------------------------
# communicator task queue: ack on success, requeue on failure
# ---------------------------------------------------------------------------

def test_task_queue_requeues_failed_tasks():
    async def main():
        comm = LocalCommunicator()
        seen = []

        async def handler(payload):
            seen.append(payload["n"])
            if len(seen) == 1:
                raise RuntimeError("first delivery fails")

        comm.add_task_subscriber("q", handler)
        comm.task_send("q", {"n": 7})
        for _ in range(100):
            await asyncio.sleep(0.01)
            if len(seen) >= 2:
                break
        comm.close()
        return seen

    seen = run(main())
    assert seen == [7, 7]     # redelivered after the nack


def test_requeue_timeout_redelivers_hung_task():
    """Visibility-timeout enforcement: a handler that never acks gets its
    task redelivered after requeue_timeout (at-least-once semantics)."""

    async def main():
        comm = LocalCommunicator(requeue_timeout=0.2)
        seen = []
        hung = asyncio.Event()

        async def handler(payload):
            seen.append(payload["n"])
            if len(seen) == 1:
                await hung.wait()      # first delivery hangs forever

        comm.add_task_subscriber("q", handler)
        comm.task_send("q", {"n": 3})
        for _ in range(200):
            await asyncio.sleep(0.02)
            if len(seen) >= 2:
                break
        hung.set()
        comm.close()
        return seen

    seen = run(main())
    assert seen == [3, 3]      # redelivered after the visibility timeout


def test_no_subscriber_task_is_parked_not_spun():
    """A task sent before any subscriber exists waits in the queue (no
    busy-requeue) and is delivered once someone subscribes."""

    async def main():
        comm = LocalCommunicator()
        comm.task_send("q", {"n": 1})
        await asyncio.sleep(0.1)
        assert comm.queue_depth("q") == 1     # still parked, not churned
        seen = []

        async def handler(payload):
            seen.append(payload["n"])

        comm.add_task_subscriber("q", handler)
        for _ in range(100):
            await asyncio.sleep(0.01)
            if seen:
                break
        comm.close()
        return seen

    assert run(main()) == [1]


def test_rpc_identifier_directory():
    async def main():
        comm = LocalCommunicator()
        comm.add_rpc_subscriber("process.1", lambda m: None)
        comm.add_rpc_subscriber("process.2", lambda m: None)
        comm.add_rpc_subscriber("worker.a", lambda m: None)
        idents = comm.rpc_identifiers("process.*")
        comm.close()
        return idents

    assert run(main()) == ["process.1", "process.2"]


def test_broadcast_subject_filter():
    async def main():
        comm = LocalCommunicator()
        got = []
        comm.add_broadcast_subscriber(
            lambda s, sender, b: got.append(s),
            subject_filter="state_changed.*")
        comm.broadcast_send("state_changed.running.finished", 1, {})
        comm.broadcast_send("unrelated.subject", 1, {})
        comm.close()
        return got

    got = run(main())
    assert got == ["state_changed.running.finished"]


def test_rpc_roundtrip():
    async def main():
        comm = LocalCommunicator()
        comm.add_rpc_subscriber("process.1", lambda msg: msg["x"] * 2)
        res = comm.rpc_send("process.1", {"x": 21})
        with pytest.raises(KeyError):
            comm.rpc_send("process.404", {})
        comm.close()
        return res

    assert run(main()) == 42


# ---------------------------------------------------------------------------
# flaky transport
# ---------------------------------------------------------------------------

def test_flaky_transport_fails_then_recovers():
    async def main():
        t = FlakyTransport(fail_first=2)
        await t.open()
        with pytest.raises(ConnectionError):
            await t.put_file("a", b"1")
        with pytest.raises(ConnectionError):
            await t.put_file("a", b"1")
        await t.put_file("a", b"1")
        # failure budget is per operation kind
        with pytest.raises(ConnectionError):
            await t.get_file("a")
        with pytest.raises(ConnectionError):
            await t.get_file("a")
        assert await t.get_file("a") == b"1"

    run(main())


# ===========================================================================
# parity with the reference, and the branches the port leaves out
# ===========================================================================

def plain_affine(x, y):
    """Lifted by both packages' calcfunction: no package named inside."""
    return {"total": x + y, "product": x * y}


def _graph(st, state_attr):
    """Node rows (no pk-independent times or uuids; the state history by
    its states alone) and link rows of a whole store."""
    nodes = []
    for r in st._conn().execute("SELECT * FROM nodes ORDER BY pk"):
        r = dict(r)
        attrs = json.loads(r.pop("attributes") or "{}")
        attrs[state_attr] = [s for s, _ in attrs.get(state_attr, [])]
        for key in ("uuid", "ctime", "mtime"):
            r.pop(key)
        nodes.append((r, attrs))
    links = [tuple(r) for r in st._conn().execute(
        "SELECT in_id, out_id, link_type, label FROM links ORDER BY pk")]
    return nodes, links


def test_lifted_function_same_hash_nodes_and_links():
    import repro.core as j_core
    from repro.caching.hashing import compute_input_hash as j_hash
    from repro.engine.runner import Runner as JRunner
    from repro.engine.runner import set_default_runner as j_set_runner
    from repro.observability.timeline import STATE_HISTORY_ATTR as J_ATTR
    from repro.provenance.store import ProvenanceStore as JStore
    from repro_torch.caching.hashing import compute_input_hash
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.observability.timeline import STATE_HISTORY_ATTR
    from repro_torch.provenance.store import ProvenanceStore

    assert STATE_HISTORY_ATTR == J_ATTR
    j_fn, fn = j_core.calcfunction(plain_affine), calcfunction(plain_affine)
    assert fn.process_class._cache_extra_salt == \
        j_fn.process_class._cache_extra_salt != ""
    assert compute_input_hash(fn.process_class,
                              {"x": Int(2), "y": Int(3)}) == \
        j_hash(j_fn.process_class, {"x": j_core.Int(2), "y": j_core.Int(3)})

    j_st, st = JStore(":memory:"), ProvenanceStore(":memory:")
    j_set_runner(JRunner(store=j_st))
    set_default_runner(Runner(store=st))
    try:
        for x, y in ((2, 3), (5, -1)):
            j_out = j_fn(j_core.Int(x), j_core.Int(y))
            out = fn(Int(x), Int(y))
            assert {k: v.value for k, v in out.items()} == \
                {k: v.value for k, v in j_out.items()}
        assert _graph(st, STATE_HISTORY_ATTR) == _graph(j_st, J_ATTR)
        nodes, links = _graph(st, STATE_HISTORY_ATTR)
        procs = [r for r, _ in nodes if r["node_type"] ==
                 NodeType.CALC_FUNCTION.value]
        assert len(procs) == 2 and all(
            r["process_type"] == "plain_affine"
            and r["process_state"] == "finished" and r["exit_status"] == 0
            and r["node_hash"] for r in procs)
        assert len(links) == 8
    finally:
        j_set_runner(None)
        set_default_runner(None)


def test_to_data_value_refuses_bf16_tensor():
    from repro_torch.core.datatypes import ArrayData, to_data_value

    t = torch.ones(3, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16.*cast"):
        to_data_value(t)
    with pytest.raises(TypeError, match="bfloat16"):
        ArrayData(t)
    # a cast tensor stores, in its own dtype
    assert to_data_value(t.float()).value.dtype == np.float32
    assert to_data_value(torch.arange(3, dtype=torch.int32)).value.dtype \
        == np.int32


def test_outline_needs_the_workchain_layer():
    """``ProcessSpec.outline`` builds its steps through
    ``core/workchain.py``: one step per plain callable."""
    from repro_torch.core.workchain import _Step

    def go(self):
        pass

    spec = ProcessSpec()
    assert spec.get_outline() is None
    spec.outline(go)
    (step,) = spec.get_outline()
    assert isinstance(step, _Step) and step.name == "go"


def test_distributed_runner_raises_before_creating_a_node(store):
    """A distributed (daemon) runner creates the process node and its
    checkpoint here and ships only the pk through the durable task queue;
    nothing runs in this process."""
    from repro_torch.engine.daemon import PROCESS_QUEUE
    from repro_torch.engine.runner import QueuedHandle, Runner

    class Echo(Process):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.input("x", valid_type=Int)

        async def run(self):
            raise AssertionError("a distributed submit must not run it")

    class Capture(LocalCommunicator):
        def task_send(self, queue, payload):
            sent.append((queue, payload))

    sent = []
    r = Runner(store=store, communicator=Capture())
    r.distributed = True
    r.submitter_id = "tests"
    handle = r.submit(Echo, {"x": Int(1)})
    assert isinstance(handle, QueuedHandle)
    ((queue, payload),) = sent
    assert queue == PROCESS_QUEUE and payload["pk"] == handle.pk
    assert payload["submitter"] == "tests" and payload["ts"] > 0
    assert store.get_node(handle.pk)["process_state"] == "created"
    assert store.load_checkpoint(handle.pk) is not None


def test_reference_checkpoint_is_refused_without_importing_it(tmp_path):
    """Both packages share one store schema. A checkpoint the reference
    wrote names ``repro.<module>:<Class>``; resuming it in the port must
    raise and load neither the reference nor JAX. The resume runs in a
    fresh interpreter, so this test's own imports cannot mask an import."""
    import os
    import subprocess
    import sys

    from repro.calcjobs import TPUTrainJob
    from repro.core import Dict as RefDict
    from repro.engine.runner import Runner as RefRunner
    from repro.provenance.store import configure_store as ref_configure

    db = str(tmp_path / "profile.db")
    ref_store = ref_configure(db)
    pk = TPUTrainJob(inputs={"config": RefDict({"arch": "qwen2-0.5b"})},
                     runner=RefRunner(store=ref_store)).pk
    ref_store.close()
    ref_configure(":memory:")

    code = (
        "import sys\n"
        "from repro_torch.core.process import (Process,\n"
        "                                      ReferencePackageError)\n"
        "from repro_torch.engine.runner import Runner\n"
        "from repro_torch.provenance.store import configure_store\n"
        f"store = configure_store({db!r})\n"
        f"ckpt = store.load_checkpoint({pk})\n"
        "try:\n"
        "    Process.recreate_from_checkpoint(ckpt,\n"
        "                                     runner=Runner(store=store))\n"
        "except ReferencePackageError as exc:\n"
        "    print('refused:', exc)\n"
        "else:\n"
        "    print('resumed')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "print('loaded:', bad)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("refused:"), out.stdout
    assert "repro.calcjobs.tpujob:TPUTrainJob" in lines[0]
    assert "runs only its own process classes" in lines[0]
    assert lines[-1] == "loaded: []", out.stdout
