"""The port's WorkChain on the CPU: the outline DSL, context, awaitables
and checkpoint resume (paper §II.B.3).

Twins of ``tests/test_workchain.py`` run against ``repro_torch``, then the
WorkChain cases that the twins of ``tests/test_{builder,ports,store,
caching}.py`` in ``tests/test_torch_{engine,store,caching}.py`` ran on a
plain Process, now on the WorkChains the reference builds. The parity
cases define one outline (``while_``, ``if_`` / ``elif_`` / ``else_``,
``return_``, ``ToContext``, ``append_``) in both packages and hold the
step sequence, context, outputs, exit status and provenance graph
together.
"""

import asyncio
import json
from collections import Counter as Multiset

import numpy as np
import pytest

from repro_torch.core import (
    ArrayData, Bool, ExitCode, Int, Process, ProcessBuilder, ProcessState,
    Str, ToContext, WorkChain, append_, calcfunction, if_, return_, while_,
    workfunction,
)
from repro_torch.provenance.store import LinkType, NodeType, QueryBuilder


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


# ===========================================================================
# twins of tests/test_workchain.py
# ===========================================================================

class Counter(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("n", valid_type=Int, default=Int(5))
        spec.output("total", valid_type=Int)
        spec.outline(
            cls.setup,
            while_(cls.below)(cls.bump),
            cls.finish,
        )

    def setup(self):
        self.ctx.i = 0

    def below(self):
        return self.ctx.i < self.inputs["n"].value

    def bump(self):
        self.ctx.i += 1

    def finish(self):
        self.out("total", Int(self.ctx.i))


def test_while_loop(store, runner):
    outputs, proc = runner.run(Counter, {"n": Int(7)})
    assert proc.is_finished_ok
    assert outputs["total"].value == 7


class Conditional(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("x", valid_type=Int)
        spec.output("kind", valid_type=Int)
        spec.outline(
            if_(cls.is_big)(cls.set_big)
            .elif_(cls.is_medium)(cls.set_medium)
            .else_(cls.set_small),
        )

    def is_big(self):
        return self.inputs["x"].value > 100

    def is_medium(self):
        return self.inputs["x"].value > 10

    def set_big(self):
        self.out("kind", Int(2))

    def set_medium(self):
        self.out("kind", Int(1))

    def set_small(self):
        self.out("kind", Int(0))


@pytest.mark.parametrize("x,expected", [(1000, 2), (50, 1), (3, 0)])
def test_if_elif_else(store, runner, x, expected):
    outputs, proc = runner.run(Conditional, {"x": Int(x)})
    assert outputs["kind"].value == expected


class EarlyReturn(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.outline(
            cls.first,
            return_,
            cls.never,
        )

    def first(self):
        self.ctx.ran = ["first"]

    def never(self):
        self.ctx.ran.append("never")


def test_return_stops_outline(store, runner):
    outputs, proc = runner.run(EarlyReturn, {})
    assert proc.is_finished_ok
    assert proc.ctx.ran == ["first"]


class Aborter(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.exit_code(418, "ERROR_I_AM_A_TEAPOT",
                       "the workchain experienced an identity crisis")
        spec.outline(cls.abort_straightaway)

    def abort_straightaway(self):
        self.report("work chain will be terminated")
        return self.exit_codes.ERROR_I_AM_A_TEAPOT


def test_exit_code_abort(store, runner):
    outputs, proc = runner.run(Aborter, {})
    assert proc.state is ProcessState.FINISHED
    assert proc.exit_code.status == 418
    assert store.get_node(proc.pk)["exit_status"] == 418


class IntReturnAbort(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.outline(cls.go)

    def go(self):
        return 404


def test_integer_abort(store, runner):
    outputs, proc = runner.run(IntReturnAbort, {})
    assert proc.exit_code.status == 404


@calcfunction
def double(a):
    return Int(a.value * 2)


class Child(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("a", valid_type=Int)
        spec.output("doubled", valid_type=Int)
        spec.outline(cls.go)

    def go(self):
        self.out("doubled", double(self.inputs["a"]))


class Parent(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.expose_inputs(Child)
        spec.output("result", valid_type=Int)
        spec.outline(cls.launch, cls.collect)

    def launch(self):
        child = self.submit(Child, **self.exposed_inputs(Child))
        return ToContext(child=child)

    def collect(self):
        assert self.ctx.child.is_finished_ok
        self.out("result", self.ctx.child.outputs["doubled"])


def test_tocontext_and_expose(store, runner):
    outputs, proc = runner.run(Parent, {"a": Int(21)})
    assert outputs["result"].value == 42
    # CALL_WORK link parent -> child
    calls = store.outgoing(proc.pk, LinkType.CALL_WORK)
    assert len(calls) == 1


class FanOut(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("n", valid_type=Int, default=Int(4))
        spec.output("sum", valid_type=Int)
        spec.outline(cls.launch_all, cls.collect)

    def launch_all(self):
        for i in range(self.inputs["n"].value):
            self.to_context(children=append_(self.submit(Child,
                                                         a=Int(i))))

    def collect(self):
        total = sum(c.outputs["doubled"].value for c in self.ctx.children)
        self.out("sum", Int(total))


def test_append_parallel_children(store, runner):
    outputs, proc = runner.run(FanOut, {"n": Int(4)})
    assert outputs["sum"].value == 2 * (0 + 1 + 2 + 3)
    assert len(proc.ctx.children) == 4


def test_missing_required_output_fails(store, runner):
    class Forgetful(WorkChain):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.output("must_have", valid_type=Int)
            spec.outline(cls.noop)

        def noop(self):
            pass

    outputs, proc = runner.run(Forgetful, {})
    assert not proc.is_finished_ok
    assert proc.exit_code.status == 11


class TwoPhase(WorkChain):
    """Module-level (checkpoint recreation imports the class by path,
    exactly like AiiDA requires registered, importable process classes)."""

    executed = []
    crash_once = True

    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.output("v", valid_type=Int)
        spec.outline(cls.phase1, cls.phase2)

    def phase1(self):
        self.ctx.v = 41
        TwoPhase.executed.append("phase1")

    def phase2(self):
        if TwoPhase.crash_once:
            TwoPhase.crash_once = False
            TwoPhase.executed.append("phase2_crash")
            raise KeyboardInterrupt  # hard worker death mid-step
        TwoPhase.executed.append("phase2")
        self.out("v", Int(self.ctx.v + 1))


class WhileCrash(WorkChain):
    """Crashes inside the while_ body on a chosen iteration — exercises
    stepper save/load of a partially-executed loop body."""

    crash_at = None
    executed = []

    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("n", valid_type=Int, default=Int(4))
        spec.output("trace", valid_type=Int)
        spec.outline(
            cls.setup,
            while_(cls.below)(
                cls.first_half,
                cls.second_half,
            ),
            cls.finish,
        )

    def setup(self):
        self.ctx.i = 0
        self.ctx.halves = 0

    def below(self):
        return self.ctx.i < self.inputs["n"].value

    def first_half(self):
        self.ctx.halves += 1
        WhileCrash.executed.append(f"first[{self.ctx.i}]")

    def second_half(self):
        if WhileCrash.crash_at == self.ctx.i:
            WhileCrash.crash_at = None
            WhileCrash.executed.append(f"crash[{self.ctx.i}]")
            raise KeyboardInterrupt   # hard worker death mid-body
        WhileCrash.executed.append(f"second[{self.ctx.i}]")
        self.ctx.halves += 1
        self.ctx.i += 1

    def finish(self):
        self.out("trace", Int(self.ctx.halves))


def test_stepper_resume_mid_while_body(store, runner):
    """Kill a chain between the two steps of a while_ body; the resumed
    stepper must re-enter the SAME iteration at the interrupted step —
    not re-run the completed first half, not skip the iteration."""
    WhileCrash.executed = []
    WhileCrash.crash_at = 2
    proc = WhileCrash(inputs={"n": Int(4)}, runner=runner)
    pk = proc.pk
    with pytest.raises(KeyboardInterrupt):
        runner.loop.run_until_complete(proc.step_until_terminated())

    ckpt = store.load_checkpoint(pk)
    assert ckpt is not None
    resumed = Process.recreate_from_checkpoint(ckpt, runner=runner)
    # position restored mid-loop: iteration 2, first half already done
    assert resumed.ctx.i == 2 and resumed.ctx.halves == 5
    runner.loop.run_until_complete(resumed.step_until_terminated())
    assert resumed.is_finished_ok
    # 4 iterations x 2 halves, none double-counted across the crash
    assert resumed.outputs["trace"].value == 8
    assert WhileCrash.executed == [
        "first[0]", "second[0]", "first[1]", "second[1]",
        "first[2]", "crash[2]",            # original run dies here
        "second[2]", "first[3]", "second[3]",   # resume: same iteration,
    ]                                           # interrupted step only


def test_checkpoint_resume_mid_outline(store, runner):
    """Kill a workchain between steps; recreate from checkpoint; the
    context and outline position survive (paper §II.B.3.c). phase1 must
    NOT re-run on resume — only the step that was interrupted does."""
    TwoPhase.executed = []
    TwoPhase.crash_once = True
    proc = TwoPhase(inputs={}, runner=runner)
    pk = proc.pk
    with pytest.raises(KeyboardInterrupt):
        runner.loop.run_until_complete(proc.step_until_terminated())

    # Simulated restart: a fresh process object from the DB checkpoint
    # (saved after phase1 completed, before phase2 crashed).
    ckpt = store.load_checkpoint(pk)
    assert ckpt is not None
    resumed = Process.recreate_from_checkpoint(ckpt, runner=runner)
    assert resumed.ctx.v == 41
    runner.loop.run_until_complete(resumed.step_until_terminated())
    assert resumed.is_finished_ok
    assert resumed.outputs["v"].value == 42
    # phase1 ran exactly once; phase2 re-ran after the crash
    assert TwoPhase.executed == ["phase1", "phase2_crash", "phase2"]



# ===========================================================================
# the reference's WorkChain cases of tests/test_builder.py,
# tests/test_ports.py, tests/test_store.py and tests/test_caching.py
# ===========================================================================

class SubChain(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("n", valid_type=Int, serializer=Int,
                   help="how many units to process")
        spec.input("tag", valid_type=Str, serializer=Str, required=False)
        spec.output("doubled", valid_type=Int)
        spec.outline(cls.go)

    def go(self):
        self.out("doubled", Int(self.inputs["n"].value * 2))


class TopChain(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.expose_inputs(SubChain, namespace="sub")
        spec.input("flag", valid_type=Bool, serializer=Bool,
                   default=lambda: Bool(False))
        spec.output("result", valid_type=Int)
        spec.outline(cls.launch, cls.collect)

    def launch(self):
        return ToContext(child=self.submit(
            SubChain, **self.exposed_inputs(SubChain, "sub")))

    def collect(self):
        self.out("result", self.ctx.child.outputs["doubled"])


def test_workchain_get_builder_mirrors_port_tree():
    b = TopChain.get_builder()
    assert isinstance(b, ProcessBuilder)
    assert b.process_class is TopChain
    assert "sub" in dir(b)
    assert "n" in dir(b.sub)
    with pytest.raises(AttributeError):
        b.sub.n  # unset leaf
    b.sub.n = Int(3)
    assert b.sub.n.value == 3


def test_exposed_namespace_builder_roundtrip(store, runner):
    """Builder assignment into an exposed namespace reaches the child via
    WorkChain.exposed_inputs — the full expose/builder round-trip."""
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
    class LambdaDefault(WorkChain):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.input("n", valid_type=Int, serializer=Int,
                       default=lambda: 7)
            spec.output("n_out", valid_type=Int)
            spec.outline(cls.go)

        def go(self):
            self.out("n_out", self.inputs["n"])

    p1 = LambdaDefault(inputs={}, runner=runner)
    p2 = LambdaDefault(inputs={}, runner=runner)
    # each instantiation evaluates the lambda and serializes it freshly
    assert isinstance(p1.inputs["n"], Int) and p1.inputs["n"].value == 7
    assert p1.inputs["n"] is not p2.inputs["n"]


def test_workchain_construction_serializes_raw_dict_inputs(store, runner):
    outputs, proc = runner.run(SubChain, {"n": 21})
    assert proc.is_finished_ok
    assert outputs["doubled"].value == 42


def test_workchain_builder_submit_local(store, runner):
    from repro_torch.engine.launch import submit

    b = SubChain.get_builder()
    b.n = 4
    handle = submit(b)
    node = runner.run_until_complete(runner.wait(handle))
    assert node["process_state"] == "finished"
    assert node["exit_status"] == 0


def test_workchain_absorb_deep_copies_ports():
    """expose_inputs must not alias Port objects between WorkChain specs."""

    class Source(WorkChain):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.input("x", valid_type=Int)
            spec.input("nested.y", valid_type=Int, default=Int(1))
            spec.outline(cls.go)

        def go(self):
            pass

    class Exposer(WorkChain):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.expose_inputs(Source, namespace="src")
            spec.input("src.x", valid_type=Str)
            spec.outline(cls.go)

        def go(self):
            pass

    exposed = Exposer.spec().inputs["src"]
    source = Source.spec().inputs
    assert exposed["x"] is not source["x"]
    assert exposed["nested.y"] is not source["nested.y"]
    assert Exposer.spec().inputs["src.x"].valid_type == (Str,)
    assert source["x"].valid_type == (Int,)
    exposed["nested.y"].required = True
    assert source["nested.y"].required is False


def test_workchain_checkpoint_dirty_skip(store, runner):
    """An unchanged checkpoint is not rewritten; a terminal WorkChain's
    checkpoint is removed."""

    class Chain(WorkChain):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.input("n", valid_type=Int, default=Int(0))
            spec.output("r", valid_type=Int)
            spec.outline(cls.go)

        def go(self):
            self.out("r", Int(1))

    h = runner.submit(Chain, {"n": Int(1)})
    runner.loop.run_until_complete(h.process.wait_done())
    assert h.process.exit_code.status == 0
    assert store.load_checkpoint(h.pk) is None


def test_workchain_checkpoint_has_no_payload_copy(store, runner):
    class Hold(WorkChain):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.input("arr", valid_type=ArrayData)
            spec.outline(cls.go)

        def go(self):
            pass

    arr = np.arange(4096, dtype=np.float64)
    proc = Hold({"arr": ArrayData(arr)}, runner=runner)
    ckpt = store.load_checkpoint(proc.pk)
    assert "__data_ref__" in ckpt["inputs"]["arr"]   # reference, not a copy
    assert "npy_b64" not in json.dumps(ckpt)
    from repro_torch.core.process import _deserialize_inputs
    vals = _deserialize_inputs(ckpt["inputs"], store)
    assert np.array_equal(vals["arr"].value, arr)


def test_workchains_never_cached(store, runner):
    from repro_torch.caching import enable_caching

    ran = []

    class Chain(WorkChain):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.input("x", valid_type=Int)
            spec.output("y", valid_type=Int)
            spec.outline(cls.go)

        def go(self):
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


# ===========================================================================
# parity: one outline in both packages
# ===========================================================================

def _parity_chain(core):
    """The same WorkChain, built on ``core`` (``repro.core`` or
    ``repro_torch.core``). Every step records its name in ``ctx.steps``."""

    @core.calcfunction
    def triple(a):
        return core.Int(a.value * 3)

    class Leaf(core.WorkChain):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.input("a", valid_type=core.Int)
            spec.output("tripled", valid_type=core.Int)
            spec.outline(cls.go)

        def go(self):
            self.out("tripled", triple(self.inputs["a"]))

    class Chain(core.WorkChain):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.input("n", valid_type=core.Int)
            spec.output("total", valid_type=core.Int)
            spec.output("tail", valid_type=core.Int, required=False)
            spec.exit_code(420, "ERROR_ODD", "an odd count reached the end")
            spec.outline(
                cls.setup,
                core.while_(cls.below)(
                    core.if_(cls.is_even)(cls.fan_out)
                    .elif_(cls.is_three)(cls.note_three)
                    .else_(cls.skip),
                    cls.advance,
                ),
                cls.launch_tail,
                cls.collect,
                core.if_(cls.even_count)(core.return_),
                cls.finish_odd,
            )

        def _step(self, name):
            self.ctx.steps.append(name)

        def setup(self):
            self.ctx.steps = []
            self.ctx.i = 0
            self._step("setup")

        def below(self):
            return self.ctx.i < self.inputs["n"].value

        def is_even(self):
            return self.ctx.i % 2 == 0

        def is_three(self):
            return self.ctx.i == 3

        def fan_out(self):
            self._step(f"fan_out[{self.ctx.i}]")
            self.to_context(leaves=core.append_(
                self.submit(Leaf, a=core.Int(self.ctx.i))))

        def note_three(self):
            self._step("note_three")

        def skip(self):
            self._step(f"skip[{self.ctx.i}]")

        def advance(self):
            self.ctx.i += 1

        def launch_tail(self):
            self._step("launch_tail")
            return core.ToContext(tail=self.submit(
                Leaf, a=core.Int(self.inputs["n"].value)))

        def collect(self):
            self._step("collect")
            total = sum(c.outputs["tripled"].value for c in self.ctx.leaves)
            self.out("total", core.Int(total))
            self.out("tail", self.ctx.tail.outputs["tripled"])

        def even_count(self):
            return self.inputs["n"].value % 2 == 0

        def finish_odd(self):
            self._step("finish_odd")
            return self.exit_codes.ERROR_ODD

    return Chain


def _run_parity(pkg: str, n: int):
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    runner_mod = importlib.import_module(f"{pkg}.engine.runner")
    store_mod = importlib.import_module(f"{pkg}.provenance.store")
    store = store_mod.configure_store(":memory:")
    runner = runner_mod.Runner(store=store)
    runner_mod.set_default_runner(runner)
    try:
        outputs, proc = runner.run(_parity_chain(core), {"n": core.Int(n)})
        ctx = {"steps": list(proc.ctx.steps), "i": proc.ctx.i,
               "leaves": [c.outputs["tripled"].value
                          for c in proc.ctx.leaves],
               "tail": proc.ctx.tail.outputs["tripled"].value}
        conn = store._conn()
        nodes = Multiset(r[0] for r in conn.execute(
            "SELECT node_type FROM nodes"))
        links = Multiset(tuple(r) for r in conn.execute(
            "SELECT a.node_type, l.link_type, l.label, b.node_type "
            "FROM links l JOIN nodes a ON a.pk = l.in_id "
            "JOIN nodes b ON b.pk = l.out_id"))
        return {"ctx": ctx,
                "outputs": {k: v.value for k, v in outputs.items()},
                "exit_status": proc.exit_code.status,
                "state": proc.state.value,
                "nodes": nodes, "links": links}
    finally:
        runner_mod.set_default_runner(None)
        store_mod.configure_store(":memory:")


@pytest.mark.parametrize("n", [4, 5])
def test_outline_parity_with_reference(n):
    ref = _run_parity("repro", n)
    port = _run_parity("repro_torch", n)
    assert port == ref
    # the outline really took every branch it was built to take
    steps = port["ctx"]["steps"]
    assert steps[0] == "setup" and "note_three" in steps
    assert "skip[1]" in steps and "fan_out[2]" in steps
    assert ("finish_odd" in steps) == (n % 2 == 1)
    assert port["exit_status"] == (420 if n % 2 else 0)
