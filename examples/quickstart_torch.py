"""Quickstart on the PyTorch port: the paper's own API tour in one script
(the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--out examples_out]

Covers: calcfunction/workfunction provenance (figs. 1-2), the WorkChain
outline DSL (fizzbuzz, listing 9), ToContext subprocesses, exit codes,
the ProcessBuilder + engine.launch API (run/run_get_node on a builder,
port serializers wrapping raw python), and querying the resulting
provenance graph.
"""

import argparse
import os
import sys

sys.path.insert(0, "src")

from repro_torch.core import (
    Int, Str, ToContext, WorkChain, calcfunction, if_, while_, workfunction,
)
from repro_torch.engine.launch import run, run_get_node
from repro_torch.engine.runner import Runner, set_default_runner
from repro_torch.provenance import NodeType, QueryBuilder, configure_store


# --- calculation functions (paper listing 6) --------------------------------

@calcfunction
def add(a, b):
    return a + b


@calcfunction
def multiply(a, b):
    return a * b


# --- a work function orchestrating them (listing 8) --------------------------

@workfunction
def add_multiply(x, y, z):
    total = add(x, y)
    return multiply(total, z)


# --- the fizzbuzz work chain (listing 9) --------------------------------------

class FizzBuzzWorkChain(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("n_max", valid_type=Int, serializer=Int, default=Int(15))
        spec.output("summary", valid_type=Str)
        spec.outline(
            cls.initialize_to_zero,
            while_(cls.is_less_than_n_max)(
                if_(cls.is_multiple_of_three_and_five)(
                    cls.report_fizz_buzz,
                ).elif_(cls.is_multiple_of_three)(
                    cls.report_fizz,
                ).elif_(cls.is_multiple_of_five)(
                    cls.report_buzz,
                ).else_(
                    cls.report_n,
                ),
                cls.increment_by_one,
            ),
            cls.finalize,
        )

    def initialize_to_zero(self):
        self.ctx.n = 0
        self.ctx.words = []

    def is_less_than_n_max(self):
        return self.ctx.n <= int(self.inputs["n_max"].value)

    def is_multiple_of_three_and_five(self):
        return self.ctx.n % 15 == 0

    def is_multiple_of_three(self):
        return self.ctx.n % 3 == 0

    def is_multiple_of_five(self):
        return self.ctx.n % 5 == 0

    def report_fizz_buzz(self):
        self.ctx.words.append("fizzbuzz")

    def report_fizz(self):
        self.ctx.words.append("fizz")

    def report_buzz(self):
        self.ctx.words.append("buzz")

    def report_n(self):
        self.ctx.words.append(str(self.ctx.n))

    def increment_by_one(self):
        self.ctx.n += 1

    def finalize(self):
        self.report("counted to %d", self.ctx.n - 1)
        self.out("summary", Str(" ".join(self.ctx.words)))


# --- a parent chain waiting on a child (listings 11/16) -----------------------

class ChildWorkChain(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("a", valid_type=Int)
        spec.output("squared", valid_type=Int)
        spec.outline(cls.run_step)

    def run_step(self):
        self.report("running the ChildWorkChain")
        self.out("squared", multiply(self.inputs["a"], self.inputs["a"]))


class ParentWorkChain(WorkChain):
    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.expose_inputs(ChildWorkChain)
        spec.output("result", valid_type=Int)
        spec.outline(cls.run_child, cls.collect)

    def run_child(self):
        child = self.submit(ChildWorkChain,
                            **self.exposed_inputs(ChildWorkChain))
        return ToContext(child=child)

    def collect(self):
        self.out("result", self.ctx.child.outputs["squared"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="examples_out",
                    help="directory of the provenance store quickstart.db")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    store = configure_store(os.path.join(args.out, "quickstart.db"))
    runner = Runner(store=store)
    set_default_runner(runner)

    print("== process functions ==")
    result = add_multiply(Int(1), Int(2), Int(3))
    print(f"add_multiply(1, 2, 3) = {result.value}")

    print("\n== fizzbuzz work chain (builder + launch API) ==")
    # the builder mirrors the port tree; a raw 15 is serialized to Int(15)
    # on assignment, so provenance still records a proper data node
    builder = FizzBuzzWorkChain.get_builder()
    builder.n_max = 15
    builder.metadata.label = "quickstart-fizzbuzz"
    outputs = run(builder)
    print(outputs["summary"].value)

    print("\n== parent/child with ToContext ==")
    outputs, proc = run_get_node(ParentWorkChain, a=Int(12))
    print(f"12^2 = {outputs['result'].value}")

    print("\n== provenance graph ==")
    qb = QueryBuilder(store)
    for nt in (NodeType.CALC_FUNCTION, NodeType.WORK_FUNCTION,
               NodeType.WORK_CHAIN, NodeType.DATA):
        print(f"  {nt.value:24s} {qb.__class__(store).nodes(nt).count()} nodes")
    logs = store.get_logs(proc.pk)
    print(f"  reports on last chain: {[l['message'] for l in logs]}")


if __name__ == "__main__":
    main()
