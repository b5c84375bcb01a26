"""Checkpoint-heavy workloads for chaos scenarios.

These live in an importable module — NOT in the harness — because daemon
workers recreate processes from their checkpoints by importing
``module:qualname``; classes defined under ``__main__`` cannot cross the
spawn boundary.

``ChaosCalc`` is deliberately a *staged* process: it takes a durable
checkpoint after every stage, so a kill -9 at any moment loses at most
one stage of work and the replacement worker resumes from ``_stage``
rather than from scratch. ``ChaosChain`` adds a call hierarchy on top so
broadcast-dependent parent/child waits are exercised too.
"""

from __future__ import annotations

import asyncio

from repro_torch.core import Float, Int, Process, ToContext, WorkChain, append_
from repro_torch.provenance.store import NodeType


class ChaosCalc(Process):
    """Runs ``steps`` stages, checkpointing after each. Survivable at any
    kill point: the stage counter rides in ``checkpoint_extras``."""

    NODE_TYPE = NodeType.CALC_FUNCTION
    CACHEABLE = False

    _stage = 0  # class default; recreate_from_checkpoint bypasses __init__

    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("steps", valid_type=Int, default=Int(3))
        spec.input("pause", valid_type=Float, default=Float(0.05))
        spec.output("result", valid_type=Int)

    def checkpoint_extras(self) -> dict:
        return {"stage": self._stage}

    def load_checkpoint_extras(self, extras: dict) -> None:
        self._stage = int(extras.get("stage", 0))

    async def run(self):
        steps = self.inputs["steps"].value
        pause = self.inputs["pause"].value
        while self._stage < steps:
            await self.interruptible(asyncio.sleep(pause))
            self._stage += 1
            self.checkpoint_now()
        self.out("result", Int(steps))


class ChaosChain(WorkChain):
    """Fans out ``n`` ChaosCalc children and waits on all of them — the
    parent's WAITING→RUNNING wake-up depends on terminal broadcasts, which
    is exactly what the broker-partition scenario drops."""

    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("n", valid_type=Int, default=Int(2))
        spec.input("steps", valid_type=Int, default=Int(3))
        spec.input("pause", valid_type=Float, default=Float(0.05))
        spec.output("total", valid_type=Int)
        spec.outline(cls.launch, cls.collect)

    def launch(self):
        for _ in range(self.inputs["n"].value):
            self.to_context(children=append_(self.submit(
                ChaosCalc, steps=self.inputs["steps"],
                pause=self.inputs["pause"])))

    def collect(self):
        total = sum(c.outputs["result"].value for c in self.ctx.children)
        self.out("total", Int(total))
