"""Chaos subsystem: deterministic fault injection for the engine.

:mod:`repro_torch.chaos.faults` is the fault-point registry. Hot paths in
the store and the engine call ``fault_point("<seam>")`` at every
failure window; a seeded :class:`ChaosPlan` (programmatic or via the
``REPRO_CHAOS`` env spec) decides whether a hit crashes the process,
raises, delays, or asks the seam to duplicate/drop a frame. Disabled, a
fault point is one module-global load and a ``None`` check.
:mod:`repro_torch.chaos.invariants` is the post-chaos verifier: zero
lost / duplicated / resurrected processes and a consistent provenance
graph. :mod:`repro_torch.chaos.harness` is the scenario runner: it
spawns a real daemon (broker + workers as OS processes), kill -9's
workers mid-step, crashes inside store transactions, partitions
broadcast fan-out, duplicates task delivery, then supervises restarts
until the workload (:mod:`repro_torch.chaos.workloads`) drains.

Only :mod:`faults` is imported here — the instrumented layers (store,
broker, process) import this package, so it must not pull the engine in.
"""

from repro_torch.chaos.faults import (  # noqa: F401
    CATALOG, ChaosInjected, ChaosPlan, activate, active_plan, deactivate,
    fault_point, reset,
)
