"""Device time by the program's own ranges: each operation of a profiled
window on the card belongs to the innermost range of the program
(``record_function``, as ``repro_torch.observability.trace.region`` and
``bwd_region`` enter them) that encloses its launch, on the launching
thread.

The match goes through the profiler's correlation: a device operation and
the runtime call that launched it (``cudaLaunchKernel``, a copy, a set)
share a correlation id, and the profiler gives that call the thread of the
host op it is linked to (torch 2.11), the launching thread. The window is
the ``cardbench.window`` range, as in ``devtrace``, and device time is
clipped to it; the ranges' shadows on the device's timeline are no
operations and are left out, as ``devtrace`` leaves them out.

**Work between autograd's nodes.** Autograd adds the gradients bound for
one tensor in its engine, after the node that made the last of them has
returned, and so after that node's ``<region>.bwd`` range has closed. An
operation launched where no ``.bwd`` range is open belongs to the ``.bwd``
range that closed last on its thread before the launch, if that range lies
inside the innermost range open at the launch (or no range is open there);
otherwise to that innermost range. So the zero-filled gradient of a
stacked leaf and its add into the leaf's gradient both belong to
``model.layer_slice.bwd``. Forward ranges never extend past their close.
An operation that no range owns is counted under ``NONE``.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass

from cardbench.devtrace import WINDOW_RANGE

NONE = "(none)"
BWD = ".bwd"


@dataclass
class Spans:
    window_s: float
    device_s: float                     # the operations' times, summed
    by_owner: dict[str, float]          # seconds by owning range
    by_owner_op: dict[tuple[str, str], float]   # (owner, operation name)
    ranges: dict[str, int]              # ranges opened in the window

    def seconds(self, *names: str) -> float:
        return sum(self.by_owner.get(n, 0.0) for n in names)

    def share(self, owned) -> float | None:
        """The share (%) of device time whose owner ``owned(name)`` holds
        for; None for a window without device time."""
        if self.device_s <= 0:
            return None
        return 100.0 * sum(s for n, s in self.by_owner.items()
                           if n != NONE and owned(n)) / self.device_s


def owners(ranges: list[tuple[float, float, str]], times: list[float]
           ) -> list[str]:
    """For each of the ascending ``times`` on one thread, the owner by the
    module's rule among ``ranges`` ((start, end, name) on that thread)."""
    by_start = sorted(ranges)
    by_end = sorted(ranges, key=lambda r: r[1])
    open_: list[tuple[float, float, str]] = []     # (-start, end, name)
    out, i, j, last = [], 0, 0, None
    for t in times:
        while i < len(by_start) and by_start[i][0] <= t:
            a, b, name = by_start[i]
            heapq.heappush(open_, (-a, b, name))
            i += 1
        while open_ and open_[0][1] < t:
            heapq.heappop(open_)
        while j < len(by_end) and by_end[j][1] < t:
            last = by_end[j]
            j += 1
        inner = open_[0] if open_ else None
        if last is not None and last[2].endswith(BWD) and (
                inner is None or last[0] >= -inner[0]):
            out.append(last[2])
        else:
            out.append(inner[2] if inner is not None else NONE)
    return out


def reduce(device: list[tuple[str, float, float, int, float]],
           ranges: list[tuple[int, float, float, str]],
           window: tuple[float, float]) -> Spans:
    """``device``: (name, start, end, thread, launch) of each device
    operation, with the launching thread and the launch's time (thread
    None where no launch was found); ``ranges``: (thread, start, end,
    name) of each program range on the host; ``window``: (start, end).
    Times in one unit, seconds out for microseconds in."""
    lo, hi = window
    inside = [(n, max(a, lo), min(b, hi), th, t) for n, a, b, th, t in device
              if b > lo and a < hi]
    per_thread: dict[int, list] = defaultdict(list)
    for k, (_, _, _, th, t) in enumerate(inside):
        if th is not None:
            per_thread[th].append((t, k))
    owner = [NONE] * len(inside)
    ranges_of: dict[int, list] = defaultdict(list)
    for th, a, b, name in ranges:
        ranges_of[th].append((a, b, name))
    for th, launches in per_thread.items():
        launches.sort()
        for (_, k), o in zip(launches, owners(ranges_of[th],
                                              [t for t, _ in launches])):
            owner[k] = o
    by_owner: dict[str, float] = defaultdict(float)
    by_owner_op: dict[tuple[str, str], float] = defaultdict(float)
    for (name, a, b, _, _), o in zip(inside, owner):
        by_owner[o] += (b - a) / 1e6
        by_owner_op[(o, name)] += (b - a) / 1e6
    counts: dict[str, int] = defaultdict(int)
    for _, a, _, name in ranges:
        if lo <= a < hi:
            counts[name] += 1
    return Spans(window_s=(hi - lo) / 1e6,
                 device_s=sum(b - a for _, a, b, _, _ in inside) / 1e6,
                 by_owner=dict(by_owner), by_owner_op=dict(by_owner_op),
                 ranges=dict(counts))


def from_events(events) -> Spans:
    """Reduce the profiler's raw events (``KinetoEvent``s: a finished
    profile's ``prof.profiler.kineto_results.events()``)."""
    from torch.autograd import DeviceType

    window = None
    ranges, device = [], []
    launches: dict[int, tuple[int, float]] = {}
    for e in events:
        a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() > 0:   # a runtime call in a host op
                launches[e.correlation_id()] = (e.start_thread_id(), a)
            elif e.is_user_annotation():
                if e.name() == WINDOW_RANGE:
                    window = (a, b)
                else:
                    ranges.append((e.start_thread_id(), a, b, e.name()))
        elif e.device_type() == DeviceType.CUDA and \
                not e.is_user_annotation() and e.name() != WINDOW_RANGE:
            device.append((e.correlation_id(), e.name(), a, b))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    ops = [(name, a, b, *launches.get(corr, (None, a)))
           for corr, name, a, b in device]
    return reduce(ops, ranges, window)


def from_profiler(prof) -> Spans:
    """Reduce a finished ``torch.profiler.profile``."""
    return from_events(prof.profiler.kineto_results.events())
