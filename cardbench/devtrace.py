"""What a profiled window of the card gives: device busy time as the union
of its operations' intervals, each kernel's kind by its name, launches,
and the idle gaps with what the host was doing in each.

``torch.profiler`` records the card's kernels, copies and sets, and the
host's ops, on one clock (a host range's shadow on the device's timeline is
left out). The window is the span of the ``cardbench.window``
range that the driver records around the profiled work; device time is
clipped to it. Busy time is the union of the device intervals, so kernels
that overlap on several streams count once.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

WINDOW_RANGE = "cardbench.window"
TOP = 10              # entries in each list of the breakdown


@dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int
    device_s_by_kind: dict[str, float]
    idle_by_host: dict[str, float]

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.device_s_by_kind),
                "idle_gaps": top(self.idle_by_host)}


def kind_of(name: str, kinds: list[dict]) -> str:
    low = name.lower()
    for k in kinds:
        if any(p in low for p in k["patterns"]):
            return k["kind"]
    return "other"


def is_kernel(name: str) -> bool:
    """A launched kernel, not a copy or a set."""
    return not name.startswith(("Memcpy", "Memset"))


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: list[tuple[float, float]], lo: float, hi: float
         ) -> list[tuple[float, float]]:
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def host_activity(host: list[tuple[float, float, str]],
                  times: list[float]) -> list[str]:
    """For each of the ascending ``times``, the innermost host op running
    then (the latest to start among those that cover it), or ``python``
    where none does. One sweep: an op that has ended by one time has ended
    by every later one."""
    order = sorted(host)
    heap: list[tuple[float, float, str]] = []
    out, i = [], 0
    for t in times:
        while i < len(order) and order[i][0] <= t:
            a, b, name = order[i]
            heapq.heappush(heap, (-a, b, name))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "python")
    return out


def reduce(device: list[tuple[str, float, float]],
           host: list[tuple[float, float, str]],
           window: tuple[float, float], kinds: list[dict]) -> Trace:
    """``device``: (name, start_us, end_us) of each device operation;
    ``host``: (start_us, end_us, name) of each host op; ``window``: the
    window's (start_us, end_us)."""
    lo, hi = window
    inside = [(n, max(a, lo), min(b, hi)) for n, a, b in device
              if b > lo and a < hi]
    by_kind: dict[str, float] = {}
    for n, a, b in inside:
        k = kind_of(n, kinds)
        by_kind[k] = by_kind.get(k, 0.0) + (b - a) / 1e6
    busy = union([(a, b) for _, a, b in inside])
    host_in = [h for h in host if h[2] != WINDOW_RANGE]
    idle: dict[str, float] = {}
    holes = gaps(busy, lo, hi)
    labels = host_activity(host_in, [0.5 * (a + b) for a, b in holes])
    for (a, b), label in zip(holes, labels):
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return Trace(window_s=(hi - lo) / 1e6,
                 busy_s=sum(b - a for a, b in busy) / 1e6,
                 launches=sum(1 for n, _, _ in inside if is_kernel(n)),
                 device_s_by_kind=by_kind, idle_by_host=idle)


def from_profiler(prof, kinds: list[dict]) -> Trace:
    """Reduce a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            # a range recorded on the host shows on the device's timeline
            # too, spanning the kernels it holds: it is no operation
            if not getattr(e, "is_user_annotation", False) and \
                    e.name != WINDOW_RANGE:
                device.append((e.name, a, b))
        elif e.name == WINDOW_RANGE:
            window = (a, b)
        else:
            host.append((a, b, e.name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    return reduce(device, host, window, kinds)
