"""Lightweight span tracer with contextvar-propagated parent ids.

A *span* is a named wall-clock interval with a parent — together they
form the per-process timeline that ``repro process report`` renders.
The API is a context manager (``with span("store.commit"):``) or a
decorator (``@traced("engine.submit")``); parent linkage flows through a
:mod:`contextvars` variable, so spans opened inside ``asyncio`` tasks
attach to the span that was current when the task was created, exactly
like ``CURRENT_PROCESS`` does for provenance CALL links.

Tracing is **off by default** (``REPRO_TRACE=0``) and the disabled path
is near-zero-cost: ``span()`` returns a shared no-op singleton — no
``Span`` object, no contextvar writes, no clock reads — so hot paths
(store commits, checkpoint flushes) can stay instrumented permanently.
``REPRO_TRACE_SAMPLE`` (0.0–1.0) keeps only that fraction of *root*
spans/timelines when tracing is on.

Finished spans go to the current :class:`Timeline` sink (set by
``Process.step_until_terminated`` for the duration of a run); a span
finished outside any Timeline is dropped.

*Regions* put names on the device's work. ``region(name)`` enters a
``torch.profiler`` range while a torch profiler records and is the no-op
singleton otherwise; ``bwd_region(name, x, fn)`` also gives the
backward of ``fn(x)`` a range ``<name>.bwd`` on the thread that runs it.
Regions are read from the profiler's trace and never enter a Timeline: a
training job of many steps would write millions of them. A ``span``
enters a range of its own name too while a profiler records, so engine
spans land on the device trace's clock. The check is one read of torch's
own profiler flag; this module imports torch only inside the calls that
enter a range.
"""

from __future__ import annotations

import contextvars
import functools
import inspect
import itertools
import os
import random
import sys
import time
from typing import Any, Callable

ENV_VAR = "REPRO_TRACE"
SAMPLE_ENV_VAR = "REPRO_TRACE_SAMPLE"

_ids = itertools.count(1)

#: the innermost open span in this context (parent of any new span)
_CURRENT: contextvars.ContextVar["Span | None"] = \
    contextvars.ContextVar("TRACE_CURRENT", default=None)
#: where finished spans are collected (a per-process Timeline, usually)
_SINK: contextvars.ContextVar["Timeline | None"] = \
    contextvars.ContextVar("TRACE_SINK", default=None)

_enabled: bool | None = None  # None = not yet resolved from the env
_sample: float = 1.0


def _resolve() -> bool:
    global _enabled, _sample
    if _enabled is None:
        _enabled = os.environ.get(ENV_VAR, "0").lower() not in (
            "0", "", "false", "off", "no")
        try:
            _sample = min(1.0, max(0.0, float(
                os.environ.get(SAMPLE_ENV_VAR, "1.0"))))
        except ValueError:
            _sample = 1.0
    return _enabled


def enabled() -> bool:
    return _enabled if _enabled is not None else _resolve()


def enable(sample: float = 1.0) -> None:
    """Turn tracing on programmatically (overrides the env)."""
    global _enabled, _sample
    _enabled = True
    _sample = min(1.0, max(0.0, sample))


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Back to env-resolved state (tests)."""
    global _enabled
    _enabled = None


def _sampled() -> bool:
    return _sample >= 1.0 or random.random() < _sample


class Span:
    """One named wall-clock interval. Use via :func:`span`, not directly."""

    __slots__ = ("name", "span_id", "parent", "start", "end", "attrs",
                 "_token", "_range")

    def __init__(self, name: str, attrs: dict | None):
        self.name = name
        self.span_id = next(_ids)
        self.attrs = attrs
        self.start = 0.0
        self.end = 0.0
        self.parent = _CURRENT.get()

    @property
    def parent_id(self) -> int | None:
        return self.parent.span_id if self.parent is not None else None

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        self._range = region(self.name)
        self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter()
        self._range.__exit__(*exc)
        _CURRENT.reset(self._token)
        sink = _SINK.get()
        if sink is not None:
            sink.append(self)

    def to_dict(self) -> dict:
        d = {"name": self.name, "id": self.span_id,
             "parent": self.parent_id, "start": self.start,
             "end": self.end}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _NoopSpan:
    """Shared do-nothing context manager — the disabled fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _NoopSpan()


def span(name: str, **attrs: Any):
    """Open a span (context manager). When tracing is disabled or this
    would-be root span is sampled out it is :func:`region` of its name:
    the shared no-op singleton unless a torch profiler records."""
    if not (_enabled if _enabled is not None else _resolve()):
        return region(name)
    if _sample < 1.0 and _CURRENT.get() is None and not _sampled():
        return region(name)
    return Span(name, attrs or None)


# ---------------------------------------------------------------------------
# Regions — named ranges on a torch profiler's trace
# ---------------------------------------------------------------------------

def _profiler():
    """torch's profiler module while one of its profilers records, else
    None (torch not loaded means no profiler)."""
    mod = sys.modules.get("torch.autograd.profiler")
    return mod if mod is not None and mod._is_profiler_enabled else None


def region(name: str):
    """A ``torch.profiler`` range named ``name`` (context manager) while a
    torch profiler records; the shared no-op singleton otherwise."""
    prof = _profiler()
    return _NOOP if prof is None else prof.record_function(name)


class _BwdRange:
    """The ``<name>.bwd`` range of one :func:`bwd_region` call."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def open(self) -> None:
        prof = _profiler()
        if self._range is None and prof is not None:
            self._range = prof.record_function(self.name)
            self._range.__enter__()

    def close(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None


@functools.cache
def _edge():
    """The identity autograd function at a region's input and outputs
    (built on first use: this module does not import torch). Forward, a
    view of its input; backward, the gradient as it came (none stays none,
    never a tensor of zeros), after calling the range's ``open`` or
    ``close`` it was given."""
    import torch

    class RegionEdge(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, on_backward):
            ctx.on_backward = on_backward
            ctx.set_materialize_grads(False)
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            ctx.on_backward()
            return g, None

    return RegionEdge


def bwd_region(name: str, x: Any, fn: Callable[[Any], Any]) -> Any:
    """``fn(x)`` inside :func:`region` ``name``. While a torch profiler
    records and ``x`` takes a gradient, identity nodes at ``x`` and at
    each output tensor of ``fn`` that takes one put the backward of
    ``fn`` inside a range ``<name>.bwd`` on the thread that runs it:
    opened when the first output's gradient arrives, closed when ``x``'s
    leaves. The identities return views and launch nothing; with no
    profiler nothing is added to the graph.

    Work that autograd does between nodes after the close (adding this
    gradient into others bound for the same tensor) runs in no range; the
    trace's reader gives it to the ``.bwd`` range that closed last on its
    thread (``cardbench/spans.py``)."""
    prof = _profiler()
    if prof is None:
        return fn(x)
    import torch

    with prof.record_function(name):
        if not (torch.is_grad_enabled() and x.requires_grad):
            return fn(x)
        edge = _edge()
        rng = _BwdRange(name + ".bwd")
        out = fn(edge.apply(x, rng.close))

        def wrap(t):
            if isinstance(t, torch.Tensor) and t.requires_grad:
                return edge.apply(t, rng.open)
            return t

        if isinstance(out, tuple):
            return tuple(wrap(t) for t in out)
        return wrap(out)


def traced(name: str | None = None, **attrs: Any) -> Callable:
    """Decorator form of :func:`span`; works on sync and async callables."""

    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__
        if inspect.iscoroutinefunction(fn):
            @functools.wraps(fn)
            async def awrapper(*a, **kw):
                with span(label, **attrs):
                    return await fn(*a, **kw)
            return awrapper

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with span(label, **attrs):
                return fn(*a, **kw)
        return wrapper

    return deco


def current_span() -> Span | None:
    return _CURRENT.get()


# ---------------------------------------------------------------------------
# Timelines — per-process span collection
# ---------------------------------------------------------------------------

class Timeline:
    """Collects the finished spans of one logical operation (a process
    run). Installed as the context's sink with :func:`push_sink`;
    drained once at the end — appends after draining are dropped so a
    late-finishing stray span cannot resurrect a persisted timeline."""

    __slots__ = ("spans", "_closed")

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self._closed = False

    def append(self, s: Span) -> None:
        if not self._closed:
            self.spans.append(s)

    def drain(self, stamp_open: bool = True) -> list[dict]:
        """Close the timeline and return span dicts (chronological by
        start). With ``stamp_open``, spans still on the context stack
        (e.g. the root span around the caller) are included with their
        end stamped 'now'."""
        self._closed = True
        out = [s.to_dict() for s in self.spans]
        if stamp_open:
            now = time.perf_counter()
            open_span = _CURRENT.get()
            while open_span is not None:
                d = open_span.to_dict()
                d["end"] = now
                out.append(d)
                open_span = open_span.parent
        out.sort(key=lambda d: d["start"])
        return out


def start_timeline() -> Timeline | None:
    """A new sink for one process run — None when tracing is disabled or
    the run is sampled out (callers skip all timeline work then)."""
    if not (_enabled if _enabled is not None else _resolve()):
        return None
    if _sample < 1.0 and not _sampled():
        return None
    return Timeline()


def push_sink(sink: Timeline | None) -> contextvars.Token:
    return _SINK.set(sink)


def pop_sink(token: contextvars.Token) -> None:
    _SINK.reset(token)


class capture:
    """Context manager collecting every span finished inside the block —
    the test/benchmark harness: ``with capture() as spans: …``."""

    def __init__(self) -> None:
        self.timeline = Timeline()

    def __enter__(self) -> Timeline:
        self._token = push_sink(self.timeline)
        return self.timeline

    def __exit__(self, *exc) -> None:
        pop_sink(self._token)
