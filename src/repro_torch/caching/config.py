"""Caching policy: which process types may take the cache-hit fast path.

Three layers, strongest first:

1. ``enable_caching()`` / ``disable_caching()`` context managers — the
   innermost active frame that mentions a process type (or all types)
   decides.
2. The ``REPRO_CACHING`` environment variable — ``1``/``all``/``true``
   enables every cacheable type, ``0``/``false``/``off`` disables all,
   and any other value is read as a comma-separated list of process-type
   names to enable. This is how daemon workers (separate OS processes,
   which inherit the environment) are switched on.
3. The global :class:`CachingPolicy` defaults (off unless opted in).

Orthogonally, a process class must be *cacheable* at all: calculation-like
processes (calcfunctions, calcjobs) are; workflow-like processes
(workchains, workfunctions) are not, because reusing a workflow node would
silently skip replaying its subprocesses. A class can force either way
with ``CACHEABLE = True/False``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

ENV_VAR = "REPRO_CACHING"
_TRUE = ("1", "all", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off", "none")


def _is_cacheable(process_cls: type) -> bool:
    explicit = getattr(process_cls, "CACHEABLE", None)
    if explicit is not None:
        return bool(explicit)
    from repro_torch.provenance.store import NodeType

    node_type = getattr(process_cls, "NODE_TYPE", None)
    return node_type in (NodeType.CALC_FUNCTION, NodeType.CALC_JOB)


class CachingPolicy:
    """Per-process-type opt-in/out with a global default."""

    def __init__(self, default_enabled: bool = False):
        self.default_enabled = default_enabled
        self._enabled: set[str] = set()
        self._disabled: set[str] = set()
        # context-manager frames: (enable?, frozenset of names or None=all)
        self._stack: list[tuple[bool, frozenset[str] | None]] = []

    # -- persistent configuration ------------------------------------------
    def enable(self, *process_types: str) -> None:
        if not process_types:
            self.default_enabled = True
            return
        for t in process_types:
            self._enabled.add(t)
            self._disabled.discard(t)

    def disable(self, *process_types: str) -> None:
        if not process_types:
            self.default_enabled = False
            self._enabled.clear()
            return
        for t in process_types:
            self._disabled.add(t)
            self._enabled.discard(t)

    # -- resolution ---------------------------------------------------------
    def is_enabled_for(self, process_cls: type) -> bool:
        if not _is_cacheable(process_cls):
            return False
        name = process_cls.__name__
        for on, names in reversed(self._stack):
            if names is None or name in names:
                return on
        env = os.environ.get(ENV_VAR)
        if env is not None:
            low = env.strip().lower()
            if low in _TRUE:
                return True
            if low in _FALSE or not low:
                return False
            return name in {t.strip() for t in env.split(",")}
        if name in self._disabled:
            return False
        if name in self._enabled:
            return True
        return self.default_enabled


_POLICY = CachingPolicy()


def get_policy() -> CachingPolicy:
    return _POLICY


def reset_policy() -> CachingPolicy:
    """Fresh policy (test isolation)."""
    global _POLICY
    _POLICY = CachingPolicy()
    return _POLICY


def is_caching_enabled_for(process_cls: type) -> bool:
    return _POLICY.is_enabled_for(process_cls)


def _names(process_types: tuple) -> frozenset[str] | None:
    if not process_types:
        return None
    return frozenset(t if isinstance(t, str) else t.__name__
                     for t in process_types)


@contextlib.contextmanager
def enable_caching(*process_types) -> Iterator[None]:
    """Scope in which caching is on — for all cacheable types, or only
    the given ones (names or classes)."""
    frame = (True, _names(process_types))
    _POLICY._stack.append(frame)
    try:
        yield
    finally:
        _POLICY._stack.remove(frame)


@contextlib.contextmanager
def disable_caching(*process_types) -> Iterator[None]:
    """Scope in which caching is off, overriding any outer enablement."""
    frame = (False, _names(process_types))
    _POLICY._stack.append(frame)
    try:
        yield
    finally:
        _POLICY._stack.remove(frame)
