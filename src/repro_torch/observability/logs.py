"""Namespaced logging configuration for daemon workers and the CLI.

``logging.basicConfig`` (what the daemon entry points used to call)
mutates the *root* logger — clobbering whatever configuration a host
application already installed. :func:`configure` instead attaches one
handler to the ``repro_torch`` logger namespace only, honours
``REPRO_LOG_LEVEL`` (the reference's variable, kept) or an explicit
``level=``, and is idempotent: calling it again just re-applies the level.

Worker records are tagged with the worker id and — while a daemon worker
is driving a process — the pk of that process, via a contextvar that the
task handler sets around each run:

    12:03:55 WARNING repro_torch.engine [worker.4711-ab12ef pk=42] ...
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import sys
from typing import IO, Iterator

ENV_VAR = "REPRO_LOG_LEVEL"

#: the pk of the process the current context is driving (daemon workers)
CURRENT_PK: contextvars.ContextVar[int | None] = \
    contextvars.ContextVar("LOG_PK", default=None)

_worker_id: str | None = None


def set_worker_id(worker_id: str | None) -> None:
    """Tag every subsequent record from this OS process."""
    global _worker_id
    _worker_id = worker_id


@contextlib.contextmanager
def pk_context(pk: int) -> Iterator[None]:
    """Records emitted inside the block carry ``pk=<pk>``."""
    token = CURRENT_PK.set(pk)
    try:
        yield
    finally:
        CURRENT_PK.reset(token)


class _ContextFilter(logging.Filter):
    """Injects the ``ctx`` field ('[worker pk=N]') into each record."""

    def filter(self, record: logging.LogRecord) -> bool:
        parts = []
        if _worker_id is not None:
            parts.append(_worker_id)
        pk = CURRENT_PK.get()
        if pk is not None:
            parts.append(f"pk={pk}")
        record.ctx = f" [{' '.join(parts)}]" if parts else ""
        return True


def _resolve_level(level: int | str | None) -> int:
    if level is None:
        level = os.environ.get(ENV_VAR) or "WARNING"
    if isinstance(level, str):
        resolved = logging.getLevelName(level.upper())
        if not isinstance(resolved, int):
            raise ValueError(f"unknown log level {level!r}")
        return resolved
    return level


def configure(level: int | str | None = None,
              worker_id: str | None = None,
              stream: IO | None = None) -> logging.Logger:
    """Configure the ``repro_torch`` logger namespace (and nothing else).

    Precedence for the level: explicit ``level`` argument, then the
    ``REPRO_LOG_LEVEL`` environment variable, then WARNING. Repeated
    calls re-apply the level without stacking handlers."""
    logger = logging.getLogger("repro_torch")
    logger.setLevel(_resolve_level(level))
    if worker_id is not None:
        set_worker_id(worker_id)
    for h in logger.handlers:
        if getattr(h, "_repro_obs", False):
            return logger  # already configured; level updated above
    handler = logging.StreamHandler(stream or sys.stderr)
    handler._repro_obs = True
    handler.addFilter(_ContextFilter())
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s%(ctx)s: %(message)s",
        datefmt="%H:%M:%S"))
    logger.addHandler(handler)
    # our handler owns repro_torch.* output; never double-print through root
    logger.propagate = False
    return logger
