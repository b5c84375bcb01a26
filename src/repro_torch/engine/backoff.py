"""Exponential-back-off-retry (paper §II.B.4.a).

Wraps any transport task in a coroutine that catches exceptions and
reschedules the operation with doubling intervals. After ``max_attempts``
the wrapper raises ``TransportTaskExhausted`` — the owning process then
PAUSES (never excepts), leaving the user free to fix the environment and
``play`` it (the paper's robustness contract).

Retries use *full jitter*: each wait is drawn uniformly from
``[0, interval]`` before the interval doubles. When hundreds of processes
hit the same dead scheduler at once, deterministic doubling re-synchronises
their retries into thundering herds — jitter decorrelates them. Pass
``jitter=False`` (or a seeded ``rng``) where tests need exact timings.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Awaitable, Callable, TypeVar

_T = TypeVar("_T")

from repro_torch.observability import metrics as _metrics

logger = logging.getLogger("repro_torch.engine.backoff")


class TransportTaskExhausted(RuntimeError):
    def __init__(self, name: str, attempts: int, last: BaseException):
        super().__init__(
            f"transport task {name!r} failed {attempts} times; last error: "
            f"{last!r}")
        self.name = name
        self.attempts = attempts
        self.last = last


async def exponential_backoff_retry(
        fn: Callable[[], Awaitable],
        *, initial_interval: float = 0.2,
        max_attempts: int = 5,
        name: str = "transport-task",
        non_retryable: tuple[type[BaseException], ...] = (),
        sleeper: Callable[[float], Awaitable] | None = None,
        jitter: bool = True,
        rng: random.Random | None = None):
    """Run ``fn`` with exponential backoff: the interval ceiling doubles
    per retry; the actual wait is full-jittered within it."""
    sleep = sleeper or asyncio.sleep
    rand = rng or random
    interval = initial_interval
    last: BaseException | None = None
    registry = _metrics.get_registry()
    for attempt in range(1, max_attempts + 1):
        try:
            return await fn()
        except non_retryable:
            raise
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 — that's the point
            last = exc
            logger.warning("%s failed (attempt %d/%d): %r", name, attempt,
                           max_attempts, exc)
            if attempt == max_attempts:
                break
            registry.counter("backoff.retries").inc()
            await sleep(rand.uniform(0.0, interval) if jitter else interval)
            interval *= 2.0
    registry.counter("backoff.exhausted").inc()
    raise TransportTaskExhausted(name, max_attempts, last)


def retry_sync(
        fn: Callable[[], _T],
        *, initial_interval: float = 0.1,
        max_attempts: int = 5,
        name: str = "transport-task",
        non_retryable: tuple[type[BaseException], ...] = (),
        sleeper: Callable[[float], None] | None = None,
        jitter: bool = True,
        rng: random.Random | None = None) -> _T:
    """Blocking counterpart of :func:`exponential_backoff_retry` for the
    synchronous clients (CLI control verbs, daemon submitters). Same
    full-jitter schedule and the same ``backoff.*`` counters, so a broker
    restart window shows up identically in the metrics whichever
    transport crossed it."""
    sleep = sleeper or time.sleep
    rand = rng or random
    interval = initial_interval
    last: BaseException | None = None
    registry = _metrics.get_registry()
    for attempt in range(1, max_attempts + 1):
        try:
            return fn()
        except non_retryable:
            raise
        except Exception as exc:  # noqa: BLE001 — that's the point
            last = exc
            logger.warning("%s failed (attempt %d/%d): %r", name, attempt,
                           max_attempts, exc)
            if attempt == max_attempts:
                break
            registry.counter("backoff.retries").inc()
            sleep(rand.uniform(0.0, interval) if jitter else interval)
            interval *= 2.0
    registry.counter("backoff.exhausted").inc()
    raise TransportTaskExhausted(name, max_attempts, last)
