"""Transports and the transport queue (paper §II.B.4.b).

A *transport* is a connection to a compute resource (AiiDA: SSH to a login
node; here: the cluster controller, or an in-process simulation). The
TransportQueue bundles connection requests per worker: it opens at most one
connection per ``safe_interval`` and hands the open transport to every
coroutine that queued a request — so N concurrent jobs cost O(1) connections
per interval instead of O(N).
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable

from repro_torch.observability.metrics import StatsDict


class Transport:
    """Base transport: open/close + exec/put/get primitives."""

    def __init__(self, hostname: str = "local"):
        self.hostname = hostname
        self._open = False
        self.open_count = 0

    async def open(self) -> "Transport":
        self._open = True
        self.open_count += 1
        return self

    async def close(self) -> None:
        self._open = False

    @property
    def is_open(self) -> bool:
        return self._open

    # -- primitives (overridden by concrete transports) ----------------------
    async def exec_command(self, command: str) -> tuple[int, str, str]:
        raise NotImplementedError

    async def put_file(self, name: str, content: bytes) -> None:
        raise NotImplementedError

    async def get_file(self, name: str) -> bytes:
        raise NotImplementedError


class LocalTransport(Transport):
    """In-process transport with an in-memory filesystem per remote dir."""

    def __init__(self, hostname: str = "local"):
        super().__init__(hostname)
        self.files: dict[str, bytes] = {}
        self.commands: list[str] = []
        self.command_handler: Callable[[str], tuple[int, str, str]] | None = None

    async def exec_command(self, command: str) -> tuple[int, str, str]:
        assert self.is_open, "transport not open"
        self.commands.append(command)
        if self.command_handler is not None:
            return self.command_handler(command)
        return 0, "", ""

    async def put_file(self, name: str, content: bytes) -> None:
        assert self.is_open, "transport not open"
        self.files[name] = bytes(content)

    async def get_file(self, name: str) -> bytes:
        assert self.is_open, "transport not open"
        return self.files[name]


class FlakyTransport(LocalTransport):
    """Fault-injecting transport: fails the first N operations of each kind.
    Used by tests and the robustness benchmark to exercise the
    exponential-backoff machinery."""

    def __init__(self, fail_first: int = 2, hostname: str = "flaky"):
        super().__init__(hostname)
        self.fail_first = fail_first
        self._failures: dict[str, int] = {}

    def _maybe_fail(self, kind: str) -> None:
        n = self._failures.get(kind, 0)
        if n < self.fail_first:
            self._failures[kind] = n + 1
            raise ConnectionError(
                f"injected transport failure #{n + 1} for {kind}")

    async def exec_command(self, command: str):
        self._maybe_fail(f"exec:{command.split()[0]}")
        return await super().exec_command(command)

    async def put_file(self, name: str, content: bytes) -> None:
        self._maybe_fail("put")
        await super().put_file(name, content)

    async def get_file(self, name: str) -> bytes:
        self._maybe_fail("get")
        return await super().get_file(name)


class TransportRequest:
    """A pending request for an open transport."""

    def __init__(self) -> None:
        self.future: asyncio.Future = asyncio.get_event_loop().create_future()


class TransportQueue:
    """At most one connection opened per safe_interval per authinfo
    (paper §II.B.4.b). Requests issued while a transport is open share it."""

    def __init__(self, safe_interval: float = 0.05):
        self.safe_interval = safe_interval
        self._transports: dict[str, Transport] = {}
        self._last_open: dict[str, float] = {}
        self._locks: dict[str, asyncio.Lock] = {}
        self.stats = StatsDict("transport", {"requests": 0, "opens": 0})

    def register_transport(self, transport: Transport) -> None:
        self._transports[transport.hostname] = transport

    def _lock(self, host: str) -> asyncio.Lock:
        if host not in self._locks:
            self._locks[host] = asyncio.Lock()
        return self._locks[host]

    async def request_transport(self, hostname: str = "local") -> Transport:
        """Wait for the safe interval, open (or reuse) the connection."""
        self.stats["requests"] += 1
        transport = self._transports.get(hostname)
        if transport is None:
            transport = LocalTransport(hostname)
            self._transports[hostname] = transport
        async with self._lock(hostname):
            if transport.is_open:
                return transport
            now = time.monotonic()
            last = self._last_open.get(hostname, -1e9)
            wait = self.safe_interval - (now - last)
            if wait > 0:
                await asyncio.sleep(wait)
            await transport.open()
            self._last_open[hostname] = time.monotonic()
            self.stats["opens"] += 1
            return transport

    async def close_all(self) -> None:
        for t in self._transports.values():
            if t.is_open:
                await t.close()
