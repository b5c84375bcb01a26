"""Job manager (paper §II.B.4.c): bundles scheduler status queries.

Instead of each CalcJob polling the scheduler, jobs register an update
request; when a transport becomes available the manager issues ONE query
for all registered job ids and fans the answers back out. Combined with the
transport queue this keeps the scheduler load O(1) in the number of
concurrent jobs.
"""

from __future__ import annotations

import asyncio
from typing import Any

from repro_torch.engine.transport import TransportQueue


class JobManager:
    def __init__(self, transport_queue: TransportQueue, scheduler,
                 hostname: str = "local", flush_interval: float = 0.05):
        self.transport_queue = transport_queue
        self.scheduler = scheduler
        self.hostname = hostname
        self.flush_interval = flush_interval
        self._requests: dict[str, list[asyncio.Future]] = {}
        self._flusher: asyncio.Task | None = None
        self.stats = {"requests": 0, "queries": 0}

    def request_job_state(self, job_id: str) -> asyncio.Future:
        """Register interest in a job's state; resolved at the next flush."""
        self.stats["requests"] += 1
        fut = asyncio.get_event_loop().create_future()
        self._requests.setdefault(job_id, []).append(fut)
        if self._flusher is None or self._flusher.done():
            self._flusher = asyncio.ensure_future(self._flush())
        return fut

    async def _flush(self) -> None:
        await asyncio.sleep(self.flush_interval)   # let requests bundle up
        if not self._requests:
            return
        pending, self._requests = self._requests, {}
        transport = await self.transport_queue.request_transport(self.hostname)
        self.stats["queries"] += 1
        try:
            states = await self.scheduler.query_jobs(
                transport, list(pending.keys()))
        except Exception as exc:  # noqa: BLE001 — fan the failure out
            for futs in pending.values():
                for f in futs:
                    if not f.done():
                        f.set_exception(exc)
            return
        for job_id, futs in pending.items():
            state = states.get(job_id, "UNDETERMINED")
            for f in futs:
                if not f.done():
                    f.set_result(state)
