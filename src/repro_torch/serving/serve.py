"""Serving steps and the continuous-batching request scheduler.

Counterpart of ``repro.serving.serve``, with the same behaviour:

* **admission** — FIFO queue; a free slot triggers a one-row prefill of
  the request's exact prompt (no padding, so the first sampled token is
  taken at the true last prompt position) whose KV rows are copied into
  the slot's row of the shared batch cache;
* **per-slot positions** — every decode step runs over the whole batch
  with a ``(B,)`` position vector, so co-batched requests at different
  depths need no padding; with ``decode_impl='pallas'`` the ragged depths
  are the decode kernel's per-row lengths;
* **eviction** — EOS, ``max_new_tokens`` or cache exhaustion frees the
  slot for the next queued request mid-flight;
* **metrics** — per-request latency and token counts land in the
  process-wide registry (``serving.*``).

Greedy decoding throughout. The host reads the device once per prefill
(the first token) and once per decode step (the ``(B,)`` next tokens).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.common import (cast_for_compute, resolve_device,
                                       shard, whole)
from repro_torch.models.registry import LM_FAMILIES, ModelBundle
from repro_torch.observability.metrics import get_registry


def _greedy(cfg, logits: torch.Tensor) -> torch.Tensor:
    """(B, 1) int32 argmax of the last position's logits over the real
    vocabulary. Under a mesh the logits are a DTensor and the tokens come
    back whole on every rank."""
    last = shard(logits[:, -1, :cfg.vocab_size], "batch", None)
    return whole(torch.argmax(last, dim=-1)).to(torch.int32)[:, None]


def make_prefill_step(bundle: ModelBundle) -> Callable:
    """The prefill step ``(params, batch, cache) -> (tokens, cache)``. Run
    it under :class:`~repro_torch.models.common.axis_rules` with the
    parameters and cache placed by
    :func:`~repro_torch.distributed.sharding.distribute_tree` to serve on
    a mesh."""
    @torch.no_grad()
    def prefill_step(params, batch, cache):
        logits, cache = bundle.prefill_fn(params, batch, cache)
        return _greedy(bundle.cfg, logits), cache

    return prefill_step


def make_decode_step(bundle: ModelBundle) -> Callable:
    """The decode step ``(params, cache, tokens, pos) -> (tokens, cache)``,
    on one device or, as :func:`make_prefill_step`, on a mesh."""
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, cache = bundle.decode_fn(params, cache, tokens, pos)
        return _greedy(bundle.cfg, logits), cache

    return serve_step


# ---------------------------------------------------------------------------
# Continuous-batching scheduler (host-side control, one batched decode step)
# ---------------------------------------------------------------------------

class QueueFullError(RuntimeError):
    """submit() rejected: the admission queue is at ``max_pending``."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str = ""           # 'eos' | 'length' | 'cache_full'
    submitted_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0


class BatchScheduler:
    """Slot-based continuous batching with per-slot decode positions.

    ``batch_size`` fixes the decode micro-batch; requests beyond it wait
    in the FIFO queue and are admitted the moment a slot is evicted.
    ``max_len`` bounds prompt + generation per slot. Runs on ``device``
    (the card when None); ``params`` are moved there and the weights cast
    once to the activation dtype.
    """

    def __init__(self, bundle: ModelBundle, params: Any, batch_size: int,
                 max_len: int, eos_id: int = -1,
                 max_pending: int | None = None,
                 device: str | torch.device | None = None):
        if bundle.cfg.family not in LM_FAMILIES:
            raise ValueError(
                f"BatchScheduler drives KV-cache LM families {LM_FAMILIES}, "
                f"not {bundle.cfg.family!r} (recurrent families have no "
                f"per-slot cache rows to splice)")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.device = resolve_device(device)
        self.bundle = bundle
        self.params = cast_for_compute(params, bundle.cfg.activation_dtype,
                                       self.device)
        self.batch_size = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        #: admission bound: submissions beyond batch occupancy + this many
        #: queued requests are rejected (backpressure to the caller)
        self.max_pending = max_pending
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * batch_size
        self.decode_step = make_decode_step(bundle)
        self.prefill_step = make_prefill_step(bundle)
        self.cache = bundle.init_cache(batch_size, max_len, self.device)
        # host-side control state: last token + cache depth per slot. Empty
        # slots keep a frozen pos <= max_len - 1 (a slot is evicted once its
        # pos reaches max_len - 1); their rows are never read, and admission
        # overwrites the whole row before re-activating one.
        self.tokens = np.zeros((batch_size, 1), np.int32)
        self.pos = np.zeros(batch_size, np.int32)
        reg = get_registry()
        self._m_submitted = reg.counter("serving.requests_submitted")
        self._m_completed = reg.counter("serving.requests_completed")
        self._m_evicted = reg.counter("serving.slot_evictions")
        self._m_decode_steps = reg.counter("serving.decode_steps")
        self._m_prefill_tokens = reg.counter("serving.prefill_tokens")
        self._m_tokens = reg.counter("serving.tokens_generated")
        self._g_active = reg.gauge("serving.slots_active")
        self._g_queue = reg.gauge("serving.queue_depth")
        self._h_latency = reg.histogram("serving.request_seconds")
        self._m_rejected = reg.counter("serving.rejected")

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.max_len:
            raise ValueError(f"prompt of {len(req.prompt)} tokens cannot fit "
                             f"a max_len={self.max_len} cache")
        if (self.max_pending is not None
                and len(self.queue) >= self.max_pending):
            self._m_rejected.inc()
            raise QueueFullError(
                f"admission queue full: {len(self.queue)} pending "
                f"(max_pending={self.max_pending}); retry after the batch "
                "drains or raise max_pending")
        req.submitted_at = time.monotonic()
        self.queue.append(req)
        self._m_submitted.inc()
        self._g_queue.set(len(self.queue))

    def _prefill_into_slot(self, req: Request, slot: int) -> None:
        req.started_at = time.monotonic()
        prompt = torch.tensor([req.prompt], dtype=torch.int64,
                              device=self.device)
        row_cache = self.bundle.init_cache(1, self.max_len, self.device)
        first_tok, row_cache = self.prefill_step(
            self.params, {"tokens": prompt}, row_cache)
        # Splice the row into the batch cache in place (the reference does
        # a donated dynamic_update_slice).
        for name, full in self.cache.items():
            full[:, slot].copy_(row_cache[name][:, 0])
        self.slots[slot] = req
        self.pos[slot] = len(req.prompt)
        tok = int(first_tok[0, 0])
        self.tokens[slot, 0] = tok
        req.generated = [tok]
        self._m_prefill_tokens.inc(len(req.prompt))
        self._m_tokens.inc()

    def _admit(self) -> list[Request]:
        """Fill free slots from the queue; returns requests that finished
        at admission (single-token generations)."""
        finished = []
        for i in range(self.batch_size):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            self._prefill_into_slot(req, i)
            if self._maybe_finish(i):
                finished.append(req)
        self._g_queue.set(len(self.queue))
        self._g_active.set(sum(s is not None for s in self.slots))
        return finished

    # -- eviction ------------------------------------------------------------
    def _maybe_finish(self, slot: int) -> bool:
        req = self.slots[slot]
        if req.generated and req.generated[-1] == self.eos_id:
            req.finish_reason = "eos"
        elif len(req.generated) >= req.max_new_tokens:
            req.finish_reason = "length"
        elif int(self.pos[slot]) >= self.max_len - 1:
            req.finish_reason = "cache_full"
        else:
            return False
        req.done = True
        req.finished_at = time.monotonic()
        self.slots[slot] = None
        self._m_completed.inc()
        self._m_evicted.inc()
        self._h_latency.observe(req.finished_at - req.submitted_at)
        return True

    # -- the decode loop -----------------------------------------------------
    def step(self) -> list[Request]:
        """Admit waiting requests, then run ONE decode step across all
        active slots; returns the requests that finished this step."""
        finished = self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            self._g_active.set(0)
            return finished
        next_tok, self.cache = self.decode_step(
            self.params, self.cache,
            torch.from_numpy(self.tokens).to(self.device, torch.int64),
            torch.from_numpy(self.pos).to(self.device))
        self._m_decode_steps.inc()
        next_host = next_tok[:, 0].cpu().numpy()        # one copy per step
        for i in active:
            req = self.slots[i]
            req.generated.append(int(next_host[i]))
            self.pos[i] += 1
            self.tokens[i, 0] = int(next_host[i])
            self._m_tokens.inc()
            if self._maybe_finish(i):
                finished.append(req)
        self._g_active.set(sum(s is not None for s in self.slots))
        return finished

    def run(self) -> list[Request]:
        """Drain queue + slots to completion; finished in completion order."""
        finished: list[Request] = []
        while self.queue or any(s is not None for s in self.slots):
            finished.extend(self.step())
        return finished
