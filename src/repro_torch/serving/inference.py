"""Memoised serving engines.

Counterpart of ``repro.serving.inference`` without its ``generate``
calcfunction, which needs the engine, store and caching layers; the port
gets its own copy of those in a later slice. :class:`ServingEngine` holds
one :class:`~repro_torch.serving.serve.BatchScheduler` and its parameters
per (arch, seed, cache size, device) for cold prompts to be batched
through; :func:`prompt_fingerprint` is the key such a cache would use.
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.models.common import resolve_device
from repro_torch.models.registry import build
from repro_torch.serving.serve import BatchScheduler, Request

#: serving defaults for the reduced demo model
DEFAULT_ARCH = "aiida-demo-110m"
DEFAULT_BATCH_SIZE = 4
_MIN_CACHE = 128

_ENGINES: dict[tuple, "ServingEngine"] = {}


class ServingEngine:
    """One scheduler + params, reused across calls."""

    def __init__(self, arch: str, seed: int, max_len: int,
                 batch_size: int = DEFAULT_BATCH_SIZE,
                 eos_id: int = -1, decode_impl: str = "pallas",
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.arch, self.seed = arch, int(seed)
        self.cfg = reduced_config(arch).replace(decode_impl=decode_impl)
        self.bundle = build(self.cfg)
        self.params = self.bundle.init_params(int(seed), self.device)
        self.scheduler = BatchScheduler(self.bundle, self.params,
                                        batch_size=batch_size,
                                        max_len=max_len, eos_id=eos_id,
                                        device=self.device)
        self._next_rid = 0

    def generate_many(self, prompts: list[list[int]],
                      max_new_tokens: int) -> list[Request]:
        """Continuous-batch a whole prompt list; results in request order."""
        reqs = []
        for p in prompts:
            req = Request(rid=self._next_rid, prompt=list(map(int, p)),
                          max_new_tokens=int(max_new_tokens))
            self._next_rid += 1
            self.scheduler.submit(req)
            reqs.append(req)
        self.scheduler.run()
        return reqs

    def generate_one(self, prompt: list[int], max_new_tokens: int) -> Request:
        return self.generate_many([prompt], max_new_tokens)[0]


def get_engine(arch: str = DEFAULT_ARCH, seed: int = 0, *,
               need_len: int = _MIN_CACHE, batch_size: int = DEFAULT_BATCH_SIZE,
               eos_id: int = -1, decode_impl: str = "pallas",
               device: str | torch.device | None = None) -> ServingEngine:
    """Memoised engine; ``need_len`` is bucketed to a power of two so one
    cache serves a band of request sizes."""
    dev = resolve_device(device)
    max_len = _MIN_CACHE
    while max_len < int(need_len) + 1:
        max_len *= 2
    key = (arch, int(seed), max_len, batch_size, eos_id, decode_impl, str(dev))
    eng = _ENGINES.get(key)
    if eng is None:
        eng = _ENGINES[key] = ServingEngine(
            arch, seed, max_len, batch_size=batch_size, eos_id=eos_id,
            decode_impl=decode_impl, device=dev)
    return eng


def reset_engines() -> None:
    """Drop the engine memo (test isolation)."""
    _ENGINES.clear()


def prompt_fingerprint(arch: str, seed: int, prompt: Any) -> str:
    """sha256 over the model identity and the exact prompt token sequence.
    Two requests with the same fingerprint get the same continuation
    (greedy decoding)."""
    toks = np.asarray(prompt, np.int32)
    h = hashlib.sha256()
    h.update(f"{arch}|{int(seed)}|".encode())
    h.update(toks.tobytes())
    return h.hexdigest()
