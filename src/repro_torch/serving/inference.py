"""Provenance-tracked LM generation as a first-class engine workload.

:func:`generate` is a calcfunction: every generation is a process node
whose inputs (architecture, parameter seed, prompt tokens, decode
settings) are content-fingerprinted by the caching layer exactly like
any other calculation. Greedy decoding makes the mapping
``(arch, seed, prompt, settings) -> continuation`` a pure function, so
with caching enabled an identical prompt is served from the provenance
graph with **zero decode steps** — the cache-hit fast path clones the
stored ``tokens``/``stats`` outputs without touching the model.

The execution side is a per-OS-process :class:`ServingEngine` memo: one
:class:`~repro_torch.serving.serve.BatchScheduler` and its parameters per
(arch, seed, cache size, device) that cold prompts are batched through.
The reduced demo config decodes through the decode-attention kernel
(``decode_impl='pallas'``; its plain version on the CPU).

``generate`` runs on the card. Its inputs name no device — a device
input would change its fingerprint and its signature — so a caller who
wants the CPU says so around the call: ``with on_device("cpu"):
generate(...)``. Without that, and without a card, it raises.
"""

from __future__ import annotations

import contextlib
import hashlib
import time
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.core.datatypes import ArrayData, Dict, Int, Str
from repro_torch.core.process_functions import calcfunction
from repro_torch.models.common import resolve_device
from repro_torch.models.registry import build
from repro_torch.serving.serve import BatchScheduler, Request

#: serving defaults for the reduced demo model
DEFAULT_ARCH = "aiida-demo-110m"
DEFAULT_BATCH_SIZE = 4
_MIN_CACHE = 128

_ENGINES: dict[tuple, "ServingEngine"] = {}

#: the device :func:`generate` runs on (None: the card); set it with
#: :func:`on_device`. A module global, not a contextvar: the runner's event
#: loop may run the process in a task created outside the block.
_DEVICE: str | torch.device | None = None


def _serving_config(arch: str, decode_impl: str):
    cfg = reduced_config(arch)
    return cfg.replace(decode_impl=decode_impl)


@contextlib.contextmanager
def on_device(device: str | torch.device | None) -> Iterator[None]:
    """Run :func:`generate` on ``device`` inside the block (``"cpu"`` where
    there is no card). The device enters neither the fingerprint nor the
    stored inputs or stats."""
    global _DEVICE
    prev, _DEVICE = _DEVICE, device
    try:
        yield
    finally:
        _DEVICE = prev


class ServingEngine:
    """One scheduler + params, reused across calls."""

    def __init__(self, arch: str, seed: int, max_len: int,
                 batch_size: int = DEFAULT_BATCH_SIZE,
                 eos_id: int = -1, decode_impl: str = "pallas",
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.arch, self.seed = arch, int(seed)
        self.cfg = _serving_config(arch, decode_impl)
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


@calcfunction
def generate(arch: Str, prompt: ArrayData, max_new_tokens: Int,
             seed: Int, eos_id: Int):
    """Greedy continuation of ``prompt`` under the (reduced) ``arch`` model
    with parameters drawn from ``seed``. Returns the generated tokens plus
    a stats document; both are provenance outputs, so identical calls are
    cache hits that never re-decode."""
    toks = [int(t) for t in np.asarray(prompt.value).reshape(-1)]
    new = int(max_new_tokens.value)
    eng = get_engine(str(arch.value), int(seed.value),
                     need_len=len(toks) + new, eos_id=int(eos_id.value),
                     device=_DEVICE)
    t0 = time.monotonic()
    req = eng.generate_many([toks], new)[0]
    dt = time.monotonic() - t0
    return {
        "tokens": ArrayData(np.asarray(req.generated, np.int32)),
        "stats": Dict({
            "prompt_tokens": len(toks),
            "new_tokens": len(req.generated),
            "finish_reason": req.finish_reason,
            "fingerprint": prompt_fingerprint(str(arch.value),
                                              int(seed.value), toks),
            "wall_seconds": dt,
        }),
    }
