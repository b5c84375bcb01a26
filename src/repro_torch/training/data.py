"""Deterministic, checkpointable data pipeline.

Production shape: host-sharded iteration (each data-parallel host consumes
a disjoint stream), exact resume from a serialized cursor, fixed-length
packing of variable-length documents. The token source is synthetic
(seeded Zipf mixture) or a binary token file — the paper's engine treats
it opaquely either way, and provenance records the pipeline state so any
batch can be regenerated.

A copy of ``repro.training.data`` (numpy only): the port keeps its own so
that it never imports ``repro``, and its batches equal the reference's
for the same seed.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int            # per-host batch
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    source: str = "synthetic"  # synthetic | file
    path: str = ""
    mean_doc_len: int = 200


class TokenStream:
    """Document generator -> packed fixed-length rows with EOD tokens."""

    EOD = 0

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._doc_index = cfg.host_id          # strided host sharding
        self._buffer: list[int] = []
        self._file_tokens: np.ndarray | None = None
        if cfg.source == "file":
            self._file_tokens = np.fromfile(cfg.path, dtype=np.uint16)

    # -- cursor (exact resume) -------------------------------------------------
    def state_dict(self) -> dict:
        return {"doc_index": self._doc_index, "buffer": list(self._buffer)}

    def load_state_dict(self, state: dict) -> None:
        self._doc_index = state["doc_index"]
        self._buffer = list(state["buffer"])

    # -- document source --------------------------------------------------------
    def _doc(self, index: int) -> np.ndarray:
        cfg = self.cfg
        if self._file_tokens is not None:
            n = len(self._file_tokens)
            rng = np.random.default_rng((cfg.seed, index))
            start = int(rng.integers(0, max(1, n - cfg.mean_doc_len)))
            length = int(rng.integers(cfg.mean_doc_len // 2,
                                      cfg.mean_doc_len * 2))
            return self._file_tokens[start:start + length].astype(np.int32)
        rng = np.random.default_rng((cfg.seed, index))
        length = int(rng.integers(cfg.mean_doc_len // 2,
                                  cfg.mean_doc_len * 2))
        # zipf-ish marginal over the vocab, documents correlated by topic
        topic = rng.integers(1, 17)
        toks = (rng.zipf(1.3, size=length) * topic) % (cfg.vocab_size - 1) + 1
        return toks.astype(np.int32)

    def _fill(self, n: int) -> None:
        while len(self._buffer) < n:
            doc = self._doc(self._doc_index)
            self._doc_index += self.cfg.num_hosts
            self._buffer.extend(doc.tolist())
            self._buffer.append(self.EOD)

    def next_batch(self) -> dict[str, np.ndarray]:
        cfg = self.cfg
        need = cfg.batch_size * (cfg.seq_len + 1)
        self._fill(need)
        flat = np.asarray(self._buffer[:need], np.int32)
        self._buffer = self._buffer[need:]
        rows = flat.reshape(cfg.batch_size, cfg.seq_len + 1)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


def serialize_state(stream: TokenStream) -> str:
    return json.dumps(stream.state_dict())


def deserialize_state(stream: TokenStream, payload: str) -> None:
    stream.load_state_dict(json.loads(payload))
