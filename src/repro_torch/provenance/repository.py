"""Content-addressed blob repository (AiiDA 1.0 §file repository).

The provenance split the paper's criterion (v) relies on: the relational
database holds the graph (nodes, links, states — small rows, indexed,
queryable) while bulk content (array payloads, retrieved files) lives in a
flat content-addressed object store next to the database file. Rows stay
small, so graph queries never drag megabytes of base64 text through the
sqlite row cache, and identical content is stored exactly once — a blob is
keyed by the sha256 of its bytes, which makes deduplication (cache clones,
archive re-imports) automatic.

Layout on disk, for a profile at ``profile.db``::

    profile.db.repo/
        ab/ab12cd…ef      # blob whose sha256 starts with ab12…

Writes are atomic (temp file + rename into place) so concurrent daemon
workers can put the same blob without coordination: the digest *is* the
name, so last-writer-wins is byte-identical to first-writer-wins.

In-memory profiles (``:memory:``) get a dict-backed repository with the
same interface.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import threading
from typing import Iterator

from repro_torch.observability import metrics as _metrics
from repro_torch.observability import trace


class BlobNotFound(KeyError):
    """No blob with the requested digest in this repository."""


class BlobRepository:
    """sha256-keyed blob store; ``root=None`` keeps blobs in memory."""

    def __init__(self, root: str | None):
        self.root = root
        self._mem: dict[str, bytes] | None = None if root else {}
        self._lock = threading.Lock()
        if root:
            os.makedirs(root, exist_ok=True)

    # -- key layout ---------------------------------------------------------
    def _path(self, digest: str) -> str:
        assert self.root is not None
        return os.path.join(self.root, digest[:2], digest)

    @staticmethod
    def digest_of(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()

    # -- primitives ---------------------------------------------------------
    def put(self, data: bytes) -> str:
        """Store ``data``; returns its sha256 digest. Idempotent — putting
        bytes that are already present is a no-op (content addressing)."""
        digest = self.digest_of(data)
        _metrics.get_registry().counter("repository.puts").inc()
        if self._mem is not None:
            with self._lock:
                self._mem.setdefault(digest, bytes(data))
            return digest
        path = self._path(digest)
        if os.path.exists(path):
            return digest
        with trace.span("repo.put", size=len(data)):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                       prefix=".tmp-")
            try:
                with os.fdopen(fd, "wb") as fh:
                    fh.write(data)
                os.replace(tmp, path)  # atomic even with concurrent writers
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        return digest

    def get(self, digest: str) -> bytes:
        _metrics.get_registry().counter("repository.gets").inc()
        if self._mem is not None:
            try:
                return self._mem[digest]
            except KeyError:
                raise BlobNotFound(digest) from None
        try:
            with trace.span("repo.get"), open(self._path(digest),
                                              "rb") as fh:
                return fh.read()
        except FileNotFoundError:
            raise BlobNotFound(digest) from None

    def delete(self, digest: str) -> bool:
        """Remove one blob (fsck blob GC). Returns True when it existed.
        Safe against concurrent putters: content addressing means a racing
        put of the same digest rewrites identical bytes."""
        if self._mem is not None:
            with self._lock:
                return self._mem.pop(digest, None) is not None
        try:
            os.unlink(self._path(digest))
            return True
        except FileNotFoundError:
            return False

    def has(self, digest: str) -> bool:
        if self._mem is not None:
            return digest in self._mem
        return os.path.exists(self._path(digest))

    # -- inventory ----------------------------------------------------------
    def digests(self) -> Iterator[str]:
        if self._mem is not None:
            yield from sorted(self._mem)
            return
        if not os.path.isdir(self.root):
            return
        for fan in sorted(os.listdir(self.root)):
            sub = os.path.join(self.root, fan)
            if not os.path.isdir(sub):
                continue
            for name in sorted(os.listdir(sub)):
                if not name.startswith(".tmp-"):
                    yield name

    def stats(self) -> dict:
        """Blob count and total bytes (repository health / CLI stats)."""
        count = 0
        total = 0
        if self._mem is not None:
            return {"blobs": len(self._mem),
                    "bytes": sum(len(v) for v in self._mem.values())}
        for digest in self.digests():
            count += 1
            try:
                total += os.path.getsize(self._path(digest))
            except OSError:
                pass
        return {"blobs": count, "bytes": total}
