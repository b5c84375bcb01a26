"""Deterministic content hashes for process inputs.

The fingerprint of a process is a sha256 over a canonical JSON document
combining:

* the process type name,
* a per-class version salt (``Process.CACHE_VERSION``; process functions
  additionally salt with a digest of their source code, so editing the
  function body invalidates its old cache entries),
* the db-storable inputs, each reduced to a content digest.

``DataValue`` payloads hash by content, not identity: arrays digest their
dtype + shape + raw bytes (so two equal arrays stored separately collide,
as they should), folders digest their sorted (name, bytes) pairs, and
scalar types digest their canonical JSON payload. ``non_db`` ports and the
``metadata`` namespace are excluded — they describe *how* to run, not
*what* is computed — as are ports declared with ``exclude_from_hash=True``
(tolerances/thresholds that are stored in provenance but do not affect the
result).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Mapping

import numpy as _np

from repro_torch.core.datatypes import ArrayData, DataValue, FolderData
from repro_torch.core.ports import PortNamespace
from repro_torch.observability import trace


def _sha256(*chunks: bytes) -> str:
    h = hashlib.sha256()
    for chunk in chunks:
        h.update(chunk)
    return h.hexdigest()


def _canonical_json(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=repr).encode()


def hash_data_value(value: DataValue) -> str:
    """Content digest of a single DataValue (stable across store/reload)."""
    type_tag = f"{value._TYPE}:".encode()
    if isinstance(value, ArrayData):
        arr = _np.ascontiguousarray(value.value)
        header = f"{arr.dtype.str}|{arr.shape}|".encode()
        return _sha256(type_tag, header, arr.tobytes())
    if isinstance(value, FolderData):
        parts = [type_tag]
        for name in value.names():
            data = value.get_bytes(name)
            parts.append(name.encode() + b"\0" +
                         hashlib.sha256(data).digest())
        return _sha256(*parts)
    return _sha256(type_tag, _canonical_json(value.to_payload()))


def _canonicalize(ns: PortNamespace | None, values: Mapping[str, Any],
                  skip_metadata: bool = False) -> dict[str, Any]:
    """Reduce an input mapping to a JSON-safe tree of content digests,
    mirroring the traversal _link_inputs uses for provenance links."""
    out: dict[str, Any] = {}
    for key, value in values.items():
        if skip_metadata and key == "metadata":
            continue  # only the *top-level* metadata namespace is excluded
        port = ns.get(key) if ns is not None else None
        if port is not None and port.non_db:
            continue
        if port is not None and getattr(port, "exclude_from_hash", False):
            # declared as not affecting the result (tolerance/threshold):
            # stored and linked in provenance, but not fingerprinted
            continue
        if isinstance(port, PortNamespace) and isinstance(value, Mapping) \
                and not isinstance(value, DataValue):
            sub = _canonicalize(port, value)
            if sub:
                out[key] = {"__ns__": sub}
            continue
        if isinstance(value, DataValue):
            out[key] = {"__data__": hash_data_value(value)}
        elif isinstance(value, Mapping):
            out[key] = {"__ns__": _canonicalize(None, value)}
        elif isinstance(value, (str, int, float, bool, type(None))):
            out[key] = {"__raw__": value}
        else:
            out[key] = {"__repr__": repr(value)}
    return out


def compute_input_hash(process_cls: type, inputs: Mapping[str, Any],
                       ns: PortNamespace | None = None) -> str:
    """The canonical input fingerprint for one process invocation."""
    with trace.span("cache.hash"):
        if ns is None:
            ns = process_cls.spec().inputs
        document = {
            # fully qualified, so same-named classes in different modules
            # cannot serve each other's outputs
            "process_type": f"{process_cls.__module__}:"
                            f"{process_cls.__qualname__}",
            "salt": str(_cache_salt(process_cls)),
            "inputs": _canonicalize(ns, inputs, skip_metadata=True),
        }
        return _sha256(b"repro-cache-v1:", _canonical_json(document))


def _cache_salt(process_cls: type) -> str:
    salt = getattr(process_cls, "CACHE_VERSION", 1)
    extra = getattr(process_cls, "_cache_extra_salt", "")
    return f"{salt}|{extra}"


def source_salt(fn) -> str:
    """Digest of a function's source, used to salt process-function
    hashes — editing the body invalidates old cache entries."""
    import inspect

    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError):
        return ""
    return hashlib.sha256(src.encode()).hexdigest()[:16]
