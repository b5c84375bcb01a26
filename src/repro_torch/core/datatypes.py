"""Database-storable value types (the paper's ``Int(3)``, ``Float`` etc.).

Every input/output that should enter the provenance graph must be a
``DataValue`` — the analogue of AiiDA's Data nodes. Values serialize to
JSON (+ raw array bytes for tensors) so the sqlite provenance store can
persist and rehydrate them. ``non_db`` ports bypass this requirement
(paper §II.A.1).

A ``torch.Tensor`` is stored as the numpy array of its host copy, with
its dtype kept, so an int32 tensor hashes like the equal int32 array.
``torch`` is only looked up if the caller already imported it."""

from __future__ import annotations

import base64
import io
import sys
from typing import Any

import numpy as _np


class DataValue:
    """Base class for storable values. Subclasses wrap a python payload."""

    _TYPE = "data"

    def __init__(self, value: Any = None):
        self._value = value
        self.uuid: str | None = None      # set once stored
        self.pk: int | None = None

    @property
    def value(self):
        return self._value

    @property
    def is_stored(self) -> bool:
        return self.pk is not None

    # -- serialization ---------------------------------------------------------
    def to_payload(self) -> dict:
        return {"type": self._TYPE, "value": self._value}

    @classmethod
    def from_payload(cls, payload: dict) -> "DataValue":
        t = payload.get("type", "data")
        klass = _TYPE_MAP.get(t, DataValue)
        return klass._from_payload(payload)

    @classmethod
    def _from_payload(cls, payload: dict) -> "DataValue":
        return cls(payload.get("value"))

    # -- conveniences -----------------------------------------------------------
    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._value!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, DataValue):
            return self._value == other._value
        return self._value == other

    def __hash__(self):
        try:
            return hash((type(self).__name__, self._value))
        except TypeError:
            return id(self)


class Int(DataValue):
    _TYPE = "int"

    def __init__(self, value: int = 0):
        super().__init__(int(value))

    def __int__(self):
        return self._value

    def __add__(self, other):
        return Int(self._value + int(other))

    def __mul__(self, other):
        return Int(self._value * int(other))


class Float(DataValue):
    _TYPE = "float"

    def __init__(self, value: float = 0.0):
        super().__init__(float(value))

    def __float__(self):
        return self._value

    def __add__(self, other):
        return Float(self._value + float(other))

    def __mul__(self, other):
        return Float(self._value * float(other))


class Bool(DataValue):
    _TYPE = "bool"

    def __init__(self, value: bool = False):
        super().__init__(bool(value))

    def __bool__(self):
        return self._value


class Str(DataValue):
    _TYPE = "str"

    def __init__(self, value: str = ""):
        super().__init__(str(value))

    def __str__(self):
        return self._value


class Dict(DataValue):
    _TYPE = "dict"

    def __init__(self, value: dict | None = None):
        super().__init__(dict(value or {}))

    def __getitem__(self, k):
        return self._value[k]

    def get(self, k, default=None):
        return self._value.get(k, default)

    def keys(self):
        return self._value.keys()

    def items(self):
        return self._value.items()


class List(DataValue):
    _TYPE = "list"

    def __init__(self, value: list | None = None):
        super().__init__(list(value or []))

    def __getitem__(self, i):
        return self._value[i]

    def __len__(self):
        return len(self._value)

    def __iter__(self):
        return iter(self._value)


def _torch_tensor_type():
    torch = sys.modules.get("torch")
    return None if torch is None else torch.Tensor


def _tensor_to_numpy(t) -> _np.ndarray:
    """Host copy of a tensor as numpy, in the tensor's own dtype. A dtype
    numpy has no plain counterpart for (bfloat16, the float8 types)
    raises rather than being widened behind the caller's back."""
    try:
        return t.detach().cpu().numpy()
    except (TypeError, RuntimeError) as exc:
        raise TypeError(
            f"cannot store a {t.dtype} tensor: numpy has no {t.dtype} "
            "dtype; cast it first (e.g. t.float())") from exc


class ArrayData(DataValue):
    """Numpy array (or tensor) payload, persisted as base64 .npy bytes."""

    _TYPE = "array"

    def __init__(self, value):
        tensor = _torch_tensor_type()
        if tensor is not None and isinstance(value, tensor):
            value = _tensor_to_numpy(value)
        arr = _np.asarray(value)
        super().__init__(arr)

    def to_payload(self) -> dict:
        buf = io.BytesIO()
        _np.save(buf, self._value, allow_pickle=False)
        return {"type": self._TYPE,
                "npy_b64": base64.b64encode(buf.getvalue()).decode()}

    @classmethod
    def _from_payload(cls, payload: dict) -> "ArrayData":
        raw = base64.b64decode(payload["npy_b64"])
        return cls(_np.load(io.BytesIO(raw), allow_pickle=False))

    def __eq__(self, other):
        o = other._value if isinstance(other, DataValue) else other
        try:
            return bool(_np.array_equal(self._value, o))
        except Exception:  # noqa: BLE001
            return False

    def __hash__(self):
        return id(self)


class FolderData(DataValue):
    """A named set of file payloads (the CalcJob retrieve target)."""

    _TYPE = "folder"

    def __init__(self, files: dict[str, bytes] | None = None):
        super().__init__({k: bytes(v) for k, v in (files or {}).items()})

    def to_payload(self) -> dict:
        return {"type": self._TYPE,
                "files": {k: base64.b64encode(v).decode()
                          for k, v in self._value.items()}}

    @classmethod
    def _from_payload(cls, payload: dict) -> "FolderData":
        return cls({k: base64.b64decode(v)
                    for k, v in payload.get("files", {}).items()})

    def get_bytes(self, name: str) -> bytes:
        return self._value[name]

    def names(self) -> list[str]:
        return sorted(self._value)

    def __hash__(self):
        return id(self)


_TYPE_MAP = {c._TYPE: c for c in
             (DataValue, Int, Float, Bool, Str, Dict, List, ArrayData,
              FolderData)}


def to_data_value(obj: Any) -> DataValue:
    """Coerce a raw python object into a storable DataValue."""
    if isinstance(obj, DataValue):
        return obj
    if isinstance(obj, bool):
        return Bool(obj)
    if isinstance(obj, int):
        return Int(obj)
    if isinstance(obj, float):
        return Float(obj)
    if isinstance(obj, str):
        return Str(obj)
    if isinstance(obj, dict):
        return Dict(obj)
    if isinstance(obj, (list, tuple)):
        return List(list(obj))
    tensor = _torch_tensor_type()
    if isinstance(obj, _np.ndarray) or (
            tensor is not None and isinstance(obj, tensor)):
        return ArrayData(obj)
    raise TypeError(f"cannot convert {type(obj).__name__} to a storable "
                    "DataValue; wrap it or mark the port non_db")
