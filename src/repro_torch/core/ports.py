"""Ports and port namespaces (paper §II.A.1).

``Port`` carries valid_type / validator / default / required / non_db /
serializer; ``PortNamespace`` is a Mapping subclass of Port, so namespaces
nest. A namespace validates iff all nested ports and itself validate.
``dynamic`` namespaces accept undeclared keys (used by exposed/dynamic
workchain inputs, §II.B.3).

Two sentinels matter here: ``_NO_DEFAULT`` (the port declares no default)
and ``UNSPECIFIED`` (the caller did not provide a value). The latter keeps
an *explicitly passed* ``None`` distinguishable from an absent key — a
required port reports "was not provided" only when the key is truly
missing, and optional typed ports reject an explicit ``None`` instead of
silently accepting it.

A port declared with ``serializer=`` (e.g. ``valid_type=Int,
serializer=Int``) transparently wraps raw Python values that are not
already of the valid type, so ``builder.n = 3`` and ``run(P, n=3)`` store
a provenance-complete ``Int(3)`` without caller boilerplate (the AiiDA 1.0
port-serializer contract).
"""

from __future__ import annotations

import copy
from collections.abc import Mapping, MutableMapping
from typing import Any, Callable

class _Sentinel:
    """A singleton marker that survives copy/deepcopy with identity
    intact — ports are deep-copied on ``absorb`` and an ``is``-compared
    sentinel must not be duplicated in the copy."""

    _instances: dict[str, "_Sentinel"] = {}

    def __new__(cls, tag: str):
        if tag not in cls._instances:
            self = super().__new__(cls)
            self._tag = tag
            cls._instances[tag] = self
        return cls._instances[tag]

    def __repr__(self) -> str:
        return self._tag

    def __bool__(self) -> bool:
        return False

    def __copy__(self) -> "_Sentinel":
        return self

    def __deepcopy__(self, memo) -> "_Sentinel":
        return self

    def __reduce__(self):
        return (_Sentinel, (self._tag,))


_NO_DEFAULT = _Sentinel("NO_DEFAULT")

#: the caller did not provide a value for this port (≠ an explicit None)
UNSPECIFIED = _Sentinel("UNSPECIFIED")

SEPARATOR = "."


class PortValidationError(ValueError):
    """Raised when a value fails port validation."""


class PortSerializationError(PortValidationError):
    """Raised when a port serializer cannot wrap a raw value."""


class Port:
    def __init__(self, name: str, *, valid_type: type | tuple[type, ...] | None = None,
                 validator: Callable[[Any], str | None] | None = None,
                 default: Any = _NO_DEFAULT, required: bool = True,
                 non_db: bool = False, exclude_from_hash: bool = False,
                 serializer: Callable[[Any], Any] | None = None,
                 help: str = ""):
        self.name = name
        if valid_type is not None and not isinstance(valid_type, tuple):
            valid_type = (valid_type,)
        self.valid_type = valid_type
        self.validator = validator
        self._default = default
        self.required = required and default is _NO_DEFAULT
        self.non_db = non_db
        # excluded from the caching input fingerprint (tolerances,
        # thresholds, … — inputs that do not change what is computed);
        # unlike non_db the value IS still stored and linked in provenance
        self.exclude_from_hash = exclude_from_hash
        self.serializer = serializer
        self.help = help

    # ------------------------------------------------------------------
    @property
    def has_default(self) -> bool:
        return self._default is not _NO_DEFAULT

    @property
    def default(self) -> Any:
        if not self.has_default:
            raise AttributeError(f"port {self.name!r} has no default")
        return self._default() if callable(self._default) else self._default

    def serialize(self, value: Any, breadcrumbs: str = "") -> Any:
        """Wrap a raw value through the port's serializer. Values already
        of the valid type (or with no serializer declared) pass through
        untouched; a serializer failure raises with the port path."""
        if (self.serializer is None or value is UNSPECIFIED
                or value is None):
            return value
        if self.valid_type is not None and isinstance(value, self.valid_type):
            return value
        path = (f"{breadcrumbs}{SEPARATOR}{self.name}"
                if breadcrumbs else self.name)
        try:
            return self.serializer(value)
        except Exception as exc:  # noqa: BLE001 — reported with the path
            raise PortSerializationError(
                f"port '{path}': could not serialize "
                f"{type(value).__name__} value {value!r}: {exc}") from exc

    def validate(self, value: Any, breadcrumbs: str = "") -> str | None:
        """Return an error string, or None when valid. ``UNSPECIFIED``
        means the key was absent; ``None`` means the caller explicitly
        passed None — the two produce different diagnostics."""
        path = f"{breadcrumbs}{SEPARATOR}{self.name}" if breadcrumbs else self.name
        if value is UNSPECIFIED:
            if self.required:
                return f"required port '{path}' was not provided"
            return None
        if value is None:
            if self.valid_type is not None and \
                    not any(t is type(None) for t in self.valid_type):
                types = tuple(t.__name__ for t in self.valid_type)
                prefix = "required " if self.required else ""
                return (f"{prefix}port '{path}' was explicitly passed None, "
                        f"which is not one of {types}")
            return None
        if self.valid_type is not None and not isinstance(value, self.valid_type):
            types = tuple(t.__name__ for t in self.valid_type)
            return (f"port '{path}': value of type "
                    f"{type(value).__name__} is not one of {types}")
        if self.validator is not None:
            err = self.validator(value)
            if err is not None:
                return f"port '{path}': {err}"
        return None

    def __repr__(self) -> str:
        extra = f", help={self.help!r}" if self.help else ""
        return (f"{type(self).__name__}({self.name!r}, "
                f"required={self.required}, non_db={self.non_db}{extra})")


class InputPort(Port):
    pass


class OutputPort(Port):
    pass


class PortNamespace(Port, MutableMapping):
    """A Port that is also a mapping of named sub-ports (nests freely)."""

    def __init__(self, name: str = "", *, dynamic: bool = False,
                 required: bool = False, non_db: bool = False,
                 exclude_from_hash: bool = False,
                 valid_type: Any = None, validator: Any = None,
                 default: Any = _NO_DEFAULT, help: str = ""):
        super().__init__(name, valid_type=valid_type, validator=validator,
                         default=default, required=required, non_db=non_db,
                         exclude_from_hash=exclude_from_hash, help=help)
        self.dynamic = dynamic
        self._ports: dict[str, Port] = {}

    # -- mapping protocol ----------------------------------------------------
    def __getitem__(self, key: str) -> Port:
        head, _, tail = key.partition(SEPARATOR)
        port = self._ports[head]
        if tail:
            if not isinstance(port, PortNamespace):
                raise KeyError(key)
            return port[tail]
        return port

    def __setitem__(self, key: str, port: Port) -> None:
        head, _, tail = key.partition(SEPARATOR)
        if tail:
            ns = self._ports.setdefault(head, PortNamespace(head))
            if not isinstance(ns, PortNamespace):
                raise KeyError(f"{head!r} exists and is not a namespace")
            ns[tail] = port
        else:
            self._ports[head] = port

    def __delitem__(self, key: str) -> None:
        del self._ports[key]

    def __iter__(self):
        return iter(self._ports)

    def __len__(self) -> int:
        return len(self._ports)

    # -- declaration helpers ---------------------------------------------------
    def create_namespace(self, key: str, **kwargs) -> "PortNamespace":
        """Recursively create nested namespaces along a dotted path."""
        head, _, tail = key.partition(SEPARATOR)
        if head not in self._ports:
            self._ports[head] = PortNamespace(head, **(kwargs if not tail else {}))
        ns = self._ports[head]
        if not isinstance(ns, PortNamespace):
            raise ValueError(f"{head!r} is already a leaf port")
        if tail:
            return ns.create_namespace(tail, **kwargs)
        return ns

    def absorb(self, other: "PortNamespace", exclude: tuple[str, ...] = (),
               include: tuple[str, ...] | None = None) -> None:
        """Copy ports from another namespace (expose_inputs machinery).

        Ports (and nested namespaces) are *deep-copied*: the exposing spec
        must never share mutable Port objects with the source class, or
        mutating one spec (e.g. re-declaring a port after exposing) would
        silently rewrite the other."""
        for name, port in other.items():
            if include is not None and name not in include:
                continue
            if name in exclude:
                continue
            self._ports[name] = copy.deepcopy(port)
        if other.dynamic:
            self.dynamic = True

    # -- serialization (port serializer= contract) ------------------------------
    def serialize(self, values: Any, breadcrumbs: str = "") -> dict[str, Any]:
        """Walk the namespace tree applying leaf-port serializers to the
        given values; undeclared keys (dynamic namespaces) pass through."""
        path = (f"{breadcrumbs}{SEPARATOR}{self.name}"
                if breadcrumbs and self.name else (self.name or breadcrumbs))
        if values is None or values is UNSPECIFIED:
            return {}
        out: dict[str, Any] = {}
        for key, value in dict(values).items():
            port = self._ports.get(key)
            if isinstance(port, PortNamespace) and isinstance(value, Mapping):
                out[key] = port.serialize(value, path)
            elif port is not None:
                out[key] = port.serialize(value, path)
            else:
                out[key] = value
        return out

    # -- validation -------------------------------------------------------------
    def validate(self, values: Any, breadcrumbs: str = "") -> str | None:
        path = (f"{breadcrumbs}{SEPARATOR}{self.name}"
                if breadcrumbs and self.name else (self.name or breadcrumbs))
        if values is UNSPECIFIED:
            values = {}
        values = dict(values or {})
        # declared ports
        for name, port in self._ports.items():
            value = values.pop(name, UNSPECIFIED)
            if value is UNSPECIFIED and port.has_default:
                value = port.default
            err = port.validate(value, path)
            if err is not None:
                return err
        # leftovers
        if values and not self.dynamic:
            return (f"namespace '{path or '<root>'}' does not accept "
                    f"undeclared ports: {sorted(values)}")
        if self.validator is not None:
            err = self.validator(values)
            if err is not None:
                return f"namespace '{path}': {err}"
        return None

    def defaults(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for name, port in self._ports.items():
            if isinstance(port, PortNamespace):
                sub = port.defaults()
                if sub:
                    out[name] = sub
            elif port.has_default:
                out[name] = port.default
        return out

    def non_db_keys(self) -> set[str]:
        return {name for name, port in self._ports.items() if port.non_db}

    def project(self, values: Mapping[str, Any]) -> dict[str, Any]:
        """Split values into (db-storable, non-db) according to port flags."""
        return {k: v for k, v in values.items() if k not in self.non_db_keys()}
