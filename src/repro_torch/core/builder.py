"""ProcessBuilder (paper §II.A; AiiDA 1.0 launch API).

``MyProcess.get_builder()`` returns a :class:`ProcessBuilder` that mirrors
the class's ``PortNamespace`` tree with attribute access::

    b = MyWorkChain.get_builder()
    b.sub.n = 3              # nested namespace, validated on assignment
    b.metadata.label = "run" # metadata ports work the same way
    run_get_node(b)          # engine/launch.py accepts builders directly

Every assignment is validated against the target port immediately — a bad
type raises :class:`PortValidationError` *at assignment time* with the full
dotted port path, instead of a dict typo surfacing at runtime. Ports with a
``serializer=`` wrap raw Python values on assignment (``b.sub.n = 3``
stores ``Int(3)``), keeping provenance complete without boilerplate.

Builders also support dotted-path get/set (``b["sub.n"]``), recursive
``_merge()`` of plain dicts, and ``_inputs(prune=True)`` which drops unset
optionals and empty namespaces — exactly what the launchers hand to the
process constructor.
"""

from __future__ import annotations

from collections.abc import Mapping, MutableMapping
from typing import Any

from repro_torch.core.ports import (
    SEPARATOR, Port, PortNamespace, PortValidationError,
)


class UnknownPortError(PortValidationError, AttributeError):
    """Assignment to a port that does not exist in a non-dynamic
    namespace. Subclasses both PortValidationError (the documented
    assignment-failure contract) and AttributeError (the natural
    exception for ``builder.typo = ...``), so either handler catches it."""


class ProcessBuilderNamespace(MutableMapping):
    """One level of a builder, mirroring one ``PortNamespace``."""

    def __init__(self, port_namespace: PortNamespace, breadcrumbs: str = ""):
        # bypass __setattr__ (which routes to ports) for internals
        object.__setattr__(self, "_port_namespace", port_namespace)
        object.__setattr__(self, "_breadcrumbs", breadcrumbs)
        object.__setattr__(self, "_data", {})
        for name, port in port_namespace.items():
            if isinstance(port, PortNamespace):
                self._data[name] = ProcessBuilderNamespace(
                    port, self._path(name))
        object.__setattr__(self, "__doc__", self._build_doc())

    # -- helpers -----------------------------------------------------------
    def _path(self, name: str) -> str:
        return (f"{self._breadcrumbs}{SEPARATOR}{name}"
                if self._breadcrumbs else name)

    def _build_doc(self) -> str:
        ns = self._port_namespace
        lines = [f"Inputs for namespace '{self._breadcrumbs or '<root>'}'"
                 + (" (dynamic)" if ns.dynamic else "") + ":"]
        if ns.help:
            lines.append(f"  {ns.help}")
        for name, port in ns.items():
            if isinstance(port, PortNamespace):
                lines.append(f"  {name}: namespace"
                             + (" (dynamic)" if port.dynamic else ""))
                continue
            types = ("|".join(t.__name__ for t in port.valid_type)
                     if port.valid_type else "any")
            req = "required" if port.required else "optional"
            tail = f" — {port.help}" if port.help else ""
            lines.append(f"  {name}: {types}, {req}{tail}")
        return "\n".join(lines)

    # -- attribute protocol ------------------------------------------------
    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self[name] = value

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"no input '{self._path(name)}' set; declared ports: "
                f"{sorted(self._port_namespace)}") from None

    def __dir__(self):
        return sorted(set(list(super().__dir__())
                          + list(self._port_namespace)
                          + list(self._data)))

    # -- mapping protocol --------------------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        head, _, tail = key.partition(SEPARATOR)
        if tail:
            target = self._data.get(head)
            if not isinstance(target, ProcessBuilderNamespace):
                raise KeyError(f"'{self._path(head)}' is not a namespace")
            target[tail] = value
            return
        port = self._port_namespace.get(head)
        if isinstance(port, PortNamespace):
            if not isinstance(value, Mapping):
                raise PortValidationError(
                    f"port '{self._path(head)}' is a namespace; assign a "
                    f"mapping, not {type(value).__name__}")
            # replace atomically: validate into a fresh namespace and swap
            # only on success, so a failed assignment leaves the previous
            # contents intact (no partial write)
            fresh = ProcessBuilderNamespace(port, self._path(head))
            fresh._merge(value)
            self._data[head] = fresh
            return
        if port is None:
            if not self._port_namespace.dynamic:
                raise UnknownPortError(
                    f"'{self._path(head)}' is not a declared input port; "
                    f"declared ports: {sorted(self._port_namespace)}")
            self._data[head] = value
            return
        value = port.serialize(value, self._breadcrumbs)
        err = port.validate(value, self._breadcrumbs)
        if err is not None:
            raise PortValidationError(err)
        self._data[head] = value

    def __getitem__(self, key: str):
        head, _, tail = key.partition(SEPARATOR)
        value = self._data[head]
        if tail:
            if not isinstance(value, ProcessBuilderNamespace):
                raise KeyError(key)
            return value[tail]
        return value

    def __delitem__(self, key: str) -> None:
        head, _, tail = key.partition(SEPARATOR)
        if tail:
            del self._data[head][tail]
            return
        value = self._data.get(head)
        if isinstance(value, ProcessBuilderNamespace):
            value.clear()
        else:
            del self._data[head]

    def __iter__(self):
        for key, value in self._data.items():
            if isinstance(value, ProcessBuilderNamespace) and not len(value):
                continue
            yield key

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def clear(self) -> None:
        for key in list(self._data):
            value = self._data[key]
            if isinstance(value, ProcessBuilderNamespace):
                value.clear()
            else:
                del self._data[key]

    # -- bulk updates ------------------------------------------------------
    def _merge(self, values: Mapping[str, Any] | None = None, **kwargs) -> None:
        """Recursively merge a nested dict into this namespace; every leaf
        goes through the normal per-assignment validation/serialization."""
        merged = dict(values or {})
        merged.update(kwargs)
        for key, value in merged.items():
            sub = self._data.get(key)
            if isinstance(sub, ProcessBuilderNamespace) and \
                    isinstance(value, Mapping):
                sub._merge(value)
            else:
                self[key] = value

    def _inputs(self, prune: bool = True) -> dict[str, Any]:
        """The accumulated inputs as a plain nested dict. With ``prune``
        (the launcher default), unset optionals and empty namespaces are
        simply absent — the process constructor applies port defaults."""
        out: dict[str, Any] = {}
        for key, value in self._data.items():
            if isinstance(value, ProcessBuilderNamespace):
                sub = value._inputs(prune=prune)
                if sub or not prune:
                    out[key] = sub
            else:
                out[key] = value
        return out

    def __repr__(self) -> str:
        return (f"{type(self).__name__}"
                f"('{self._breadcrumbs or '<root>'}', "
                f"{self._inputs(prune=True)!r})")


class ProcessBuilder(ProcessBuilderNamespace):
    """The root builder, bound to a process class (launchable as-is)."""

    def __init__(self, process_class: type):
        object.__setattr__(self, "_process_class", process_class)
        super().__init__(process_class.spec().inputs)

    @property
    def process_class(self) -> type:
        return self._process_class

    def __repr__(self) -> str:
        return (f"ProcessBuilder({self._process_class.__name__}, "
                f"{self._inputs(prune=True)!r})")


def expand_launch_target(process, inputs: Mapping[str, Any] | None = None
                         ) -> tuple[type, dict[str, Any]]:
    """Normalize the two launcher call shapes — ``(ProcessClass, **inputs)``
    or ``(builder, **overrides)`` — into ``(process_class, inputs)``."""
    if isinstance(process, ProcessBuilder):
        merged = process._inputs(prune=True)
        for key, value in dict(inputs or {}).items():
            if isinstance(merged.get(key), dict) and isinstance(value, Mapping):
                merged[key].update(value)
            else:
                merged[key] = value
        return process._process_class, merged
    if isinstance(process, type):
        return process, dict(inputs or {})
    raise TypeError(
        f"expected a Process class or a ProcessBuilder, got "
        f"{type(process).__name__}")
