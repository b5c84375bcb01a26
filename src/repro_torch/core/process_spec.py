"""ProcessSpec (paper §II.A.2–3): declarative input/output ports, nested
namespaces, exit codes, the WorkChain outline, and port exposing.

Ports declared here are the launch surface: ``Process.get_builder()``
mirrors ``spec.inputs`` as a :class:`~repro_torch.core.builder.ProcessBuilder`,
and a port's ``serializer=`` (e.g. ``spec.input("n", valid_type=Int,
serializer=Int)``) wraps raw python values both at builder assignment and
at process construction. ``expose_inputs`` deep-copies the source ports
(via ``PortNamespace.absorb``), so re-declaring an exposed port afterwards
— the standard way to specialize an exposed namespace — never mutates the
source class's spec."""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.core.exit_code import ExitCode, ExitCodesNamespace
from repro_torch.core.ports import InputPort, OutputPort, PortNamespace


class ProcessSpec:
    def __init__(self) -> None:
        self.inputs = PortNamespace("inputs")
        self.outputs = PortNamespace("outputs")
        self.exit_codes = ExitCodesNamespace()
        self._outline = None
        self._exposed_inputs: dict[tuple[type, str | None], list[str]] = {}
        self._sealed = False
        # default metadata ports (non_db attributes of the process node)
        self.input_namespace("metadata", dynamic=True, non_db=True)
        self.input("metadata.label", valid_type=str, required=False,
                   non_db=True)
        self.input("metadata.description", valid_type=str, required=False,
                   non_db=True)

    # -- declarative methods (later declarations override earlier ones) ------
    def input(self, name: str, **kwargs) -> None:
        non_db = kwargs.pop("non_db", False)
        self.inputs[name] = InputPort(name.rsplit(".", 1)[-1], non_db=non_db,
                                      **kwargs)

    def output(self, name: str, **kwargs) -> None:
        kwargs.setdefault("required", True)
        self.outputs[name] = OutputPort(name.rsplit(".", 1)[-1], **kwargs)

    def input_namespace(self, name: str, *, dynamic: bool = False,
                        non_db: bool = False) -> None:
        ns = self.inputs.create_namespace(name)
        ns.dynamic = dynamic
        ns.non_db = non_db

    def output_namespace(self, name: str, *, dynamic: bool = False) -> None:
        ns = self.outputs.create_namespace(name)
        ns.dynamic = dynamic

    def exit_code(self, status: int, label: str, message: str) -> None:
        if status < 0:
            raise ValueError("exit status must be a non-negative integer")
        self.exit_codes[label] = ExitCode(status, message, label)

    # -- outline (workchains, §II.B.3.a) --------------------------------------
    def outline(self, *instructions) -> None:
        from repro_torch.core.workchain import _build_outline
        self._outline = _build_outline(instructions)

    def get_outline(self):
        return self._outline

    # -- exposing (§II.B.3.g) ---------------------------------------------------
    def expose_inputs(self, process_class, namespace: str | None = None,
                      exclude: tuple[str, ...] = (),
                      include: tuple[str, ...] | None = None) -> None:
        source = process_class.spec().inputs
        if namespace:
            target = self.inputs.create_namespace(namespace)
        else:
            target = self.inputs
        exclude = tuple(exclude) + ("metadata",) if not namespace else tuple(exclude)
        target.absorb(source, exclude=exclude, include=include)
        self._exposed_inputs[(process_class, namespace)] = [
            name for name in source
            if name not in exclude and (include is None or name in include)
        ]

    def expose_outputs(self, process_class, namespace: str | None = None,
                       exclude: tuple[str, ...] = (),
                       include: tuple[str, ...] | None = None) -> None:
        source = process_class.spec().outputs
        target = (self.outputs.create_namespace(namespace) if namespace
                  else self.outputs)
        target.absorb(source, exclude=tuple(exclude), include=include)

    def exposed_input_names(self, process_class,
                            namespace: str | None = None) -> list[str]:
        return self._exposed_inputs.get((process_class, namespace), [])

    # -- validation helpers -------------------------------------------------------
    def validate_inputs(self, values: dict[str, Any]) -> str | None:
        return self.inputs.validate(values)

    def validate_outputs(self, values: dict[str, Any]) -> str | None:
        return self.outputs.validate(values)
