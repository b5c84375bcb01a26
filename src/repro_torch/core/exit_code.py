"""Exit codes (paper §II.A.3): POSIX-style integer exit statuses with
human-readable labels and messages, declared on the process spec."""

from __future__ import annotations

from typing import NamedTuple


class ExitCode(NamedTuple):
    status: int = 0
    message: str = ""
    label: str = ""

    def format(self, **kwargs) -> "ExitCode":
        return self._replace(message=self.message.format(**kwargs))

    @property
    def is_finished_ok(self) -> bool:
        return self.status == 0


class ExitCodesNamespace(dict):
    """Container allowing attribute access by label:
    ``spec.exit_codes.ERROR_I_AM_A_TEAPOT``."""

    def __getattr__(self, label: str) -> ExitCode:
        try:
            return self[label]
        except KeyError as exc:
            raise AttributeError(
                f"no exit code with label {label!r}; "
                f"available: {sorted(self)}") from exc
