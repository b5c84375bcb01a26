"""Client-side process control (the ``verdi process pause|play|kill``
role, paper §III.C.b).

A :class:`ProcessController` is a synchronous facade over the broker's
control plane: control RPCs are routed by the broker to whichever daemon
worker owns ``process.<pk>``, and ``watch`` tails the
``state_changed.<pk>.<state>`` broadcast stream (with durable replay of
missed events). It is what non-async
callers use; async code talks to :class:`repro_torch.engine.broker.BrokerClient`
directly.
"""

from __future__ import annotations

from typing import Any, Iterator

from repro_torch.engine.broker import SyncBrokerClient
from repro_torch.engine.communicator import process_rpc_id


class NoRunningDaemon(RuntimeError):
    """No broker endpoint was found (daemon not running?)."""


class ProcessController:
    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.timeout = timeout
        try:
            self._client = SyncBrokerClient(host, port)
        except OSError as exc:
            raise NoRunningDaemon(
                f"cannot reach broker at {host}:{port}: {exc}") from exc

    @classmethod
    def from_workdir(cls, workdir: str, timeout: float = 10.0
                     ) -> "ProcessController":
        """Connect via the ``broker.json`` a running daemon wrote into its
        working directory."""
        import json
        import os

        path = os.path.join(workdir, "broker.json")
        if not os.path.exists(path):
            raise NoRunningDaemon(f"no broker.json in {workdir!r} — is the "
                                  "daemon running?")
        with open(path) as fh:
            info = json.load(fh)
        return cls(info["host"], info["port"], timeout=timeout)

    # -- control intents -----------------------------------------------------
    def _intent(self, pk: int, intent: str, **kw) -> Any:
        return self._client.rpc(process_rpc_id(pk), {"intent": intent, **kw},
                                timeout=self.timeout)

    def pause(self, pk: int) -> Any:
        return self._intent(pk, "pause")

    def play(self, pk: int) -> Any:
        return self._intent(pk, "play")

    def kill(self, pk: int, message: str = "killed by user") -> Any:
        return self._intent(pk, "kill", message=message)

    def status(self, pk: int) -> dict:
        return self._intent(pk, "status")

    # -- directory -----------------------------------------------------------
    def live_processes(self) -> list[int]:
        """pks with a live control endpoint right now (any worker)."""
        idents = self._client.lookup("process.*", timeout=self.timeout)
        return sorted(int(i.split(".", 1)[1]) for i in idents)

    def workers(self) -> list[dict]:
        """One status dict per connected daemon worker (advertised pks)."""
        out = []
        for ident in self._client.lookup("worker.*", timeout=self.timeout):
            try:
                out.append(self._client.rpc(ident, {}, timeout=self.timeout))
            except (KeyError, TimeoutError):
                continue
        return out

    # -- event tailing ---------------------------------------------------------
    def watch(self, pk: int | None = None, timeout: float | None = None,
              replay_since: int | None = None
              ) -> Iterator[tuple[str, Any, dict]]:
        """Yield live ``(subject, sender, body)`` state-change events —
        all processes, or one pk. Stops after ``timeout`` seconds total
        (None = tail forever)."""
        subject_filter = (f"state_changed.{pk}.*" if pk is not None
                          else "state_changed.*")
        yield from self._client.events(subject_filter=subject_filter,
                                       timeout=timeout,
                                       replay_since=replay_since)

    def close(self) -> None:
        self._client.close()

    def __enter__(self) -> "ProcessController":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
