"""Extended finite-state machine (paper §III.B, fig. 6).

States carry extended data (the process instance itself holds it); the
machine enforces the transition table and fires the three hooks around every
transition::

    on_exiting()            # about to leave the current state
    on_entering(new_state)  # about to enter new_state
    <state assigned>
    on_entered(from_state)  # transition finished — persistence + broadcast

This hook discipline is what lets the engine guarantee a checkpoint exists
for every state the outside world can observe.
"""

from __future__ import annotations

import enum
from typing import Callable


class ProcessState(str, enum.Enum):
    CREATED = "created"
    RUNNING = "running"
    WAITING = "waiting"
    PAUSED = "paused"
    FINISHED = "finished"
    EXCEPTED = "excepted"
    KILLED = "killed"

    @property
    def is_terminal(self) -> bool:
        return self in TERMINAL_STATES


TERMINAL_STATES = frozenset(
    {ProcessState.FINISHED, ProcessState.EXCEPTED, ProcessState.KILLED})

TRANSITIONS: dict[ProcessState, frozenset[ProcessState]] = {
    ProcessState.CREATED: frozenset({
        ProcessState.RUNNING, ProcessState.PAUSED, ProcessState.EXCEPTED,
        ProcessState.KILLED}),
    ProcessState.RUNNING: frozenset({
        ProcessState.RUNNING, ProcessState.WAITING, ProcessState.PAUSED,
        ProcessState.FINISHED, ProcessState.EXCEPTED, ProcessState.KILLED}),
    ProcessState.WAITING: frozenset({
        ProcessState.RUNNING, ProcessState.WAITING, ProcessState.PAUSED,
        ProcessState.FINISHED, ProcessState.EXCEPTED, ProcessState.KILLED}),
    ProcessState.PAUSED: frozenset({
        ProcessState.RUNNING, ProcessState.WAITING, ProcessState.EXCEPTED,
        ProcessState.KILLED}),
    ProcessState.FINISHED: frozenset(),
    ProcessState.EXCEPTED: frozenset(),
    ProcessState.KILLED: frozenset(),
}


class InvalidTransitionError(RuntimeError):
    pass


class StateMachine:
    """Mixin driving the state field with hook discipline."""

    def __init__(self) -> None:
        self._sm_state: ProcessState = ProcessState.CREATED
        self._paused_from: ProcessState | None = None

    @property
    def state(self) -> ProcessState:
        return self._sm_state

    @property
    def is_terminated(self) -> bool:
        return self._sm_state.is_terminal

    # hooks — subclasses override
    def on_exiting(self) -> None:  # noqa: B027
        pass

    def on_entering(self, state: ProcessState) -> None:  # noqa: B027
        pass

    def on_entered(self, from_state: ProcessState) -> None:  # noqa: B027
        pass

    def transition_to(self, new_state: ProcessState) -> None:
        current = self._sm_state
        if new_state not in TRANSITIONS[current]:
            raise InvalidTransitionError(
                f"invalid transition {current.value} -> {new_state.value}")
        if new_state is ProcessState.PAUSED:
            self._paused_from = current
        self.on_exiting()
        self.on_entering(new_state)
        self._sm_state = new_state
        self.on_entered(current)

    def resume_from_pause(self) -> ProcessState:
        """PAUSED -> the state that was interrupted (RUNNING/WAITING)."""
        target = self._paused_from or ProcessState.RUNNING
        if target not in (ProcessState.RUNNING, ProcessState.WAITING):
            target = ProcessState.RUNNING
        self.transition_to(target)
        return target
