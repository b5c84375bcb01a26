# The event-based process engine — ProcessSpec/ports, the extended state
# machine and the calcfunction/workfunction provenance decorators. The
# WorkChain outline DSL (``core/workchain.py``) is not ported yet.

from repro_torch.core.builder import (  # noqa: F401
    ProcessBuilder, ProcessBuilderNamespace, UnknownPortError,
)
from repro_torch.core.datatypes import (  # noqa: F401
    ArrayData, Bool, DataValue, Dict, Float, FolderData, Int, List, Str,
    to_data_value,
)
from repro_torch.core.exit_code import ExitCode  # noqa: F401
from repro_torch.core.ports import (  # noqa: F401
    UNSPECIFIED, InputPort, OutputPort, Port, PortNamespace,
    PortSerializationError, PortValidationError,
)
from repro_torch.core.process import Process, ProcessKilled  # noqa: F401
from repro_torch.core.process_functions import calcfunction, workfunction  # noqa: F401
from repro_torch.core.process_spec import ProcessSpec  # noqa: F401
from repro_torch.core.statemachine import (  # noqa: F401
    InvalidTransitionError, ProcessState, StateMachine, TERMINAL_STATES,
    TRANSITIONS,
)
