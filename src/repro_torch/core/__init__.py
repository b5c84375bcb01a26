# The paper's primary contribution: the event-based process engine —
# ProcessSpec/ports, the extended state machine, calcfunction/workfunction
# provenance decorators, and the checkpointable WorkChain outline DSL.

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
from repro_torch.core.workchain import (  # noqa: F401
    ToContext, WorkChain, append_, if_, return_, while_,
)
