from repro_torch.calcjobs.calcjob import CalcJob  # noqa: F401
from repro_torch.calcjobs.scheduler import (  # noqa: F401
    JobState, SimScheduler, SimulatedCluster, SlurmScheduler,
)
from repro_torch.calcjobs.gpujob import GPUTrainJob  # noqa: F401
