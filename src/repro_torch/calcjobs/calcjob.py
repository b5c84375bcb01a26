"""CalcJob (paper §II.B.4): the four transport tasks — upload, submit,
update, retrieve — each wrapped in exponential-back-off-retry; exhaustion
PAUSES the process instead of excepting it (fig. 3 + §II.B.4.a). The job
stage and scheduler id are checkpointed, so a restarted worker resumes a
job exactly where it was (even mid-queue on the cluster).
"""

from __future__ import annotations

import json
from typing import Any

from repro_torch.core.datatypes import Dict, FolderData
from repro_torch.core.exit_code import ExitCode
from repro_torch.core.process import Process, ProcessState
from repro_torch.core.process_spec import ProcessSpec
from repro_torch.engine.backoff import TransportTaskExhausted, \
    exponential_backoff_retry
from repro_torch.engine.jobmanager import JobManager
from repro_torch.calcjobs.scheduler import JobState, SimScheduler, SimulatedCluster
from repro_torch.provenance.store import NodeType

UPLOAD, SUBMIT, UPDATE, RETRIEVE, DONE = \
    "upload", "submit", "update", "retrieve", "done"


class CalcInfo:
    """What prepare_for_submission produces."""

    def __init__(self, *, files: dict[str, bytes], executable: str,
                 retrieve_list: list[str]):
        self.files = files
        self.executable = executable
        self.retrieve_list = retrieve_list


def get_cluster(runner) -> SimulatedCluster:
    """The runner-wide simulated cluster (swap-in point for a real one)."""
    cluster = getattr(runner, "_cluster", None)
    if cluster is None:
        cluster = SimulatedCluster()
        runner._cluster = cluster
    return cluster


def get_job_manager(runner, hostname: str) -> JobManager:
    managers = getattr(runner, "_job_managers", None)
    if managers is None:
        managers = {}
        runner._job_managers = managers
    if hostname not in managers:
        cluster = get_cluster(runner)
        if hostname not in runner.transport_queue._transports:
            runner.transport_queue.register_transport(
                cluster.make_transport(hostname))
        managers[hostname] = JobManager(runner.transport_queue,
                                        SimScheduler(), hostname)
    return managers[hostname]


class CalcJob(Process):
    NODE_TYPE = NodeType.CALC_JOB

    # backoff knobs (configurable per transport-task type, §II.B.4.a)
    MAX_ATTEMPTS = 5
    INITIAL_INTERVAL = 0.05

    @classmethod
    def define(cls, spec: ProcessSpec) -> None:
        super().define(spec)
        spec.input("metadata.computer", valid_type=str, required=False,
                   non_db=True, default="local")
        spec.input("metadata.options", valid_type=dict, required=False,
                   non_db=True, default=dict)
        spec.output("retrieved", valid_type=FolderData)
        spec.exit_code(100, "ERROR_SCHEDULER_FAILED",
                       "the scheduler reported the job as failed: {reason}")
        spec.exit_code(110, "ERROR_MISSING_OUTPUT",
                       "expected output file {name} was not retrieved")
        spec.exit_code(120, "ERROR_JOB_LOST",
                       "the scheduler no longer knows job {job_id}")

    # -- subclass hooks -----------------------------------------------------------
    def prepare_for_submission(self) -> CalcInfo:
        raise NotImplementedError

    def parse(self, retrieved: FolderData) -> ExitCode | None:
        """Parse retrieved files into outputs; runs locally (not a
        transport task — paper §II.B.4)."""
        return None

    # -- state for checkpointing ------------------------------------------------------
    def checkpoint_extras(self) -> dict:
        return {"stage": getattr(self, "_stage", UPLOAD),
                "job_id": getattr(self, "_job_id", None),
                "workdir": getattr(self, "_workdir", None),
                "retrieve_list": getattr(self, "_retrieve_list", [])}

    def load_checkpoint_extras(self, extras: dict) -> None:
        self._stage = extras.get("stage", UPLOAD)
        self._job_id = extras.get("job_id")
        self._workdir = extras.get("workdir")
        self._retrieve_list = extras.get("retrieve_list", [])

    # -- helpers ------------------------------------------------------------------------
    @property
    def hostname(self) -> str:
        return self.metadata.get("computer", "local")

    async def _with_backoff(self, fn, name: str):
        """Run one transport task with exponential backoff; on exhaustion
        pause the process (the paper's pause-not-except contract) and retry
        after the user (or an error handler) plays it."""
        while True:
            try:
                return await exponential_backoff_retry(
                    fn, initial_interval=self.INITIAL_INTERVAL,
                    max_attempts=self.MAX_ATTEMPTS,
                    name=f"{name}[{self.pk}]")
            except TransportTaskExhausted as exc:
                self.report("transport task %s exhausted retries: %s",
                            name, exc)
                self._pause_requested = True
                self._play.clear()
                await self._pause_point()   # blocks until play() or kill()

    # -- the lifecycle -------------------------------------------------------------------
    async def run(self):
        if not hasattr(self, "_stage"):
            self._stage = UPLOAD
            self._job_id = None
            self._workdir = None
            self._retrieve_list = []
        tq = self.runner.transport_queue
        manager = get_job_manager(self.runner, self.hostname)
        scheduler = manager.scheduler

        while self._stage != DONE:
            await self._pause_point()

            if self._stage == UPLOAD:
                info = self.prepare_for_submission()
                self._workdir = f"job_{self.pk}"
                self._retrieve_list = info.retrieve_list

                async def upload():
                    t = await tq.request_transport(self.hostname)
                    for name, data in info.files.items():
                        await t.put_file(f"{self._workdir}/{name}", data)
                    script = {"executable": info.executable,
                              "workdir": self._workdir}
                    await t.put_file(f"{self._workdir}.job",
                                     json.dumps(script).encode())

                await self._with_backoff(upload, "upload")
                self.report("uploaded %d files to %s", len(info.files),
                            self.hostname)
                self._stage = SUBMIT
                self.checkpoint_now()

            elif self._stage == SUBMIT:
                async def submit():
                    t = await tq.request_transport(self.hostname)
                    return await scheduler.submit(t, f"{self._workdir}.job")

                self._job_id = await self._with_backoff(submit, "submit")
                self.report("submitted as job %s", self._job_id)
                self._stage = UPDATE
                self.checkpoint_now()

            elif self._stage == UPDATE:
                async def update():
                    # bundled query via the job manager (paper §II.B.4.c)
                    return await self.interruptible(
                        manager.request_job_state(self._job_id))

                state = await self._with_backoff(update, "update")
                if state in (JobState.DONE.value, JobState.FAILED.value):
                    self._scheduler_state = state
                    self._stage = RETRIEVE
                    self.checkpoint_now()
                elif state == JobState.UNDETERMINED.value:
                    # Lost-job mitigation: after a node failure the scheduler
                    # may have no record of our id (e.g. this process was
                    # resumed on another worker while the original cluster
                    # allocation vanished). Resubmit from the upload stage.
                    self._undetermined = getattr(self, "_undetermined", 0) + 1
                    if self._undetermined >= 5:
                        self.report("job %s lost by scheduler; resubmitting",
                                    self._job_id)
                        self._undetermined = 0
                        self._stage = UPLOAD
                        self.checkpoint_now()
                    else:
                        import asyncio
                        await self.interruptible(asyncio.sleep(0.05))
                else:
                    import asyncio
                    self._undetermined = 0
                    self.transition_to(ProcessState.WAITING)
                    await self.interruptible(asyncio.sleep(0.02))
                    self.transition_to(ProcessState.RUNNING)

            elif self._stage == RETRIEVE:
                async def retrieve():
                    t = await tq.request_transport(self.hostname)
                    files = {}
                    for name in self._retrieve_list:
                        try:
                            files[name] = await t.get_file(
                                f"{self._workdir}/{name}")
                        except KeyError:
                            pass
                    return files

                files = await self._with_backoff(retrieve, "retrieve")
                retrieved = FolderData(files)
                self.out("retrieved", retrieved)
                self._stage = DONE

                # parsing is local — not a transport task
                sched_state = getattr(self, "_scheduler_state", None)
                if sched_state == JobState.FAILED.value:
                    job = get_cluster(self.runner).jobs.get(self._job_id, {})
                    return self.exit_codes.ERROR_SCHEDULER_FAILED.format(
                        reason=job.get("reason", "unknown"))
                missing = [n for n in self._retrieve_list if n not in files]
                if missing:
                    return self.exit_codes.ERROR_MISSING_OUTPUT.format(
                        name=missing[0])
                return self.parse(retrieved)

        return None
