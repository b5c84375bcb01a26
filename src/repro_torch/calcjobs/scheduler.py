"""Scheduler abstraction (paper §II.B.4) + the simulated cluster.

``SimScheduler`` talks to a ``SimulatedCluster`` through transport
commands — exactly the way the SLURM scheduler talks over SSH — so the
whole upload→submit→update→retrieve machinery, the backoff wrapper and the
bundled job manager are exercised end-to-end without real hardware.

``SlurmScheduler`` emits/parses real SLURM commands (deployment path; it is
string-level compatible and unit-tested, the cluster behind it is whatever
the transport connects to).
"""

from __future__ import annotations

import enum
import itertools
import json
import random
import time
from typing import Any, Callable

from repro_torch.engine.transport import LocalTransport, Transport
from repro_torch.observability.metrics import StatsDict


class JobState(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    UNDETERMINED = "UNDETERMINED"


# ---------------------------------------------------------------------------
# The simulated cluster
# ---------------------------------------------------------------------------

class SimulatedCluster:
    """An in-memory cluster: a queue with configurable delays, runtimes,
    failure injection, and named python executables."""

    def __init__(self, *, queue_delay: float = 0.02, runtime: float = 0.05,
                 fail_rate: float = 0.0, seed: int = 0):
        from concurrent.futures import ThreadPoolExecutor

        self.queue_delay = queue_delay
        self.runtime = runtime
        self.fail_rate = fail_rate
        self.rng = random.Random(seed)
        self.jobs: dict[str, dict[str, Any]] = {}
        self._ids = itertools.count(1000)
        self.executables: dict[str, Callable[[dict], dict]] = {}
        self.filesystems: dict[str, dict[str, bytes]] = {}
        self.stats = StatsDict("scheduler", {"submits": 0, "queries": 0})
        # Executables run OFF the event loop: a worker whose loop is blocked
        # cannot answer broker heartbeats and gets presumed dead — the exact
        # failure mode kiwiPy's separate comm thread exists to prevent
        # (paper §III.C.a).
        self._pool = ThreadPoolExecutor(max_workers=2,
                                        thread_name_prefix="simcluster")

    def register_executable(self, name: str,
                            fn: Callable[[dict], dict]) -> None:
        """fn(input_files: {name: bytes}) -> output_files: {name: bytes}"""
        self.executables[name] = fn

    def make_transport(self, hostname: str = "local") -> LocalTransport:
        t = LocalTransport(hostname)
        t.command_handler = self.handle_command
        t.files = self.filesystems.setdefault(hostname, {})
        return t

    # -- the 'remote side': command handling ---------------------------------
    def handle_command(self, command: str) -> tuple[int, str, str]:
        parts = command.split()
        if parts[0] == "sbatch":
            return self._sbatch(parts[1])
        if parts[0] == "squeue":
            return self._squeue(parts[1].split(",") if len(parts) > 1 else [])
        if parts[0] == "scancel":
            job = self.jobs.get(parts[1])
            if job and job["state"] in (JobState.PENDING, JobState.RUNNING):
                job["state"] = JobState.FAILED
                job["reason"] = "cancelled"
            return 0, "", ""
        return 127, "", f"unknown command: {parts[0]}"

    def _sbatch(self, script_path: str) -> tuple[int, str, str]:
        self.stats["submits"] += 1
        job_id = str(next(self._ids))
        will_fail = self.rng.random() < self.fail_rate
        self.jobs[job_id] = {
            "state": JobState.PENDING,
            "script": script_path,
            "submitted": time.monotonic(),
            "will_fail": will_fail,
            "executed": False,
        }
        return 0, f"Submitted batch job {job_id}", ""

    def _advance(self, job_id: str) -> None:
        job = self.jobs[job_id]
        now = time.monotonic()
        if job["state"] is JobState.PENDING and \
                now - job["submitted"] >= self.queue_delay:
            job["state"] = JobState.RUNNING
            job["started"] = now
        if job["state"] is JobState.RUNNING and \
                now - job["started"] >= self.runtime:
            if job["will_fail"]:
                job["state"] = JobState.FAILED
                job["reason"] = "injected job failure"
                return
            fut = job.get("future")
            if fut is None:
                job["future"] = self._pool.submit(self._execute, job_id)
            elif fut.done():
                err = fut.exception()
                if err is not None:
                    job["state"] = JobState.FAILED
                    job["reason"] = f"executable raised: {err!r}"
                elif job.get("exec_error"):
                    job["state"] = JobState.FAILED
                    job["reason"] = job["exec_error"]
                else:
                    job["state"] = JobState.DONE

    def _execute(self, job_id: str) -> None:
        """Run the job script (in the cluster thread pool): parse its JSON
        for the executable name and workdir, call the python executable."""
        job = self.jobs[job_id]
        if job["executed"]:
            return
        job["executed"] = True
        for fs in self.filesystems.values():
            if job["script"] in fs:
                spec = json.loads(fs[job["script"]])
                exe = self.executables.get(spec["executable"])
                workdir = spec["workdir"]
                inputs = {
                    name[len(workdir) + 1:]: data
                    for name, data in fs.items()
                    if name.startswith(workdir + "/")}
                if exe is None:
                    job["exec_error"] = f"no executable {spec['executable']}"
                    return
                outputs = exe(inputs)
                for name, data in (outputs or {}).items():
                    fs[f"{workdir}/{name}"] = data
                return
        job["exec_error"] = f"job script {job['script']} not found"

    def _squeue(self, job_ids: list[str]) -> tuple[int, str, str]:
        self.stats["queries"] += 1
        lines = []
        for jid in job_ids:
            if jid not in self.jobs:
                lines.append(f"{jid} UNDETERMINED")
                continue
            self._advance(jid)
            lines.append(f"{jid} {self.jobs[jid]['state'].value}")
        return 0, "\n".join(lines), ""


# ---------------------------------------------------------------------------
# Scheduler adapters (speak over a Transport)
# ---------------------------------------------------------------------------

class SimScheduler:
    """Talks the simulated cluster's command dialect over any transport."""

    async def submit(self, transport: Transport, script_path: str) -> str:
        rc, out, err = await transport.exec_command(f"sbatch {script_path}")
        if rc != 0:
            raise RuntimeError(f"sbatch failed ({rc}): {err}")
        return out.rsplit(" ", 1)[-1].strip()

    async def query_jobs(self, transport: Transport, job_ids: list[str]
                         ) -> dict[str, str]:
        if not job_ids:
            return {}
        rc, out, err = await transport.exec_command(
            f"squeue {','.join(job_ids)}")
        if rc != 0:
            raise RuntimeError(f"squeue failed ({rc}): {err}")
        states: dict[str, str] = {}
        for line in out.splitlines():
            jid, state = line.split()
            states[jid] = state
        return states

    async def cancel(self, transport: Transport, job_id: str) -> None:
        await transport.exec_command(f"scancel {job_id}")


class SlurmScheduler(SimScheduler):
    """Real-SLURM command generation (deployment target). Inherits the
    submit/query/cancel plumbing; adds the batch-script writer."""

    def job_script(self, *, job_name: str, command: str, nodes: int = 1,
                   tasks_per_node: int = 1, walltime: str = "01:00:00",
                   partition: str | None = None, account: str | None = None,
                   tpu_topology: str | None = None) -> str:
        lines = ["#!/bin/bash", f"#SBATCH --job-name={job_name}",
                 f"#SBATCH --nodes={nodes}",
                 f"#SBATCH --ntasks-per-node={tasks_per_node}",
                 f"#SBATCH --time={walltime}"]
        if partition:
            lines.append(f"#SBATCH --partition={partition}")
        if account:
            lines.append(f"#SBATCH --account={account}")
        if tpu_topology:
            lines.append(f"#SBATCH --gres=tpu:{tpu_topology}")
        lines += ["", "set -euo pipefail", command, ""]
        return "\n".join(lines)

    def parse_sbatch_output(self, out: str) -> str:
        # 'Submitted batch job 12345'
        return out.rsplit(" ", 1)[-1].strip()
