"""GPUTrainJob: the CalcJob that launches a training run on the card — the
counterpart of the reference's ``TPUTrainJob``, with the same ports, exit
codes and ``metrics.json``.

The job's payload is the port's own training loop: the cluster-side
executable builds the requested architecture (reduced or full), runs
``steps`` optimizer steps and writes ``metrics.json``. ``parse`` lifts the
metrics into provenance and maps failure modes onto exit codes (NaN loss,
scheduler failure, …) that error handlers (restart.py) react to.

The job runs on the CUDA card unless its config names another device
(``"device": "cpu"``). Without a card and without that key the payload
raises, so the job ends with ``ERROR_SCHEDULER_FAILED`` (100) and the
cluster job's reason names the missing card: it never trains on the CPU
instead. The device is an input of the job and so part of its
fingerprint, because a CPU run and a card run give different losses.
"""

from __future__ import annotations

import json

from repro_torch.calcjobs.calcjob import CalcInfo, CalcJob, get_cluster
from repro_torch.core.datatypes import Dict, FolderData
from repro_torch.core.exit_code import ExitCode
from repro_torch.core.process_spec import ProcessSpec

EXECUTABLE_NAME = "gpu_train"


def gpu_train_executable(input_files: dict[str, bytes]) -> dict[str, bytes]:
    """Cluster-side payload: a PyTorch training run on ``config["device"]``
    (the card when absent)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.common import resolve_device
    from repro_torch.models.registry import build
    from repro_torch.training.optim import OptimConfig
    from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                                 make_train_step)

    config = json.loads(input_files["config.json"])
    device = resolve_device(config.get("device"))
    arch = config["arch"]
    cfg = reduced_config(arch) if config.get("reduced", True) \
        else get_config(arch)
    if config.get("overrides"):
        cfg = cfg.replace(**config["overrides"])
    bundle = build(cfg)
    steps = config.get("steps", 10)
    tcfg = TrainConfig(optim=OptimConfig(
        lr=config.get("lr", 3e-4),
        total_steps=steps,
        warmup_steps=max(1, steps // 10)))
    seed = config.get("seed", 0)
    state = init_train_state(bundle, tcfg, seed, device)
    # the state is donated, as the reference's step is jitted
    step_fn = make_train_step(bundle, tcfg, donate=True)

    b, s = config.get("batch", 2), config.get("seq", 64)
    losses = []
    data_rng = np.random.default_rng(seed)
    for _ in range(steps):
        tokens = data_rng.integers(0, cfg.vocab_size, (b, s + 1),
                                   dtype=np.int32)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in (("tokens", tokens[:, :-1]),
                              ("labels", tokens[:, 1:]))}
        # a VLM's zero patches, an audio model's frames drawn from data_rng
        # after the tokens, as the reference's recipe makes them
        batch.update(bundle.draw_extra_inputs(b, data_rng, device))
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])      # read once, after the last step
    losses = torch.stack(losses).tolist()

    if config.get("inject_nan", False):
        losses[-1] = float("nan")

    out = {
        "metrics.json": json.dumps({
            "losses": losses,
            "final_loss": losses[-1],
            "steps": len(losses),
            "arch": arch,
        }).encode(),
    }
    return out


class GPUTrainJob(CalcJob):
    @classmethod
    def define(cls, spec: ProcessSpec) -> None:
        super().define(spec)
        spec.input("config", valid_type=Dict)
        spec.output("metrics", valid_type=Dict)
        spec.exit_code(310, "ERROR_NAN_LOSS",
                       "training diverged: loss is NaN")
        spec.exit_code(311, "ERROR_NO_METRICS",
                       "metrics.json missing from retrieved files")

    def prepare_for_submission(self) -> CalcInfo:
        # make sure the cluster knows our executable
        cluster = get_cluster(self.runner)
        if EXECUTABLE_NAME not in cluster.executables:
            cluster.register_executable(EXECUTABLE_NAME, gpu_train_executable)
        cfg = dict(self.inputs["config"].value)
        return CalcInfo(
            files={"config.json": json.dumps(cfg).encode()},
            executable=EXECUTABLE_NAME,
            retrieve_list=["metrics.json"],
        )

    def parse(self, retrieved: FolderData) -> ExitCode | None:
        import math

        try:
            metrics = json.loads(retrieved.get_bytes("metrics.json"))
        except KeyError:
            return self.exit_codes.ERROR_NO_METRICS
        self.out("metrics", Dict(metrics))
        if math.isnan(metrics.get("final_loss", 0.0)):
            return self.exit_codes.ERROR_NAN_LOSS
        return None
