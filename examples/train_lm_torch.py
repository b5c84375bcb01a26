"""End-to-end driver of the PyTorch port: a PretrainWorkChain training a
language model under the engine, with checkpoint/restart, NaN error
handling and provenance. The twin of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py                 # ~10M model
    PYTHONPATH=src python examples/train_lm_torch.py --preset 110m   # full demo
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 4 --chunk 2

The chain trains in CHUNKS: every outline step runs `chunk_steps` optimizer
steps, then checkpoints (model state via the tensor checkpointer, engine
state via the process checkpoint, data cursor inside the context) — kill
the process at any point and rerun with --resume <pk> to continue from the
last chunk boundary. A NaN loss aborts the chunk with exit code 310 and the
chain restarts from the last good checkpoint with a lower LR.

It trains on the CUDA card, its attention through the port's flash
kernels, unless ``--device cpu`` is given; without a card and without that
flag it raises. The device is an input of the chain, so a resumed chain
keeps the device it started on.
"""

import argparse
import math
import sys
import time

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_config
from repro_torch.core import Dict, Float, Int, Str, WorkChain, while_
from repro_torch.engine.launch import run_get_node
from repro_torch.engine.runner import Runner, set_default_runner
from repro_torch.models.common import resolve_device
from repro_torch.models.registry import build
from repro_torch.provenance import configure_store
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optim import OptimConfig
from repro_torch.training.train_step import (
    TrainConfig, init_train_state, make_train_step,
)

PRESETS = {
    "tiny": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                 d_ff=704, vocab_size=8192, attn_impl="pallas"),
    # the aiida-demo-110m config as-is, its attention through the kernels
    "110m": dict(attn_impl="pallas"),
}


class PretrainWorkChain(WorkChain):
    """Trains in checkpointed chunks; recovers from NaN by lowering LR."""

    @classmethod
    def define(cls, spec):
        super().define(spec)
        spec.input("preset", valid_type=Dict, serializer=Dict,
                   help="model-config overrides applied to the base config")
        spec.input("total_steps", valid_type=Int, serializer=Int,
                   default=lambda: Int(60))
        spec.input("chunk_steps", valid_type=Int, serializer=Int,
                   default=lambda: Int(20))
        spec.input("lr", valid_type=Float, serializer=Float,
                   default=lambda: Float(3e-3))
        spec.input("ckpt_dir", valid_type=Dict, serializer=Dict,
                   default=lambda: Dict({"dir": ""}), required=False)
        spec.input("device", valid_type=Str, serializer=Str, required=False,
                   help="torch device to train on (the CUDA card when "
                        "absent)")
        spec.output("final_metrics", valid_type=Dict)
        spec.exit_code(310, "ERROR_NAN_LOSS", "loss diverged to NaN")
        spec.exit_code(320, "ERROR_NO_PROGRESS",
                       "loss failed to improve across restarts")
        spec.outline(
            cls.setup,
            while_(cls.not_done)(
                cls.train_chunk,
            ),
            cls.finalize,
        )

    # -- helpers (the step function lives on the instance, not the
    # checkpoint) ------------------------------------------------------------
    def _ensure_runtime(self):
        if hasattr(self, "_step_fn"):
            return
        preset = dict(self.inputs["preset"].value)
        cfg = get_config("aiida-demo-110m").replace(**preset)
        device = resolve_device(self.inputs["device"].value
                                if "device" in self.inputs else None)
        self._bundle = build(cfg)
        ocfg = OptimConfig(lr=self.ctx.lr,
                           warmup_steps=10,
                           total_steps=int(self.inputs["total_steps"].value))
        tcfg = TrainConfig(optim=ocfg)
        self._step_fn = make_train_step(self._bundle, tcfg, donate=True)
        self._data = TokenStream(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=self.ctx.seq_len,
            batch_size=self.ctx.batch, seed=17))
        if self.ctx.data_cursor is not None:
            self._data.load_state_dict(self.ctx.data_cursor)
        ckdir = self.ctx.ckpt_dir
        # the model checkpoint of the engine's last committed chunk, not
        # the latest on disk: a kill between the two saves leaves a model
        # checkpoint one chunk ahead of ctx.step and the data cursor
        step = self.ctx.step or None
        if step is not None:
            target = init_train_state(self._bundle, tcfg, 0, device)
            self._train_state = ckpt.restore_checkpoint(
                ckdir, step, target=target, device=device)
            self.report("restored model checkpoint at step %d", step)
        else:
            self._train_state = init_train_state(self._bundle, tcfg, 0,
                                                 device)
        self._device = device
        self._tcfg = tcfg

    # -- outline ------------------------------------------------------------
    def setup(self):
        self.ctx.step = 0
        self.ctx.losses = []
        self.ctx.lr = float(self.inputs["lr"].value)
        self.ctx.nan_restarts = 0
        self.ctx.data_cursor = None
        self.ctx.seq_len = 128
        self.ctx.batch = 4
        self.ctx.ckpt_dir = (self.inputs["ckpt_dir"].value.get("dir")
                             or f"examples_out/ckpt_{self.pk}")
        self.report("training starts: %d steps in chunks of %d",
                    self.inputs["total_steps"].value,
                    self.inputs["chunk_steps"].value)

    def not_done(self):
        return self.ctx.step < int(self.inputs["total_steps"].value)

    def train_chunk(self):
        self._ensure_runtime()
        n = min(int(self.inputs["chunk_steps"].value),
                int(self.inputs["total_steps"].value) - self.ctx.step)
        t0 = time.time()
        for _ in range(n):
            batch = self._data.next_batch()
            self._train_state, metrics = self._step_fn(
                self._train_state,
                {k: torch.from_numpy(v.copy()).to(self._device)
                 for k, v in batch.items()})
        loss = float(metrics["loss"])
        dt = time.time() - t0
        self.ctx.step += n

        if math.isnan(loss) or math.isinf(loss):
            self.ctx.step -= n     # rewind: the chunk did not commit
            self.ctx.nan_restarts += 1
            if self.ctx.nan_restarts > 3:
                return self.exit_codes.ERROR_NO_PROGRESS
            self.ctx.lr /= 10.0
            del self._step_fn      # rebuild with the lower LR
            self.report("NaN at step %d! restarting chunk from last "
                        "checkpoint with lr=%.2e", self.ctx.step, self.ctx.lr)
            return None            # chunk re-runs from last good state

        # commit: loss history, data cursor, model checkpoint — this is the
        # restart point for both engine-level and tensor-level recovery
        self.ctx.losses.append(loss)
        self.ctx.data_cursor = self._data.state_dict()
        ckpt.save_checkpoint(self.ctx.ckpt_dir, self.ctx.step,
                             self._train_state)
        self.report("step %d: loss=%.4f grad_norm=%.2f (%.1fs, %.1f tok/s)",
                    self.ctx.step, loss, float(metrics["grad_norm"]), dt,
                    n * self.ctx.batch * self.ctx.seq_len / dt)

    def finalize(self):
        self.report("done: %d steps, final loss %.4f",
                    self.ctx.step, self.ctx.losses[-1])
        self.out("final_metrics", Dict({
            "losses": self.ctx.losses,
            "final_loss": self.ctx.losses[-1],
            "steps": self.ctx.step,
            "nan_restarts": self.ctx.nan_restarts,
        }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--chunk", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu (default: the CUDA card)")
    ap.add_argument("--resume", type=int, default=None,
                    help="pk of an interrupted chain to resume")
    args = ap.parse_args()
    # fail before anything is stored: no card and no --device is an error
    resolve_device(args.device)

    store = configure_store("examples_out/train_lm.db")
    runner = Runner(store=store)
    set_default_runner(runner)

    if args.resume is not None:
        handle = runner.resume_from_checkpoint(args.resume)
        if handle is None:
            print(f"no checkpoint for pk={args.resume}")
            return
        runner.loop.run_until_complete(handle.process.wait_done())
        proc = handle.process
    else:
        # builder + launch API: raw python scalars/dicts are wrapped by
        # the port serializers, so provenance stays complete without
        # Int(...)/Dict(...) boilerplate at every call site
        builder = PretrainWorkChain.get_builder()
        builder.preset = PRESETS[args.preset]
        builder.total_steps = args.steps
        builder.chunk_steps = args.chunk
        builder.lr = args.lr
        if args.device is not None:
            builder.device = args.device
        builder.metadata.label = f"train-lm-{args.preset}"
        outputs, proc = run_get_node(builder)

    print(f"\nstate={proc.state.value} exit={proc.exit_code}")
    for log in store.get_logs(proc.pk):
        print("  [report]", log["message"])
    if "final_metrics" in proc.outputs:
        m = proc.outputs["final_metrics"].value
        print(f"loss: {m['losses'][0]:.3f} -> {m['final_loss']:.3f} "
              f"over {m['steps']} steps")


if __name__ == "__main__":
    main()
