"""Where whisper-large-v3's time goes on the card, beyond what the smoke
run prints.

Two measurements at full width and depth:

1. the training recipe of ``GPUTrainJob`` (phase 21 of ``chip_smoke.py``)
   run directly, timed in parts by the host clock: the fp32 parameters
   drawn on the host, the train state on the card, and each of two steps
   of 4 x 448 tokens beside 1500 frames per row (``attn_impl="pallas"``);
2. one whole bf16 prefill of 8 rows of 1500 frames and a 4-token prompt
   under ``torch.profiler`` (launches, device time), beside the count
   phase 22 scales from its 1 + 1 and 2 + 2 layer windows. The whole
   profile's ~6e5 kernels take the profiler minutes to process.

Needs the card; prints one JSON object as its last line.

    python3 scripts/whisper_probe_torch.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def train_parts(torch, cs) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    from repro_torch.training.optim import OptimConfig
    from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                                 make_train_step)

    cfg = get_config(cs.AUDIO).replace(attn_impl="pallas")
    bundle = build(cfg)
    steps = cs.AUDIO_TRAIN_STEPS
    tcfg = TrainConfig(optim=OptimConfig(lr=3e-4, total_steps=steps,
                                         warmup_steps=max(1, steps // 10)))
    t = time.perf_counter()
    bundle.init_params(0, "cpu")
    draw_s = time.perf_counter() - t
    t = time.perf_counter()
    state = init_train_state(bundle, tcfg, 0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    step_fn = make_train_step(bundle, tcfg)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(steps):
        tokens = rng.integers(0, cfg.vocab_size, (4, cs.AUDIO_MAX_LEN + 1),
                              dtype=np.int32)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                 for k, v in (("tokens", tokens[:, :-1]),
                              ("labels", tokens[:, 1:]))}
        batch.update(bundle.draw_extra_inputs(4, rng, "cuda"))
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        out.append({"step_s": time.perf_counter() - t, "loss": loss})
    peak = torch.cuda.max_memory_allocated()
    del state
    return {"host_draw_s": draw_s, "init_train_state_s": init_s,
            "steps": out, "peak_memory_bytes": peak}


def prefill_whole_and_scaled(torch, cs) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    from repro_torch.serving.serve import make_prefill_step

    cs.free_card(torch)
    cfg = get_config(cs.AUDIO).replace(param_dtype="bfloat16",
                                       attn_impl="pallas",
                                       decode_impl="pallas")
    params = cs.card_params(torch, cfg, 22)[0]
    bundle = build(cfg)
    prefill = make_prefill_step(bundle)
    gen = torch.Generator(device="cuda").manual_seed(22)
    batch = {"tokens": torch.randint(1, cfg.vocab_size,
                                     (cs.AUDIO_BATCH, cs.AUDIO_PROMPTS[0]),
                                     generator=gen, device="cuda")}
    for name, (shape, dtype) in bundle.extra_inputs(cs.AUDIO_BATCH).items():
        batch[name] = torch.randn(shape, generator=gen, device="cuda",
                                  dtype=dtype)

    def one():
        cache = bundle.init_cache(cs.AUDIO_BATCH, cs.AUDIO_MAX_LEN, "cuda")
        int(prefill(params, batch, cache)[0][0, 0])

    t = time.perf_counter()
    whole = cs.device_share(torch, one, 1, expect="flash_fwd")
    whole_s = time.perf_counter() - t
    scaled = cs.audio_prefill_profile(torch, cfg, params, batch,
                                      whole["wall_ms"])
    keys = ("wall_ms", "device_ms", "launches_per_run", "device_ms_by_kind")
    return {"whole": {k: whole[k] for k in keys},
            "whole_profile_s": whole_s,
            "scaled": {k: scaled[k] for k in keys}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("whisper_probe_torch: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build

    _build.build_all()
    smi = cs.smi_line()
    print(smi, flush=True)
    train = train_parts(torch, cs)
    print(f"train: {json.dumps(train)}", flush=True)
    prefill = prefill_whole_and_scaled(torch, cs)
    print(f"prefill: {json.dumps(prefill)}", flush=True)
    print(json.dumps({"nvidia_smi": smi, "train": train, "prefill": prefill}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
