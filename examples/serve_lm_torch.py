"""Continuous-batching LM serving on a small model, on the PyTorch port:
the twin of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/serve_lm_torch.py --batch 4 --requests 10
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

A :class:`~repro_torch.serving.serve.BatchScheduler` drives prefill +
per-slot-position decode: requests of different prompt lengths and
budgets are co-batched, evicted on completion, and replaced from the FIFO
queue mid-flight. ``--decode-impl pallas`` routes the decode inner
product through the port's decode-attention kernel (its plain version on
the CPU); ``--int8-kv`` quantises the KV cache.

It serves on the CUDA card unless ``--device cpu`` is given; without a
card and without that flag it raises. The reference's ``--platform`` and
``--devices`` flags (host-device forcing through ``setup_devices``) have
no counterpart here: the port does not have ``configs/devices.py`` yet,
and it serves on one device.
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.common import resolve_device
from repro_torch.models.registry import build
from repro_torch.serving.serve import BatchScheduler, Request


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu (default: the CUDA card)")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (micro-batch size)")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--decode-impl", default="pallas",
                    choices=["direct", "pallas"])
    ap.add_argument("--int8-kv", action="store_true")
    args = ap.parse_args()

    device = resolve_device(args.device)
    print(f"device: {device}")

    cfg = get_config("aiida-demo-110m").replace(
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=2, d_ff=704,
        vocab_size=8192, decode_impl=args.decode_impl,
        kv_cache_dtype="int8" if args.int8_kv else "bfloat16")
    bundle = build(cfg)
    params = bundle.init_params(0, device)

    max_len = args.max_prompt_len + args.new_tokens + 1
    sched = BatchScheduler(bundle, params, batch_size=args.batch,
                           max_len=max_len, device=device)

    # mixed-length prompts from a small length set
    rng = np.random.default_rng(0)
    lengths = [args.max_prompt_len, args.max_prompt_len // 2]
    t0 = time.time()
    for rid in range(args.requests):
        n = lengths[rid % len(lengths)]
        sched.submit(Request(
            rid=rid,
            prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
            max_new_tokens=args.new_tokens - (rid % 3) * 4))
    finished = sched.run()
    dt = time.time() - t0

    toks = sum(len(r.generated) for r in finished)
    print(f"served {len(finished)} requests through {args.batch} slots in "
          f"{dt:.2f}s ({toks} tokens, {toks/dt:.0f} tok/s, "
          f"decode_impl={args.decode_impl}, "
          f"kv={'int8' if args.int8_kv else 'bf16'})")
    for r in finished[:4]:
        print(f"  req {r.rid}: prompt {len(r.prompt):3d} tok -> "
              f"{len(r.generated):2d} new [{r.finish_reason}] "
              f"{r.generated[:8]} ...")


if __name__ == "__main__":
    main()
