#!/usr/bin/env python3
"""Wall time of ``chip_smoke.py``'s attention-kernel and hybrid phases, for
one or more checkouts of the repository, one after the other on one card.

    python3 scripts/smoke_phase_walls.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (say, this one and a ``git archive`` of
its parent unpacked under ``build/``). For each, a process of its own
builds that checkout's kernels and runs that checkout's phase functions:
2 (decode kernel), 3 (flash forward), 6 (flash backward), 10 (the hybrid's
serving), 11 (the hybrid's float32 card-vs-CPU serving) and 21 (the
families' training jobs), each timed by the host's clock, the hybrid's
weights drawn once between 6 and 10. The hybrid takes the configuration
that checkout's ``main()`` gives it. Prints the card's ``nvidia-smi`` line
and, per ROOT, one ``WALLS`` JSON line: each phase's seconds, the build's,
and the hybrid's training job's own ``wall_s`` from phase 21. Needs a CUDA
card; a phase that fails fails the run.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import inspect, json, re, sys, time
from pathlib import Path
root = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(root / "src"), str(root)]
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops

walls = {}
t = time.perf_counter()
_build.build_all()
walls["build"] = time.perf_counter() - t
expr = re.search(r"cfg_rg = (get_config\(HYBRID\)\.replace\([^)]*\))",
                 inspect.getsource(cs.main)).group(1)
cfg_rg = eval(expr, {"get_config": get_config, "HYBRID": cs.HYBRID})
counters = (da_ops.decode_attention, fa_ops.flash_attention_fwd,
            fa_ops.flash_attention_bwd_dq, fa_ops.flash_attention_bwd_dkv,
            rg_ops.rglru_scan)
out = {}
for name, fn in (
        ("2", lambda: cs.decode_phase(torch, da_ops, da_ref,
                                      _build.build_log("decode_attention"))),
        ("3", lambda: cs.flash_phase(torch, fa_ops, fa_ref,
                                     _build.build_log("flash_attention_fwd"))),
        ("6", lambda: cs.flash_bwd_phase(
            torch, fa_ops, fa_ref, _build.build_log("flash_attention_bwd"))),
        ("hybrid weights", lambda: out.setdefault(
            "params", cs.host_params(torch, cfg_rg, 10))),
        ("10", lambda: cs.hybrid_serve_phase(torch, cfg_rg, out["params"],
                                             counters)),
        ("11", lambda: cs.hybrid_parity_phase(torch, cfg_rg,
                                              out["params"])),
        ("21", lambda: cs.family_train_phase(torch, fa_ops, rg_ops))):
    if name == "21":
        del out["params"]
    t = time.perf_counter()
    out[name] = fn()
    walls[name] = time.perf_counter() - t
hybrid_job = out["21"]["recurrentgemma-2b"]
print("WALLS " + json.dumps({
    "root": str(root), "hybrid_attn_impl": cfg_rg.attn_impl,
    "walls_s": walls, "hybrid_train_job_wall_s": hybrid_job["wall_s"],
    "hybrid_train_launches": hybrid_job["launches"]}), flush=True)
'''


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in (str(Path(r).resolve()) for r in argv):
        got = subprocess.run([sys.executable, "-c", CHILD, root],
                             cwd=root, timeout=1500)
        if got.returncode:
            print(f"{root}: exit {got.returncode}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
