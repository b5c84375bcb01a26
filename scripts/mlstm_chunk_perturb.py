"""Where the chunkwise-mLSTM kernel's tensor-core body spends its time.

Builds variants of ``src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu``
with one piece of work taken out each (their outputs are wrong by design)
and times every variant against the unchanged body at the serving prefill
shape (B = 4, H = 4, S = 2048, hd = 512, bf16, chunks of 128), twice in
turn, with CUDA events. The difference from the unchanged body bounds
what that piece costs on the critical path; the pieces overlap, so the
differences do not add up. Needs the card and ``nvcc``; the variants are
built under the ignored ``build/mlstm_perturb/``.

    python3 scripts/mlstm_chunk_perturb.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# variant -> the replacements that take its piece of work out
VARIANTS = {
    "unchanged": [],
    "no update products": [("wgmma_rs(dacc, ", "if (0) wgmma_rs(dacc, ")],
    "no update operand": [
        ("update_operand(k_tile, ksc, 0,", "if (0) update_operand(k_tile, ksc, 0,"),
        ("update_operand(k_tile, ksc, quarter,",
         "if (0) update_operand(k_tile, ksc, quarter,")],
    "no q C_prev products": [("wgmma_ss_tb(hacc, ", "if (0) wgmma_ss_tb(hacc, ")],
    "no C_prev lo staging": [
        ("stage_c(Cs, gbase + OFF_STG, d0, tid, true);", "")],
    "no exp of att": [
        ("expf(((bt[half] - gb[s]) + gl[s]) - mo[half])", "1.f")],
    "no q n_prev": [("dot[half] = fmaf(qq.x, nv[2 * e], dot[half]);", ""),
                    ("dot[half] = fmaf(qq.y, nv[2 * e + 1], dot[half]);", "")],
    "no cumsum adds": [("acc += g[G_B + 32 * r + j];", "acc += 1.f;")],
}


def build(kernels, _build) -> dict:
    """Compile every variant in parallel; returns name -> launch function."""
    src = _build.source("mlstm_chunk")
    text = src.read_text()
    out = _build.BUILD_DIR.parent / "mlstm_perturb"
    shutil.rmtree(out, ignore_errors=True)
    # the source includes ../../_hopper/hopper.cuh from its csrc directory
    (out / "_hopper").mkdir(parents=True)
    shutil.copy(_build.KERNELS_DIR / _build.SHARED_DIR / "hopper.cuh",
                out / "_hopper")
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        body = text
        for old, new in subs:
            if old not in body:
                raise SystemExit(f"variant {name!r}: {old!r} is not in the "
                                 "source any more")
            body = body.replace(old, new)
        cu = out / f"v{i}" / "csrc" / "mlstm_chunk.cu"
        cu.parent.mkdir(parents=True)
        cu.write_text(body)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} did not build:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(so)).repro_mlstm_chunk
        fn.argtypes = kernels._launcher().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mlstm_chunk_perturb: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm_chunk import ops as ml_ops

    fns = build(ml_ops, _build)
    b, h, s, hd = 4, 4, 2048, 512
    gen = torch.Generator(device="cuda").manual_seed(5)
    sets = [cs.mlstm_inputs(torch, gen, b, h, s, hd, torch.bfloat16, False)
            for _ in range(2)]
    hs = torch.empty((b, h, s, hd), dtype=torch.bfloat16, device="cuda")
    state = (torch.empty((b, h, hd, hd), device="cuda"),
             torch.empty((b, h, hd), device="cuda"),
             torch.empty((b, h), device="cuda"))

    def call(fn, q, k, v, li, lf, C0, n0, m0):
        err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], li.data_ptr(),
                 lf.data_ptr(), C0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
                 hs.data_ptr(), *(t.data_ptr() for t in state), b, h, s, hd,
                 128, hd ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")

    print(cs.smi_line())
    times = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            times[name].append(cs.time_ms(
                torch, lambda *a, fn=fn: call(fn, *a), sets, iters=10))
    base = min(times["unchanged"])
    print(f"mLSTM tensor-core body at B={b} H={h} S={s} hd={hd} bf16, ms "
          "per call (two rounds), and the unchanged body's best less this "
          "variant's best:")
    for name, ms in times.items():
        print(f"  {name:22s} {ms[0]:.4f} {ms[1]:.4f}  "
              f"{base - min(ms):+.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
