#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Builds the port's CUDA kernels from
``src/repro_torch/kernels/*/csrc/*.cu`` (into the ignored ``build/``),
then:

1. prints the card's ``nvidia-smi`` name and power limit and what
   ``ptxas`` reported for each kernel;
2. holds the decode-attention kernel against its plain PyTorch version
   (ragged lengths incl. 0 and Smax; bf16 at 2e-2, f32 at 5e-5) and times
   kernel, plain version and SDPA;
3. does the same for the flash-attention forward kernel (out and lse;
   causal lengths 1/37/511/700, window, softcap, q_offset, and the
   training shape B = 8, S = 1024) and times it at the serving and at the
   training shapes;
4. serves 8 requests at the full width of ``aiida-demo-110m`` (bf16,
   random weights from a seed) through ``BatchScheduler`` and checks that
   every prefill and decode step went through the kernels;
5. serves 2 requests in float32 on the card and on the CPU (plain
   versions) and requires identical greedy tokens;
6. holds the two flash-attention backward kernels (dq pass, dk/dv pass)
   against their plain version on the card (MHA, GQA 4x, G = 3; S = 96,
   250, 1024; window, softcap, q_offset; f32 at 1e-4, bf16 at 2e-2, and
   each output's error within 1e-4 / 1e-2 of its norm), checks them again
   at the training shape (B = 8, S = 1024, bf16) and times each pass, the
   plain version and SDPA's backward there;
7. trains ``aiida-demo-110m`` at full width (bf16 activations, fp32
   parameters, AdamW, the config's remat policy) for 6 steps of 8 x 1024
   tokens through ``make_train_step`` and checks every loss is finite and
   every step launched 24 flash forwards (forward + remat recompute), 12
   dq and 12 dk/dv passes; prints tokens/s, ms per step, peak memory and a
   profiled step;
8. takes one full-width float32 train step's gradients on the card and on
   the CPU (plain versions) from the same parameters and batch, and holds
   loss, grad_norm (1e-4 relative) and every gradient leaf (1e-3 of its
   norm) together;
9. holds the RG-LRU scan kernel against its plain sequential version
   (B in 1/4, S in 1/37/1000/4096, D in 48/96/2560, fp32 and bf16 inputs,
   nonzero h0; 5e-5) and its backward (the reversed scan, through the
   autograd Function) against autograd of the plain version at
   (2, 1024, 2560) and (3, 333, 100) (1e-4), and times kernel and plain
   version at the prefill shape (4, 4096, 2560);
10. serves ``recurrentgemma-2b`` at full width and depth (26 layers, bf16,
   random weights from a seed, the config's chunked attention over a
   2048-slot ring, the scan kernel): 4 prompts of 4096 tokens, 64 greedy
   tokens each, through the serving steps; checks 18 scan launches in
   the prefill and none in the decode steps; prints prefill and decode
   times, tokens/s, peak memory and a profiled prefill and decode step;
11. serves the first 3 layers of the same parameters in float32 on the
   card and on the CPU (2 prompts of 2560 tokens, past the window, 8 new
   tokens) and requires identical greedy tokens;
12. holds the chunkwise mLSTM kernel against its plain chunkwise version
   (hs at 5e-5 / 2e-2, the fp32 state at 5e-5) and the sequential oracle
   (hs 1e-4, C 1e-3, m 1e-5, or, where the plain version is itself
   farther, no farther than it plus the first bar) over B in 1/4, H = 4,
   S in 1/37/96/2048 (L = 1, 37, 32, 96, 128), hd in 64/512, fp32 and
   bf16 q/k/v, zero and nonzero carried state, and times kernel and plain
   version at the prefill shape (4, 4, 2048, 512) bf16;
13. serves ``xlstm-350m`` at full width and depth (24 layers, sLSTM at
   7/15/23, bf16, random weights from a seed, the mLSTM kernel): 4
   prompts of 2048 tokens, 32 greedy tokens each, through the serving
   steps; checks 21 mLSTM launches in the prefill, none in the decode
   steps and none of the other kernels; prints prefill and decode times,
   tokens/s, peak memory and a profiled 512-token prefill and decode step;
14. serves the first 8 layers of the same parameters (the sLSTM at 7
   included) in float32 on the card and on the CPU (2 prompts of 1024
   tokens, 8 new tokens) and requires identical greedy tokens (reporting
   the top-2 logit margin where they differ).

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that line. Full results also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
TOL = {"bfloat16": 2e-2, "float32": 5e-5}
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# a backward output's error as a share of that output's norm: the
# elementwise bound above is loose for the small gradients of late rows
BWD_NORM_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
L2_BYTES = 50 * 2**20

ARCH = "aiida-demo-110m"
SERVE_BATCH, SERVE_MAX_LEN, SERVE_NEW = 4, 1024, 64
SERVE_PROMPTS = (96, 250, 511, 700)
N_REQUESTS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 6
PARITY_BATCH, PARITY_SEQ = 2, 256

HYBRID = "recurrentgemma-2b"
RG_D = 2560                        # its d_rnn
SERVE_RG_BATCH, SERVE_RG_PROMPT, SERVE_RG_NEW = 4, 4096, 64
PARITY_RG_BATCH, PARITY_RG_PROMPT, PARITY_RG_NEW, PARITY_RG_LAYERS = \
    2, 2560, 8, 3

XLSTM = "xlstm-350m"
X_HD = 512                         # its mLSTM head dim, 2 * 1024 / 4
SERVE_X_BATCH, SERVE_X_PROMPT, SERVE_X_NEW = 4, 2048, 32
SERVE_X_PROFILED = 512
PARITY_X_BATCH, PARITY_X_PROMPT, PARITY_X_NEW, PARITY_X_LAYERS = \
    2, 1024, 8, 8


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, arg_sets, iters: int = 40) -> float:
    """Mean ms per call of ``fn(*args)``, cycling through ``arg_sets``
    (enough copies to exceed the L2 cache, so every call reads its inputs
    from device memory as the serving path does)."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    return max(2, -(-2 * L2_BYTES // max(nbytes, 1)))


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def bwd_close(torch, got, want, dt_name: str, what: str) -> dict:
    """Hold backward outputs (dq, dk, dv) against the plain version's:
    elementwise at ``BWD_TOL`` and as a share of each output's norm at
    ``BWD_NORM_TOL``. Returns each output's max abs error and, under
    ``share_<name>``, its error as a share of its norm."""
    tol, norm_tol = BWD_TOL[dt_name], BWD_NORM_TOL[dt_name]
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite {name}")
        errs[name] = max_err(torch, g, w)
        check(torch.allclose(g, w, atol=tol, rtol=tol),
              f"{what}: {name} max abs err {errs[name]} > {tol}")
        share = float((g - w).norm() / w.norm().clamp_min(1e-30))
        check(share <= norm_tol,
              f"{what}: {name} error is {share:.3e} of its norm > {norm_tol}")
        errs[f"share_{name}"] = share
    return errs


# ---------------------------------------------------------------------------
# phase 2: decode attention
# ---------------------------------------------------------------------------

def decode_phase(torch, da_ops, da_ref) -> dict:
    b, h, hkv, hd, smax = 4, 12, 4, 64, 1024
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        for lens in ([0, 1, 130, 1023], [1024, 1023, 130, 0]):
            q = torch.randn(b, h, hd, generator=gen, device="cuda").to(dt)
            k = torch.randn(b, smax, hkv, hd, generator=gen,
                            device="cuda").to(dt)
            v = torch.randn(b, smax, hkv, hd, generator=gen,
                            device="cuda").to(dt)
            kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out = da_ops.decode_attention(q, k, v, kv)
            ref = da_ref.decode_attention_ref(q, k, v, kv,
                                              scale=hd ** -0.5)
            torch.cuda.synchronize()
            err = max_err(torch, out, ref)
            tol = TOL[dt_name]
            check(bool(torch.isfinite(out.float()).all()),
                  f"decode {dt_name} {lens}: non-finite output")
            check(torch.allclose(out.float(), ref.float(), atol=tol,
                                 rtol=tol),
                  f"decode {dt_name} {lens}: max abs err {err} > {tol}")
            for row, n in enumerate(lens):
                if n == 0:
                    check(bool((out[row] == 0).all()),
                          f"decode {dt_name}: kv_len=0 row is not zero")
            worst = max(worst, err)
            print(f"decode_attention {dt_name} kv_len={lens}: "
                  f"max_abs_err={err:.3e} (tol {tol})")

    # timing at the serving phase's shapes: bf16, mid-generation depths
    dt = torch.bfloat16
    lens = [n + SERVE_NEW // 2 for n in SERVE_PROMPTS]
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    es = 2
    cache_bytes = 2 * b * smax * hkv * hd * es
    sets = []
    for _ in range(copies_for(cache_bytes)):
        q = torch.randn(b, h, hd, device="cuda").to(dt)
        k = torch.randn(b, smax, hkv, hd, device="cuda").to(dt)
        v = torch.randn(b, smax, hkv, hd, device="cuda").to(dt)
        sets.append((q, k, v))
    ms = time_ms(torch, lambda q, k, v: da_ops.decode_attention(q, k, v, kv),
                 sets)
    plain_ms = time_ms(
        torch, lambda q, k, v: da_ref.decode_attention_ref(
            q, k, v, kv, scale=hd ** -0.5), sets)
    # library yardstick: SDPA over the same live keys (heads expanded and
    # moved first, outside the timed call)
    mask = (torch.arange(smax, device="cuda")[None, :] < kv[:, None])
    mask = mask[:, None, None, :]
    lib_sets = [(q[:, :, None, :],
                 k.transpose(1, 2).repeat_interleave(h // hkv, 1).contiguous(),
                 v.transpose(1, 2).repeat_interleave(h // hkv, 1).contiguous())
                for q, k, v in sets[:copies_for(cache_bytes * h // hkv)]]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(torch, lambda q, k, v: sdpa(q, k, v, attn_mask=mask),
                         lib_sets)
    live = sum(lens)
    nbytes = (2 * b * h * hd + 2 * live * hkv * hd) * es + 4 * b
    flops = 4 * live * h * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    print(f"decode_attention timing: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{max(t_bytes, t_ops):.5f} ms")
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "timed_at": f"B={b} H={h} Hkv={hkv} hd={hd} Smax={smax} bf16 "
                    f"kv_len={lens}",
    }


# ---------------------------------------------------------------------------
# phase 3: flash attention forward
# ---------------------------------------------------------------------------

def flash_phase(torch, fa_ops, fa_ref) -> dict:
    h, hkv, hd = 12, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [dict(sq=s, skv=s) for s in (1, 37, 511, 700)]
    cases += [dict(sq=700, skv=700, window=64),
              dict(sq=511, skv=511, softcap=30.0),
              dict(sq=37, skv=42, q_offset=5)]
    worst = 0.0
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        for c in cases:
            opts = dict(causal=True, window=c.get("window", 0),
                        scale=hd ** -0.5, softcap=c.get("softcap", 0.0),
                        q_offset=c.get("q_offset", 0))
            q = torch.randn(1, c["sq"], h, hd, generator=gen,
                            device="cuda").to(dt)
            k = torch.randn(1, c["skv"], hkv, hd, generator=gen,
                            device="cuda").to(dt)
            v = torch.randn(1, c["skv"], hkv, hd, generator=gen,
                            device="cuda").to(dt)
            out, lse = fa_ops.flash_attention_fwd(q, k, v, **opts)
            rout, rlse = fa_ref.flash_attention_ref(q, k, v, **opts)
            torch.cuda.synchronize()
            tol = TOL[dt_name]
            err = max(max_err(torch, out, rout), max_err(torch, lse, rlse))
            check(torch.allclose(out.float(), rout.float(), atol=tol,
                                 rtol=tol),
                  f"flash {dt_name} {c}: out max abs err "
                  f"{max_err(torch, out, rout)} > {tol}")
            check(torch.allclose(lse, rlse, atol=tol, rtol=tol),
                  f"flash {dt_name} {c}: lse max abs err "
                  f"{max_err(torch, lse, rlse)} > {tol}")
            worst = max(worst, err)
            print(f"flash_attention_fwd {dt_name} {c}: max_abs_err="
                  f"{err:.3e} (tol {tol})")

    # the training path's shape, bf16 causal: out and lse against the
    # plain version (the backward check in phase 6 takes them as given)
    dt = torch.bfloat16
    opts = dict(causal=True, window=0, scale=hd ** -0.5, softcap=0.0,
                q_offset=0)
    q = torch.randn(TRAIN_BATCH, TRAIN_SEQ, h, hd, generator=gen,
                    device="cuda").to(dt)
    k = torch.randn(TRAIN_BATCH, TRAIN_SEQ, hkv, hd, generator=gen,
                    device="cuda").to(dt)
    v = torch.randn(TRAIN_BATCH, TRAIN_SEQ, hkv, hd, generator=gen,
                    device="cuda").to(dt)
    out, lse = fa_ops.flash_attention_fwd(q, k, v, **opts)
    rout, rlse = fa_ref.flash_attention_ref(q, k, v, **opts)
    torch.cuda.synchronize()
    tol = TOL["bfloat16"]
    err = max(max_err(torch, out, rout), max_err(torch, lse, rlse))
    check(torch.allclose(out.float(), rout.float(), atol=tol, rtol=tol)
          and torch.allclose(lse, rlse, atol=tol, rtol=tol),
          f"flash bf16 B={TRAIN_BATCH} S={TRAIN_SEQ}: max abs err {err} > "
          f"{tol}")
    worst = max(worst, err)
    print(f"flash_attention_fwd bfloat16 B={TRAIN_BATCH} S={TRAIN_SEQ} "
          f"(training shape): max_abs_err={err:.3e} (tol {tol})")
    del q, k, v, out, lse, rout, rlse

    # serving: the mean per launch over the prompt lengths, as the serving
    # path launches each length equally often
    serve = [fwd_timing(torch, fa_ops, fa_ref, 1, s, h, hkv, hd)
             for s in SERVE_PROMPTS]
    serve = {key: sum(t[key] for t in serve) / len(serve) for key in serve[0]}
    serve["timed_at"] = (f"B=1 H={h} Hkv={hkv} hd={hd} bf16 causal, mean "
                         f"over S in {list(SERVE_PROMPTS)}")
    train = fwd_timing(torch, fa_ops, fa_ref, TRAIN_BATCH, TRAIN_SEQ, h, hkv,
                       hd)
    train["timed_at"] = (f"B={TRAIN_BATCH} S={TRAIN_SEQ} H={h} Hkv={hkv} "
                         f"hd={hd} bf16 causal")
    for path, t in (("serve", serve), ("train", train)):
        t["bound_ms"] = max(t["t_bytes"], t["t_ops"])
        t["bound_by"] = "bytes" if t["t_bytes"] >= t["t_ops"] else "operations"
        print(f"flash_attention_fwd timing ({path}, {t['timed_at']}): kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms")
    # the row's headline numbers are the serving shapes'; both paths'
    # numbers are under ``timing_by_path``
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:109",
        "max_abs_err": worst,
        **{key: serve[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "timed_at")},
        "timing_by_path": {"serve": serve, "train": train},
    }


def fwd_timing(torch, fa_ops, fa_ref, b, s, h, hkv, hd) -> dict:
    """Kernel, plain and SDPA ms of one bf16 causal forward at (b, s), and
    the two terms of its bound."""
    dt = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes = b * s * (2 * h + 2 * hkv) * hd * 2 + 4 * b * h * s
    sets = [(torch.randn(b, s, h, hd, device="cuda").to(dt),
             torch.randn(b, s, hkv, hd, device="cuda").to(dt),
             torch.randn(b, s, hkv, hd, device="cuda").to(dt))
            for _ in range(copies_for(nbytes))]
    ms = time_ms(torch, lambda q, k, v: fa_ops.flash_attention_fwd(q, k, v),
                 sets)
    plain_ms = time_ms(
        torch, lambda q, k, v: fa_ref.flash_attention_ref(
            q, k, v, causal=True, window=0, scale=hd ** -0.5, softcap=0.0,
            q_offset=0), sets[:4], iters=10)
    lib_sets = [(q.transpose(1, 2).contiguous(),
                 k.transpose(1, 2).repeat_interleave(h // hkv, 1)
                 .contiguous(),
                 v.transpose(1, 2).repeat_interleave(h // hkv, 1)
                 .contiguous()) for q, k, v in sets]
    library_ms = time_ms(torch, lambda q, k, v: sdpa(q, k, v, is_causal=True),
                         lib_sets)
    pairs = b * s * (s + 1) // 2
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "t_bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "t_ops": 4 * hd * h * pairs / PEAK_FLOPS["bfloat16"] * 1e3}


# ---------------------------------------------------------------------------
# phases 4 and 5: serving
# ---------------------------------------------------------------------------

def fan_in_scaled(cfg, params):
    """``params`` with the attention projections rescaled to std
    1/sqrt(fan-in of their contraction).

    The reference's init rule takes the fan-in from the stacked leaf's
    shape[-2]: the head count for wq/wk/wv (std 1/sqrt(12) and 1/sqrt(4)
    where the contraction runs over d_model = 768) and head_dim for wo.
    At full width that makes attention logits so large that softmax is
    nearly a hard argmax, which amplifies float32 rounding over 12
    layers until greedy tokens flip: on the CPU alone, the direct and
    kernel routes of the same package disagree on the first token. With
    fan-in-scaled projections identical greedy tokens test the port,
    not that amplification."""
    params["layers"]["attn"] = _scaled_attn(cfg, params["layers"]["attn"])
    return params


def _scaled_attn(cfg, attn):
    """A copy of one attention parameter dict (stacked or not) with the
    projections rescaled as :func:`fan_in_scaled` says."""
    out = dict(attn)
    for name in ("wq", "wk", "wv"):
        out[name] = attn[name] * (attn[name].shape[-2] / cfg.d_model) ** 0.5
    out["wo"] = attn["wo"] * (attn["wo"].shape[-2]
                              / (cfg.num_heads * cfg.hd)) ** 0.5
    return out


def serve(torch, cfg, prompts, new_tokens, batch, device, seed=0):
    from repro_torch.models.registry import build
    from repro_torch.serving.serve import BatchScheduler, Request

    bundle = build(cfg)
    params = fan_in_scaled(cfg, bundle.init_params(
        torch.Generator().manual_seed(seed), device))
    sched = BatchScheduler(bundle, params, batch_size=batch,
                           max_len=SERVE_MAX_LEN, device=device)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched, reqs


def device_share(torch, fn, n: int) -> dict:
    """Run ``fn`` ``n`` times under ``torch.profiler``: wall ms per run,
    the device time the profiler saw per run, the idle share, and the
    kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    evs = kernels or [e for e in prof.key_averages() if dev_us(e) > 0]
    device = sum(dev_us(e) for e in evs) / 1e3 / n
    top, by_kind = {}, {}
    for e in sorted(evs, key=dev_us, reverse=True):
        ms = dev_us(e) / 1e3 / n
        if len(top) < 8 or e.key[:60] in top:
            top[e.key[:60]] = top.get(e.key[:60], 0.0) + ms
        by_kind[kernel_kind(e.key)] = by_kind.get(kernel_kind(e.key), 0.0) + ms
    return {"wall_ms": wall, "device_ms": device,
            "idle_share": max(0.0, 1.0 - device / wall) if wall else None,
            "launches_per_run": sum(e.count for e in evs) / n,
            "top_device_ms": top, "device_ms_by_kind": by_kind}


def kernel_kind(name: str) -> str:
    """A device kernel's kind, by its name: one of the port's kernels,
    a matmul (cuBLAS), elementwise, a reduction, or other."""
    low = name.lower()
    for kind in ("decode_attention", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv", "rglru_scan", "mlstm_chunk"):
        if kind in low:
            return kind
    if any(t in low for t in ("nvjet", "gemm", "xmma", "cutlass")):
        return "matmul"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduction"
    return "other"


def serve_phase(torch, cfg_full, da_ops, fa_ops) -> dict:
    from repro_torch.models.registry import build
    from repro_torch.observability.metrics import get_registry
    from repro_torch.serving.serve import BatchScheduler, Request

    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, cfg_full.vocab_size,
                             (SERVE_PROMPTS[i % len(SERVE_PROMPTS)],),
                             generator=gen).tolist()
               for i in range(N_REQUESTS)]
    bundle = build(cfg_full)
    params = bundle.init_params(torch.Generator().manual_seed(0), "cuda")
    sched = BatchScheduler(bundle, params, batch_size=SERVE_BATCH,
                           max_len=SERVE_MAX_LEN, device="cuda")
    # warm-up (library handles, allocator) outside the counted run
    warm = Request(rid=-1, prompt=prompts[0][:16], max_new_tokens=4)
    sched.submit(warm)
    sched.run()
    torch.cuda.synchronize()

    steps = get_registry().counter("serving.decode_steps")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    steps_before = steps.value
    da_ops.decode_attention.launches = 0
    fa_ops.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode_launches = da_ops.decode_attention.launches
    flash_launches = fa_ops.flash_attention_fwd.launches
    decode_steps = steps.value - steps_before

    check(all(r.done and r.finish_reason == "length"
              and len(r.generated) == SERVE_NEW for r in reqs),
          "not every request finished with its 64 tokens: "
          f"{[(r.done, r.finish_reason, len(r.generated)) for r in reqs]}")
    check(all(0 <= t < cfg_full.vocab_size for r in reqs
              for t in r.generated), "a generated token is out of vocab")
    layers = cfg_full.num_layers
    check(flash_launches == layers * N_REQUESTS,
          f"flash launches {flash_launches} != {layers} x {N_REQUESTS}")
    check(decode_launches == layers * decode_steps,
          f"decode launches {decode_launches} != {layers} x {decode_steps}")
    tokens = sum(len(r.generated) for r in reqs)

    # per-request prefill and per-step decode time, host clock around work
    # that ends in a device sync (each step copies its tokens to the host)
    prefill_ms = []
    p700 = torch.tensor([prompts[SERVE_PROMPTS.index(700)]], device="cuda")
    for n in SERVE_PROMPTS:
        p = torch.tensor([prompts[SERVE_PROMPTS.index(n)]], device="cuda")
        row = bundle.init_cache(1, SERVE_MAX_LEN, "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        tok, _ = sched.prefill_step(sched.params, {"tokens": p}, row)
        int(tok[0, 0])
        prefill_ms.append((time.perf_counter() - t) * 1e3)
    toks = torch.ones((SERVE_BATCH, 1), dtype=torch.int64, device="cuda")
    pos = torch.tensor([n + SERVE_NEW // 2 for n in SERVE_PROMPTS],
                       device="cuda")
    step_ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        nxt, _ = sched.decode_step(sched.params, sched.cache, toks, pos)
        nxt.cpu()
        step_ms.append((time.perf_counter() - t) * 1e3)
    step_ms.sort()
    profiled = {
        "decode_step": device_share(torch, lambda: sched.decode_step(
            sched.params, sched.cache, toks, pos)[0].cpu(), 5),
        "prefill_700": device_share(torch, lambda: int(sched.prefill_step(
            sched.params, {"tokens": p700},
            bundle.init_cache(1, SERVE_MAX_LEN, "cuda"))[0][0, 0]), 3),
    }
    result = {
        "requests": N_REQUESTS, "tokens_generated": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "decode_steps": decode_steps,
        "flash_launches": flash_launches, "decode_launches": decode_launches,
        "prefill_ms_by_len": dict(zip(map(str, SERVE_PROMPTS), prefill_ms)),
        "prefill_ms_mean": sum(prefill_ms) / len(prefill_ms),
        "decode_step_ms_median": step_ms[len(step_ms) // 2],
        "profile": profiled,
    }
    print("serve: " + json.dumps(result))
    return result


def parity_phase(torch, cfg_full) -> dict:
    cfg32 = cfg_full.replace(dtype="float32", kv_cache_dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(1, cfg32.vocab_size, (n,), generator=gen)
               .tolist() for n in (96, 250)]
    _, on_card = serve(torch, cfg32, prompts, 8, 2, "cuda")
    _, on_cpu = serve(torch, cfg32, prompts, 8, 2, "cpu")
    card = [r.generated for r in on_card]
    cpu = [r.generated for r in on_cpu]
    check(card == cpu, f"f32 greedy tokens differ: card {card} cpu {cpu}")
    print(f"parity f32: card and cpu tokens identical: {card}")
    return {"tokens": card}


# ---------------------------------------------------------------------------
# phase 6: flash attention backward
# ---------------------------------------------------------------------------

def flash_bwd_phase(torch, fa_ops, fa_ref) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [dict(s=96, h=4, hkv=4), dict(s=250, h=8, hkv=2),
             dict(s=1024, h=12, hkv=4), dict(s=250, h=12, hkv=4, window=64),
             dict(s=250, h=12, hkv=4, softcap=30.0),
             dict(s=96, skv=128, h=12, hkv=4, q_offset=32)]
    hd = 64
    worst = {"dq": 0.0, "dkv": 0.0, "share_dq": 0.0, "share_dkv": 0.0}

    def note(errs):
        for key, names in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            worst[key] = max(worst[key], *(errs[n] for n in names))
            worst[f"share_{key}"] = max(worst[f"share_{key}"],
                                        *(errs[f"share_{n}"] for n in names))
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        for c in cases:
            sq, skv = c["s"], c.get("skv", c["s"])
            opts = dict(causal=True, window=c.get("window", 0),
                        scale=hd ** -0.5, softcap=c.get("softcap", 0.0),
                        q_offset=c.get("q_offset", 0))
            q = torch.randn(2, sq, c["h"], hd, generator=gen,
                            device="cuda").to(dt)
            k = torch.randn(2, skv, c["hkv"], hd, generator=gen,
                            device="cuda").to(dt)
            v = torch.randn(2, skv, c["hkv"], hd, generator=gen,
                            device="cuda").to(dt)
            do = torch.randn(2, sq, c["h"], hd, generator=gen,
                             device="cuda").to(dt)
            out, lse = fa_ops.flash_attention_fwd(q, k, v, **opts)
            got = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, **opts)
            want = fa_ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                  **opts)
            torch.cuda.synchronize()
            tol = BWD_TOL[dt_name]
            errs = bwd_close(torch, got, want, dt_name,
                             f"flash bwd {dt_name} {c}")
            note(errs)
            print(f"flash_attention_bwd {dt_name} {c}: max_abs_err " +
                  " ".join(f"{n}={e:.3e}" for n, e in errs.items()) +
                  f" (tol {tol}, {BWD_NORM_TOL[dt_name]} of the norm)")

    # the training phase's shapes, bf16 causal: checked on the first input
    # set (whose plain backward is also the one timed), then timed
    b, s, h, hkv, dt = TRAIN_BATCH, TRAIN_SEQ, 12, 4, torch.bfloat16
    opts = dict(causal=True, window=0, scale=hd ** -0.5, softcap=0.0,
                q_offset=0)
    q_bytes, kv_bytes, row_bytes = (b * s * h * hd * 2, b * s * hkv * hd * 2,
                                    b * h * s * 4)
    # what each pass reads: q, do; k, v; lse, delta (out only makes delta)
    nbytes_in = 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes
    sets = []
    for _ in range(copies_for(nbytes_in + q_bytes)):
        q = torch.randn(b, s, h, hd, device="cuda").to(dt)
        k = torch.randn(b, s, hkv, hd, device="cuda").to(dt)
        v = torch.randn(b, s, hkv, hd, device="cuda").to(dt)
        do = torch.randn(b, s, h, hd, device="cuda").to(dt)
        out, lse = fa_ops.flash_attention_fwd(q, k, v, **opts)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        sets.append((q, k, v, do, out, lse, delta))
    dq_ms = time_ms(torch, lambda q, k, v, do, out, lse, delta:
                    fa_ops.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                  opts), sets, iters=20)
    dkv_ms = time_ms(torch, lambda q, k, v, do, out, lse, delta:
                     fa_ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                    opts), sets, iters=20)
    q, k, v, do, out, lse, delta = sets[0]
    got = (fa_ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, opts),
           *fa_ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, opts))
    want = fa_ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **opts)
    torch.cuda.synchronize()
    errs = bwd_close(torch, got, want, "bfloat16",
                     f"flash bwd bfloat16 B={b} S={s} (training shape)")
    note(errs)
    print(f"flash_attention_bwd bfloat16 B={b} S={s} (training shape): "
          "max_abs_err " + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
          + f" (tol {BWD_TOL['bfloat16']}, {BWD_NORM_TOL['bfloat16']} of the "
          "norm)")
    del got, want
    plain_ms = time_ms(torch, lambda q, k, v, do, out, lse, delta:
                       fa_ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                      **opts),
                       sets[:1], iters=3)
    # library yardstick: SDPA's backward (both passes and its own delta)
    # with the KV heads expanded outside the timed call
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = []
    for q, k, v, do, *_ in sets:
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt = k.transpose(1, 2).repeat_interleave(h // hkv, 1).contiguous() \
            .requires_grad_(True)
        vt = v.transpose(1, 2).repeat_interleave(h // hkv, 1).contiguous() \
            .requires_grad_(True)
        lib.append((sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt),
                    do.transpose(1, 2).contiguous()))
    library_ms = time_ms(torch, lambda o, ins, g: torch.autograd.grad(
        o, ins, g, retain_graph=True), lib, iters=20)
    del lib, sets

    pairs = b * h * s * (s + 1) // 2
    rows = []
    for name, ms, products, out_bytes, line in (
            ("dq", dq_ms, 3, q_bytes, 298),
            ("dkv", dkv_ms, 4, 2 * kv_bytes, 329)):
        t_bytes = (nbytes_in + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = products * 2 * hd * pairs / PEAK_FLOPS["bfloat16"] * 1e3
        rows.append({
            "name": f"flash_attention_bwd_{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_bwd.cu",
            "replaces": f"src/repro/kernels/flash_attention/kernel.py:{line}",
            "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
            "max_norm_share": worst[f"share_{name}"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "timed_at": f"B={b} S={s} H={h} Hkv={hkv} hd={hd} bf16 causal; "
                        "plain_ms and library_ms are the whole backward "
                        "(dq, dk and dv in one call)",
        })
        print(f"flash_attention_bwd_{name} timing: kernel {ms:.4f} ms, "
              f"plain (whole bwd) {plain_ms:.4f} ms, sdpa bwd (whole) "
              f"{library_ms:.4f} ms, bound {max(t_bytes, t_ops):.5f} ms")
    return rows


# ---------------------------------------------------------------------------
# phases 7 and 8: training
# ---------------------------------------------------------------------------

def train_phase(torch, cfg_full, fa_ops) -> dict:
    from repro_torch.models.registry import build
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.train_step import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)

    cfg = cfg_full
    bundle = build(cfg)
    tcfg = TrainConfig()
    state = init_train_state(bundle, tcfg, 0, "cuda")
    step_fn = make_train_step(bundle, tcfg)
    data = TokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  batch_size=TRAIN_BATCH, seed=0))
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                data.next_batch().items()} for _ in range(TRAIN_STEPS + 1)]
    counters = (fa_ops.flash_attention_fwd, fa_ops.flash_attention_bwd_dq,
                fa_ops.flash_attention_bwd_dkv)
    # forward + the remat recompute, unless the policy saves everything
    recompute = cfg.remat_policy not in ("off", "everything_saveable")
    per_step = (cfg.num_layers * (2 if recompute else 1), cfg.num_layers,
                cfg.num_layers)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    losses, step_ms, launches = [], [], []
    for i in range(TRAIN_STEPS):
        before = [c.launches for c in counters]
        t = time.perf_counter()
        state, metrics = step_fn(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        launches.append([c.launches - n for c, n in zip(counters, before)])
        losses.append(float(metrics["loss"]))
    totals = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated()

    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(all(tuple(n) == per_step for n in launches),
          f"launches per step (fwd, dq, dkv) {launches} != {per_step}")
    check(int(state["step"]) == TRAIN_STEPS, "step counter did not advance")
    timed = sorted(step_ms[1:])                    # step 1 is warm-up
    median = timed[len(timed) // 2]

    box = {"state": state}

    def one_step():
        box["state"], m = step_fn(box["state"], batches[-1])
        float(m["loss"])

    profiled = device_share(torch, one_step, 1)
    result = {
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "remat_policy": cfg.remat_policy, "losses": losses,
        "step_ms": step_ms, "step_ms_median": median,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
        "peak_memory_bytes": peak,
        "launches_per_step_fwd_dq_dkv": list(per_step),
        "launches": dict(zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv"), totals)),
        "profile": profiled,
    }
    print("train: " + json.dumps(result))
    return result


def train_parity_phase(torch, cfg_full) -> dict:
    from repro_torch.models.common import map_tree, tree_leaves
    from repro_torch.models.registry import build
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.optim import clip_by_global_norm
    from repro_torch.training.train_step import value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_full.replace(dtype="float32")
    bundle = build(cfg)
    params = fan_in_scaled(cfg, bundle.init_params(
        torch.Generator().manual_seed(7), "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=PARITY_SEQ,
        batch_size=PARITY_BATCH, seed=1)).next_batch().items()}
    runs = {}
    for dev in ("cuda", "cpu"):
        p = map_tree(lambda t: t.to(dev), params)
        (loss, _), grads = value_and_grad(
            bundle, p, {k: t.to(dev) for k, t in batch.items()})
        _, norm = clip_by_global_norm(grads, 1.0)
        runs[dev] = (float(loss), float(norm),
                     {k: g.cpu() for k, g in tree_leaves(grads)})
    (l_card, n_card, g_card), (l_cpu, n_cpu, g_cpu) = runs["cuda"], runs["cpu"]
    check(abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu),
          f"f32 loss card {l_card} cpu {l_cpu}")
    check(abs(n_card - n_cpu) <= 1e-4 * abs(n_cpu),
          f"f32 grad_norm card {n_card} cpu {n_cpu}")
    leaf_err = {}
    for key, g in g_card.items():
        ref = g_cpu[key]
        leaf_err[key] = float((g - ref).norm() / ref.norm().clamp_min(1e-30))
        check(leaf_err[key] <= 1e-3,
              f"f32 gradient {key}: relative error {leaf_err[key]}")
    result = {"loss": [l_card, l_cpu], "grad_norm": [n_card, n_cpu],
              "worst_leaf_rel_err": max(leaf_err.values()),
              "leaf_rel_err": leaf_err}
    print(f"train parity f32: loss card {l_card:.7f} cpu {l_cpu:.7f}, "
          f"grad_norm card {n_card:.6f} cpu {n_cpu:.6f}, worst leaf "
          f"{result['worst_leaf_rel_err']:.3e}")
    return result


# ---------------------------------------------------------------------------
# phase 9: the RG-LRU scan
# ---------------------------------------------------------------------------

def rglru_phase(torch, rg_ops, rg_ref) -> dict:
    """The scan kernel against the plain sequential scan: a forward sweep
    (B, S, D, fp32 and bf16 inputs, nonzero h0; 5e-5 abs and rel), the
    backward through the autograd Function against autograd through the
    plain version (1e-4), then kernel and plain timed at the prefill
    shape."""
    gen = torch.Generator(device="cuda").manual_seed(9)

    def inputs(b, s, d, dt, g=gen):
        a = (0.5 + 0.5 * torch.rand(b, s, d, generator=g, device="cuda"))
        x = torch.randn(b, s, d, generator=g, device="cuda")
        h0 = torch.randn(b, d, generator=g, device="cuda")
        return a.to(dt), x.to(dt), h0

    worst = 0.0
    tol = TOL["float32"]
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for b in (1, 4):
            for s in (1, 37, 1000, 4096):
                for d in (48, 96, RG_D):
                    a, x, h0 = inputs(b, s, d, dt)
                    hs, h_last = rg_ops.rglru_scan(a, x, h0)
                    rhs, rh_last = rg_ref.rglru_scan_ref(a, x, h0)
                    torch.cuda.synchronize()
                    err = max(max_err(torch, hs, rhs),
                              max_err(torch, h_last, rh_last))
                    check(hs.dtype == torch.float32 and hs.shape == (b, s, d)
                          and h_last.shape == (b, d),
                          f"rglru {dt_name} {(b, s, d)}: outputs "
                          f"{hs.dtype} {tuple(hs.shape)} "
                          f"{tuple(h_last.shape)}")
                    check(torch.allclose(hs, rhs, atol=tol, rtol=tol)
                          and torch.allclose(h_last, rh_last, atol=tol,
                                             rtol=tol),
                          f"rglru {dt_name} {(b, s, d)}: max abs err {err} "
                          f"> {tol}")
                    worst = max(worst, err)
        print(f"rglru_scan {dt_name} forward sweep B in (1, 4), S in (1, 37, "
              f"1000, 4096), D in (48, 96, {RG_D}): max_abs_err so far "
              f"{worst:.3e} (tol {tol})")

    # backward: the kernel's autograd Function (forward scan, reversed scan)
    # against autograd through the plain loop, for random cotangents
    btol = BWD_TOL["float32"]
    bwd_worst = 0.0
    for b, s, d in ((2, 1024, RG_D), (3, 333, 100)):
        a, x, h0 = inputs(b, s, d, torch.float32)
        ghs = torch.randn(b, s, d, generator=gen, device="cuda")
        ghl = torch.randn(b, d, generator=gen, device="cuda")
        grads = []
        for fn in (rg_ops.rglru_scan, rg_ref.rglru_scan_ref):
            ins = [t.clone().requires_grad_(True) for t in (a, x, h0)]
            hs, h_last = fn(*ins)
            grads.append(torch.autograd.grad(
                (hs * ghs).sum() + (h_last * ghl).sum(), ins))
        torch.cuda.synchronize()
        for name, g, w in zip(("da", "dx", "dh0"), *grads):
            err = max_err(torch, g, w)
            check(torch.allclose(g, w, atol=btol, rtol=btol),
                  f"rglru bwd {(b, s, d)}: {name} max abs err {err} > {btol}")
            bwd_worst = max(bwd_worst, err)
        print(f"rglru_scan backward {(b, s, d)}: max_abs_err {bwd_worst:.3e} "
              f"(tol {btol})")

    # timing at the prefill shape: fp32 a and bx, as rglru_gates gives them
    b, s, d = SERVE_RG_BATCH, SERVE_RG_PROMPT, RG_D
    elems = b * s * d
    nbytes = 12 * elems + 8 * b * d       # a, x in; hs out; h0 in, h_last out
    sets = [inputs(b, s, d, torch.float32, None)
            for _ in range(copies_for(8 * elems))]
    ms = time_ms(torch, rg_ops.rglru_scan, sets, iters=20)
    plain_ms = time_ms(torch, rg_ref.rglru_scan_ref, sets[:1], iters=2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * elems / PEAK_FLOPS["float32"] * 1e3
    del sets
    print(f"rglru_scan timing (B={b} S={s} D={d} fp32): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.5f} ms, "
          "library none")
    return {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:52",
        "max_abs_err": worst, "bwd_max_abs_err": bwd_worst,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # no single PyTorch call computes a linear recurrence
        "library_ms": None,
        "timed_at": f"B={b} S={s} D={d} fp32 a and x",
    }


# ---------------------------------------------------------------------------
# phases 10 and 11: hybrid (recurrentgemma-2b) serving
# ---------------------------------------------------------------------------

def host_params(torch, cfg, seed):
    """fp32 master parameters of ``cfg`` on the host, from ``seed``. Drawn
    once: a family's serving and parity phases both take them."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import build

    t = time.perf_counter()
    params = build(cfg).init_params(torch.Generator().manual_seed(seed),
                                    "cpu")
    n = sum(p.numel() for _, p in tree_leaves(params))
    print(f"{cfg.name} parameters: {n} (fp32, drawn on the host in "
          f"{time.perf_counter() - t:.1f}s)")
    return params


def greedy(torch, bundle, params, prompts, new_tokens, max_len, device,
           counter):
    """Prefill a batch of equal-length prompts, then ``new_tokens - 1``
    greedy decode steps, through the serving steps. Returns the
    (B, new_tokens) tokens, the host ms of the prefill and of each decode
    step, the launches ``counter`` (a kernel wrapper) counted in the
    prefill and in the decode steps, and the state the run leaves."""
    from repro_torch.serving.serve import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(bundle), make_decode_step(bundle)
    cache = bundle.init_cache(len(prompts), max_len, device)
    toks = torch.tensor(prompts, device=device)
    n = toks.shape[1]
    if device == "cuda":
        torch.cuda.synchronize()
    before = counter.launches
    t = time.perf_counter()
    tok, cache = prefill(params, {"tokens": toks}, cache)
    out = [tok.cpu()]                    # the host reads every step's tokens
    prefill_ms = (time.perf_counter() - t) * 1e3
    mid = counter.launches
    step_ms = []
    for i in range(new_tokens - 1):
        t = time.perf_counter()
        tok, cache = decode(params, cache, tok.long(),
                            torch.tensor(n + i, device=device))
        out.append(tok.cpu())
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = (mid - before, counter.launches - mid)
    return torch.cat(out, dim=1), prefill_ms, step_ms, launches, cache


def hybrid_serve_phase(torch, cfg, params, counters) -> dict:
    """Full-width, full-depth serving in bf16: 4 prompts of 4096 tokens
    (past the 2048-slot ring, so the prefill's ring wraps), 64 greedy
    tokens each. Every prefill must launch the scan kernel once per RG-LRU
    layer and no decode step may launch it."""
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.models.common import cast_for_compute
    from repro_torch.models.registry import build
    from repro_torch.models.rglru import layer_kinds
    from repro_torch.serving.serve import make_decode_step, make_prefill_step

    bundle = build(cfg)
    n_rglru = layer_kinds(cfg).count("rglru")
    t = time.perf_counter()
    dev_params = cast_for_compute(params, cfg.activation_dtype,
                                  torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"hybrid weights on the card in {time.perf_counter() - t:.1f}s")
    gen = torch.Generator().manual_seed(11)
    prompts = torch.randint(1, cfg.vocab_size,
                            (SERVE_RG_BATCH, SERVE_RG_PROMPT),
                            generator=gen).tolist()
    max_len = SERVE_RG_PROMPT + SERVE_RG_NEW
    # warm-up (library handles, allocator) outside the counted run
    scan = rg_ops.rglru_scan
    greedy(torch, bundle, dev_params, [p[:512] for p in prompts], 2, 1024,
           "cuda", scan)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    t = time.perf_counter()
    tokens, prefill_ms, step_ms, (pre_l, dec_l), cache = greedy(
        torch, bundle, dev_params, prompts, SERVE_RG_NEW, max_len, "cuda",
        scan)
    wall = time.perf_counter() - t
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    check(tuple(tokens.shape) == (SERVE_RG_BATCH, SERVE_RG_NEW),
          f"hybrid tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "a generated token is out of vocab")
    check(pre_l == n_rglru,
          f"rglru launches per prefill {pre_l} != {n_rglru}")
    check(dec_l == 0,
          f"rglru launches in {SERVE_RG_NEW - 1} decode steps {dec_l} != 0")
    check(launches["rglru_scan"] == n_rglru,
          f"rglru launches in the run {launches['rglru_scan']} != {n_rglru}")
    check(all(bool(torch.isfinite(t.float()).all()) for st in cache
              for t in st.values()), "non-finite serving state")

    # one profiled prefill, and decode steps from the state the run left
    prefill = make_prefill_step(bundle)
    decode = make_decode_step(bundle)
    toks = torch.tensor(prompts, device="cuda")
    last = tokens[:, -1:].to("cuda").long()
    pos = torch.tensor(max_len - 1, device="cuda")
    profiled = {
        "prefill": device_share(torch, lambda: prefill(
            dev_params, {"tokens": toks},
            bundle.init_cache(SERVE_RG_BATCH, max_len, "cuda"))[0].cpu(), 1),
        "decode_step": device_share(torch, lambda: decode(
            dev_params, cache, last, pos)[0].cpu(), 5),
    }
    decode_median = sorted(step_ms)[len(step_ms) // 2]
    result = {
        "batch": SERVE_RG_BATCH, "prompt": SERVE_RG_PROMPT,
        "new_tokens": SERVE_RG_NEW, "layers": cfg.num_layers,
        "rglru_layers": n_rglru, "window": cfg.local_window,
        "attn_impl": cfg.attn_impl, "wall_s": wall,
        "tokens_per_s": SERVE_RG_BATCH * SERVE_RG_NEW / wall,
        "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": SERVE_RG_BATCH * SERVE_RG_PROMPT
        / (prefill_ms / 1e3),
        "decode_step_ms_median": decode_median,
        "decode_tokens_per_s": SERVE_RG_BATCH / (decode_median / 1e3),
        "peak_memory_bytes": peak,
        "rglru_launches_prefill": pre_l, "rglru_launches_decode": dec_l,
        "launches": launches,
        "first_tokens": tokens[:, :8].tolist(),
        "profile": profiled,
    }
    print("hybrid serve: " + json.dumps(result))
    return result


def hybrid_parity_phase(torch, cfg, params) -> dict:
    """The first Griffin unit (rglru, rglru, attn) of the same parameters
    at full width in float32, on the card (scan kernel) and on the CPU
    (plain versions): identical greedy tokens for prompts past the
    window."""
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.models.common import cast_for_compute
    from repro_torch.models.registry import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.replace(num_layers=PARITY_RG_LAYERS, dtype="float32",
                      kv_cache_dtype="float32")
    layers = [dict(lp, kind_attn=dict(lp["kind_attn"], attn=_scaled_attn(
        cfg, lp["kind_attn"]["attn"]))) if "kind_attn" in lp else lp
        for lp in params["layers"][:PARITY_RG_LAYERS]]
    sub = {"embedding": params["embedding"], "layers": layers,
           "ln_final": params["ln_final"]}
    bundle = build(cfg)
    gen = torch.Generator().manual_seed(12)
    prompts = torch.randint(1, cfg.vocab_size,
                            (PARITY_RG_BATCH, PARITY_RG_PROMPT),
                            generator=gen).tolist()
    max_len = PARITY_RG_PROMPT + PARITY_RG_NEW
    runs = {}
    for dev in ("cuda", "cpu"):
        p = cast_for_compute(sub, torch.float32, torch.device(dev))
        runs[dev] = greedy(torch, bundle, p, prompts, PARITY_RG_NEW,
                           max_len, dev, rg_ops.rglru_scan)
    card, cpu = runs["cuda"][0].tolist(), runs["cpu"][0].tolist()
    check(card == cpu, f"hybrid f32 greedy tokens differ: card {card} "
                       f"cpu {cpu}")
    check(runs["cuda"][3] == (2, 0),
          f"hybrid parity rglru launches (prefill, decode) "
          f"{runs['cuda'][3]} != (2, 0)")
    print(f"hybrid parity f32 ({PARITY_RG_LAYERS} layers, B="
          f"{PARITY_RG_BATCH}, prompt {PARITY_RG_PROMPT}): card and cpu "
          f"tokens identical: {card}")
    return {"tokens": card, "prefill_ms": {d: r[1] for d, r in runs.items()}}


# ---------------------------------------------------------------------------
# phases 12 to 14: the chunkwise mLSTM and xlstm-350m serving
# ---------------------------------------------------------------------------

def mlstm_inputs(torch, gen, b, h, s, hd, dt, state):
    """The reference's sweep inputs (``tests/test_kernels.py:258-265``) on
    the card; with ``state``, a nonzero finite (C0, n0, m0)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k, v = (randn(b, h, s, hd).to(dt) for _ in range(3))
    li = randn(b, h, s)
    lf = -(1 + 0.5 * randn(b, h, s)).abs()
    if state:
        C0, n0, m0 = 0.5 * randn(b, h, hd, hd), 0.5 * randn(b, h, hd), \
            randn(b, h)
    else:
        C0 = torch.zeros((b, h, hd, hd), device="cuda")
        n0 = torch.zeros((b, h, hd), device="cuda")
        m0 = torch.full((b, h), -1e30, device="cuda")
    return q, k, v, li, lf, C0, n0, m0


def mlstm_case(torch, ml_ops, ml_ref, ins, chunk, dt_name, what) -> dict:
    """One sweep case: the kernel against the plain chunkwise version (hs
    at TOL, the fp32 state at 5e-5) and against the sequential oracle at
    the reference's bars, absolute (bf16 hs at the bf16 bar, absolute and
    relative). Where the chunkwise formulation itself (the plain version,
    the kernel body's arithmetic) is farther from the oracle than a bar,
    the kernel may be no farther than it is plus the kernel-vs-plain bar:
    at S = 2048 its exponents carry the rounding of cumsums near -128, and
    the reference's own kernel is 1.4e-4 to 2.5e-4 from its oracle in hs.
    Returns the errors, and the plain version's where it passes a bar."""
    tol = TOL[dt_name]
    q = ins[0]
    hs, st = ml_ops.mlstm_chunk(*ins, chunk=chunk)
    phs, pst = ml_ref.mlstm_chunkwise_ref(*ins, chunk=chunk)
    ohs, ost = ml_ref.mlstm_recurrent_ref(*ins)
    torch.cuda.synchronize()
    check(hs.dtype == q.dtype and hs.shape == q.shape
          and all(t.dtype == torch.float32 for t in st),
          f"{what}: outputs {hs.dtype} {tuple(hs.shape)}")
    check(all(bool(torch.isfinite(t.float()).all()) for t in (hs, *st)),
          f"{what}: non-finite output")
    err = max_err(torch, hs, phs)
    check(torch.allclose(hs.float(), phs.float(), atol=tol, rtol=tol),
          f"{what}: hs vs plain {err} > {tol}")
    for name, g, w in zip("Cnm", st, pst):
        e = max_err(torch, g, w)
        check(torch.allclose(g, w, atol=5e-5, rtol=5e-5),
              f"{what}: {name} vs plain {e} > 5e-5")
        err = max(err, e)
    out, beyond = {"plain": err}, {}
    bars = {"hs": 1e-4 if dt_name == "float32" else tol, "C": 1e-3,
            "m": 1e-5}
    for name, g, p, w in (("hs", hs, phs, ohs), ("C", st[0], pst[0], ost[0]),
                          ("m", st[2], pst[2], ost[2])):
        e, pe = max_err(torch, g, w), max_err(torch, p, w)
        bar = bars[name]
        if pe > bar:
            beyond[name] = pe
            bar = pe + (tol if name == "hs" else 5e-5)
        rtol = bars[name] if g.dtype == torch.bfloat16 else 0.0
        check(torch.allclose(g.float(), w.float(), atol=bar, rtol=rtol),
              f"{what}: {name} vs oracle {e} > {bar} (plain version {pe})")
        out[f"oracle_{name}"] = e
    return out, beyond


def mlstm_phase(torch, ml_ops, ml_ref) -> dict:
    """The chunkwise mLSTM kernel against its plain versions
    (:func:`mlstm_case`) over a sweep: B in 1/4, H = 4, S in 1/37/96/2048
    with chunks giving L = 1, 37, 32, 96, 128; hd in 64/512; fp32 and bf16
    q/k/v; zero and nonzero carried state. Then the kernel and the plain
    chunkwise version timed at the prefill shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(13)
    lengths = ((1, 128), (37, 128), (37, 16), (96, 128), (96, 64),
               (SERVE_X_PROMPT, 128))
    worst = {}
    beyond = {}       # the plain version's worst oracle error past a bar
    cases = 0
    for dt_name, b, (s, chunk), hd, state in itertools.product(
            ("float32", "bfloat16"), (1, SERVE_X_BATCH), lengths, (64, X_HD),
            (False, True)):
        what = (f"mlstm {dt_name} B={b} S={s} chunk={chunk} hd={hd} "
                f"state={state}")
        ins = mlstm_inputs(torch, gen, b, 4, s, hd, getattr(torch, dt_name),
                           state)
        errs, past = mlstm_case(torch, ml_ops, ml_ref, ins, chunk, dt_name,
                                what)
        for name, e in errs.items():
            key = f"{dt_name}_{name}"
            worst[key] = max(worst.get(key, 0.0), e)
        for name, e in past.items():
            beyond[name] = max(beyond.get(name, 0.0), e)
        cases += 1
    print(f"mlstm_chunk sweep, {cases} cases: worst errors {worst}; the "
          f"plain chunkwise version's own oracle error where it passes a "
          f"bar: {beyond}")

    # timing at the prefill shape: bf16 q/k/v, zero initial state
    b, h, s, hd = SERVE_X_BATCH, 4, SERVE_X_PROMPT, X_HD
    L = ml_ref.chunk_len(s, 128)
    qkv_bytes = 3 * b * h * s * hd * 2
    sets = [mlstm_inputs(torch, gen, b, h, s, hd, torch.bfloat16, False)
            for _ in range(copies_for(qkv_bytes))]
    ms = time_ms(torch, lambda *a: ml_ops.mlstm_chunk(*a, chunk=L), sets,
                 iters=10)
    plain_ms = time_ms(torch,
                       lambda *a: ml_ref.mlstm_chunkwise_ref(*a, chunk=L),
                       sets, iters=4)
    del sets
    state_bytes = 4 * b * h * (hd * hd + hd + 1)
    nbytes = (4 * b * h * s * hd * 2        # q, k, v in, hs out (bf16)
              + 2 * b * h * s * 4           # li, lf
              + 2 * state_bytes)            # (C0, n0, m0) in, (C, n, m) out
    nc = s // L
    # per (b, h, chunk): q k^T and att v (2 L^2 hd each), q C and the
    # k^T v update (2 L hd^2 each)
    flops = b * h * nc * (4 * L * L * hd + 4 * L * hd * hd)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    print(f"mlstm_chunk timing (B={b} H={h} S={s} hd={hd} L={L} bf16): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{max(t_bytes, t_ops):.5f} ms ({nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.1f} GFLOP), library none")
    return {
        "name": "mlstm_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:91",
        "max_abs_err": max(worst["float32_plain"], worst["bfloat16_plain"]),
        "errors": worst, "plain_oracle_err_past_bar": beyond,
        "cases": cases, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # no single PyTorch call computes a chunkwise mLSTM
        "library_ms": None,
        "timed_at": f"B={b} H={h} S={s} hd={hd} L={L} bf16 q/k/v",
    }


def ssm_serve_phase(torch, cfg, params, counters) -> dict:
    """Full-width, full-depth xlstm-350m serving in bf16: 4 prompts of
    2048 tokens, 32 greedy tokens each, through the serving steps. Every
    prefill must launch the mLSTM kernel once per mLSTM layer (21), no
    decode step may launch it, and no other kernel runs."""
    from repro_torch.kernels.mlstm_chunk import ops as ml_ops
    from repro_torch.models.common import cast_for_compute
    from repro_torch.models.registry import build
    from repro_torch.models.xlstm import slstm_positions
    from repro_torch.serving.serve import make_decode_step, make_prefill_step

    bundle = build(cfg)
    n_mlstm = cfg.num_layers - len(slstm_positions(cfg))
    t = time.perf_counter()
    dev_params = cast_for_compute(params, cfg.activation_dtype,
                                  torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"xlstm weights on the card in {time.perf_counter() - t:.1f}s")
    gen = torch.Generator().manual_seed(15)
    prompts = torch.randint(1, cfg.vocab_size,
                            (SERVE_X_BATCH, SERVE_X_PROMPT),
                            generator=gen).tolist()
    max_len = SERVE_X_PROMPT + SERVE_X_NEW
    mlstm = ml_ops.mlstm_chunk
    # warm-up (library handles, allocator) outside the counted run
    greedy(torch, bundle, dev_params, [p[:256] for p in prompts], 2, 512,
           "cuda", mlstm)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    t = time.perf_counter()
    tokens, prefill_ms, step_ms, (pre_l, dec_l), cache = greedy(
        torch, bundle, dev_params, prompts, SERVE_X_NEW, max_len, "cuda",
        mlstm)
    wall = time.perf_counter() - t
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    check(tuple(tokens.shape) == (SERVE_X_BATCH, SERVE_X_NEW),
          f"xlstm tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "a generated token is out of vocab")
    check(pre_l == n_mlstm,
          f"mlstm launches per prefill {pre_l} != {n_mlstm}")
    check(dec_l == 0,
          f"mlstm launches in {SERVE_X_NEW - 1} decode steps {dec_l} != 0")
    others = {k: n for k, n in launches.items() if k != "mlstm_chunk"}
    check(launches["mlstm_chunk"] == n_mlstm and not any(others.values()),
          f"launches in the xlstm run {launches}")
    check(all(bool(torch.isfinite(t.float()).all()) for st in cache
              for t in st.values()), "non-finite serving state")

    # profiled: a decode step from the state the run left, and a prefill
    # of 512-token prompts (the 2048-token prefill's sLSTM loop makes ~2e5
    # launches, too many events for a tractable trace)
    prefill = make_prefill_step(bundle)
    decode = make_decode_step(bundle)
    short = torch.tensor([p[:SERVE_X_PROFILED] for p in prompts],
                         device="cuda")
    last = tokens[:, -1:].to("cuda").long()
    pos = torch.tensor(max_len - 1, device="cuda")
    profiled = {
        f"prefill_{SERVE_X_PROFILED}": device_share(torch, lambda: prefill(
            dev_params, {"tokens": short},
            bundle.init_cache(SERVE_X_BATCH, max_len, "cuda"))[0].cpu(), 1),
        "decode_step": device_share(torch, lambda: decode(
            dev_params, cache, last, pos)[0].cpu(), 5),
    }
    decode_median = sorted(step_ms)[len(step_ms) // 2]
    result = {
        "batch": SERVE_X_BATCH, "prompt": SERVE_X_PROMPT,
        "new_tokens": SERVE_X_NEW, "layers": cfg.num_layers,
        "mlstm_layers": n_mlstm, "wall_s": wall,
        "tokens_per_s": SERVE_X_BATCH * SERVE_X_NEW / wall,
        "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": SERVE_X_BATCH * SERVE_X_PROMPT
        / (prefill_ms / 1e3),
        "decode_step_ms_median": decode_median,
        "decode_tokens_per_s": SERVE_X_BATCH / (decode_median / 1e3),
        "peak_memory_bytes": peak,
        "mlstm_launches_prefill": pre_l, "mlstm_launches_decode": dec_l,
        "launches": launches,
        "first_tokens": tokens[:, :8].tolist(),
        "profile": profiled,
    }
    print("xlstm serve: " + json.dumps(result))
    return result


def greedy_margins(torch, bundle, params, prompts, new_tokens, max_len,
                   device):
    """Greedy tokens through the bundle's prefill and decode functions (the
    ones the serving steps wrap), with each step's top-2 logit margin."""
    tok_all, margins = [], []
    with torch.no_grad():
        cache = bundle.init_cache(len(prompts), max_len, device)
        logits, cache = bundle.prefill_fn(
            params, {"tokens": torch.tensor(prompts, device=device)}, cache)
        for i in range(new_tokens):
            lg = logits[:, -1, :bundle.cfg.vocab_size].float()
            top = lg.topk(2, dim=-1).values
            margins.append((top[:, 0] - top[:, 1]).cpu())
            tok = lg.argmax(dim=-1)[:, None]
            tok_all.append(tok.cpu())
            if i + 1 < new_tokens:
                logits, cache = bundle.decode_fn(
                    params, cache, tok,
                    torch.tensor(len(prompts[0]) + i, device=device))
    return torch.cat(tok_all, dim=1), torch.stack(margins, dim=1)


def ssm_parity_phase(torch, cfg, params) -> dict:
    """The first 8 layers of the same parameters (seven mLSTM, the sLSTM
    at position 7) at full width in float32, on the card (mLSTM kernel)
    and on the CPU (plain versions): identical greedy tokens. Where they
    differ, the CPU's top-2 logit margin at that step is reported and the
    phase fails."""
    from repro_torch.kernels.mlstm_chunk import ops as ml_ops
    from repro_torch.models.common import cast_for_compute
    from repro_torch.models.registry import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.replace(num_layers=PARITY_X_LAYERS, dtype="float32")
    sub = dict(params, layers=params["layers"][:PARITY_X_LAYERS])
    bundle = build(cfg)
    gen = torch.Generator().manual_seed(16)
    prompts = torch.randint(1, cfg.vocab_size,
                            (PARITY_X_BATCH, PARITY_X_PROMPT),
                            generator=gen).tolist()
    max_len = PARITY_X_PROMPT + PARITY_X_NEW
    runs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        p = cast_for_compute(sub, torch.float32, torch.device(dev))
        before = ml_ops.mlstm_chunk.launches
        t = time.perf_counter()
        runs[dev] = greedy_margins(torch, bundle, p, prompts, PARITY_X_NEW,
                                   max_len, dev)
        secs[dev] = time.perf_counter() - t
        if dev == "cuda":
            launched = ml_ops.mlstm_chunk.launches - before
    card, cpu = runs["cuda"][0], runs["cpu"][0]
    if not torch.equal(card, cpu):
        row, step = (card != cpu).nonzero()[0].tolist()
        margin = float(runs["cpu"][1][row, step])
        raise SmokeFailure(
            f"xlstm f32 greedy tokens differ: card {card.tolist()} cpu "
            f"{cpu.tolist()}; first at row {row} step {step}, where the "
            f"CPU's top-2 logit margin is {margin:.3e}")
    n_mlstm = PARITY_X_LAYERS - 1
    check(launched == n_mlstm,
          f"xlstm parity mlstm launches {launched} != {n_mlstm}")
    print(f"xlstm parity f32 ({PARITY_X_LAYERS} layers, B={PARITY_X_BATCH}, "
          f"prompt {PARITY_X_PROMPT}): card and cpu tokens identical: "
          f"{card.tolist()}; smallest top-2 margin "
          f"{float(runs['cpu'][1].min()):.3e}")
    return {"tokens": card.tolist(),
            "min_margin": float(runs["cpu"][1].min()),
            "seconds": secs}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mlstm_chunk import ops as ml_ops
    from repro_torch.kernels.mlstm_chunk import ref as ml_ref
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan import ref as rg_ref

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t:.1f}s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    smi = smi_line()
    print(smi)

    kernels = [decode_phase(torch, da_ops, da_ref),
               flash_phase(torch, fa_ops, fa_ref)]
    cfg_full = get_config(ARCH).replace(attn_impl="pallas",
                                        decode_impl="pallas")
    served = serve_phase(torch, cfg_full, da_ops, fa_ops)
    parity = parity_phase(torch, cfg_full)
    kernels += flash_bwd_phase(torch, fa_ops, fa_ref)
    trained = train_phase(torch, cfg_full, fa_ops)
    train_parity = train_parity_phase(torch, cfg_full)
    kernels.append(rglru_phase(torch, rg_ops, rg_ref))
    cfg_rg = get_config(HYBRID).replace(use_pallas=True)
    rg_params = host_params(torch, cfg_rg, 10)
    counters = (da_ops.decode_attention, fa_ops.flash_attention_fwd,
                fa_ops.flash_attention_bwd_dq, fa_ops.flash_attention_bwd_dkv,
                rg_ops.rglru_scan)
    hybrid = hybrid_serve_phase(torch, cfg_rg, rg_params, counters)
    hybrid_parity = hybrid_parity_phase(torch, cfg_rg, rg_params)
    del rg_params
    kernels.append(mlstm_phase(torch, ml_ops, ml_ref))
    cfg_x = get_config(XLSTM).replace(use_pallas=True)
    x_params = host_params(torch, cfg_x, 14)
    ssm = ssm_serve_phase(torch, cfg_x, x_params,
                          (*counters, ml_ops.mlstm_chunk))
    ssm_parity = ssm_parity_phase(torch, cfg_x, x_params)
    del x_params
    # launches on each main path (serving, training, hybrid and ssm
    # serving), each counted from 0
    by_path = {
        "decode_attention": {"serve": served["decode_launches"]},
        "flash_attention_fwd": {"serve": served["flash_launches"],
                                "train": trained["launches"][
                                    "flash_attention_fwd"]},
        "flash_attention_bwd_dq": {"train": trained["launches"][
            "flash_attention_bwd_dq"]},
        "flash_attention_bwd_dkv": {"train": trained["launches"][
            "flash_attention_bwd_dkv"]},
        "rglru_scan": {"hybrid_serve": hybrid["launches"]["rglru_scan"]},
        "mlstm_chunk": {"ssm_serve": ssm["launches"]["mlstm_chunk"]},
    }
    for kern in kernels:
        kern["launches_by_path"] = by_path[kern["name"]]
        kern["launches"] = sum(by_path[kern["name"]].values())
        check(kern["launches"] > 0, f"{kern['name']} never launched on a "
                                    "main path")

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "device": device, "kernels": kernels,
         "serve": served, "parity": parity, "train": trained,
         "train_parity": train_parity, "hybrid_serve": hybrid,
         "hybrid_parity": hybrid_parity, "ssm_serve": ssm,
         "ssm_parity": ssm_parity}, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:      # any phase failing fails the run, with its trace
        traceback.print_exc()
        sys.exit(1)
