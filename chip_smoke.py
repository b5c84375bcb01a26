#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Builds the port's CUDA kernels from
``src/repro_torch/kernels/*/csrc/*.cu`` (into the ignored ``build/``),
then:

1. prints the card's ``nvidia-smi`` name and power limit and what
   ``ptxas`` reported for each kernel;
2. holds the split-KV decode-attention kernel against its plain PyTorch
   version (bf16 at 2e-2, f32 at 5e-5): kv_len 0, 1, Smax and across the
   tile and split edges, B * Hkv of 4, 16 and 64 (splits of 64 and 128
   positions), hd 32/64/128, G = 3/2/8, and the decode shapes of phases
   18, 19 and 22 (G = 1 and 7 at hd 128, caches of 1024 and 3072;
   whisper's 8 rows of G = 1 with 20 KV heads at hd 64, cache 448, at
   each batch's first, profiled and last steps and the edges 5, 64, 65,
   133, 256, 448), each call launched twice for the
   same output (the merge's tickets back at zero); requires ptxas to
   report no spills; times kernel (events and the profiler's device time
   per launch), plain version and SDPA at the serving shape;
3. does the same for the flash-attention forward kernel (out and lse, in
   bf16 on its tensor-core body and in f32 on its CUDA-core body, each
   bf16 call counted by ``tensor_core_launches``): hd 32/64/128, lengths
   at the tile edges 1/63/64/65/127/128/129/700/1024 and the serving
   prompts 96/250/511/700, causal and not, Skv > Sq with q_offset =
   Skv - Sq, Skv = 0, windows 1/64/127, softcap with a window, G = 1/3/4,
   strided q/k/v views, views at an odd element offset (copied
   contiguous by the wrapper), the attention shapes of phases 18, 19,
   21 and 22 (hd 128: moonshot's prompts and its 8 x 1024 batch with
   G = 1, llava's 3008 positions with G = 7 at B = 1 and 2; hd 64 with 20
   heads and G = 1: whisper's prompts of 4 and 132 tokens in 8 rows and
   its 4 x 448 training batch), and the training shape B = 8, S = 1024;
   out also
   within 1e-2 / 1e-4 of its norm and lse within 1e-4 absolute; requires
   ptxas to report no spills; times it at each serving shape and at the
   training shape, printing kernel, device and SDPA ms, kernel/SDPA and
   bound/kernel;
4. serves 8 requests at the full width of ``aiida-demo-110m`` (bf16,
   random weights from a seed) through ``BatchScheduler`` and checks that
   every prefill and decode step went through the kernels, every flash
   launch on the tensor-core body;
5. serves 2 requests in float32 on the card and on the CPU (plain
   versions) and requires identical greedy tokens;
6. holds the two flash-attention backward kernels (dq pass, dk/dv pass;
   bf16 on their tensor-core bodies, each bf16 call counted by
   ``tensor_core_launches``, f32 on their CUDA-core bodies) against their
   plain version on the card: hd 32/64/128, Sq at the tile edges
   1/63/64/65/127/128/129/250/1024, causal and not, Skv > Sq with
   q_offset, windows 1/64, softcap, G = 1/3/4, strided q/k/v/do views,
   keyless rows and phase 21's training batches (moonshot 8 x 1024 with
   G = 1, llava 2 x 3008 with G = 7, hd 128; whisper 4 x 448 with 20
   heads of 64) (f32 at 1e-4, bf16 at 2e-2,
   and each output's error within 1e-4 / 1e-2 of its norm, or within 1e-4 of zero where the plain
   version's is zero to rounding); requires ptxas to report no spills;
   checks them again at the training shape (B = 8, S = 1024, bf16) and
   times each pass there (events and the profiler's device time), the
   plain version and SDPA's whole backward, printing kernel/SDPA and
   bound/kernel;
7. trains ``aiida-demo-110m`` at full width (bf16 activations, fp32
   parameters, AdamW, the config's remat policy) for 6 steps of 8 x 1024
   tokens through ``make_train_step`` and checks every loss is finite and
   every step launched 24 flash forwards (forward + remat recompute), 12
   dq and 12 dk/dv passes, all on their tensor-core bodies; prints
   tokens/s, ms per step, peak memory and a profiled step;
8. takes one full-width float32 train step's gradients on the card and on
   the CPU (plain versions) from the same parameters and batch, and holds
   loss, grad_norm (1e-4 relative) and every gradient leaf (1e-3 of its
   norm) together;
9. holds the single-pass RG-LRU scan kernel against its plain sequential
   version (5e-5), forward and reversed (the backward's scan, called
   directly): B in 1/4, S in 1/37/1000/4096, D in 48/96/2560, fp32 and
   bf16 inputs, nonzero h0; then the tile edges (S = T - 1, T, T + 1,
   2T +- 1 for the plan's tile length T; D = 1/31/32/33/63/64/65/2560;
   B = 1 with D = 2560; bf16 with an odd D; a view at an odd offset);
   every case launched twice for the same bits and h_last equal to the
   last step of hs; requires ptxas to report no spills; holds its
   backward (through the autograd Function) against autograd of the
   plain version at (2, 1024, 2560) and (3, 333, 100) (1e-4); times kernel
   (events and the profiler's device time per launch), plain version and
   a stream yardstick (``torch.add(a, x, out=hs)``, the same 12 bytes per
   element) at the prefill shape (4, 4096, 2560), kernel and yardstick at
   B = 1, and reports the bytes per element the design moves;
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
   (hs at 5e-5 / 2e-2 and within 1e-4 / 1e-2 of its norm, the fp32 state
   at 5e-5) and the sequential oracle (hs 1e-4, C 1e-3, m 1e-5, or,
   where the plain version is itself farther, no farther than it plus the
   first bar) over B in 1/4, H = 4, S in 1/37/96/2048 (L = 1, 37, 32, 96,
   128), hd in 64/512, fp32 and bf16 q/k/v, zero and nonzero carried
   state, each bf16 call with L = 128 counted on the tensor-core body and
   no other; requires ptxas to report no spills in either body; times
   kernel (events and the profiler's device time per launch) and plain
   version at the prefill shape (4, 4, 2048, 512) bf16;
13. serves ``xlstm-350m`` at full width and depth (24 layers, sLSTM at
   7/15/23, bf16, random weights from a seed, the mLSTM kernel): 4
   prompts of 2048 tokens, 32 greedy tokens each, through the serving
   steps; checks 21 mLSTM launches in the prefill, all on the tensor-core
   body, none in the decode steps and none of the other kernels; prints
   prefill and decode times,
   tokens/s, peak memory and a profiled 512-token prefill and decode step;
14. serves the first 8 layers of the same parameters (the sLSTM at 7
   included) in float32 on the card and on the CPU (2 prompts of 1024
   tokens, 8 new tokens) and requires identical greedy tokens (reporting
   the top-2 logit margin where they differ);
15. drives the engine on the card: with an on-disk provenance store, a
   ``Runner`` as the default and caching on, calls the ``generate``
   calcfunction 256 times (64 distinct prompts of 8-96 tokens, each 4
   times in shuffled order, 16 new tokens, the reduced ``aiida-demo-110m``
   in bf16, decoding through the decode-attention kernel); checks that
   each of the 64 cold calls advanced ``serving.decode_steps`` and each
   of the 192 hits by zero, that the kernel launched exactly (cold decode
   steps x layers) times, that each hit's tokens equal its cold twin's
   and its node carries ``cached_from``, that the store holds 256
   finished-ok CalcFunctionNodes (through ``QueryBuilder``), that the cold
   tokens equal those of a ``BatchScheduler`` run directly on the
   engine's parameters, and that 8 prompts served on the CPU
   (``on_device("cpu")``, a fresh store) give the card's tokens up to a
   step where the CPU's top-1/top-2 logit margin is below the margin
   shift bf16 rounding itself causes on these steps (the CPU's bf16
   margins against its float32 evaluation); prints cold and hit median
   wall per call, a cold call's wall outside its own decode (the
   engine's host cost), the store file's size, node and link counts, the
   kernel's launches and a profiled cold call (device time, idle share);
16. drives the workflow layer on the card, each part on a fresh on-disk
   store with caching off: (a) one ``GPUTrainJob`` (full-width
   ``aiida-demo-110m``, 6 steps of 8 x 1024 tokens, the flash kernels)
   through a ``Runner``: finished ok, 6 finite losses, ``retrieved`` and
   ``metrics`` among its CREATE links, each flash kernel launched as
   often as by the same recipe run directly in this process (and more
   than 0), losses within 1e-4 relative of the direct run's; prints both
   walls and their difference; (b) a ``BaseRestartWorkChain`` with a
   handler for exit code 310 over a 2-step job with an injected NaN:
   finished ok after 2 iterations, children 310 then 0; (c) a daemon of 2
   worker OS processes (3 slots each, so each runs two trainings) runs a
   sweep WorkChain of 4 such jobs (seeds 0-3):
   the WorkChain and 4 CalcJobNodes finished ok, 4 CALL_CALC links, no
   unfinished process, every process seen in a worker's pid (never this
   one's), no requeue, lease expiry, duplicate or stale delivery, seed
   0's losses within 1e-4 of (a)'s, ``fsck`` and ``check_store`` clean;
   prints the sweep's wall, the pickup latency histogram, each worker's
   peak card memory, the store's size, nodes and links, and each client
   the broker dropped, named a daemon worker or a sync client;
17. drives the rest of the engine on the card, each part on its own
   on-disk store: (a) ``examples/train_lm_torch.py``'s
   ``PretrainWorkChain`` in this process (full-width ``aiida-demo-110m``
   on the flash kernels, 12 steps of 4 x 128 tokens in chunks of 4, lr
   3e-3): finished ok, 12 steps, 3 finite losses, 24 flash forwards, 12
   dq and 12 dk/dv passes per step, all on the tensor-core bodies; (b)
   the same recipe as a subprocess of the example, SIGKILLed once its
   store holds the first chunk's checkpoint, then ``--resume <pk>``:
   finished ok at 12 steps, its report names the restored model
   checkpoint, losses within 1e-4 relative of (a)'s; prints whether they
   are bit-equal and the SIGKILL-to-finish wall; (c) ``python -m
   repro_torch.cli`` over (b)'s store, each command a subprocess:
   ``process list|report|show``, ``graph export``, ``stats``, ``store
   fsck``, ``chaos check``: each exits 0, the list and report name the
   chain and its chunk reports, fsck and the invariants are clean; prints
   each command's wall; (d) ``archive create``, ``inspect``, ``import``
   into a fresh profile at the same path, and a re-export from it: the
   two archives are byte-identical and fsck of the target is clean;
   prints the archive's bytes and nodes; (e) the crash script's recipe
   over phase 16's job: 4 ``GPUTrainJob``s (seeds 0-3) through a daemon
   of 2 workers that exit 1.5 s after connecting until 4 restarts: at
   least one restart and one requeue, every job exit status 0, seed 0's
   losses within 1e-4 of phase 16 (a)'s, ``fsck`` and ``check_store``
   clean; (f) the chaos scenarios ``kill9-midstep``, ``zombie-worker``
   and ``broker-kill9`` (seed 1) through the CLI: each ok with no
   violation, ``kill9-midstep`` with a requeue; prints each one's elapsed
   time, its workers' start and restarts;
18. serves ``moonshot-v1-16b-a3b`` (MoE, 64 experts, top 6) at full width
   and depth (48 layers, 28.06 B parameters, bf16 weights drawn on the
   card from a seed): 8 requests of 96/250/511/700 tokens, 32 new tokens
   each, batch 4, cache 1024, through ``BatchScheduler``; every prefill
   on the flash forward's tensor-core body (``attn_impl="pallas"``, a
   change from the published ``"chunked"``), every decode step on the
   decode kernel; prints prefill ms by length, the median decode step,
   the least time a decode step can take (each weight it needs read once:
   of each layer's experts those its tokens were routed to) beside the
   time of the bytes the dense dispatch reads (every expert), peak
   memory, parameters and a profiled decode step (device time, idle
   share);
19. serves ``llava-next-34b`` (VLM) at full width and depth (60 layers,
   34.44 B parameters, bf16 on the card, drawn after phase 18's are
   freed): one row of 2880 patch embeddings and 128 text tokens (the
   flash forward at 3008 positions, 7 query heads per KV head), 32 new
   tokens, cache 3072, through ``make_prefill_step`` /
   ``make_decode_step``; prints what phase 18 prints and the card's free
   memory before the init;
20. at full width and 4 layers in float32, greedy tokens of each family
   on the card (the flash and decode kernels) identical to the CPU's
   (plain versions), from the same parameters: moonshot 2 prompts of 64
   tokens, llava one of 32 tokens after 256 patches, 8 new tokens;
   prints the smallest top-2 logit margin and the smallest gap between
   the k-th and (k+1)-th router probability of any token;
21. one ``GPUTrainJob`` per family through a ``Runner`` at full width:
   moonshot (8 x 1024 tokens) and llava (2 x (2880 patches + 128
   tokens)) at 2 layers (the card's memory: fp32 parameters, gradients
   and AdamW moments) for 3 steps, whisper at 8 encoder and 8 decoder
   layers of its 32 + 32 (the smoke's time: at full depth the job took
   301.70 s for 2 steps) for 2 steps, 4 x 448 tokens beside 1500 frames
   per row, drawn as the reference's job recipe draws them: finished
   ok, finite
   losses, every flash forward, recompute, dq and dk/dv launch on the
   tensor-core bodies (16 / 8 / 8 per whisper step: its decoder's
   self-attention), moonshot's aux loss finite and positive; prints
   losses, aux, peak memory, wall;
22. serves ``whisper-large-v3`` (audio, encoder-decoder) at full width
   and depth (32 encoder and 32 decoder layers, 1.54 B parameters, bf16
   weights drawn on the card) through ``make_prefill_step`` /
   ``make_decode_step``: two batches of 8 rows of 1500 frame embeddings
   (one 30 s window each), prompts of 4 tokens and then of 132 (128 of
   the previous window's text before the 4 task tokens), 124 new tokens
   each, cache 448 (the published ``max_target_positions``); checks 32
   flash forwards per batch, all on the tensor-core body, and 32 decode
   launches per decode step; the encoder and the cross-attention are
   not causal and stay on the chunked path, as in the reference; prints
   each prefill's wall, the prefill's launches and device time (profiled
   at 1 + 1 and 2 + 2 layers, and scaled to the full depth by the
   per-layer difference: a profile of the full prefill's ~6e5 kernels
   takes the profiler minutes), the median decode step, a profiled decode step (device time, idle share,
   launches), peak memory, and a decode step's bound (the decoder
   weights a step reads, the cross K/V cache and the self cache up to
   its length, over the memory rate);
23. at full width, 4 encoder and 4 decoder layers, float32, 2 rows of
   1500 frames and a 4-token prompt, 16 new tokens: greedy tokens on the
   card (the flash and decode kernels) identical to the CPU's (plain
   versions), from the same parameters (attention projections fan-in
   scaled); prints the smallest top-2 logit margin;
24. serves ``aiida-demo-110m`` at full width and depth in bf16 through a
   1 x 1 NCCL device mesh (one rank; ``make_rules(..., fsdp=False)``,
   parameters and cache placed by ``distribute_tree``, the serving steps
   under ``axis_rules``, the kernels on each rank's local shards) and
   without one, in turns (plain, mesh, mesh, plain): 4 rows of 700
   prompt tokens from seed 0, 64 new tokens, cache 1024; requires
   identical tokens and equal decode (12 per step) and flash (12, all on
   the tensor-core body) launches; prints the host ms per decode step
   both ways beside the ``nvidia-smi`` line (DTensor's dispatch is the
   mesh's own cost on a host-bound step) and a profiled decode step each
   way (device time, idle share, launches);
25. trains ``aiida-demo-110m`` at full width and depth with phase 7's
   recipe (bf16 activations, fp32 parameters, AdamW, remat
   ``nothing_saveable``, 8 x 1024; the launcher's schedule for 4 steps)
   through the launcher's per-rank body (``launch.train.train_rank``) in
   a one-rank NCCL group on a 1 x 1 mesh (state placed by
   ``train_state_axes``, DTensor through forward, backward and
   optimizer, the flash forward and both backward kernels under
   ``local_map`` on each rank's local shards), a sharded checkpoint at
   step 2, and the same loop without a mesh (``launch.train.run``), in
   turns (plain, mesh, mesh, plain); requires losses and grad_norm within
   1e-4 relative (bit equality printed), 24 / 12 / 12 flash launches per
   step both ways, all on the tensor cores, every local shard on the
   card, the step-2 checkpoint restored without a mesh leaf for leaf
   bit-equal to the mesh's state, and one more step from each of the two
   states with losses within 1e-4; prints the host ms per step both
   ways, peak memory and the phase's wall.

Prints the smoke's wall, a ``{"kernels": [...]}`` line (each kernel with
the body that ran it), the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that line. Full results also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import functools
import itertools
import json
import math
import re
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
# an output's error as a share of that output's norm (flash forward out,
# backward dq/dk/dv): the elementwise bounds above are loose for the small
# values of late rows
NORM_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# the flash forward's lse, absolute in both dtypes (it is accumulated in
# fp32 either way): a bound relative to lse's size would grow with it
LSE_TOL = 1e-4
# a backward output the plain version gives as zero to rounding (dq and
# dk when every row sees one key): its share of a zero norm is undefined,
# so the kernel's must be zero too, within this absolute bound
ZERO_TOL = 1e-4
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
# phase 15: distinct prompts, calls of each, new tokens, prompts also
# served on the CPU
ENGINE_PROMPTS, ENGINE_REPEATS, ENGINE_NEW, ENGINE_CPU_PROMPTS = 64, 4, 16, 8
AUDIO = "whisper-large-v3"
# phase 22: rows per batch, the prompts of its two batches (the 4 task
# tokens; 128 tokens of the previous window's text before them, as
# long-form transcription feeds them), new tokens per batch (the first
# from the prefill), the cache (whisper's published max_target_positions)
AUDIO_BATCH, AUDIO_PROMPTS, AUDIO_NEW, AUDIO_MAX_LEN = 8, (4, 132), 124, 448
# the decode step profiled in each batch: this many steps after its first
AUDIO_PROFILED_STEP = AUDIO_NEW // 2


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
    ``NORM_TOL``, or, where the plain version's output is zero to rounding,
    within ``ZERO_TOL`` of zero. Returns each output's max abs error and,
    under ``share_<name>``, its error as a share of its norm (0 for a zero
    output)."""
    tol, norm_tol = BWD_TOL[dt_name], NORM_TOL[dt_name]
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite {name}")
        errs[name] = max_err(torch, g, w)
        check(torch.allclose(g, w, atol=tol, rtol=tol),
              f"{what}: {name} max abs err {errs[name]} > {tol}")
        if float(w.abs().max()) <= ZERO_TOL:
            check(float(g.abs().max()) <= ZERO_TOL,
                  f"{what}: {name} is zero in the plain version, but the "
                  f"kernel's reaches {float(g.abs().max())} > {ZERO_TOL}")
            errs[f"share_{name}"] = 0.0
            continue
        share = float((g - w).norm() / w.norm().clamp_min(1e-30))
        check(share <= norm_tol,
              f"{what}: {name} error is {share:.3e} of its norm > {norm_tol}")
        errs[f"share_{name}"] = share
    return errs


# ---------------------------------------------------------------------------
# phase 2: decode attention
# ---------------------------------------------------------------------------

# (b, h, hkv, hd, smax, kv_len): the serving geometry (splits of 64
# positions) across its tile and split edges, B * Hkv = 4 (b = 1) and 64
# (splits of 128), hd 32 with G = 8 (eight query heads per block) and hd
# 128; None draws lengths from the generator
DECODE_CASES = (
    (4, 12, 4, 64, 1024, [0, 1, 130, 1023]),
    (4, 12, 4, 64, 1024, [1024, 1023, 130, 0]),
    (4, 12, 4, 64, 1024, [63, 64, 65, 127]),
    (4, 12, 4, 64, 1024, [128, 129, 960, 961]),
    (1, 12, 4, 64, 1024, [1024]),
    (1, 12, 4, 64, 1024, [65]),
    (16, 12, 4, 64, 1024, [0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257,
                           511, 512, 513, 1023, 1024]),
    (16, 8, 4, 128, 2048, None),
    (2, 8, 1, 32, 300, [299, 37]),
    # the engine's generate (phase 15): the reduced config's heads, its
    # cache buckets of 128 and 256 positions
    (4, 4, 2, 32, 128, [0, 1, 63, 64]),
    (4, 4, 2, 32, 128, [65, 128, 1, 0]),
    (4, 4, 2, 32, 256, [0, 1, 63, 64]),
    (4, 4, 2, 32, 256, [65, 256, 1, 0]),
    # phase 18's moonshot (G = 1, hd 128, cache 1024): its prompts' first,
    # timed and last decode steps, and the edges
    (4, 16, 16, 128, 1024, [97, 251, 512, 701]),
    (4, 16, 16, 128, 1024, [113, 267, 528, 717]),
    (4, 16, 16, 128, 1024, [127, 281, 542, 731]),
    (4, 16, 16, 128, 1024, [0, 1, 1023, 1024]),
    # phase 19's llava (G = 7, hd 128, cache 3072): 2880 patches and 128
    # tokens, the decode steps' first, timed and last lengths, and a full
    # cache
    (1, 56, 8, 128, 3072, [3009]),
    (1, 56, 8, 128, 3072, [3025]),
    (1, 56, 8, 128, 3072, [3039]),
    (1, 56, 8, 128, 3072, [3072]),
) + tuple(
    # phase 22's whisper (G = 1, 20 KV heads, hd 64, cache 448): each
    # batch's first, profiled and last decode steps (every row at one
    # length), and the edges
    (AUDIO_BATCH, 20, 20, 64, AUDIO_MAX_LEN, [n + 1 + step] * AUDIO_BATCH)
    for n in AUDIO_PROMPTS
    for step in (0, AUDIO_PROFILED_STEP, AUDIO_NEW - 2)
) + ((AUDIO_BATCH, 20, 20, 64, AUDIO_MAX_LEN,
      [5, 64, 65, 133, 256, 448, 0, 1]),)


def decode_phase(torch, da_ops, da_ref, build_log: str) -> dict:
    usage = ptxas_all(build_log, "decode_attention_kernel")
    print(f"decode_attention split-KV body, ptxas: {usage}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        for b, h, hkv, hd, smax, lens in DECODE_CASES:
            q = torch.randn(b, h, hd, generator=gen, device="cuda").to(dt)
            k = torch.randn(b, smax, hkv, hd, generator=gen,
                            device="cuda").to(dt)
            v = torch.randn(b, smax, hkv, hd, generator=gen,
                            device="cuda").to(dt)
            if lens is None:
                lens = torch.randint(0, smax + 1, (b,), generator=gen,
                                     device="cuda").tolist()
            kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
            before = da_ops.decode_attention.launches
            out = da_ops.decode_attention(q, k, v, kv)
            again = da_ops.decode_attention(q, k, v, kv)
            ref = da_ref.decode_attention_ref(q, k, v, kv,
                                              scale=hd ** -0.5)
            torch.cuda.synchronize()
            plan = da_ops.split_plan(b, hkv, h // hkv, smax, sms)
            what = (f"decode {dt_name} B={b} H={h} Hkv={hkv} hd={hd} "
                    f"Smax={smax} plan={plan} kv_len={lens}")
            err = max_err(torch, out, ref)
            tol = TOL[dt_name]
            check(da_ops.decode_attention.launches - before == 2,
                  f"{what}: launches {da_ops.decode_attention.launches - before}")
            check(bool(torch.isfinite(out.float()).all()),
                  f"{what}: non-finite output")
            check(torch.allclose(out.float(), ref.float(), atol=tol,
                                 rtol=tol),
                  f"{what}: max abs err {err} > {tol}")
            # the merge's tickets are back at zero after every launch
            check(torch.equal(out, again), f"{what}: a second launch differs")
            for row, n in enumerate(lens):
                if n == 0:
                    check(bool((out[row] == 0).all()),
                          f"{what}: kv_len=0 row is not zero")
            worst = max(worst, err)
            print(f"{what}: max_abs_err={err:.3e} (tol {tol})")

    # timing at the serving phase's shapes: bf16, mid-generation depths
    b, h, hkv, hd, smax = 4, 12, 4, 64, 1024
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
    # the kernel's own device time: the event time above is the wrapper's
    # host cost as much as the card's
    rotate = itertools.cycle(sets)
    prof = device_share(
        torch, lambda: da_ops.decode_attention(*next(rotate), kv), 40,
        expect="decode_attention")
    device_ms = prof["device_ms_per_launch_by_kind"]["decode_attention"]
    device_seen = prof["launches_by_kind"]["decode_attention"]
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
    bound = max(t_bytes, t_ops)
    plan = da_ops.split_plan(b, hkv, h // hkv, smax, sms)
    print(f"decode_attention timing (B={b} H={h} Hkv={hkv} hd={hd} "
          f"Smax={smax} bf16 kv_len={lens}, plan {plan}): kernel {ms:.5f} "
          f"ms (device {device_ms:.5f} ms per launch over {device_seen:.2f} "
          f"launches seen per call), plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.5f} ms, bound {bound:.5f} ms, bound/kernel "
          f"{bound / ms:.4f} (device {bound / device_ms:.4f})")
    return {
        "name": "decode_attention", "route": "cuda",
        "body": "decode_attention_kernel: split-KV, merged in one launch",
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
        "max_abs_err": worst, "ms": ms, "device_ms": device_ms,
        "device_launches_seen_per_call": device_seen,
        "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "split_plan": plan, "ptxas": usage,
        "timed_at": f"B={b} H={h} Hkv={hkv} hd={hd} Smax={smax} bf16 "
                    f"kv_len={lens}",
    }


# ---------------------------------------------------------------------------
# phase 3: flash attention forward
# ---------------------------------------------------------------------------

# the attention shapes of phases 18, 19 and 21: moonshot's prompts (G = 1,
# hd 128) and its training batch, llava's 2880 patches + 128 tokens (G = 7,
# 3008 positions, no multiple of the tile) in its prefill and its training
# batch of 2; the forward and backward sweeps both hold them
FAMILY_ATTN_CASES = (
    [dict(b=1, sq=s, skv=s, h=16, hkv=16, hd=128) for s in SERVE_PROMPTS]
    + [dict(b=8, sq=1024, skv=1024, h=16, hkv=16, hd=128),
       dict(b=1, sq=3008, skv=3008, h=56, hkv=8, hd=128),
       dict(b=2, sq=3008, skv=3008, h=56, hkv=8, hd=128)])

# the attention shapes of phases 21 and 22 (whisper's decoder: 20 heads
# of 64, G = 1): the two prefills (8 rows of 4 and of 132 tokens) and the
# training batch of 4 x 448; the forward and backward sweeps hold them
AUDIO_ATTN_CASES = (
    [dict(b=AUDIO_BATCH, sq=n, skv=n, h=20, hkv=20, hd=64)
     for n in AUDIO_PROMPTS]
    + [dict(b=4, sq=AUDIO_MAX_LEN, skv=AUDIO_MAX_LEN, h=20, hkv=20, hd=64)])

# the forward's sweep: each case is (b, sq, skv, h, hkv, hd, options); a
# "strided" case reads q, k and v as views of one fused (b, s, h + 2 hkv,
# hd) projection, so q's rows are strided; an "odd" case reads views one
# element into their storage, whose rows are not 16-byte aligned
_C = dict(h=12, hkv=4, hd=64, b=1)
# the serving path's prompts among the tile-edge lengths
FLASH_CASES = (
    [dict(_C, sq=s, skv=s) for s in sorted({1, 63, 64, 65, 127, 128, 129,
                                            700, 1024, *SERVE_PROMPTS})]
    + [dict(_C, sq=s, skv=s, hd=hd) for hd in (32, 128)
       for s in (65, 129, 700)]
    + [dict(_C, sq=s, skv=s, hd=hd, causal=False)
       for hd, s in ((64, 1), (64, 64), (64, 129), (64, 700), (32, 129),
                     (128, 129))]
    + [dict(_C, sq=65, skv=200, q_offset=135),
       dict(_C, sq=129, skv=1024, q_offset=895),
       dict(_C, sq=64, skv=1024, q_offset=960, hd=128),
       dict(_C, sq=37, skv=300, causal=False)]
    + [dict(_C, sq=65, skv=0, q_offset=-65), dict(_C, sq=65, skv=0,
                                                   causal=False)]
    + [dict(_C, sq=700, skv=700, window=w) for w in (1, 64, 127)]
    + [dict(_C, sq=129, skv=129, window=64, hd=128)]
    + [dict(_C, sq=511, skv=511, softcap=30.0, window=127),
       dict(_C, sq=129, skv=129, softcap=30.0, hd=32)]
    + [dict(_C, b=2, sq=257, skv=257, h=h) for h in (4, 12, 16)]   # G 1/3/4
    + [dict(_C, b=2, sq=300, skv=300, strided=True),
       dict(_C, sq=129, skv=129, strided=True, hd=128)]
    + [dict(_C, b=2, sq=129, skv=129, odd=True),
       dict(_C, sq=65, skv=200, q_offset=135, hd=128, odd=True)]
    # the earlier sweep's cases
    + [dict(_C, sq=37, skv=37), dict(_C, sq=511, skv=511, softcap=30.0),
       dict(_C, sq=37, skv=42, q_offset=5)]
    + FAMILY_ATTN_CASES + AUDIO_ATTN_CASES)


def flash_inputs(torch, gen, c: dict, dt):
    b, hd = c["b"], c["hd"]
    if c.get("strided"):
        qkv = torch.randn(b, c["sq"], c["h"] + 2 * c["hkv"], hd,
                          generator=gen, device="cuda").to(dt)
        return qkv.split([c["h"], c["hkv"], c["hkv"]], dim=2)
    if c.get("odd"):
        def odd(*shape):
            flat = torch.randn(math.prod(shape) + 1, generator=gen,
                               device="cuda").to(dt)
            return flat[1:].view(shape)
        return (odd(b, c["sq"], c["h"], hd), odd(b, c["skv"], c["hkv"], hd),
                odd(b, c["skv"], c["hkv"], hd))
    return (torch.randn(b, c["sq"], c["h"], hd, generator=gen,
                        device="cuda").to(dt),
            torch.randn(b, c["skv"], c["hkv"], hd, generator=gen,
                        device="cuda").to(dt),
            torch.randn(b, c["skv"], c["hkv"], hd, generator=gen,
                        device="cuda").to(dt))


def ptxas_all(log: str, kernel: str) -> dict:
    """Registers and spills ptxas reported for every instantiation of
    ``kernel``, keyed by its template arguments as mangled (or the kernel's
    name for one that has none); fails if any spills."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        if "Compiling entry" not in line or kernel not in line:
            continue
        tail = line.split(kernel, 1)[1]
        key = tail[1:tail.index("EE")] if tail.startswith("I") else kernel
        text = " ".join(lines[i:i + 4])
        found[key] = {
            name: int(re.search(pattern, text).group(1))
            for name, pattern in (("registers", r"Used (\d+) registers"),
                                  ("spill_stores", r"(\d+) bytes spill stores"),
                                  ("spill_loads", r"(\d+) bytes spill loads"))}
    check(bool(found), f"ptxas reported nothing for {kernel}")
    spilled = {k: u for k, u in found.items()
               if u["spill_stores"] or u["spill_loads"]}
    check(not spilled, f"{kernel} spills: {spilled}")
    return found


def fwd_close(torch, out, lse, rout, rlse, dt_name: str, what: str
              ) -> dict:
    """Hold the forward's out and lse against the plain version's: out
    elementwise at ``TOL`` and as a share of its norm at ``NORM_TOL``, lse
    at the absolute ``LSE_TOL`` where a row has a live key, -inf (and
    nowhere else) where it has none. Returns the errors."""
    tol, norm_tol = TOL[dt_name], NORM_TOL[dt_name]
    live = torch.isfinite(rlse)
    check(bool(torch.isfinite(out.float()).all())
          and bool((torch.isfinite(lse) == live).all())
          and bool((lse[~live] == -math.inf).all()),
          f"{what}: non-finite out, or lse not finite exactly where the "
          "plain version has a live key")
    o, ro = out.float(), rout.float()
    errs = {"out": max_err(torch, o, ro),
            "lse": max_err(torch, lse[live], rlse[live]),
            "share_out": float((o - ro).norm() / ro.norm().clamp_min(1e-30))
            if ro.numel() else 0.0}
    check(torch.allclose(o, ro, atol=tol, rtol=tol),
          f"{what}: out max abs err {errs['out']} > {tol}")
    check(errs["share_out"] <= norm_tol,
          f"{what}: out error is {errs['share_out']:.3e} of its norm > "
          f"{norm_tol}")
    check(errs["lse"] <= LSE_TOL,
          f"{what}: lse max abs err {errs['lse']} > {LSE_TOL}")
    return errs


def flash_phase(torch, fa_ops, fa_ref, build_log: str) -> dict:
    fwd = fa_ops.flash_attention_fwd
    # ptxas's report of every tensor-core instantiation (none may spill)
    found = ptxas_all(build_log, "flash_fwd_wgmma_kernel")
    usage = {}
    for hd in fa_ops._HEAD_DIMS:
        check(f"Li{hd}" in found, "ptxas reported nothing for "
                                  f"flash_fwd_wgmma_kernel<{hd}>")
        usage[f"hd{hd}"] = found[f"Li{hd}"]
    print(f"flash_attention_fwd tensor-core body, ptxas: {usage}")

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        tol = TOL[dt_name]
        for c in FLASH_CASES:
            opts = dict(causal=c.get("causal", True),
                        window=c.get("window", 0), scale=c["hd"] ** -0.5,
                        softcap=c.get("softcap", 0.0),
                        q_offset=c.get("q_offset", 0))
            q, k, v = flash_inputs(torch, gen, c, dt)
            before = (fwd.launches, fwd.tensor_core_launches)
            out, lse = fwd(q, k, v, **opts)
            torch.cuda.synchronize()
            tc = fwd.tensor_core_launches - before[1]
            check(fwd.launches - before[0] == 1 and tc == (dt_name ==
                                                           "bfloat16"),
                  f"flash {dt_name} {c}: launches {fwd.launches - before[0]}"
                  f", tensor-core launches {tc}")
            rout, rlse = fa_ref.flash_attention_ref(q, k, v, **opts)
            e = fwd_close(torch, out, lse, rout, rlse, dt_name,
                          f"flash {dt_name} {c}")
            worst = max(worst, e["out"], e["lse"])
            print(f"flash_attention_fwd {dt_name} {c}: out err "
                  f"{e['out']:.2e} ({e['share_out']:.2e} of its norm) lse "
                  f"err {e['lse']:.2e} (tol {tol}, {NORM_TOL[dt_name]} of "
                  f"the norm, lse {LSE_TOL})")

    # the training path's shape, bf16 causal: out and lse against the
    # plain version (the backward check in phase 6 takes them as given)
    h, hkv, hd = 12, 4, 64
    opts = dict(causal=True, window=0, scale=hd ** -0.5, softcap=0.0,
                q_offset=0)
    q, k, v = flash_inputs(torch, gen, dict(b=TRAIN_BATCH, sq=TRAIN_SEQ,
                                            skv=TRAIN_SEQ, h=h, hkv=hkv,
                                            hd=hd), torch.bfloat16)
    out, lse = fwd(q, k, v, **opts)
    rout, rlse = fa_ref.flash_attention_ref(q, k, v, **opts)
    torch.cuda.synchronize()
    e = fwd_close(torch, out, lse, rout, rlse, "bfloat16",
                  f"flash bf16 B={TRAIN_BATCH} S={TRAIN_SEQ}")
    worst = max(worst, e["out"], e["lse"])
    print(f"flash_attention_fwd bfloat16 B={TRAIN_BATCH} S={TRAIN_SEQ} "
          f"(training shape): out err {e['out']:.3e} ({e['share_out']:.3e} "
          f"of its norm), lse err {e['lse']:.3e} (tol {TOL['bfloat16']}, "
          f"{NORM_TOL['bfloat16']} of the norm, lse {LSE_TOL})")
    del q, k, v, out, lse, rout, rlse

    # serving: the mean per launch over the prompt lengths, as the serving
    # path launches each length equally often
    by_len = {}
    for s in SERVE_PROMPTS:
        by_len[s] = fwd_timing(torch, fa_ops, fa_ref, 1, s, h, hkv, hd)
        by_len[s]["timed_at"] = (f"B=1 S={s} H={h} Hkv={hkv} hd={hd} bf16 "
                                 "causal")
    serve = {key: sum(t[key] for t in by_len.values()) / len(by_len)
             for key in ("ms", "device_ms", "plain_ms", "library_ms",
                         "t_bytes", "t_ops")}
    serve["timed_at"] = (f"B=1 H={h} Hkv={hkv} hd={hd} bf16 causal, mean "
                         f"over S in {list(SERVE_PROMPTS)}")
    train = fwd_timing(torch, fa_ops, fa_ref, TRAIN_BATCH, TRAIN_SEQ, h, hkv,
                       hd)
    train["timed_at"] = (f"B={TRAIN_BATCH} S={TRAIN_SEQ} H={h} Hkv={hkv} "
                         f"hd={hd} bf16 causal")
    for path, b, s, t in ([("serve", 1, n, by_len[n]) for n in SERVE_PROMPTS]
                          + [("serve", 1, None, serve),
                             ("train", TRAIN_BATCH, TRAIN_SEQ, train)]):
        t["bound_ms"] = max(t["t_bytes"], t["t_ops"])
        t["bound_by"] = "bytes" if t["t_bytes"] >= t["t_ops"] else "operations"
        t["kernel_over_sdpa"] = t["ms"] / t["library_ms"]
        t["bound_over_kernel"] = t["bound_ms"] / t["ms"]
        if s is not None:
            t["ptxas"] = usage[f"hd{hd}"]
        print(f"flash_attention_fwd timing ({path}, {t['timed_at']}): kernel "
              f"{t['ms']:.5f} ms (device {t['device_ms']:.5f} ms), sdpa "
              f"{t['library_ms']:.5f} ms, "
              f"kernel/sdpa {t['kernel_over_sdpa']:.3f}, bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}), bound/kernel "
              f"{t['bound_over_kernel']:.4f}, plain {t['plain_ms']:.4f} ms"
              + (f", ptxas {t['ptxas']}" if "ptxas" in t else ""))
    # the row's headline numbers are the serving shapes' mean; every
    # shape's numbers are under ``timing_by_path``
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "body": "flash_fwd_wgmma_kernel (bf16; f32 flash_fwd_f32_kernel)",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:109",
        "max_abs_err": worst,
        **{key: serve[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "timed_at")},
        "timing_by_path": {"serve": serve, "train": train,
                           "serve_by_len": {str(n): t
                                            for n, t in by_len.items()}},
        "ptxas": usage,
    }


def fwd_timing(torch, fa_ops, fa_ref, b, s, h, hkv, hd) -> dict:
    """Kernel (CUDA events over back-to-back calls, and the profiler's
    device time), plain and SDPA ms of one bf16 causal forward at (b, s),
    and the two terms of its bound."""
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
    # the kernel's own device time: at the serving shapes the wrapper's
    # host cost, not the card, sets the timed ``ms``
    rotate = itertools.cycle(sets)
    device_ms = device_share(
        torch, lambda: fa_ops.flash_attention_fwd(*next(rotate)),
        20, expect="flash_fwd")["device_ms_by_kind"]["flash_fwd"]
    pairs = b * s * (s + 1) // 2
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
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
    not that amplification. An LM's tree holds its attention under
    ``layers/attn``; whisper's under ``enc_layers/attn``,
    ``dec_layers/self_attn`` and ``dec_layers/cross_attn``."""
    for stack, names in (("layers", ("attn",)), ("enc_layers", ("attn",)),
                         ("dec_layers", ("self_attn", "cross_attn"))):
        for name in names if stack in params else ():
            params[stack][name] = _scaled_attn(cfg, params[stack][name])
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


def device_share(torch, fn, n: int, expect: str | None = None) -> dict:
    """Run ``fn`` ``n`` times under ``torch.profiler``: wall ms per run,
    the device time the profiler saw per run, the idle share, and the
    kernels that took the most device time.

    With ``expect``, a kernel kind the window must hold: a window whose
    trace lost every launch of that kind (the profiler drops a short
    window's device events now and then) is profiled again, up to three
    times, and then fails."""
    for _ in range(3):
        got = _profiled(torch, fn, n)
        if expect is None or expect in got["device_ms_per_launch_by_kind"]:
            return got
        print(f"profiler: no {expect} launch in a window of {n} runs; "
              "profiling again")
    raise SmokeFailure(f"profiler: three windows held no {expect} launch")


def _profiled(torch, fn, n: int) -> dict:
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
    top, by_kind, count = {}, {}, {}
    for e in sorted(evs, key=dev_us, reverse=True):
        ms = dev_us(e) / 1e3 / n
        if len(top) < 8 or e.key[:60] in top:
            top[e.key[:60]] = top.get(e.key[:60], 0.0) + ms
        kind = kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        count[kind] = count.get(kind, 0) + e.count
    # each kernel's own span in the trace: a median that an event merged
    # with another or cut short does not move
    spans = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            spans.setdefault(kernel_kind(e.name), []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    return {"wall_ms": wall, "device_ms": device,
            "idle_share": max(0.0, 1.0 - device / wall) if wall else None,
            "launches_per_run": sum(e.count for e in evs) / n,
            "top_device_ms": top, "device_ms_by_kind": by_kind,
            # the mean over the kernels the trace holds, which a dropped
            # event does not bias
            "device_ms_per_launch_by_kind": {
                kind: by_kind[kind] * n / count[kind] for kind in by_kind
                if count[kind]},
            "device_ms_median_by_kind": {
                kind: sorted(v)[len(v) // 2] for kind, v in spans.items()},
            "launches_by_kind": {kind: c / n for kind, c in count.items()}}


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
    fa_ops.flash_attention_fwd.tensor_core_launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode_launches = da_ops.decode_attention.launches
    flash_launches = fa_ops.flash_attention_fwd.launches
    flash_tc = fa_ops.flash_attention_fwd.tensor_core_launches
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
    check(flash_tc == flash_launches,
          f"{flash_launches - flash_tc} bf16 flash launches missed the "
          "tensor-core body")
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
        "flash_launches": flash_launches,
        "flash_tensor_core_launches": flash_tc,
        "decode_launches": decode_launches,
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

# the backward's sweep: each case is (b, sq, skv, h, hkv, hd, options);
# "strided" reads q, k and v as views of one fused projection and do as
# every other head of a wider tensor; a negative q_offset leaves the first
# rows without a key (lse = -inf)
_D = dict(b=2, h=12, hkv=4, hd=64)
BWD_CASES = (
    [dict(_D, sq=s, skv=s, hd=hd) for hd in (32, 64, 128)
     for s in (1, 63, 64, 65, 127, 128, 129, 250)]
    + [dict(_D, b=1, sq=1024, skv=1024, hd=hd) for hd in (32, 64, 128)]
    + [dict(_D, sq=s, skv=s, hd=hd, causal=False)
       for hd, s in ((32, 129), (64, 1), (64, 65), (64, 250), (128, 129))]
    + [dict(_D, sq=65, skv=200, q_offset=135, hd=hd) for hd in (32, 64, 128)]
    + [dict(_D, sq=37, skv=300, causal=False),
       dict(_D, sq=96, skv=128, q_offset=32)]
    + [dict(_D, sq=250, skv=250, hd=hd, window=w) for w in (1, 64)
       for hd in (32, 64, 128)]
    + [dict(_D, sq=250, skv=250, softcap=30.0),
       dict(_D, sq=129, skv=129, hd=128, softcap=30.0, window=64),
       dict(_D, sq=129, skv=129, hd=32, softcap=30.0)]
    + [dict(_D, sq=257, skv=257, h=h) for h in (4, 12, 16)]     # G 1/3/4
    + [dict(_D, sq=250, skv=250, h=8, hkv=2)]
    + [dict(_D, sq=300, skv=300, strided=True),
       dict(_D, sq=129, skv=129, hd=128, strided=True),
       dict(_D, sq=65, skv=65, hd=32, strided=True)]
    + [dict(_D, sq=40, skv=40, q_offset=-10),
       dict(_D, sq=100, skv=100, q_offset=-70, hd=128, window=16)]
    # the families' training batches (phase 21)
    + FAMILY_ATTN_CASES[-3::2] + AUDIO_ATTN_CASES[-1:])


def bwd_inputs(torch, gen, c: dict, dt):
    q, k, v = flash_inputs(torch, gen, c, dt)
    shape = (c["b"], c["sq"], c["h"], c["hd"])
    if c.get("strided"):
        do = torch.randn(c["b"], c["sq"], 2 * c["h"], c["hd"], generator=gen,
                         device="cuda").to(dt)[:, :, ::2]
    else:
        do = torch.randn(shape, generator=gen, device="cuda").to(dt)
    return q, k, v, do


def flash_bwd_phase(torch, fa_ops, fa_ref, build_log: str) -> list[dict]:
    passes = (fa_ops.flash_attention_bwd_dq, fa_ops.flash_attention_bwd_dkv)
    # ptxas's report of every tensor-core instantiation of both passes
    # (none may spill)
    usage = {}
    for kernel in ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel"):
        found = ptxas_all(build_log, kernel)
        for hd in fa_ops._HEAD_DIMS:
            check(f"Li{hd}" in found,
                  f"ptxas reported nothing for {kernel}<{hd}>")
            usage[f"{kernel}<{hd}>"] = found[f"Li{hd}"]
    print(f"flash_attention_bwd tensor-core bodies, ptxas: {usage}")

    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {"dq": 0.0, "dkv": 0.0, "share_dq": 0.0, "share_dkv": 0.0}

    def note(errs):
        for key, names in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            worst[key] = max(worst[key], *(errs[n] for n in names))
            worst[f"share_{key}"] = max(worst[f"share_{key}"],
                                        *(errs[f"share_{n}"] for n in names))
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        for c in BWD_CASES:
            opts = dict(causal=c.get("causal", True),
                        window=c.get("window", 0), scale=c["hd"] ** -0.5,
                        softcap=c.get("softcap", 0.0),
                        q_offset=c.get("q_offset", 0))
            q, k, v, do = bwd_inputs(torch, gen, c, dt)
            out, lse = fa_ops.flash_attention_fwd(q, k, v, **opts)
            before = [(p.launches, p.tensor_core_launches) for p in passes]
            got = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, **opts)
            torch.cuda.synchronize()
            counts = [(p.launches - n, p.tensor_core_launches - t)
                      for p, (n, t) in zip(passes, before)]
            tc = int(dt_name == "bfloat16")
            check(counts == [(1, tc), (1, tc)],
                  f"flash bwd {dt_name} {c}: (launches, tensor-core "
                  f"launches) of dq, dk/dv {counts}")
            want = fa_ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                  **opts)
            tol = BWD_TOL[dt_name]
            errs = bwd_close(torch, got, want, dt_name,
                             f"flash bwd {dt_name} {c}")
            note(errs)
            print(f"flash_attention_bwd {dt_name} {c}: max_abs_err " +
                  " ".join(f"{n}={e:.3e}" for n, e in errs.items()) +
                  f" (tol {tol}, {NORM_TOL[dt_name]} of the norm)")

    # the training phase's shapes, bf16 causal: checked on the first input
    # set (whose plain backward is also the one timed), then timed
    b, s, h, hkv, hd, dt = TRAIN_BATCH, TRAIN_SEQ, 12, 4, 64, torch.bfloat16
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
    # each pass's own device time, from the profiler
    rotate = itertools.cycle(sets)

    def one_pass(fn):
        q, k, v, do, out, lse, delta = next(rotate)
        fn(q, k, v, do, lse, delta, opts)

    device_ms = {
        name: device_share(torch, lambda: one_pass(fn), 10,
                           expect=f"flash_bwd_{name}")[
            "device_ms_by_kind"][f"flash_bwd_{name}"]
        for name, fn in (("dq", fa_ops.flash_attention_bwd_dq),
                         ("dkv", fa_ops.flash_attention_bwd_dkv))}
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
          + f" (tol {BWD_TOL['bfloat16']}, {NORM_TOL['bfloat16']} of the "
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
    rotate = itertools.cycle(lib)

    def sdpa_bwd():
        o, ins, g = next(rotate)
        torch.autograd.grad(o, ins, g, retain_graph=True)

    library_device_ms = device_share(torch, sdpa_bwd, 10)["device_ms"]
    del lib, sets, rotate

    pairs = b * h * s * (s + 1) // 2
    rows = []
    for name, ms, products, out_bytes, line in (
            ("dq", dq_ms, 3, q_bytes, 298),
            ("dkv", dkv_ms, 4, 2 * kv_bytes, 329)):
        t_bytes = (nbytes_in + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = products * 2 * hd * pairs / PEAK_FLOPS["bfloat16"] * 1e3
        rows.append({
            "name": f"flash_attention_bwd_{name}", "route": "cuda",
            "body": f"flash_bwd_{name}_wgmma_kernel (bf16; f32 "
                    f"flash_bwd_{name}_f32_kernel)",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_bwd.cu",
            "replaces": f"src/repro/kernels/flash_attention/kernel.py:{line}",
            "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
            "max_norm_share": worst[f"share_{name}"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "device_ms": device_ms[name],
            "library_device_ms": library_device_ms,
            "kernel_over_sdpa": ms / library_ms,
            "bound_over_kernel": max(t_bytes, t_ops) / ms,
            "ptxas": {hd_: usage[f"flash_bwd_{name}_wgmma_kernel<{hd_}>"]
                      for hd_ in fa_ops._HEAD_DIMS},
            "timed_at": f"B={b} S={s} H={h} Hkv={hkv} hd={hd} bf16 causal; "
                        "plain_ms and library_ms are the whole backward "
                        "(dq, dk and dv in one call)",
        })
        print(f"flash_attention_bwd_{name} timing: kernel {ms:.5f} ms "
              f"(device {device_ms[name]:.5f} ms), sdpa bwd (whole) "
              f"{library_ms:.5f} ms (device {library_device_ms:.5f} ms), "
              f"kernel/sdpa {ms / library_ms:.3f}, bound "
              f"{max(t_bytes, t_ops):.5f} ms ({rows[-1]['bound_by']}), "
              f"bound/kernel {max(t_bytes, t_ops) / ms:.4f}, plain (whole "
              f"bwd) {plain_ms:.4f} ms")
    print(f"flash_attention_bwd pair timing: dq + dk/dv {dq_ms + dkv_ms:.5f}"
          f" ms (device {device_ms['dq'] + device_ms['dkv']:.5f} ms), sdpa "
          f"bwd {library_ms:.5f} ms, pair/sdpa "
          f"{(dq_ms + dkv_ms) / library_ms:.3f}")
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
        c.tensor_core_launches = 0
    losses, step_ms, launches, tc = [], [], [], []
    for i in range(TRAIN_STEPS):
        before = [(c.launches, c.tensor_core_launches) for c in counters]
        t = time.perf_counter()
        state, metrics = step_fn(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        launches.append([c.launches - n for c, (n, _) in zip(counters,
                                                             before)])
        tc.append([c.tensor_core_launches - n
                   for c, (_, n) in zip(counters, before)])
        losses.append(float(metrics["loss"]))
    totals = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated()

    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(all(tuple(n) == per_step for n in launches),
          f"launches per step (fwd, dq, dkv) {launches} != {per_step}")
    check(all(tuple(n) == per_step for n in tc),
          f"tensor-core launches per step (fwd, dq, dkv) {tc} != "
          f"{per_step}")
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
        "tensor_core_launches_per_step_fwd_dq_dkv": tc,
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

def rglru_case(torch, rg_ops, rg_ref, a, x, h0, reverse, what) -> float:
    """One scan case, launched twice: the forward through the autograd
    Function, the reversed scan (the backward's) called directly. Both
    launches must give the same bits (the kernel's status words and
    counters are ready again after every launch), hs and h_last must be
    within 5e-5 of the plain version, and h_last must equal the last step
    of hs. Returns the max abs error."""
    b, s, d = a.shape
    fn = ((lambda: rg_ops._scan(a, x, h0, reverse=True)) if reverse
          else (lambda: rg_ops.rglru_scan(a, x, h0)))
    before = rg_ops.rglru_scan.launches
    hs, h_last = fn()
    hs2, h_last2 = fn()
    rhs, rh_last = rg_ref.rglru_scan_ref(a, x, h0, reverse=reverse)
    torch.cuda.synchronize()
    tol = TOL["float32"]
    check(rg_ops.rglru_scan.launches - before == 2,
          f"{what}: launches {rg_ops.rglru_scan.launches - before} != 2")
    check(hs.dtype == torch.float32 and hs.shape == (b, s, d)
          and h_last.shape == (b, d),
          f"{what}: outputs {hs.dtype} {tuple(hs.shape)} "
          f"{tuple(h_last.shape)}")
    err = max(max_err(torch, hs, rhs), max_err(torch, h_last, rh_last))
    check(torch.allclose(hs, rhs, atol=tol, rtol=tol)
          and torch.allclose(h_last, rh_last, atol=tol, rtol=tol),
          f"{what}: max abs err {err} > {tol}")
    check(torch.equal(hs, hs2) and torch.equal(h_last, h_last2),
          f"{what}: a second launch differs")
    check(torch.equal(h_last, hs[:, 0] if reverse else hs[:, -1]),
          f"{what}: h_last is not the last step of hs")
    return err


def rglru_phase(torch, rg_ops, rg_ref, build_log: str) -> dict:
    """The scan kernel against the plain sequential scan: a forward and
    reversed sweep (B, S, D, fp32 and bf16 inputs, nonzero h0; 5e-5 abs
    and rel), cases at the tile edges (S = T - 1, T, T + 1 and 2T +- 1 for
    the tile length T; D around the 32 and 64 channels of a tile; B = 1
    with D = 2560, where time is split hardest; D = 1; bf16 with an odd
    D; a view at an odd offset), each launched twice for the same bits
    (:func:`rglru_case`); ptxas must report no spills; the backward
    through the autograd Function against autograd through the plain
    version (1e-4). Then kernel (events and the profiler's device time per
    launch), plain version and ``torch.add(a, x, out=hs)`` (the same 12
    bytes per element: an achievable-bandwidth yardstick) timed at the
    prefill shape, and kernel and yardstick at B = 1."""
    usage = ptxas_all(build_log, "rglru_scan_kernel")
    print(f"rglru_scan single-pass body, ptxas: {usage}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(9)

    def inputs(b, s, d, dt, g=gen):
        a = (0.5 + 0.5 * torch.rand(b, s, d, generator=g, device="cuda"))
        x = torch.randn(b, s, d, generator=g, device="cuda")
        h0 = torch.randn(b, d, generator=g, device="cuda")
        return a.to(dt), x.to(dt), h0

    worst, cases = 0.0, 0
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for b, s, d in itertools.product((1, 4), (1, 37, 1000, 4096),
                                         (48, 96, RG_D)):
            a, x, h0 = inputs(b, s, d, dt)
            for reverse in (False, True):
                worst = max(worst, rglru_case(
                    torch, rg_ops, rg_ref, a, x, h0, reverse,
                    f"rglru {dt_name} {(b, s, d)} reverse={reverse}"))
                cases += 1
        print(f"rglru_scan {dt_name} sweep B in (1, 4), S in (1, 37, 1000, "
              f"4096), D in (48, 96, {RG_D}), both directions: max_abs_err "
              f"so far {worst:.3e} (tol {TOL['float32']})")

    # the tile edges, at the plan's tile length for each (B, D)
    edges = []
    for b, d in ((1, 31), (2, 32), (1, 33), (3, 63), (1, 64), (2, 65),
                 (1, RG_D), (2, 1)):
        t = rg_ops.tile_plan(b, 4096, d, sms).tile_t
        edges += [(b, s, d, "float32") for s in (t - 1, t, t + 1,
                                                   2 * t - 1, 2 * t + 1)]
    edges += [(1, SERVE_RG_PROMPT, RG_D, "float32"),
              (1, 1000, RG_D, "float32"), (2, 4097, 1, "float32"),
              (2, 333, 33, "bfloat16"), (1, SERVE_RG_PROMPT, RG_D,
                                         "bfloat16")]
    plans = {}
    for b, s, d, dt_name in edges:
        a, x, h0 = inputs(b, s, d, getattr(torch, dt_name))
        plans[f"{(b, s, d)}"] = tuple(rg_ops.tile_plan(b, s, d, sms))
        for reverse in (False, True):
            worst = max(worst, rglru_case(
                torch, rg_ops, rg_ref, a, x, h0, reverse,
                f"rglru edge {dt_name} {(b, s, d)} plan "
                f"{plans[f'{(b, s, d)}']} reverse={reverse}"))
            cases += 1
    # views one element into their storage: the wrapper copies them to the
    # alignment of the kernel's copies
    base = torch.randn(2 * 333 * 100 + 1, generator=gen, device="cuda")
    av = (0.5 + 0.5 * torch.sigmoid(base))[1:].view(2, 333, 100)
    xv = base[1:].view(2, 333, 100)
    h0 = torch.randn(2, 100, generator=gen, device="cuda")
    check(av.data_ptr() % 8 != 0, "the odd-offset view is aligned")
    for reverse in (False, True):
        worst = max(worst, rglru_case(torch, rg_ops, rg_ref, av, xv, h0,
                                      reverse, f"rglru odd-offset view "
                                               f"reverse={reverse}"))
        cases += 1
    print(f"rglru_scan edges (S at T - 1, T, T + 1, 2T +- 1; D 1/31/32/33/"
          f"63/64/65/{RG_D}; B = 1 at D = {RG_D}; bf16 odd D; an odd-offset "
          f"view): {cases} cases in all, each launched twice with equal "
          f"bits, max_abs_err {worst:.3e}")

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
    def timed(b, s, d, plain: bool) -> dict:
        elems = b * s * d
        sets = [inputs(b, s, d, torch.float32, None)
                for _ in range(copies_for(8 * elems))]
        outs = [(a, x, torch.empty_like(a)) for a, x, _ in sets]
        # kernel, yardstick, kernel, yardstick: the card's clocks move
        # between phases, so the two are compared within one window
        runs = {"ms": [], "stream_ms": []}
        for _ in range(2):
            runs["ms"].append(time_ms(torch, rg_ops.rglru_scan, sets,
                                      iters=20))
            runs["stream_ms"].append(time_ms(
                torch, lambda a, x, o: torch.add(a, x, out=o), outs,
                iters=20))
        ms, stream_ms = (sum(v) / len(v) for v in runs.values())
        rotate = itertools.cycle(sets)
        prof = device_share(torch,
                            lambda: rg_ops.rglru_scan(*next(rotate)), 20,
                            expect="rglru_scan")
        plain_ms = (time_ms(torch, rg_ref.rglru_scan_ref, sets[:1], iters=2)
                    if plain else None)
        plan = rg_ops.tile_plan(b, s, d, sms)
        nbytes = 12 * elems + 8 * b * d     # a, x in; hs out; h0, h_last
        # what the design moves beyond that: each tile writes its
        # aggregate and inclusive carry and reads one predecessor's carry,
        # and writes and reads a status word
        extra = plan.tiles * (4 * plan.tile_c * 4 + 16)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * elems / PEAK_FLOPS["float32"] * 1e3
        return {"ms": ms, "device_ms": prof["device_ms_per_launch_by_kind"][
                    "rglru_scan"],
                "device_ms_median": prof["device_ms_median_by_kind"][
                    "rglru_scan"],
                "device_launches_seen": prof["launches_by_kind"]["rglru_scan"],
                "stream_ms": stream_ms, "runs": runs, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes_per_element": (nbytes + extra) / elems,
                "plan": tuple(plan)}

    b, s, d = SERVE_RG_BATCH, SERVE_RG_PROMPT, RG_D
    main = timed(b, s, d, plain=True)
    one = timed(1, s, d, plain=False)
    for (tb, label), r in (((b, "prefill"), main), ((1, "B=1"), one)):
        print(f"rglru_scan timing {label} (B={tb} S={s} D={d} fp32, plan "
              f"{r['plan']}): kernel {r['ms']:.5f} ms (device "
              f"{r['device_ms']:.5f} ms per launch over "
              f"{r['device_launches_seen']:.2f} launches seen per call, "
              f"median {r['device_ms_median']:.5f} ms), stream yardstick "
              f"{r['stream_ms']:.5f} ms (interleaved runs {r['runs']}), plain "
              f"{r['plain_ms']} ms, bound {r['bound_ms']:.5f} ms, "
              f"bound/kernel {r['bound_ms'] / r['ms']:.4f} (device "
              f"{r['bound_ms'] / r['device_ms']:.4f}), "
              f"{r['bytes_per_element']:.4f} bytes per element moved, "
              f"library none")
    return {
        "name": "rglru_scan", "route": "cuda",
        "body": "rglru_scan_kernel: one pass, persistent blocks, "
                "decoupled look-back over time tiles",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:52",
        "max_abs_err": worst, "bwd_max_abs_err": bwd_worst, "cases": cases,
        "ms": main["ms"], "device_ms": main["device_ms"],
        "device_ms_median": main["device_ms_median"],
        "device_launches_seen_per_call": main["device_launches_seen"],
        "stream_ms": main["stream_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "bytes_per_element": main["bytes_per_element"],
        # no single PyTorch call computes a linear recurrence (torch.add is
        # only a yardstick of bandwidth)
        "library_ms": None, "tile_plan": main["plan"], "b1": one,
        "edge_plans": plans, "ptxas": usage,
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
    pre = profiled["prefill"]
    result = {
        "scan_share_of_prefill_device": pre["device_ms_by_kind"].get(
            "rglru_scan", 0.0) / pre["device_ms"],
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
    at TOL and within NORM_TOL of its norm, the fp32 state at 5e-5) and
    against the sequential oracle at
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
    share = float((hs.float() - phs.float()).norm()
                  / phs.float().norm().clamp_min(1e-30))
    check(share <= NORM_TOL[dt_name],
          f"{what}: hs error is {share:.3e} of its norm > "
          f"{NORM_TOL[dt_name]}")
    state_err = state_share = 0.0
    for name, g, w in zip("Cnm", st, pst):
        e = max_err(torch, g, w)
        check(torch.allclose(g, w, atol=5e-5, rtol=5e-5),
              f"{what}: {name} vs plain {e} > 5e-5")
        state_err = max(state_err, e)
        # the error as a share of the 5e-5 abs+rel bar it must stay under
        state_share = max(state_share, float(
            ((g - w).abs() / (5e-5 + 5e-5 * w.abs())).max()))
    out, beyond = {"plain": max(err, state_err), "share_hs": share,
                   "plain_state": state_err,
                   "plain_state_of_bar": state_share}, {}
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


def mlstm_phase(torch, ml_ops, ml_ref, build_log: str) -> dict:
    """The chunkwise mLSTM kernel against its plain versions
    (:func:`mlstm_case`) over a sweep: B in 1/4, H = 4, S in 1/37/96/2048
    with chunks giving L = 1, 37, 32, 96, 128; hd in 64/512; fp32 and bf16
    q/k/v; zero and nonzero carried state; every bf16 call with L = 128
    counted on the tensor-core body and no other. Then the kernel (events
    and the profiler's device time) and the plain chunkwise version timed
    at the prefill shape."""
    usage = {kern: ptxas_all(build_log, kern)
             for kern in ("mlstm_chunk_wgmma_kernel", "mlstm_chunk_f32_kernel")}
    print(f"mlstm_chunk bodies, ptxas: {usage}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(13)
    lengths = ((1, 128), (37, 128), (37, 16), (96, 128), (96, 64),
               (SERVE_X_PROMPT, 128))
    worst = {}
    beyond = {}       # the plain version's worst oracle error past a bar
    cases = tc_cases = 0
    for dt_name, b, (s, chunk), hd, state in itertools.product(
            ("float32", "bfloat16"), (1, SERVE_X_BATCH), lengths, (64, X_HD),
            (False, True)):
        what = (f"mlstm {dt_name} B={b} S={s} chunk={chunk} hd={hd} "
                f"state={state}")
        dt = getattr(torch, dt_name)
        ins = mlstm_inputs(torch, gen, b, 4, s, hd, dt, state)
        tc_before = ml_ops.mlstm_chunk.tensor_core_launches
        errs, past = mlstm_case(torch, ml_ops, ml_ref, ins, chunk, dt_name,
                                what)
        tc = ml_ops.mlstm_chunk.tensor_core_launches - tc_before
        want_tc = ml_ops.takes_tensor_cores(dt, ml_ref.chunk_len(s, chunk),
                                            hd)
        check(tc == int(want_tc), f"{what}: tensor-core launches {tc}, "
                                  f"expected {int(want_tc)}")
        tc_cases += tc
        for name, e in errs.items():
            key = f"{dt_name}_{name}"
            worst[key] = max(worst.get(key, 0.0), e)
        for name, e in past.items():
            beyond[name] = max(beyond.get(name, 0.0), e)
        cases += 1
    print(f"mlstm_chunk sweep, {cases} cases ({tc_cases} on the "
          f"tensor-core body): worst errors {worst}; the plain chunkwise "
          f"version's own oracle error where it passes a bar: {beyond}")

    # timing at the prefill shape: bf16 q/k/v, zero initial state
    b, h, s, hd = SERVE_X_BATCH, 4, SERVE_X_PROMPT, X_HD
    L = ml_ref.chunk_len(s, 128)
    qkv_bytes = 3 * b * h * s * hd * 2
    sets = [mlstm_inputs(torch, gen, b, h, s, hd, torch.bfloat16, False)
            for _ in range(copies_for(qkv_bytes))]
    before = (ml_ops.mlstm_chunk.launches,
              ml_ops.mlstm_chunk.tensor_core_launches)
    ms = time_ms(torch, lambda *a: ml_ops.mlstm_chunk(*a, chunk=L), sets,
                 iters=10)
    check(ml_ops.mlstm_chunk.tensor_core_launches - before[1]
          == ml_ops.mlstm_chunk.launches - before[0] > 0,
          "a timed bf16 call missed the tensor-core body")
    rotate = itertools.cycle(sets)
    prof = device_share(
        torch, lambda: ml_ops.mlstm_chunk(*next(rotate), chunk=L), 10,
        expect="mlstm_chunk")
    device_ms = prof["device_ms_per_launch_by_kind"]["mlstm_chunk"]
    device_seen = prof["launches_by_kind"]["mlstm_chunk"]
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
    bound = max(t_bytes, t_ops)
    print(f"mlstm_chunk timing (B={b} H={h} S={s} hd={hd} L={L} bf16, "
          f"tensor-core body): kernel {ms:.5f} ms (device {device_ms:.5f} "
          f"ms per launch over {device_seen:.1f} launches seen per call), "
          f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms "
          f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP), bound/kernel "
          f"{bound / ms:.4f} (device {bound / device_ms:.4f}), library none")
    return {
        "name": "mlstm_chunk", "route": "cuda",
        "body": "mlstm_chunk_wgmma_kernel (bf16, L = 128, hd % 64 == 0; "
                "every other call mlstm_chunk_f32_kernel)",
        "source": "src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:91",
        "max_abs_err": max(worst["float32_plain"], worst["bfloat16_plain"]),
        "errors": worst, "plain_oracle_err_past_bar": beyond,
        "cases": cases, "tensor_core_cases": tc_cases, "ptxas": usage,
        "ms": ms, "device_ms": device_ms,
        "device_launches_seen_per_call": device_seen, "plain_ms": plain_ms,
        "bound_ms": bound,
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
    mlstm.tensor_core_launches = 0
    t = time.perf_counter()
    tokens, prefill_ms, step_ms, (pre_l, dec_l), cache = greedy(
        torch, bundle, dev_params, prompts, SERVE_X_NEW, max_len, "cuda",
        mlstm)
    wall = time.perf_counter() - t
    launches = {c.__name__: c.launches for c in counters}
    tc_launches = mlstm.tensor_core_launches
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
    check(tc_launches == n_mlstm,
          f"{n_mlstm - tc_launches} of the prefill's {n_mlstm} mLSTM "
          "launches missed the tensor-core body")
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
        "mlstm_tensor_core_launches": tc_launches,
        "launches": launches,
        "first_tokens": tokens[:, :8].tolist(),
        "profile": profiled,
    }
    print("xlstm serve: " + json.dumps(result))
    return result


def greedy_margins(torch, bundle, params, batch, new_tokens, max_len,
                   device):
    """Greedy tokens through the bundle's prefill and decode functions (the
    ones the serving steps wrap), with each step's top-2 logit margin;
    decode positions start after the prefill's (a VLM's patches
    included)."""
    n = bundle.cfg.num_patches + batch["tokens"].shape[1]
    tok_all, margins = [], []
    with torch.no_grad():
        cache = bundle.init_cache(batch["tokens"].shape[0], max_len, device)
        logits, cache = bundle.prefill_fn(
            params, {k: v.to(device) for k, v in batch.items()}, cache)
        for i in range(new_tokens):
            lg = logits[:, -1, :bundle.cfg.vocab_size].float()
            top = lg.topk(2, dim=-1).values
            margins.append((top[:, 0] - top[:, 1]).cpu())
            tok = lg.argmax(dim=-1)[:, None]
            tok_all.append(tok.cpu())
            if i + 1 < new_tokens:
                logits, cache = bundle.decode_fn(
                    params, cache, tok, torch.tensor(n + i, device=device))
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
        runs[dev] = greedy_margins(torch, bundle, p,
                                   {"tokens": torch.tensor(prompts)},
                                   PARITY_X_NEW, max_len, dev)
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


# ---------------------------------------------------------------------------
# phase 15: the engine on the card
# ---------------------------------------------------------------------------

def engine_phase(torch, da_ops) -> dict:
    """The ``generate`` calcfunction through the engine: provenance store
    on disk, default runner, caching on."""
    import os
    import tempfile

    from repro_torch.caching import disable_caching, enable_caching
    from repro_torch.core.datatypes import ArrayData, Int, Str
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.observability.metrics import get_registry
    from repro_torch.provenance.store import (
        NodeType, QueryBuilder, configure_store,
    )
    from repro_torch.serving import inference
    from repro_torch.serving.serve import BatchScheduler, Request

    gen = torch.Generator().manual_seed(15)
    vocab = inference._serving_config(ARCH, "pallas").vocab_size
    prompts = [torch.randint(1, vocab, (int(n),), generator=gen).tolist()
               for n in torch.randint(8, 97, (ENGINE_PROMPTS,),
                                      generator=gen)]
    check(len({tuple(p) for p in prompts}) == ENGINE_PROMPTS,
          "engine prompts are not distinct")
    order = [i for i in range(ENGINE_PROMPTS) for _ in range(ENGINE_REPEATS)]
    order = [order[j] for j in torch.randperm(len(order), generator=gen)]

    def call(prompt):
        return inference.generate(
            Str(ARCH), ArrayData(torch.tensor(prompt, dtype=torch.int32)),
            Int(ENGINE_NEW), Int(0), Int(-1))

    steps = get_registry().counter("serving.decode_steps")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="engine_",
                                     dir=ROOT / "build") as tmp:
        store = configure_store(os.path.join(tmp, "profile.db"))
        set_default_runner(Runner(store=store))
        # a cold call's wall outside its own decode (the engine's host
        # cost: hashing, store, runner) is its wall less the decode time
        # it reports in its stats
        cold, cold_wall, cold_engine, hit_wall = {}, [], [], []
        da_ops.decode_attention.launches = 0
        with enable_caching():
            for i in order:
                before = steps.value
                t = time.perf_counter()
                out = call(prompts[i])
                wall = time.perf_counter() - t
                advanced = steps.value - before
                tokens = out["tokens"].value.tolist()
                check(len(tokens) == ENGINE_NEW
                      and out["stats"]["finish_reason"] == "length"
                      and all(0 <= x < vocab for x in tokens),
                      f"engine prompt {i}: bad output {tokens} "
                      f"{out['stats'].value}")
                if i not in cold:
                    check(advanced > 0, f"engine prompt {i}: a cold call "
                                        "advanced no decode step")
                    cold[i] = (tokens, advanced)
                    cold_wall.append(wall)
                    cold_engine.append(wall - out["stats"]["wall_seconds"])
                else:
                    check(advanced == 0, f"engine prompt {i}: a hit ran "
                                         f"{advanced} decode steps")
                    check(tokens == cold[i][0], f"engine prompt {i}: hit "
                          f"tokens {tokens} != cold {cold[i][0]}")
                    hit_wall.append(wall)
        launches = da_ops.decode_attention.launches
        cold_steps = sum(n for _, n in cold.values())
        layers = inference._serving_config(ARCH, "pallas").num_layers
        check(launches == cold_steps * layers,
              f"engine decode launches {launches} != {cold_steps} cold "
              f"decode steps x {layers} layers")

        # the store: every call one finished-ok node; in each
        # fingerprint's group one cold node, and every hit cloned from a
        # node of its own group (the newest one the registry found)
        n_ok = (QueryBuilder(store).nodes(NodeType.CALC_FUNCTION)
                .with_state("finished").with_exit_status(0).count())
        check(n_ok == len(order), f"store holds {n_ok} finished-ok "
                                  f"CalcFunctionNodes, not {len(order)}")
        rows = (QueryBuilder(store).nodes(NodeType.CALC_FUNCTION)
                .project("uuid", "node_hash", "attributes").all())
        by_hash: dict = {}
        for r in rows:
            by_hash.setdefault(r["node_hash"], []).append(
                (r["uuid"], json.loads(r["attributes"] or "{}")))
        check(len(by_hash) == ENGINE_PROMPTS,
              f"{len(by_hash)} fingerprints for {ENGINE_PROMPTS} prompts")
        for group in by_hash.values():
            uuids = {u for u, _ in group}
            hits = [a["cached_from"] for _, a in group if "cached_from" in a]
            check(len(group) == ENGINE_REPEATS
                  and len(hits) == ENGINE_REPEATS - 1
                  and all(u in uuids for u in hits),
                  "a fingerprint's group is not one cold node and hits "
                  f"cloned within it: {group}")
        # each call: a process node, its 5 inputs and 2 outputs as data
        # nodes, one link to each
        n_nodes, n_links = store.count_nodes(), store.count_links()
        check(n_nodes == 8 * len(order) and n_links == 7 * len(order),
              f"store holds {n_nodes} nodes and {n_links} links, not "
              f"8 and 7 per call")
        store.close()
        store_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                          if f.is_file())

    # the device's share of a cold call (caching off, so each run decodes;
    # a hit does no device work), outside the counted run
    set_default_runner(Runner(store=configure_store(":memory:")))
    with disable_caching():
        profiled = device_share(torch, lambda: call(prompts[0]), 3)

    # the same prompts straight through a scheduler on the engine's
    # parameters: the engine adds nothing to the numbers
    eng = inference.get_engine(ARCH, 0, need_len=max(map(len, prompts))
                               + ENGINE_NEW, device="cuda")
    sched = BatchScheduler(eng.bundle, eng.params,
                           batch_size=inference.DEFAULT_BATCH_SIZE,
                           max_len=eng.scheduler.max_len, eos_id=-1,
                           device="cuda")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=ENGINE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    direct = [r.generated for r in reqs]
    for i, r in enumerate(direct):
        check(r == cold[i][0], f"engine prompt {i}: generate gave "
              f"{cold[i][0]}, the scheduler {r}")

    cpu = engine_cpu_parity(torch, prompts[:ENGINE_CPU_PROMPTS],
                            [cold[i][0] for i in range(ENGINE_CPU_PROMPTS)])
    set_default_runner(None)
    configure_store(":memory:")

    def median_ms(xs):
        return sorted(xs)[len(xs) // 2] * 1e3

    result = {
        "calls": len(order), "cold_calls": len(cold_wall),
        "hits": len(hit_wall),
        "cold_ms_median": median_ms(cold_wall),
        "cold_engine_ms_median": median_ms(cold_engine),
        "hit_ms_median": median_ms(hit_wall),
        "cold_decode_steps": cold_steps,
        "decode_launches": launches,
        "store_bytes": store_bytes, "nodes": n_nodes, "links": n_links,
        "cpu_parity": cpu,
        "profile_cold_call": profiled,
    }
    print("engine: " + json.dumps(result))
    return result


def engine_cpu_parity(torch, prompts, card_tokens) -> dict:
    """``prompts`` through ``generate`` on the CPU (a fresh store): its
    tokens must equal the card's up to the first step where they differ,
    and there the CPU's top-1/top-2 logit margin must be below the bar:
    the largest shift bf16 rounding itself puts on the CPU's margins at
    these steps (its bf16 margins against a float32 evaluation of the
    same tokens). After a divergence the two continue from different
    tokens and are not compared."""
    from repro_torch.core.datatypes import ArrayData, Int, Str
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.models.transformer import lm_forward
    from repro_torch.provenance.store import configure_store
    from repro_torch.serving import inference

    set_default_runner(Runner(store=configure_store(":memory:")))
    with inference.on_device("cpu"):
        cpu_tokens = [inference.generate(
            Str(ARCH), ArrayData(torch.tensor(p, dtype=torch.int32)),
            Int(ENGINE_NEW), Int(0), Int(-1))["tokens"].value.tolist()
            for p in prompts]
    eng = inference.get_engine(ARCH, 0, need_len=max(map(len, prompts))
                               + ENGINE_NEW, device="cpu")
    cfg32 = eng.cfg.replace(dtype="float32", kv_cache_dtype="float32")
    margins, shifts = [], []
    with torch.no_grad():
        for p, toks in zip(prompts, cpu_tokens):
            seq = torch.tensor([p + toks[:-1]])
            rows = slice(len(p) - 1, len(p) - 1 + len(toks))
            lg = lm_forward(eng.cfg, eng.params, {"tokens": seq})[0][
                0, rows, :eng.cfg.vocab_size].float()
            lg32 = lm_forward(cfg32, eng.params, {"tokens": seq})[0][
                0, rows, :eng.cfg.vocab_size].float()
            top = lg.topk(2, dim=-1).indices
            m = lg.gather(1, top)
            m32 = lg32.gather(1, top)
            margins.append((m[:, 0] - m[:, 1]).tolist())
            shifts.append(float(((m[:, 0] - m[:, 1])
                                 - (m32[:, 0] - m32[:, 1])).abs().max()))
    bar = max(shifts)
    agreed, diverged = 0, []
    for i, (card, cpu) in enumerate(zip(card_tokens, cpu_tokens)):
        step = next((j for j, (a, b) in enumerate(zip(card, cpu)) if a != b),
                    None)
        if step is None:
            agreed += len(card)
            continue
        agreed += step
        diverged.append({"prompt": i, "step": step,
                         "cpu_margin": margins[i][step]})
        check(margins[i][step] < bar,
              f"engine card-vs-cpu prompt {i}: tokens differ at step "
              f"{step} (card {card}, cpu {cpu}) where the CPU's top-2 "
              f"margin {margins[i][step]:.3e} clears the bar {bar:.3e}")
    print(f"engine card vs cpu ({len(prompts)} prompts, bf16): {agreed} of "
          f"{len(prompts) * ENGINE_NEW} steps agree before any divergence; "
          f"divergences {diverged}; margin bar {bar:.3e}")
    return {"agreed_steps": agreed, "diverged": diverged, "margin_bar": bar,
            "cpu_tokens": cpu_tokens}


# ---------------------------------------------------------------------------
# phase 16: the workflow layer (CalcJob, restart WorkChain, daemon)
# ---------------------------------------------------------------------------

WORKFLOW_JOB = {"arch": ARCH, "reduced": False, "steps": TRAIN_STEPS,
                "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                "overrides": {"attn_impl": "pallas"}}
RESTART_STEPS = 2
SWEEP_JOBS, SWEEP_WORKERS = 4, 2
# a worker's slots: the workchain holds one while it waits, so the broker
# (which fills a worker up to its slots) hands each worker two trainings
SWEEP_SLOTS = 1 + SWEEP_JOBS // SWEEP_WORKERS
SWEEP_TIMEOUT_S = 600
FLASH_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")


@functools.cache
def _sweep_workchain():
    """The sweep of phase 16(c), the twin of ``tests/test_system.py``'s:
    fan out one GPUTrainJob per seed, collect the best. A daemon worker
    resumes it by its path ``__main__:SweepWorkChain``; in a spawned
    worker ``__main__`` is this script, imported without running
    ``main()``, and the module ``__getattr__`` below builds the class."""
    from repro_torch.calcjobs import GPUTrainJob
    from repro_torch.core import Dict, Int, WorkChain, append_

    class SweepWorkChain(WorkChain):
        @classmethod
        def define(cls, spec):
            super().define(spec)
            spec.input("n_jobs", valid_type=Int, default=Int(3))
            spec.input("config", valid_type=Dict)
            spec.output("best_loss", valid_type=Dict)
            spec.outline(cls.launch, cls.collect)

        def launch(self):
            base = dict(self.inputs["config"].value)
            for seed in range(self.inputs["n_jobs"].value):
                self.to_context(jobs=append_(self.submit(
                    GPUTrainJob, config=Dict({**base, "seed": seed}))))

        def collect(self):
            best = None
            for job in self.ctx.jobs:
                assert job.is_finished_ok
                m = job.outputs["metrics"].value
                if best is None or m["final_loss"] < best["final_loss"]:
                    best = m
            self.out("best_loss", Dict(best))

    SweepWorkChain.__module__ = "__main__"
    SweepWorkChain.__qualname__ = "SweepWorkChain"
    return SweepWorkChain


def __getattr__(name: str):
    if name == "SweepWorkChain":
        return _sweep_workchain()
    raise AttributeError(name)


def job_reasons(runner) -> str:
    """The simulated cluster's reason for each failed job of ``runner``."""
    from repro_torch.calcjobs.calcjob import get_cluster

    return "; ".join(f"job {jid}: {job.get('reason')}" for jid, job in
                     get_cluster(runner).jobs.items() if job.get("reason"))


def direct_train(torch, config: dict) -> list[float]:
    """``GPUTrainJob``'s recipe written out, outside the engine: the full
    config with its overrides, ``init_train_state`` from the seed, the
    train step, batches from ``numpy.random.default_rng(seed)``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    from repro_torch.training.optim import OptimConfig
    from repro_torch.training.train_step import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)

    cfg = get_config(config["arch"]).replace(**config["overrides"])
    bundle = build(cfg)
    steps, seed = config["steps"], config.get("seed", 0)
    tcfg = TrainConfig(optim=OptimConfig(lr=3e-4, total_steps=steps,
                                         warmup_steps=max(1, steps // 10)))
    state = init_train_state(bundle, tcfg, seed, "cuda")
    step_fn = make_train_step(bundle, tcfg)
    rng = np.random.default_rng(seed)
    b, s = config["batch"], config["seq"]
    losses = []
    for _ in range(steps):
        tokens = rng.integers(0, cfg.vocab_size, (b, s + 1), dtype=np.int32)
        state, metrics = step_fn(state, {
            "tokens": torch.from_numpy(tokens[:, :-1].copy()).to("cuda"),
            "labels": torch.from_numpy(tokens[:, 1:].copy()).to("cuda")})
        losses.append(metrics["loss"])
    return torch.stack(losses).tolist()


def named_drops(stats: dict) -> list[dict]:
    """The broker's drop records, each named a daemon worker (it said
    hello with its name) or a sync client (it never did)."""
    return [{**d, "kind": "daemon worker" if d["worker"] else "sync client"}
            for d in stats.get("dropped", [])]


def losses_close(got: list[float], want: list[float]) -> bool:
    return len(got) == len(want) and all(
        abs(g - w) <= 1e-4 * abs(w) for g, w in zip(got, want))


def workflow_phase(torch, fa_ops) -> dict:
    """GPUTrainJob through the engine's workflow layer: in process, under
    a restart WorkChain, and as a sweep through a daemon of two worker OS
    processes, each on a fresh on-disk store with caching off."""
    import gc
    import os
    import tempfile

    from repro_torch.caching import disable_caching
    from repro_torch.calcjobs import GPUTrainJob
    from repro_torch.calcjobs.restart import (BaseRestartWorkChain,
                                              process_handler)
    from repro_torch.chaos.invariants import check_store
    from repro_torch.core import Dict, Int
    from repro_torch.engine.broker import SyncBrokerClient
    from repro_torch.engine.daemon import Daemon
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.observability.metrics import merge_snapshots
    from repro_torch.provenance.fsck import fsck
    from repro_torch.provenance.store import (LinkType, NodeType,
                                              QueryBuilder, configure_store)

    counters = (fa_ops.flash_attention_fwd, fa_ops.flash_attention_bwd_dq,
                fa_ops.flash_attention_bwd_dkv)

    def zero():
        for c in counters:
            c.launches = 0
            c.tensor_core_launches = 0

    # workers inherit this environment when they are spawned
    os.environ.pop("REPRO_CACHING", None)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(prefix="workflow_", dir=ROOT / "build")
    result: dict = {"config": WORKFLOW_JOB}
    with disable_caching():
        # (a) one job through a Runner, then the same recipe directly;
        # the jobs whose launches are counted run one at a time
        store = configure_store(os.path.join(tmp.name, "inprocess.db"))
        runner = Runner(store=store)
        set_default_runner(runner)
        zero()
        t = time.perf_counter()
        outputs, proc = runner.run(GPUTrainJob,
                                   {"config": Dict(WORKFLOW_JOB)})
        job_wall = time.perf_counter() - t
        job_launches = [c.launches for c in counters]
        job_tc = [c.tensor_core_launches for c in counters]
        check(proc.is_finished_ok, f"calcjob: {proc.exit_code}; "
                                   f"{job_reasons(runner)}")
        metrics = outputs["metrics"].value
        losses = metrics["losses"]
        check(metrics["steps"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS
              and all(math.isfinite(x) for x in losses),
              f"calcjob metrics {metrics}")
        labels = {label for _, _, label in
                  store.outgoing(proc.pk, LinkType.CREATE)}
        check({"retrieved", "metrics"} <= labels,
              f"calcjob CREATE links {labels}")
        zero()
        t = time.perf_counter()
        direct = direct_train(torch, WORKFLOW_JOB)
        direct_wall = time.perf_counter() - t
        direct_launches = [c.launches for c in counters]
        check(job_launches == direct_launches and all(job_launches),
              f"calcjob launches {job_launches} != direct {direct_launches}")
        check(job_tc == job_launches, f"calcjob tensor-core launches "
                                      f"{job_tc} of {job_launches}")
        check(losses_close(losses, direct),
              f"calcjob losses {losses} != direct {direct}")
        result["in_process"] = {
            "losses": losses, "direct_losses": direct,
            "job_wall_s": job_wall, "direct_wall_s": direct_wall,
            "engine_s": job_wall - direct_wall,
            "launches": dict(zip(FLASH_NAMES, job_launches))}
        print(f"workflow (a): job {job_wall:.3f} s, direct "
              f"{direct_wall:.3f} s, engine {job_wall - direct_wall:.3f} s "
              f"around {TRAIN_STEPS} steps; launches "
              f"{dict(zip(FLASH_NAMES, job_launches))}")

        # (b) a restart WorkChain recovers an injected NaN
        class NanRestart(BaseRestartWorkChain):
            _process_class = GPUTrainJob

            @process_handler(310)
            def handle_nan(self, child):
                cfg = dict(self.ctx.process_inputs["config"].value)
                cfg["inject_nan"] = False
                cfg["lr"] = cfg.get("lr", 3e-4) / 10
                self.ctx.process_inputs["config"] = Dict(cfg)
                self.report("NaN handled: lr lowered")
                return None

        outputs, proc = runner.run(NanRestart, {"config": Dict(
            {**WORKFLOW_JOB, "steps": RESTART_STEPS, "inject_nan": True})})
        statuses = [c.exit_status for c in proc.ctx.children]
        check(proc.is_finished_ok and proc.ctx.iteration == 2
              and statuses == [310, 0],
              f"restart: {proc.exit_code}, iteration {proc.ctx.iteration}, "
              f"children {statuses}; {job_reasons(runner)}")
        result["restart"] = {"iterations": proc.ctx.iteration,
                             "child_exit_statuses": statuses}
        print(f"workflow (b): restart children {statuses}")
        set_default_runner(None)
        store.close()
        configure_store(":memory:")
        del outputs, proc, runner, store

    # (c) the sweep through a daemon: release what the earlier phases
    # cached on the card first
    gc.collect()
    torch.cuda.empty_cache()
    result["smoke_reserved_bytes"] = torch.cuda.memory_reserved()
    daemon = Daemon(os.path.join(tmp.name, "daemon"), workers=SWEEP_WORKERS,
                    slots=SWEEP_SLOTS)
    t = time.perf_counter()
    daemon.start()
    try:
        start_s = time.perf_counter() - t
        t = time.perf_counter()
        wc_pk = daemon.submit(_sweep_workchain(), {
            "n_jobs": Int(SWEEP_JOBS), "config": Dict(WORKFLOW_JOB)})
        dstore = configure_store(daemon.store_path)
        ran_in: dict[int, set] = {}
        with daemon.controller() as ctl:
            while True:
                for advert in ctl.workers():
                    for pk in advert["pks"]:
                        ran_in.setdefault(pk, set()).add(advert["pid"])
                node = dstore.get_node(wc_pk)
                if node["process_state"] in ("finished", "excepted",
                                             "killed"):
                    break
                check(time.perf_counter() - t < SWEEP_TIMEOUT_S,
                      f"sweep not done in {SWEEP_TIMEOUT_S} s: {node}")
                check(daemon.supervise() == 0,
                      "a daemon worker or the broker died")
                time.sleep(0.2)
            sweep_wall = time.perf_counter() - t
            adverts = ctl.workers()
        broker = SyncBrokerClient(daemon.host, daemon.port)
        try:
            stats = broker.broker_stats()
        finally:
            broker.close()
        worker_pids = set(daemon.worker_pids())
    finally:
        daemon.stop()

    jobs = QueryBuilder(dstore).nodes(NodeType.CALC_JOB).project(
        "pk", "process_state", "exit_status", "exit_message").all()
    job_pks = [r["pk"] for r in jobs]
    check(node["process_state"] == "finished" and node["exit_status"] == 0,
          f"sweep workchain: {node['process_state']} "
          f"{node['exit_status']} {node['exit_message']}; jobs {jobs}")
    n_ok = (QueryBuilder(dstore).nodes(NodeType.CALC_JOB)
            .with_state("finished").with_exit_status(0).count())
    calls = dstore.outgoing(wc_pk, LinkType.CALL_CALC)
    check(n_ok == SWEEP_JOBS and len(jobs) == SWEEP_JOBS
          and len(calls) == SWEEP_JOBS,
          f"sweep: {n_ok} finished-ok CalcJobNodes of {len(jobs)}, "
          f"{len(calls)} CALL_CALC links")
    check(dstore.unfinished_processes() == [], "unfinished processes left")
    for pk in (wc_pk, *job_pks):
        pids = ran_in.get(pk, set())
        check(pids and pids <= worker_pids and os.getpid() not in pids,
              f"process {pk} ran in {pids}, workers {worker_pids}, smoke "
              f"{os.getpid()}")
    merged = merge_snapshots(a["metrics"] for a in adverts)
    counters_seen = merged["counters"]
    requeues = stats["tasks_delivered"] - stats["tasks_enqueued"]
    anomalies = {"requeues": requeues,
                 "leases_expired": stats["leases_expired"],
                 "duplicate_tasks": counters_seen.get(
                     "daemon.duplicate_tasks", 0),
                 "stale_deliveries": counters_seen.get(
                     "daemon.stale_deliveries", 0)}
    check(stats["tasks_enqueued"] == 1 + SWEEP_JOBS
          and not any(anomalies.values()),
          f"daemon: {anomalies}, enqueued {stats['tasks_enqueued']}")
    dropped = named_drops(stats)
    print(f"workflow (c): broker dropped {len(dropped)} client(s): "
          + "; ".join(f"{d['client']} {d['kind']} ({d['reason']})"
                      for d in dropped))
    seeds = {}
    for pk in job_pks:
        cfg = next(dstore.load_data(p).value for p, _, label in
                   dstore.incoming(pk) if label == "config")
        metrics = next(dstore.load_data(p).value for p, _, label in
                       dstore.outgoing(pk, LinkType.CREATE)
                       if label == "metrics")
        seeds[cfg["seed"]] = metrics["losses"]
    check(sorted(seeds) == list(range(SWEEP_JOBS))
          and losses_close(seeds[0], result["in_process"]["losses"]),
          f"sweep seed 0 losses {seeds.get(0)} != in-process "
          f"{result['in_process']['losses']}")
    report = fsck(dstore, broker_db=daemon.broker_db)
    invariants = check_store(dstore, [wc_pk, *job_pks])
    check(report.clean, f"fsck: {report.counts()}")
    check(invariants.ok, f"check_store: {invariants.summary()}")
    n_nodes, n_links = dstore.count_nodes(), dstore.count_links()
    dstore.close()
    configure_store(":memory:")
    store_bytes = sum(f.stat().st_size for f in Path(daemon.store_path)
                      .parent.rglob("*") if f.is_file()
                      and str(f).startswith(daemon.store_path))
    tmp.cleanup()
    result["daemon"] = {
        "workers": SWEEP_WORKERS, "slots": SWEEP_SLOTS, "jobs": SWEEP_JOBS,
        "start_s": start_s, "sweep_wall_s": sweep_wall,
        "losses_by_seed": seeds, "anomalies": anomalies,
        "broker": {k: stats[k] for k in ("tasks_enqueued",
                                         "tasks_delivered",
                                         "leases_granted",
                                         "clients_dropped")},
        "dropped_clients": dropped,
        "pickup_seconds": merged["histograms"].get("daemon.pickup_seconds"),
        "worker_peak_cuda_bytes": {a["pid"]: a["cuda_peak_bytes"]
                                   for a in adverts},
        "worker_tasks": {a["pid"]: a["metrics"]["counters"].get(
            "daemon.tasks", 0) for a in adverts},
        "worker_preload_s": {a["pid"]: a["preload_s"] for a in adverts},
        "store_bytes": store_bytes, "nodes": n_nodes, "links": n_links}
    print("workflow: " + json.dumps(result))
    return result


# ---------------------------------------------------------------------------
# phase 17: the rest of the engine (the pretraining example killed and
# resumed, the CLI, archives, crash recovery, chaos scenarios)
# ---------------------------------------------------------------------------

TRAIN_EXAMPLE = ROOT / "examples" / "train_lm_torch.py"
CRASH_SCRIPT = ROOT / "scripts" / "daemon_crash_test_torch.py"
PRETRAIN_STEPS, PRETRAIN_CHUNK, PRETRAIN_LR = 12, 4, 3e-3
PRETRAIN_ARGS = ["--preset", "110m", "--steps", str(PRETRAIN_STEPS),
                 "--chunk", str(PRETRAIN_CHUNK), "--lr", str(PRETRAIN_LR)]
# flash launches per step of the training recipe (phase 7's)
STEP_LAUNCHES = (24, 12, 12)
CHAOS_SCENARIOS = ("kill9-midstep", "zombie-worker", "broker-kill9")
SUBPROCESS_TIMEOUT_S = 300


def load_file(name: str, path: Path):
    """Import the module at ``path`` under ``name``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_env() -> dict:
    import os

    return dict(os.environ, PYTHONPATH=str(SRC))


def run_sub(args: list[str], cwd) -> tuple[subprocess.CompletedProcess,
                                             float]:
    """``python <args>`` in ``cwd``; the completed process and its wall."""
    t = time.perf_counter()
    out = subprocess.run([sys.executable, *args], cwd=cwd, env=sub_env(),
                         capture_output=True, text=True,
                         timeout=SUBPROCESS_TIMEOUT_S)
    return out, time.perf_counter() - t


def chain_rows(db: str) -> list[dict]:
    from repro_torch.provenance.store import (NodeType, ProvenanceStore,
                                              QueryBuilder)

    store = ProvenanceStore(db)
    try:
        return (QueryBuilder(store).nodes(NodeType.WORK_CHAIN)
                .project("pk", "process_state", "exit_status").all())
    finally:
        store.close()


def committed_step(db: str, pk: int) -> int:
    """The chain's step in its last durable engine checkpoint."""
    from repro_torch.provenance.store import ProvenanceStore

    store = ProvenanceStore(db)
    try:
        ck = store.load_checkpoint(pk)
    finally:
        store.close()
    if not ck:
        return 0
    return ck["extras"]["ctx"].get("step", {}).get("__raw__", 0)


def chain_outcome(db: str, pk: int) -> tuple[dict, list[str]]:
    """The chain's final metrics and its reports."""
    from repro_torch.provenance.store import LinkType, ProvenanceStore

    store = ProvenanceStore(db)
    try:
        metrics = next((store.load_data(p).value for p, _, label in
                        store.outgoing(pk, LinkType.RETURN)
                        if label == "final_metrics"), {})
        reports = [log["message"] for log in store.get_logs(pk)]
    finally:
        store.close()
    return metrics, reports


def engine_phase_17(torch, fa_ops, sweep_losses: list[float]) -> dict:
    """The pretraining example at full width on the card, in process and
    killed and resumed as a subprocess; the CLI, an archive round trip,
    crash recovery and chaos scenarios over real stores."""
    import os
    import shutil
    import signal
    import tempfile

    from repro_torch.caching import disable_caching
    from repro_torch.chaos.invariants import check_store
    from repro_torch.engine.launch import run_get_node
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.provenance.fsck import fsck
    from repro_torch.provenance.store import configure_store

    counters = (fa_ops.flash_attention_fwd, fa_ops.flash_attention_bwd_dq,
                fa_ops.flash_attention_bwd_dkv)
    for c in counters:
        c.launches = 0
        c.tensor_core_launches = 0
    tmp = tempfile.TemporaryDirectory(prefix="engine17_", dir=ROOT / "build")
    work = Path(tmp.name)
    result: dict = {}

    # (a) the chain in this process
    ex = load_file("train_lm_torch", TRAIN_EXAMPLE)
    with disable_caching():
        store = configure_store(str(work / "inprocess.db"))
        set_default_runner(Runner(store=store))
        builder = ex.PretrainWorkChain.get_builder()
        builder.preset = ex.PRESETS["110m"]
        builder.total_steps = PRETRAIN_STEPS
        builder.chunk_steps = PRETRAIN_CHUNK
        builder.lr = PRETRAIN_LR
        builder.ckpt_dir = {"dir": str(work / "ckpt_a")}
        t = time.perf_counter()
        outputs, proc = run_get_node(builder)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t
        launches = [c.launches for c in counters]
        tc = [c.tensor_core_launches for c in counters]
        reports = [log["message"] for log in store.get_logs(proc.pk)]
        set_default_runner(None)
        store.close()
        configure_store(":memory:")
    check(proc.is_finished_ok, f"pretrain (a): {proc.exit_code}; "
                               f"reports {reports}")
    metrics = outputs["final_metrics"].value
    losses = metrics["losses"]
    check(metrics["steps"] == PRETRAIN_STEPS
          and len(losses) == PRETRAIN_STEPS // PRETRAIN_CHUNK
          and all(math.isfinite(x) for x in losses),
          f"pretrain (a) metrics {metrics}")
    want = [n * PRETRAIN_STEPS for n in STEP_LAUNCHES]
    check(launches == want and tc == launches,
          f"pretrain (a) launches {launches} (tensor-core {tc}), want "
          f"{want}")
    result["in_process"] = {"wall_s": wall_a, "losses": losses,
                            "launches": dict(zip(FLASH_NAMES, launches))}
    print(f"engine (a): PretrainWorkChain {PRETRAIN_STEPS} steps in "
          f"{wall_a:.3f} s, losses {losses}, launches "
          f"{dict(zip(FLASH_NAMES, launches))}")

    # (b) the example as a subprocess, SIGKILLed once its first chunk is
    # committed, then resumed
    run_dir = work / "b"
    run_dir.mkdir()
    db = str(run_dir / "examples_out" / "train_lm.db")
    log_path = work / "b.log"
    t = time.perf_counter()
    with open(log_path, "w") as log:
        child = subprocess.Popen(
            [sys.executable, str(TRAIN_EXAMPLE), *PRETRAIN_ARGS],
            cwd=run_dir, env=sub_env(), stdout=log, stderr=subprocess.STDOUT)
        pk, step = None, 0
        try:
            while child.poll() is None:
                check(time.perf_counter() - t < SUBPROCESS_TIMEOUT_S,
                      "pretrain (b): no chunk committed in time")
                if pk is None and os.path.exists(db):
                    rows = chain_rows(db)
                    pk = rows[0]["pk"] if rows else None
                if pk is not None:
                    step = committed_step(db, pk)
                    if step >= PRETRAIN_CHUNK:
                        break
                time.sleep(0.02)
        finally:
            child.send_signal(signal.SIGKILL)
            child.wait()
    t_kill = time.perf_counter()
    check(child.returncode == -signal.SIGKILL and pk is not None,
          f"pretrain (b): exit {child.returncode} before a commit; "
          f"{log_path.read_text()[-2000:]}")
    check(chain_rows(db)[0]["process_state"] not in ("finished",
                                                     "excepted", "killed"),
          "pretrain (b): the chain ended before the kill")
    resumed, _ = run_sub([str(TRAIN_EXAMPLE), "--resume", str(pk)], run_dir)
    kill_to_finish = time.perf_counter() - t_kill
    check(resumed.returncode == 0 and "state=finished" in resumed.stdout,
          f"pretrain (b) resume: {resumed.returncode} {resumed.stdout} "
          f"{resumed.stderr[-2000:]}")
    row = chain_rows(db)[0]
    metrics_b, reports_b = chain_outcome(db, pk)
    losses_b = metrics_b.get("losses", [])
    check(row["process_state"] == "finished" and row["exit_status"] == 0
          and metrics_b.get("steps") == PRETRAIN_STEPS,
          f"pretrain (b): {row}, metrics {metrics_b}")
    check(f"restored model checkpoint at step {step}" in reports_b,
          f"pretrain (b) reports {reports_b}")
    check(losses_close(losses_b, losses),
          f"pretrain (b) losses {losses_b} != (a) {losses}")
    result["kill_resume"] = {
        "killed_at_step": step, "losses": losses_b,
        "bit_equal": losses_b == losses, "kill_to_finish_s": kill_to_finish,
        "first_run_s": t_kill - t}
    print(f"engine (b): killed at step {step}, resumed to "
          f"{PRETRAIN_STEPS}; losses bit-equal to (a): "
          f"{losses_b == losses}; SIGKILL to finish {kill_to_finish:.3f} s")

    # (c) the CLI over (b)'s store, each command a subprocess
    cli = ["-m", "repro_torch.cli", "-p", db]
    commands = {
        "process list": ["process", "list"],
        "process report": ["process", "report", str(pk)],
        "process show": ["process", "show", str(pk)],
        "graph export": ["graph", "export", str(pk)],
        "stats": ["stats"],
        "store fsck": ["store", "fsck"],
        "chaos check": ["chaos", "check", "--pk", str(pk),
                        "--expect-terminal"],
    }
    walls, outs = {}, {}
    for name, args in commands.items():
        out, walls[name] = run_sub([*cli, *args], run_dir)
        check(out.returncode == 0, f"cli {name}: {out.returncode} "
                                   f"{out.stdout[-1000:]} {out.stderr[-1000:]}")
        outs[name] = out.stdout
    check("PretrainWorkChain" in outs["process list"],
          f"cli process list: {outs['process list']}")
    chunk_reports = [f"step {n}: loss=" for n in
                     range(PRETRAIN_CHUNK, PRETRAIN_STEPS + 1,
                           PRETRAIN_CHUNK)]
    check("PretrainWorkChain" in outs["process report"]
          and all(r in outs["process report"] for r in chunk_reports),
          f"cli process report: {outs['process report']}")
    check("findings (found) : 0" in outs["store fsck"],
          f"cli store fsck: {outs['store fsck']}")
    check("violations        : 0" in outs["chaos check"],
          f"cli chaos check: {outs['chaos check']}")
    result["cli_s"] = walls
    print("engine (c): cli walls " + json.dumps(
        {k: round(v, 3) for k, v in walls.items()}))

    # (d) an archive of the chain, imported into a fresh profile at the
    # same path (the manifest names the profile) and exported again
    first, again = work / "first.zip", work / "again.zip"
    steps_d = {}
    out, steps_d["create"] = run_sub([*cli, "archive", "create", "-o",
                                      str(first), "--pk", str(pk)], run_dir)
    check(out.returncode == 0, f"archive create: {out.stderr[-1000:]}")
    n_nodes = int(re.search(r": (\d+) node\(s\)", out.stdout).group(1))
    out, steps_d["inspect"] = run_sub([*cli, "archive", "inspect",
                                       str(first)], run_dir)
    check(out.returncode == 0 and "archive version 1" in out.stdout,
          f"archive inspect: {out.stdout} {out.stderr[-1000:]}")
    shutil.move(str(run_dir / "examples_out"), str(work / "b_source"))
    out, steps_d["import"] = run_sub([*cli, "archive", "import",
                                      str(first)], run_dir)
    check(out.returncode == 0 and f"imported {n_nodes} node(s)" in out.stdout,
          f"archive import: {out.stdout} {out.stderr[-1000:]}")
    out, steps_d["re-export"] = run_sub([*cli, "archive", "create", "-o",
                                         str(again), "--all"], run_dir)
    check(out.returncode == 0, f"archive re-export: {out.stderr[-1000:]}")
    check(first.read_bytes() == again.read_bytes(),
          "archive: the re-export differs from the first archive")
    out, steps_d["fsck"] = run_sub([*cli, "store", "fsck"], run_dir)
    check(out.returncode == 0 and "findings (found) : 0" in out.stdout,
          f"archive target fsck: {out.stdout} {out.stderr[-1000:]}")
    result["archive"] = {"bytes": first.stat().st_size, "nodes": n_nodes,
                         "walls_s": steps_d}
    print(f"engine (d): archive {first.stat().st_size} bytes, {n_nodes} "
          f"nodes; re-export byte-identical; walls " + json.dumps(
              {k: round(v, 3) for k, v in steps_d.items()}))

    # (e) crash recovery: the crash script's recipe, phase 16's jobs
    os.environ.pop("REPRO_CACHING", None)
    crash = load_file("daemon_crash_test_torch", CRASH_SCRIPT)
    out_e = crash.crash_recovery(str(work / "crash"), WORKFLOW_JOB,
                                 timeout=SWEEP_TIMEOUT_S)
    stats = out_e["broker"]
    requeues = stats["tasks_delivered"] - stats["tasks_enqueued"]
    check(out_e["restarts"] >= 1 and requeues >= 1,
          f"crash: {out_e['restarts']} restarts, {requeues} requeues")
    check(set(out_e["exit_statuses"].values()) == {0},
          f"crash: states {out_e['states']}, exit statuses "
          f"{out_e['exit_statuses']}")
    cstore = configure_store(out_e["store_path"])
    seed0 = next(
        cstore.load_data(p).value["losses"]
        for p, _, label in cstore.outgoing(out_e["pks"][0])
        if label == "metrics")
    check(losses_close(seed0, sweep_losses),
          f"crash: seed 0 losses {seed0} != phase 16 (a) {sweep_losses}")
    report = fsck(cstore, broker_db=out_e["broker_db"])
    invariants = check_store(cstore, out_e["pks"])
    check(report.clean, f"crash fsck: {report.counts()}")
    check(invariants.ok, f"crash check_store: {invariants.summary()}")
    cstore.close()
    configure_store(":memory:")
    result["crash"] = {"restarts": out_e["restarts"], "requeues": requeues,
                       "wall_s": out_e["wall_s"],
                       "dropped_clients": named_drops(stats)}
    print(f"engine (e): {crash.JOBS} jobs through crashing workers in "
          f"{out_e['wall_s']:.3f} s, {out_e['restarts']} restarts, "
          f"{requeues} requeues")

    # (f) chaos scenarios through the CLI, workers on this machine
    result["chaos"] = {}
    for name in CHAOS_SCENARIOS:
        out, wall = run_sub(["-m", "repro_torch.cli", "chaos", "run",
                             "--scenario", name, "--seed", "1", "--json",
                             "--workdir", str(work / f"chaos_{name}")],
                            work)
        doc = json.loads(out.stdout[out.stdout.index("{"):])
        check(out.returncode == 0 and doc["ok"] and not doc["violations"],
              f"chaos {name}: {doc['failures']} {doc['violations']}")
        requeues = (doc["broker_stats"]["tasks_delivered"]
                    - doc["broker_stats"]["tasks_enqueued"])
        if name == "kill9-midstep":
            check(requeues >= 1, f"chaos {name}: no requeue; "
                                 f"{doc['broker_stats']}")
        result["chaos"][name] = {
            "elapsed_s": doc["elapsed"], "restarts": doc["restarts"],
            "connect_wait_s": doc["connect_wait"], "requeues": requeues,
            "wall_s": wall}
        print(f"engine (f): {name} ok in {doc['elapsed']:.3f} s after "
              f"{doc['connect_wait']:.3f} s of worker start, "
              f"{doc['restarts']} restarts, {requeues} requeues")
    tmp.cleanup()
    print("engine17: " + json.dumps(result))
    return result


# ---------------------------------------------------------------------------
# phases 18 to 21: the MoE and VLM families (moonshot-v1-16b-a3b,
# llava-next-34b) at full width
# ---------------------------------------------------------------------------

MOE, VLM = "moonshot-v1-16b-a3b", "llava-next-34b"
MOE_BATCH, MOE_MAX_LEN, MOE_NEW = 4, 1024, 32
VLM_TEXT, VLM_NEW, VLM_MAX_LEN = 128, 32, 3072
FAMILY_DECODE_TIMED, FAMILY_PROFILED = 10, 3
# phase 20: layers, and rows x prompt tokens (a VLM's patches cut to
# VLM_PARITY_PATCHES for the CPU's time), new tokens
PARITY_FAMILY_LAYERS, PARITY_FAMILY_NEW = 4, 8
MOE_PARITY_BATCH, MOE_PARITY_PROMPT = 2, 64
VLM_PARITY_PATCHES, VLM_PARITY_TEXT = 256, 32
# phase 21: one GPUTrainJob per family, 2 layers (the card's memory:
# fp32 parameters, gradients and AdamW moments), 3 steps
FAMILY_TRAIN_LAYERS, FAMILY_TRAIN_STEPS = 2, 3
AUDIO_TRAIN_STEPS, AUDIO_TRAIN_LAYERS = 2, 8
FAMILY_JOBS = {
    MOE: {"arch": MOE, "reduced": False, "steps": FAMILY_TRAIN_STEPS,
          "batch": 8, "seq": 1024,
          "overrides": {"num_layers": FAMILY_TRAIN_LAYERS,
                        "attn_impl": "pallas"}},
    VLM: {"arch": VLM, "reduced": False, "steps": FAMILY_TRAIN_STEPS,
          "batch": 2, "seq": 128,
          "overrides": {"num_layers": FAMILY_TRAIN_LAYERS,
                        "attn_impl": "pallas"}},
    # whisper at 8 + 8 of its 32 + 32 layers: at full depth each step was
    # 69-92 s of host launches (the chunked loop's) and the job 301.70 s
    # for 2 steps, the smoke's largest item; 4 rows of 448 tokens beside
    # 1500 frames each
    AUDIO: {"arch": AUDIO, "reduced": False, "steps": AUDIO_TRAIN_STEPS,
            "batch": 4, "seq": AUDIO_MAX_LEN,
            "overrides": {"attn_impl": "pallas",
                          "num_layers": AUDIO_TRAIN_LAYERS,
                          "encoder_layers": AUDIO_TRAIN_LAYERS}},
}
#: why each job runs below its config's depth
FAMILY_TRAIN_CUTS = {
    MOE: "the card's memory: fp32 parameters, gradients and AdamW moments",
    VLM: "the card's memory: fp32 parameters, gradients and AdamW moments",
    AUDIO: "the smoke's time: the full-depth job took 301.70 s for 2 steps",
}


def free_card(torch) -> dict:
    """Release what earlier phases cached on the card; its free and
    total bytes after."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free, total = torch.cuda.mem_get_info()
    return {"free_bytes": free, "total_bytes": total}


def card_params(torch, cfg, seed: int):
    """``cfg``'s parameters drawn on the card in its param dtype (the
    route for full-width models: no host or fp32 copy of the tree);
    returns them, their count and bytes, and the seconds the draw took."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import build

    t = time.perf_counter()
    params = build(cfg).init_params_on_device(
        torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    leaves = [p for _, p in tree_leaves(params)]
    return (params, sum(p.numel() for p in leaves),
            sum(p.numel() * p.element_size() for p in leaves), secs)


def decode_bound_ms(cfg, params, kv_rows: list[int],
                    experts_touched: list[int] | None = None, *,
                    prefill_only: tuple[str, ...] = (),
                    extra_bytes: int = 0) -> dict:
    """The least time a decode step can take on this card: each weight the
    step needs read once, and each row's cache read up to its length, over
    the data sheet's memory rate. Of the embedding table the step needs
    the batch's rows (all of it when it is tied to the output head), of
    the projector nothing (only the prefill reads it), and of a MoE layer
    the experts its tokens were routed to (``experts_touched``, one count
    per layer, from this run's router). Leaves whose path starts with one
    of ``prefill_only`` are not read either (whisper's encoder and its
    cross-attention's K/V projections); ``extra_bytes`` are other cache
    bytes every step reads (whisper's cross K/V). ``dense_dispatch_ms`` is
    the time of the bytes the port's dense dispatch reads: every expert."""
    from repro_torch.models.common import tree_leaves

    def nbytes(p):
        return p.numel() * p.element_size()

    leaves = dict(tree_leaves(params))
    experts = {k for k in leaves if k.startswith("layers/moe/w_")}
    emb = leaves["embedding"]
    base = sum(nbytes(p) for k, p in leaves.items()
               if k not in experts and k not in ("embedding", "mm_projector")
               and not k.startswith(prefill_only))
    base += nbytes(emb) if cfg.tie_embeddings else \
        len(kv_rows) * cfg.d_model * emb.element_size()
    every_expert = sum(nbytes(leaves[k]) for k in experts)
    if experts:
        per_expert = every_expert // (cfg.num_layers * cfg.num_experts)
        check(experts_touched is not None
              and len(experts_touched) == cfg.num_layers,
              f"decode bound: routed experts per layer {experts_touched}")
        routed = sum(experts_touched) * per_expert
    else:
        routed = 0
    kv = sum(kv_rows) * cfg.num_layers * 2 * cfg.kv_heads_eff * cfg.hd * 2
    kv += extra_bytes
    return {"weight_bytes": base + routed, "routed_expert_bytes": routed,
            "every_expert_bytes": every_expert,
            "experts_touched": experts_touched, "kv_bytes": kv,
            "bound_ms": (base + routed + kv) / HBM_BYTES_PER_S * 1e3,
            "dense_dispatch_ms": (base + every_expert + kv)
            / HBM_BYTES_PER_S * 1e3}


def experts_routed(torch, step) -> list[int]:
    """The distinct experts each MoE layer's router picked in one call of
    ``step`` (the counts a decode step's bound reads)."""
    from repro_torch.models import mlp as mlp_mod

    top_k, counts = mlp_mod.top_k_stable, []

    def watched(probs, k):
        w, i = top_k(probs, k)
        counts.append(int(torch.unique(i).numel()))
        return w, i

    mlp_mod.top_k_stable = watched
    try:
        step()
    finally:
        mlp_mod.top_k_stable = top_k
    return counts


def zero_counters(counters) -> None:
    for c in counters:
        c.launches = 0
        if hasattr(c, "tensor_core_launches"):
            c.tensor_core_launches = 0


def moe_serve_phase(torch, da_ops, fa_ops) -> dict:
    """moonshot-v1-16b-a3b at full width and depth (48 layers, bf16
    weights drawn on the card), 8 requests through ``BatchScheduler``:
    every prefill on the flash kernel's tensor-core body, every decode
    step on the decode kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    from repro_torch.observability.metrics import get_registry
    from repro_torch.serving.serve import BatchScheduler, Request

    card = free_card(torch)
    cfg = get_config(MOE).replace(param_dtype="bfloat16",
                                  attn_impl="pallas", decode_impl="pallas")
    params, n_params, n_bytes, init_s = card_params(torch, cfg, 18)
    print(f"moe serve: {MOE} {n_params} parameters, {n_bytes} bytes bf16, "
          f"drawn on the card in {init_s:.2f} s; card before: {card}")
    bundle = build(cfg)
    gen = torch.Generator().manual_seed(18)
    prompts = [torch.randint(1, cfg.vocab_size,
                             (SERVE_PROMPTS[i % len(SERVE_PROMPTS)],),
                             generator=gen).tolist()
               for i in range(N_REQUESTS)]
    sched = BatchScheduler(bundle, params, batch_size=MOE_BATCH,
                           max_len=MOE_MAX_LEN, device="cuda")
    warm = Request(rid=-1, prompt=prompts[0][:16], max_new_tokens=2)
    sched.submit(warm)
    sched.run()
    torch.cuda.synchronize()

    steps = get_registry().counter("serving.decode_steps")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MOE_NEW)
            for i, p in enumerate(prompts)]
    steps_before = steps.value
    zero_counters((da_ops.decode_attention, fa_ops.flash_attention_fwd))
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": da_ops.decode_attention.launches,
                "flash_attention_fwd": fa_ops.flash_attention_fwd.launches}
    flash_tc = fa_ops.flash_attention_fwd.tensor_core_launches
    decode_steps = steps.value - steps_before
    check(all(r.done and r.finish_reason == "length"
              and len(r.generated) == MOE_NEW for r in reqs),
          "moe: not every request finished with its tokens: "
          f"{[(r.done, r.finish_reason, len(r.generated)) for r in reqs]}")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "moe: a generated token is out of vocab")
    layers = cfg.num_layers
    check(launches["flash_attention_fwd"] == layers * N_REQUESTS,
          f"moe flash launches {launches['flash_attention_fwd']} != "
          f"{layers} x {N_REQUESTS}")
    check(flash_tc == launches["flash_attention_fwd"],
          f"moe: {launches['flash_attention_fwd'] - flash_tc} flash "
          "launches missed the tensor-core body")
    check(launches["decode_attention"] == layers * decode_steps,
          f"moe decode launches {launches['decode_attention']} != {layers} "
          f"x {decode_steps}")
    tokens = sum(len(r.generated) for r in reqs)

    prefill_ms = {}
    for n in SERVE_PROMPTS:
        p = torch.tensor([prompts[SERVE_PROMPTS.index(n)]], device="cuda")
        row = bundle.init_cache(1, MOE_MAX_LEN, "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        tok, _ = sched.prefill_step(sched.params, {"tokens": p}, row)
        int(tok[0, 0])
        prefill_ms[str(n)] = (time.perf_counter() - t) * 1e3
        del row
    toks = torch.ones((MOE_BATCH, 1), dtype=torch.int64, device="cuda")
    kv_rows = [n + MOE_NEW // 2 for n in SERVE_PROMPTS]
    pos = torch.tensor(kv_rows, device="cuda")
    step_ms = []
    for _ in range(FAMILY_DECODE_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        nxt, _ = sched.decode_step(sched.params, sched.cache, toks, pos)
        nxt.cpu()
        step_ms.append((time.perf_counter() - t) * 1e3)
    step_ms.sort()
    profiled = device_share(torch, lambda: sched.decode_step(
        sched.params, sched.cache, toks, pos)[0].cpu(), FAMILY_PROFILED)
    touched = experts_routed(torch, lambda: sched.decode_step(
        sched.params, sched.cache, toks, pos)[0].cpu())
    bound = decode_bound_ms(cfg, params, kv_rows, touched)
    result = {
        "arch": MOE, "layers": layers, "cut": None,
        "parameters": n_params, "param_bytes": n_bytes, "init_s": init_s,
        "requests": N_REQUESTS, "prompts": list(SERVE_PROMPTS),
        "new_tokens": MOE_NEW, "batch": MOE_BATCH, "max_len": MOE_MAX_LEN,
        "wall_s": wall, "tokens_generated": tokens,
        "tokens_per_s": tokens / wall, "decode_steps": decode_steps,
        "launches": launches, "flash_tensor_core_launches": flash_tc,
        "prefill_ms_by_len": prefill_ms,
        "decode_step_ms_median": step_ms[len(step_ms) // 2],
        "decode_bound": bound,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "card_before": card, "profile_decode_step": profiled,
        "first_tokens": [r.generated[:8] for r in reqs[:2]],
    }
    print("moe serve: " + json.dumps(result))
    del sched, params
    return result


def vlm_serve_phase(torch, da_ops, fa_ops) -> dict:
    """llava-next-34b at full width and depth (60 layers, bf16 weights
    drawn on the card), one row of 2880 patch embeddings and 128 text
    tokens through ``make_prefill_step`` / ``make_decode_step`` (the
    reference's scheduler sends tokens only): the prefill on the flash
    kernel (3008 positions, 7 query heads per KV head), every decode step
    on the decode kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    from repro_torch.serving.serve import make_decode_step, make_prefill_step

    card = free_card(torch)
    print(f"vlm serve: card before the init: {card}")
    cfg = get_config(VLM).replace(param_dtype="bfloat16",
                                  attn_impl="pallas", decode_impl="pallas")
    params, n_params, n_bytes, init_s = card_params(torch, cfg, 19)
    print(f"vlm serve: {VLM} {n_params} parameters, {n_bytes} bytes bf16, "
          f"drawn on the card in {init_s:.2f} s")
    bundle = build(cfg)
    prefill, decode = make_prefill_step(bundle), make_decode_step(bundle)
    gen = torch.Generator(device="cuda").manual_seed(19)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (1, VLM_TEXT),
                                     generator=gen, device="cuda")}
    for name, (shape, dtype) in bundle.extra_inputs(1).items():
        batch[name] = torch.randn(shape, generator=gen, device="cuda",
                                  dtype=dtype)
    n = cfg.num_patches + VLM_TEXT
    # warm-up (library handles, allocator) outside the counted run
    warm = bundle.init_cache(1, VLM_MAX_LEN, "cuda")
    tok, warm = prefill(params, batch, warm)
    decode(params, warm, tok.long(), torch.tensor(n, device="cuda"))
    del warm
    torch.cuda.synchronize()

    zero_counters((da_ops.decode_attention, fa_ops.flash_attention_fwd))
    cache = bundle.init_cache(1, VLM_MAX_LEN, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, cache = prefill(params, batch, cache)
    out = [tok.cpu()]
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step_ms = []
    for i in range(VLM_NEW - 1):
        t = time.perf_counter()
        tok, cache = decode(params, cache, tok.long(),
                            torch.tensor(n + i, device="cuda"))
        out.append(tok.cpu())
        step_ms.append((time.perf_counter() - t) * 1e3)
    wall = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1)
    launches = {"decode_attention": da_ops.decode_attention.launches,
                "flash_attention_fwd": fa_ops.flash_attention_fwd.launches}
    flash_tc = fa_ops.flash_attention_fwd.tensor_core_launches
    layers = cfg.num_layers
    check(tokens.shape == (1, VLM_NEW) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
        f"vlm tokens {tokens.tolist()}")
    check(launches["flash_attention_fwd"] == layers and flash_tc == layers,
          f"vlm flash launches {launches['flash_attention_fwd']} "
          f"(tensor-core {flash_tc}) != {layers}")
    check(launches["decode_attention"] == layers * (VLM_NEW - 1),
          f"vlm decode launches {launches['decode_attention']} != "
          f"{layers} x {VLM_NEW - 1}")
    step_ms.sort()
    pos = torch.tensor(n + VLM_NEW // 2, device="cuda")
    profiled = device_share(torch, lambda: decode(
        params, cache, tok.long(), pos)[0].cpu(), FAMILY_PROFILED)
    bound = decode_bound_ms(cfg, params, [n + VLM_NEW // 2])
    result = {
        "arch": VLM, "layers": layers, "cut": None,
        "parameters": n_params, "param_bytes": n_bytes, "init_s": init_s,
        "batch": 1, "patches": cfg.num_patches, "text": VLM_TEXT,
        "positions": n, "new_tokens": VLM_NEW, "max_len": VLM_MAX_LEN,
        "wall_s": wall, "prefill_ms": prefill_ms,
        "prefill_positions_per_s": n / prefill_ms * 1e3,
        "decode_step_ms_median": step_ms[len(step_ms) // 2],
        "decode_bound": bound, "launches": launches,
        "flash_tensor_core_launches": flash_tc,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "card_before": card, "profile_decode_step": profiled,
        "first_tokens": tokens[:, :8].tolist(),
    }
    print("vlm serve: " + json.dumps(result))
    del cache, params
    return result


def family_parity_phase(torch, da_ops, fa_ops) -> dict:
    """Each family at full width and 4 layers in float32: greedy tokens on
    the card (the flash and decode kernels) identical to the CPU's (plain
    versions), from the same parameters (drawn on the card, copied to the
    host; attention projections fan-in scaled). Reports the smallest
    top-2 logit margin and, for the MoE, the smallest gap between the
    k-th and (k+1)-th router probability of any token."""
    from repro_torch.configs import get_config
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.models.common import map_tree
    from repro_torch.models.registry import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    top_k = mlp_mod.top_k_stable
    gaps = []

    def watched_top_k(probs, k):
        srt = torch.sort(probs, dim=-1, descending=True).values
        gaps.append(float((srt[..., k - 1] - srt[..., k]).min()))
        return top_k(probs, k)

    result = {}
    for arch, seed in ((MOE, 20), (VLM, 21)):
        free_card(torch)
        cfg = get_config(arch).replace(
            num_layers=PARITY_FAMILY_LAYERS, dtype="float32",
            kv_cache_dtype="float32", param_dtype="float32",
            attn_impl="pallas", decode_impl="pallas")
        gen = torch.Generator().manual_seed(seed)
        if arch == VLM:
            cfg = cfg.replace(num_patches=VLM_PARITY_PATCHES)
            b, s = 1, VLM_PARITY_TEXT
        else:
            b, s = MOE_PARITY_BATCH, MOE_PARITY_PROMPT
        bundle = build(cfg)
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (b, s),
                                         generator=gen)}
        for name, (shape, dtype) in bundle.extra_inputs(b).items():
            batch[name] = torch.randn(shape, generator=gen, dtype=dtype)
        params, _, _, _ = card_params(torch, cfg, seed)
        params = fan_in_scaled(cfg, params)
        max_len = cfg.num_patches + batch["tokens"].shape[1] \
            + PARITY_FAMILY_NEW
        runs, secs, launched, router_gap = {}, {}, {}, {}
        mlp_mod.top_k_stable = watched_top_k
        try:
            for dev in ("cuda", "cpu"):
                p = params if dev == "cuda" else map_tree(
                    lambda t: t.cpu(), params)
                zero_counters((da_ops.decode_attention,
                               fa_ops.flash_attention_fwd))
                gaps.clear()
                t = time.perf_counter()
                runs[dev] = greedy_margins(torch, bundle, p, batch,
                                           PARITY_FAMILY_NEW, max_len, dev)
                secs[dev] = time.perf_counter() - t
                launched[dev] = {
                    "decode_attention": da_ops.decode_attention.launches,
                    "flash_attention_fwd": fa_ops.flash_attention_fwd.launches}
                router_gap[dev] = min(gaps) if gaps else None
                del p
        finally:
            mlp_mod.top_k_stable = top_k
        del params
        card, cpu = runs["cuda"][0], runs["cpu"][0]
        if not torch.equal(card, cpu):
            row, step = (card != cpu).nonzero()[0].tolist()
            raise SmokeFailure(
                f"{arch} f32 greedy tokens differ: card {card.tolist()} cpu "
                f"{cpu.tolist()}; first at row {row} step {step}, where the "
                f"CPU's top-2 logit margin is "
                f"{float(runs['cpu'][1][row, step]):.3e}")
        layers = cfg.num_layers
        want = {"decode_attention": layers * (PARITY_FAMILY_NEW - 1),
                "flash_attention_fwd": layers}
        check(launched["cuda"] == want,
              f"{arch} parity launches {launched['cuda']} != {want}")
        check(launched["cpu"] == {k: 0 for k in want},
              f"{arch} parity: the CPU run launched {launched['cpu']}")
        margin = float(runs["cpu"][1].min())
        result[arch] = {"layers": layers, "tokens": card.tolist(),
                        "min_logit_margin": margin,
                        "min_router_gap": router_gap, "seconds": secs}
        print(f"{arch} parity f32 ({layers} layers, tokens "
              f"{tuple(batch['tokens'].shape)}"
              + (f", {cfg.num_patches} patches" if arch == VLM else "")
              + f"): card and cpu tokens identical: {card.tolist()}; "
              f"smallest top-2 margin {margin:.3e}; smallest router gap "
              f"{router_gap}")
    return result


def family_train_phase(torch, fa_ops) -> dict:
    """One ``GPUTrainJob`` per family through a ``Runner`` at full width,
    the MoE and the VLM at 2 layers (the card's memory: fp32 parameters,
    gradients and AdamW moments) for 3 steps, whisper at 8 + 8 layers (the
    smoke's time) for 2: finished ok, finite losses, every flash launch (forward, its remat recompute, dq
    and dk/dv; whisper's decoder self-attention only, its encoder and
    cross-attention being on the chunked path) on the tensor-core bodies,
    and the MoE's aux loss positive and finite at every layer call."""
    import os
    import tempfile

    from repro_torch.caching import disable_caching
    from repro_torch.calcjobs import GPUTrainJob
    from repro_torch.configs import get_config
    from repro_torch.core import Dict
    from repro_torch.engine.runner import Runner, set_default_runner
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.provenance.store import configure_store

    counters = (fa_ops.flash_attention_fwd, fa_ops.flash_attention_bwd_dq,
                fa_ops.flash_attention_bwd_dkv)
    moe_forward = mlp_mod.moe_forward
    aux_seen = []

    def watched_moe(cfg, p, x):
        out, aux = moe_forward(cfg, p, x)
        aux_seen.append(aux.detach())
        return out, aux

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(prefix="family_", dir=ROOT / "build")
    result = {}
    with disable_caching():
        for arch, config in FAMILY_JOBS.items():
            card = free_card(torch)
            store = configure_store(os.path.join(tmp.name, f"{arch}.db"))
            runner = Runner(store=store)
            set_default_runner(runner)
            zero_counters(counters)
            aux_seen.clear()
            mlp_mod.moe_forward = watched_moe
            try:
                t = time.perf_counter()
                outputs, proc = runner.run(GPUTrainJob,
                                           {"config": Dict(config)})
                wall = time.perf_counter() - t
            finally:
                mlp_mod.moe_forward = moe_forward
            launches = dict(zip(FLASH_NAMES, (c.launches for c in counters)))
            tc = [c.tensor_core_launches for c in counters]
            check(proc.is_finished_ok, f"{arch} train job: {proc.exit_code}; "
                                       f"{job_reasons(runner)}")
            losses = outputs["metrics"].value["losses"]
            steps = config["steps"]
            check(len(losses) == steps
                  and all(math.isfinite(x) for x in losses),
                  f"{arch} train losses {losses}")
            layers = config["overrides"].get("num_layers",
                                             get_config(arch).num_layers)
            want = {"flash_attention_fwd": 2 * layers * steps,
                    "flash_attention_bwd_dq": layers * steps,
                    "flash_attention_bwd_dkv": layers * steps}
            check(launches == want, f"{arch} train launches {launches} != "
                                    f"{want}")
            check(tc == list(launches.values()),
                  f"{arch} train tensor-core launches {tc} of {launches}")
            # each MoE layer's forward, then its recompute in the backward
            # (which stops once it has what the backward needs)
            aux = [float(a) for a in aux_seen]
            if arch == MOE:
                check(len(aux) >= layers * steps
                      and all(math.isfinite(a) and a > 0 for a in aux),
                      f"{arch} aux losses {aux}")
            else:
                check(not aux, f"{arch} ran a MoE layer")
            cut = None if layers == get_config(arch).num_layers else (
                f"depth {layers} of {get_config(arch).num_layers} layers "
                f"({FAMILY_TRAIN_CUTS[arch]})")
            result[arch] = {
                "layers": layers, "cut": cut,
                "batch": config["batch"], "seq": config["seq"],
                "losses": losses, "aux_loss": aux, "wall_s": wall,
                "launches": launches, "tensor_core_launches": tc,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "card_before": card}
            print(f"family train {arch}: losses {losses}, wall {wall:.3f} s, "
                  f"peak {result[arch]['peak_memory_bytes']} bytes, launches "
                  f"{launches}" + (f", aux min {min(aux):.6f} max "
                                   f"{max(aux):.6f}" if aux else ""))
            set_default_runner(None)
            store.close()
            configure_store(":memory:")
            del outputs, proc, runner, store
    tmp.cleanup()
    print("family train: " + json.dumps(result))
    return result


# ---------------------------------------------------------------------------
# phases 22 and 23: the audio family (whisper-large-v3) at full width
# ---------------------------------------------------------------------------

# phase 23: encoder and decoder layers, rows, prompt tokens, new tokens
PARITY_AUDIO_LAYERS, PARITY_AUDIO_BATCH = 4, 2
PARITY_AUDIO_PROMPT, PARITY_AUDIO_NEW = 4, 16
#: leaves a whisper decode step does not read: the encoder, and the
#: cross-attention's K/V projections (the prefill fills the cross cache)
AUDIO_PREFILL_ONLY = ("enc_layers/", "enc_ln/", "dec_layers/cross_attn/wk",
                      "dec_layers/cross_attn/wv", "dec_layers/cross_attn/bk",
                      "dec_layers/cross_attn/bv")


def audio_prefill_profile(torch, cfg, params, batch, wall_ms: float
                          ) -> dict:
    """The prefill's launches and device time at full depth, from the
    profiler at 1 + 1 and 2 + 2 layers (the same width, frames, prompt
    and parameters, the stacks' first layers): each encoder and decoder
    layer runs the same code, so the full count is the 1 + 1 count plus
    (layers - 1) times the difference. A profile of the full prefill
    holds ~6e5 kernels and ~2e6 host events, whose processing takes the
    profiler minutes; these windows hold 2-4% of them."""
    from repro_torch.models.common import map_tree
    from repro_torch.models.registry import build
    from repro_torch.serving.serve import make_prefill_step

    got = {}
    for k in (1, 2):
        sub = cfg.replace(num_layers=k, encoder_layers=k)
        bundle = build(sub)
        p = dict(params, enc_layers=map_tree(lambda t: t[:k],
                                             params["enc_layers"]),
                 dec_layers=map_tree(lambda t: t[:k], params["dec_layers"]))
        prefill = make_prefill_step(bundle)

        def one():
            c = bundle.init_cache(AUDIO_BATCH, AUDIO_MAX_LEN, "cuda")
            int(prefill(p, batch, c)[0][0, 0])

        got[k] = device_share(torch, one, 1, expect="flash_fwd")
    layers = cfg.num_layers
    check(cfg.encoder_layers == layers, "audio profile: the stacks differ "
          f"in depth ({cfg.encoder_layers} and {layers})")

    def full(key):
        return got[1][key] + (layers - 1) * (got[2][key] - got[1][key])

    kinds = set(got[1]["device_ms_by_kind"]) | set(got[2]["device_ms_by_kind"])
    by_kind = {kind: got[1]["device_ms_by_kind"].get(kind, 0.0)
               + (layers - 1) * (got[2]["device_ms_by_kind"].get(kind, 0.0)
                                 - got[1]["device_ms_by_kind"].get(kind, 0.0))
               for kind in kinds}
    device = full("device_ms")
    return {"launches_per_run": full("launches_per_run"), "device_ms": device,
            "wall_ms": wall_ms, "idle_share": max(0.0, 1.0 - device / wall_ms),
            "device_ms_by_kind": by_kind,
            "windows": {f"{k}+{k}": {key: got[k][key] for key in (
                "wall_ms", "device_ms", "launches_per_run",
                "launches_by_kind", "device_ms_by_kind")} for k in got}}


def audio_serve_phase(torch, da_ops, fa_ops) -> dict:
    """whisper-large-v3 at full width and depth (32 encoder and 32 decoder
    layers, bf16 weights drawn on the card) through ``make_prefill_step``
    / ``make_decode_step``: two batches of 8 rows, each row 1500 frame
    embeddings (one 30 s window) and a prompt of 4 tokens, then of 132
    (128 of the previous window's text before the 4), 124 new tokens each
    into a cache of 448. The decoder's self-attention takes the flash
    forward in the prefill and the decode kernel in every step; the
    encoder and the cross-attention stay on the chunked path."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    from repro_torch.serving.serve import make_decode_step, make_prefill_step

    card = free_card(torch)
    cfg = get_config(AUDIO).replace(param_dtype="bfloat16",
                                    attn_impl="pallas", decode_impl="pallas")
    params, n_params, n_bytes, init_s = card_params(torch, cfg, 22)
    print(f"audio serve: {AUDIO} {n_params} parameters, {n_bytes} bytes "
          f"bf16, drawn on the card in {init_s:.2f} s; card before: {card}")
    bundle = build(cfg)
    prefill, decode = make_prefill_step(bundle), make_decode_step(bundle)
    gen = torch.Generator(device="cuda").manual_seed(22)
    batches = []
    for n in AUDIO_PROMPTS:
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (AUDIO_BATCH, n),
                                         generator=gen, device="cuda")}
        for name, (shape, dtype) in bundle.extra_inputs(AUDIO_BATCH).items():
            batch[name] = torch.randn(shape, generator=gen, device="cuda",
                                      dtype=dtype)
        batches.append(batch)
    # warm-up (library handles, allocator) outside the counted run
    warm = bundle.init_cache(AUDIO_BATCH, AUDIO_MAX_LEN, "cuda")
    tok, warm = prefill(params, batches[0], warm)
    decode(params, warm, tok.long(),
           torch.tensor(AUDIO_PROMPTS[0], device="cuda"))
    del warm
    torch.cuda.synchronize()

    counters = (da_ops.decode_attention, fa_ops.flash_attention_fwd)
    zero_counters(counters)
    prefill_ms, step_ms, tokens, caches = [], [], [], []
    t0 = time.perf_counter()
    for n, batch in zip(AUDIO_PROMPTS, batches):
        cache = bundle.init_cache(AUDIO_BATCH, AUDIO_MAX_LEN, "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        tok, cache = prefill(params, batch, cache)
        out = [tok.cpu()]
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        for i in range(AUDIO_NEW - 1):
            t = time.perf_counter()
            tok, cache = decode(params, cache, tok.long(),
                                torch.tensor(n + i, device="cuda"))
            out.append(tok.cpu())
            step_ms.append((time.perf_counter() - t) * 1e3)
        tokens.append(torch.cat(out, dim=1))
        caches.append((cache, tok))
    wall = time.perf_counter() - t0
    launches = {"decode_attention": da_ops.decode_attention.launches,
                "flash_attention_fwd": fa_ops.flash_attention_fwd.launches}
    flash_tc = fa_ops.flash_attention_fwd.tensor_core_launches
    layers, n_batches = cfg.num_layers, len(AUDIO_PROMPTS)
    for toks in tokens:
        check(toks.shape == (AUDIO_BATCH, AUDIO_NEW) and bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"audio tokens {toks.tolist()}")
    check(launches["flash_attention_fwd"] == layers * n_batches
          and flash_tc == launches["flash_attention_fwd"],
          f"audio flash launches {launches['flash_attention_fwd']} "
          f"(tensor-core {flash_tc}) != {layers} x {n_batches}")
    check(launches["decode_attention"] == layers * n_batches * (AUDIO_NEW - 1),
          f"audio decode launches {launches['decode_attention']} != "
          f"{layers} x {n_batches} x {AUDIO_NEW - 1}")
    step_ms.sort()
    peak = torch.cuda.max_memory_allocated()

    prof_prefill = audio_prefill_profile(torch, cfg, params, batches[0],
                                         prefill_ms[0])
    # a decode step of the second batch, mid-generation, under the profiler
    cache, tok = caches[-1]
    n = AUDIO_PROMPTS[-1]
    pos = torch.tensor(n + AUDIO_PROFILED_STEP, device="cuda")
    prof_decode = device_share(torch, lambda: decode(
        params, cache, tok.long(), pos)[0].cpu(), FAMILY_PROFILED,
        expect="decode_attention")
    cross = 2 * cfg.num_layers * AUDIO_BATCH * cfg.num_frames \
        * cfg.kv_heads_eff * cfg.hd * 2
    bound = decode_bound_ms(cfg, params,
                            [n + AUDIO_PROFILED_STEP + 1] * AUDIO_BATCH,
                            prefill_only=AUDIO_PREFILL_ONLY,
                            extra_bytes=cross)
    bound["cross_cache_bytes"] = cross
    result = {
        "arch": AUDIO, "encoder_layers": cfg.encoder_layers,
        "decoder_layers": layers, "cut": None,
        "parameters": n_params, "param_bytes": n_bytes, "init_s": init_s,
        "batch": AUDIO_BATCH, "frames": cfg.num_frames,
        "prompts": list(AUDIO_PROMPTS), "new_tokens": AUDIO_NEW,
        "max_len": AUDIO_MAX_LEN, "wall_s": wall,
        "tokens_generated": n_batches * AUDIO_BATCH * AUDIO_NEW,
        "tokens_per_s": n_batches * AUDIO_BATCH * AUDIO_NEW / wall,
        "prefill_ms_by_prompt": dict(zip(map(str, AUDIO_PROMPTS),
                                         prefill_ms)),
        "decode_step_ms_median": step_ms[len(step_ms) // 2],
        "decode_steps": len(step_ms), "decode_bound": bound,
        "launches": launches, "flash_tensor_core_launches": flash_tc,
        "peak_memory_bytes": peak, "card_before": card,
        "profile_prefill": prof_prefill, "profile_decode_step": prof_decode,
        "first_tokens": [t[:2, :8].tolist() for t in tokens],
    }
    print("audio serve: " + json.dumps(result))
    print(f"audio serve: prefill {prefill_ms[0]:.2f} / {prefill_ms[1]:.2f} ms "
          f"({prof_prefill['launches_per_run']:.0f} launches, device "
          f"{prof_prefill['device_ms']:.2f} ms), decode step median "
          f"{result['decode_step_ms_median']:.2f} ms (device "
          f"{prof_decode['device_ms']:.3f} ms, idle "
          f"{prof_decode['idle_share']:.3f}, "
          f"{prof_decode['launches_per_run']:.0f} launches), bound "
          f"{bound['bound_ms']:.4f} ms ({bound['weight_bytes']} weight + "
          f"{bound['kv_bytes']} cache bytes), peak {peak} bytes")
    del caches, cache, params
    return result


def audio_parity_phase(torch, da_ops, fa_ops) -> dict:
    """whisper at full width, 4 encoder and 4 decoder layers, float32: the
    card's greedy tokens (the flash and decode kernels) identical to the
    CPU's (plain versions), from the same parameters (drawn on the card,
    copied to the host, attention projections fan-in scaled). Reports the
    smallest top-2 logit margin."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import map_tree
    from repro_torch.models.registry import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_card(torch)
    cfg = get_config(AUDIO).replace(
        num_layers=PARITY_AUDIO_LAYERS, encoder_layers=PARITY_AUDIO_LAYERS,
        dtype="float32", kv_cache_dtype="float32", param_dtype="float32",
        attn_impl="pallas", decode_impl="pallas")
    bundle = build(cfg)
    gen = torch.Generator().manual_seed(23)
    b = PARITY_AUDIO_BATCH
    batch = {"tokens": torch.randint(1, cfg.vocab_size,
                                     (b, PARITY_AUDIO_PROMPT), generator=gen)}
    for name, (shape, dtype) in bundle.extra_inputs(b).items():
        batch[name] = torch.randn(shape, generator=gen, dtype=dtype)
    params, _, _, _ = card_params(torch, cfg, 23)
    params = fan_in_scaled(cfg, params)
    max_len = PARITY_AUDIO_PROMPT + PARITY_AUDIO_NEW
    runs, secs, launched = {}, {}, {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else map_tree(lambda t: t.cpu(), params)
        zero_counters((da_ops.decode_attention, fa_ops.flash_attention_fwd))
        t = time.perf_counter()
        runs[dev] = greedy_margins(torch, bundle, p, batch, PARITY_AUDIO_NEW,
                                   max_len, dev)
        secs[dev] = time.perf_counter() - t
        launched[dev] = {
            "decode_attention": da_ops.decode_attention.launches,
            "flash_attention_fwd": fa_ops.flash_attention_fwd.launches}
        del p
    del params
    card, cpu = runs["cuda"][0], runs["cpu"][0]
    if not torch.equal(card, cpu):
        row, step = (card != cpu).nonzero()[0].tolist()
        raise SmokeFailure(
            f"audio f32 greedy tokens differ: card {card.tolist()} cpu "
            f"{cpu.tolist()}; first at row {row} step {step}, where the "
            f"CPU's top-2 logit margin is "
            f"{float(runs['cpu'][1][row, step]):.3e}")
    layers = cfg.num_layers
    want = {"decode_attention": layers * (PARITY_AUDIO_NEW - 1),
            "flash_attention_fwd": layers}
    check(launched["cuda"] == want,
          f"audio parity launches {launched['cuda']} != {want}")
    check(launched["cpu"] == {k: 0 for k in want},
          f"audio parity: the CPU run launched {launched['cpu']}")
    margin = float(runs["cpu"][1].min())
    result = {"encoder_layers": cfg.encoder_layers, "decoder_layers": layers,
              "frames": cfg.num_frames, "tokens": card.tolist(),
              "min_logit_margin": margin, "seconds": secs,
              "launches": launched["cuda"]}
    print(f"audio parity f32 ({layers} + {layers} layers, tokens "
          f"{tuple(batch['tokens'].shape)}, {cfg.num_frames} frames): card "
          f"and cpu tokens identical: {card.tolist()}; smallest top-2 margin "
          f"{margin:.3e}")
    return result


# ---------------------------------------------------------------------------
# phase 24: the dense LM served through a device mesh
# ---------------------------------------------------------------------------

# rows, prompt tokens, new tokens (the first from the prefill), cache:
# phase 4's longest prompt, its new-token count and its cache
MESH_BATCH, MESH_PROMPT, MESH_NEW, MESH_MAX_LEN = 4, 700, 64, 1024


def mesh_greedy(torch, bundle, params, cache, prompts, counters,
                profile: bool) -> dict:
    """A prefill of ``prompts`` and ``MESH_NEW - 1`` decode steps through
    the serving steps, each step's tokens read on the host: the tokens,
    the host ms of each decode step and each counter's launches; with
    ``profile``, also a profiled decode step (device time, idle share)."""
    from repro_torch.serving.serve import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(bundle), make_decode_step(bundle)
    zero_counters(counters)
    tok, cache = prefill(params, {"tokens": prompts}, cache)
    toks = [tok.cpu()]
    pos = torch.full((prompts.shape[0],), prompts.shape[1],
                     dtype=torch.int32, device="cuda")
    step_ms = []
    for _ in range(MESH_NEW - 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tok, cache = decode(params, cache, tok, pos)
        toks.append(tok.cpu())
        step_ms.append((time.perf_counter() - t) * 1e3)
        pos = pos + 1
    step_ms.sort()
    out = {"tokens": torch.cat(toks, dim=1),
           "step_ms_median": step_ms[len(step_ms) // 2],
           "launches": {c.__name__: c.launches for c in counters},
           "tensor_core_launches": {
               c.__name__: c.tensor_core_launches for c in counters
               if hasattr(c, "tensor_core_launches")}}
    if profile:
        # the last step again (it rewrites the same cache position)
        out["profile"] = device_share(
            torch, lambda: decode(params, cache, tok, pos - 1)[0].cpu(), 5,
            expect="decode_attention")
    return out


def mesh_serve_phase(torch, da_ops, fa_ops, smi: str) -> dict:
    """Full-width, full-depth ``aiida-demo-110m`` in bf16 through a 1 x 1
    NCCL mesh (``make_rules(..., fsdp=False)``; parameters and cache placed
    by ``distribute_tree``, the steps under ``axis_rules``) against the
    same run without rules: 4 rows of 700 prompt tokens from seed 0, 64
    new tokens, cache 1024. Identical tokens, equal decode and flash
    launches (every flash launch on the tensor-core body, every local
    shard on the card); the host ms per decode step both ways, run in
    turns (plain, mesh, mesh, plain)."""
    import os
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import (get_config, make_serving_mesh,
                                     setup_devices)
    from repro_torch.configs.devices import RENDEZVOUS_ENV
    from repro_torch.distributed.sharding import distribute_tree, make_rules
    from repro_torch.models.common import (axis_rules, cast_for_compute,
                                           tree_leaves)
    from repro_torch.models.registry import build

    cfg = get_config(ARCH).replace(attn_impl="pallas", decode_impl="pallas")
    bundle = build(cfg)
    params = cast_for_compute(
        bundle.init_params(torch.Generator().manual_seed(0), "cuda"),
        cfg.activation_dtype, torch.device("cuda"))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (MESH_BATCH, MESH_PROMPT)).astype(np.int32)
    ).to("cuda")
    counters = (da_ops.decode_attention, fa_ops.flash_attention_fwd)

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(prefix="mesh_", dir=ROOT / "build")
    rank_env = {"RANK": "0", "WORLD_SIZE": "1",
                RENDEZVOUS_ENV: os.path.join(tmp.name, "rendezvous")}
    os.environ.update(rank_env)
    try:
        setup_devices("cuda", 1)
        mesh = make_serving_mesh(data=1, model=1)
        rules = make_rules(cfg, mesh, fsdp=False)
        notes: list[str] = []
        mesh_params = distribute_tree(params, bundle.param_axes(), rules,
                                      mesh, notes)
        check(all(t.to_local().is_cuda
                  for _, t in tree_leaves(mesh_params)),
              "a parameter shard is not on the card")

        def plain(profile=False):
            return mesh_greedy(torch, bundle, params, bundle.init_cache(
                MESH_BATCH, MESH_MAX_LEN, "cuda"), prompts, counters,
                profile)

        def meshed(profile=False):
            cache = distribute_tree(
                bundle.init_cache(MESH_BATCH, MESH_MAX_LEN, "cuda"),
                bundle.cache_axes(), rules, mesh)
            with axis_rules(mesh, rules):
                return mesh_greedy(torch, bundle, mesh_params, cache,
                                   prompts, counters, profile)

        plain()                       # warm-up: library handles, allocator
        runs = [("plain", plain()), ("mesh", meshed()),
                ("mesh", meshed(True)), ("plain", plain(True))]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for name in rank_env:
            os.environ.pop(name, None)
        tmp.cleanup()
    layers = cfg.num_layers
    want = {"decode_attention": layers * (MESH_NEW - 1),
            "flash_attention_fwd": layers}
    base = runs[0][1]["tokens"]
    for kind, run in runs:
        check(torch.equal(run["tokens"], base),
              f"{kind} tokens differ from the first plain run's")
        check(run["launches"] == want,
              f"{kind} launches {run['launches']} != {want}")
        check(run["tensor_core_launches"]["flash_attention_fwd"]
              == layers, f"{kind} flash launches missed the tensor cores")
    check(bool(((base >= 0) & (base < cfg.vocab_size)).all()),
          "a generated token is out of vocab")
    ms = {kind: [r["step_ms_median"] for k, r in runs if k == kind]
          for kind in ("plain", "mesh")}
    result = {
        "rows": MESH_BATCH, "prompt": MESH_PROMPT, "new_tokens": MESH_NEW,
        "max_len": MESH_MAX_LEN, "mesh": {"data": 1, "model": 1},
        "placement_notes": notes, "tokens_identical": True,
        "launches": want,
        "decode_step_ms_median": ms,
        "mesh_host_ms_per_step": (sum(ms["mesh"]) - sum(ms["plain"]))
        / len(ms["mesh"]),
        "profiled_decode_step": {k: r["profile"] for k, r in runs
                                 if "profile" in r},
        "nvidia_smi": smi}
    print(f"mesh serve (runs plain, mesh, mesh, plain; {smi}): decode step "
          f"ms {ms}")
    print("mesh serve: " + json.dumps(result))
    return result


# ---------------------------------------------------------------------------
# phase 25: the dense LM trained through a device mesh
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS, MESH_CKPT_STEP = 4, 2


def mesh_train_run(torch, launch, args, cfg, counters, mesh: bool,
                   keep_step: int | None = None) -> dict:
    """One run of the launcher's loop (``train_rank`` on the 1 x 1 mesh, or
    ``run`` without one) with every counter from 0: each step's loss,
    grad_norm, launches and tensor-core launches by counter, its host ms
    (from the previous step's end to its own, synchronised: the batch's
    draw and copy, the step, the metrics' read), the peak memory, whether
    every local shard of the state is on the card, and with
    ``keep_step`` that step's state."""
    out = {"loss": [], "grad_norm": [], "launches": [], "tensor_core": [],
           "step_ms": []}
    prev = {"t": 0.0, "n": [(0, 0)] * len(counters)}

    def on_step(step, state, metrics):
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["step_ms"].append((now - prev["t"]) * 1e3)
        n = [(c.launches, c.tensor_core_launches) for c in counters]
        out["launches"].append([a - b for (a, _), (b, _) in
                                zip(n, prev["n"])])
        out["tensor_core"].append([a - b for (_, a), (_, b) in
                                   zip(n, prev["n"])])
        if step == 1:
            from repro_torch.models.common import is_dtensor, tree_leaves

            out["on_card"] = all(
                (t.to_local() if is_dtensor(t) else t).is_cuda
                for _, t in tree_leaves(state))
        if step == keep_step:
            out["kept"] = state
        prev["t"], prev["n"] = time.perf_counter(), n

    zero_counters(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prev["t"] = time.perf_counter()
    code = (launch.train_rank(args, cfg=cfg, on_step=on_step) if mesh
            else launch.run(args, cfg=cfg, on_step=on_step))
    check(code == 0, f"the launcher's loop exited with code {code}")
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["step_ms_median"] = sorted(out["step_ms"][1:])[
        (len(out["step_ms"]) - 1) // 2]        # step 1 builds the caches
    return out


def mesh_train_phase(torch, fa_ops, smi: str) -> dict:
    """Full-width, full-depth ``aiida-demo-110m`` trained through a 1 x 1
    NCCL mesh by the launcher's per-rank body, against the same loop
    without a mesh (module docstring, item 25)."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config, setup_devices
    from repro_torch.configs.devices import RENDEZVOUS_ENV
    from repro_torch.distributed.sharding import (make_rules, shard_batch,
                                                  tree_placements)
    from repro_torch.launch import train as launch
    from repro_torch.models.common import axis_rules, tree_leaves
    from repro_torch.models.registry import build
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.train_step import (make_train_step,
                                                 train_state_axes,
                                                 train_state_shapes)

    t_phase = time.perf_counter()
    cfg = get_config(ARCH).replace(attn_impl="pallas")
    bundle = build(cfg)
    counters = (fa_ops.flash_attention_fwd, fa_ops.flash_attention_bwd_dq,
                fa_ops.flash_attention_bwd_dkv)
    per_step = [2 * cfg.num_layers, cfg.num_layers, cfg.num_layers]

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(prefix="mesh_train_",
                                      dir=ROOT / "build")
    ckpt_dir = os.path.join(tmp.name, "ckpt")
    argv = ["--arch", ARCH, "--steps", str(MESH_TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "2",
            "--device", "cuda"]
    args = launch.parse_args(argv)
    ckpt_args = launch.parse_args([*argv, "--ckpt-dir", ckpt_dir,
                                   "--ckpt-every", str(MESH_CKPT_STEP)])
    rank_env = {"RANK": "0", "WORLD_SIZE": "1",
                RENDEZVOUS_ENV: os.path.join(tmp.name, "rendezvous")}
    os.environ.update(rank_env)
    try:
        setup_devices("cuda", 1)
        runs = [("plain", mesh_train_run(torch, launch, args, cfg, counters,
                                         False)),
                ("mesh", mesh_train_run(torch, launch, ckpt_args, cfg,
                                        counters, True, MESH_CKPT_STEP)),
                ("mesh", mesh_train_run(torch, launch, args, cfg, counters,
                                        True)),
                ("plain", mesh_train_run(torch, launch, args, cfg, counters,
                                         False))]
        main_run = runs[1][1]
        kept = main_run.pop("kept")
        # the step-2 checkpoint, written by the sharded save, restored
        # without a mesh
        restored = ckpt.restore_checkpoint(
            ckpt_dir, step=MESH_CKPT_STEP,
            target=train_state_shapes(bundle, launch.train_config(args)),
            device="cuda")
        kept_leaves = dict(tree_leaves(kept))
        unequal = [k for k, t in tree_leaves(restored)
                   if not torch.equal(t, kept_leaves[k].to_local())]
        check(not unequal, f"restored leaves differ from the mesh's state "
                           f"at step {MESH_CKPT_STEP}: {unequal}")
        # one more step from each state on step 3's batch
        tcfg = launch.train_config(args)
        batch = [b for _, b in zip(range(MESH_CKPT_STEP + 1), TokenStream(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                       batch_size=TRAIN_BATCH, seed=args.seed)))][-1]
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
        _, m_plain = make_train_step(bundle, tcfg)(restored, batch)
        mesh = kept["step"].device_mesh
        rules = make_rules(cfg, mesh, fsdp=False)
        pl = tree_placements(train_state_shapes(bundle, tcfg),
                             train_state_axes(bundle, tcfg), rules, mesh)
        with axis_rules(mesh, rules):
            _, m_mesh = make_train_step(bundle, tcfg, pl)(
                kept, shard_batch(batch, bundle.batch_axes(), rules, mesh))
        one_more = {"plain_from_restored": [float(m_plain["loss"]),
                                            float(m_plain["grad_norm"])],
                    "mesh_from_kept": [float(m_mesh["loss"]),
                                       float(m_mesh["grad_norm"])]}
        del kept, restored
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for name in rank_env:
            os.environ.pop(name, None)
        tmp.cleanup()

    base = runs[0][1]
    for kind, run in runs:
        check(all(math.isfinite(x) for x in run["loss"]),
              f"{kind}: non-finite loss {run['loss']}")
        check(len(run["loss"]) == MESH_TRAIN_STEPS, f"{kind}: steps")
        check(all(n == per_step for n in run["launches"]),
              f"{kind}: flash launches per step (fwd, dq, dkv) "
              f"{run['launches']} != {per_step}")
        check(all(n == per_step for n in run["tensor_core"]),
              f"{kind}: tensor-core launches per step {run['tensor_core']}")
        check(run["on_card"], f"{kind}: a state shard is not on the card")
        for what in ("loss", "grad_norm"):
            for got, want in zip(run[what], base[what]):
                check(abs(got - want) <= 1e-4 * abs(want),
                      f"{kind} {what} {run[what]} vs plain {base[what]}")
    (l_p, n_p), (l_m, n_m) = (one_more["plain_from_restored"],
                              one_more["mesh_from_kept"])
    check(abs(l_p - l_m) <= 1e-4 * abs(l_m) and
          abs(n_p - n_m) <= 1e-4 * abs(n_m),
          f"one more step: restored {one_more['plain_from_restored']} vs "
          f"mesh {one_more['mesh_from_kept']}")
    ms = {kind: [r["step_ms_median"] for k, r in runs if k == kind]
          for kind in ("plain", "mesh")}
    result = {
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": MESH_TRAIN_STEPS,
        "mesh": {"data": 1, "model": 1}, "checkpoint_step": MESH_CKPT_STEP,
        "losses": {f"{k}{i}": r["loss"] for i, (k, r) in enumerate(runs)},
        "grad_norms": {f"{k}{i}": r["grad_norm"]
                       for i, (k, r) in enumerate(runs)},
        "losses_bit_equal": all(r["loss"] == base["loss"] for _, r in runs),
        "grad_norms_bit_equal": all(r["grad_norm"] == base["grad_norm"]
                                    for _, r in runs),
        "launches_per_step_fwd_dq_dkv": per_step,
        "launches": dict(zip(("flash_attention_fwd",
                              "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv"),
                             map(sum, zip(*main_run["launches"])))),
        "restored_bit_equal": True, "one_more_step": one_more,
        "one_more_bit_equal": l_p == l_m,
        "step_ms": {f"{k}{i}": r["step_ms"] for i, (k, r) in enumerate(runs)},
        "step_ms_median": ms,
        "mesh_host_ms_per_step": (sum(ms["mesh"]) - sum(ms["plain"]))
        / len(ms["mesh"]),
        "peak_memory_bytes": {f"{k}{i}": r["peak_memory_bytes"]
                              for i, (k, r) in enumerate(runs)},
        "phase_wall_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    print(f"mesh train (runs plain, mesh, mesh, plain; {smi}): step ms "
          f"{ms}, losses bit-equal {result['losses_bit_equal']}, phase "
          f"{result['phase_wall_s']:.1f} s")
    print("mesh train: " + json.dumps(result))
    return result


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
    t_start = t = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t:.1f}s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    smi = smi_line()
    print(smi)

    kernels = [decode_phase(torch, da_ops, da_ref,
                            _build.build_log("decode_attention")),
               flash_phase(torch, fa_ops, fa_ref,
                           _build.build_log("flash_attention_fwd"))]
    cfg_full = get_config(ARCH).replace(attn_impl="pallas",
                                        decode_impl="pallas")
    served = serve_phase(torch, cfg_full, da_ops, fa_ops)
    parity = parity_phase(torch, cfg_full)
    kernels += flash_bwd_phase(torch, fa_ops, fa_ref,
                               _build.build_log("flash_attention_bwd"))
    trained = train_phase(torch, cfg_full, fa_ops)
    train_parity = train_parity_phase(torch, cfg_full)
    kernels.append(rglru_phase(torch, rg_ops, rg_ref,
                               _build.build_log("rglru_scan")))
    cfg_rg = get_config(HYBRID).replace(use_pallas=True)
    rg_params = host_params(torch, cfg_rg, 10)
    counters = (da_ops.decode_attention, fa_ops.flash_attention_fwd,
                fa_ops.flash_attention_bwd_dq, fa_ops.flash_attention_bwd_dkv,
                rg_ops.rglru_scan)
    hybrid = hybrid_serve_phase(torch, cfg_rg, rg_params, counters)
    hybrid_parity = hybrid_parity_phase(torch, cfg_rg, rg_params)
    del rg_params
    kernels.append(mlstm_phase(torch, ml_ops, ml_ref,
                               _build.build_log("mlstm_chunk")))
    cfg_x = get_config(XLSTM).replace(use_pallas=True)
    x_params = host_params(torch, cfg_x, 14)
    ssm = ssm_serve_phase(torch, cfg_x, x_params,
                          (*counters, ml_ops.mlstm_chunk))
    ssm_parity = ssm_parity_phase(torch, cfg_x, x_params)
    del x_params
    engine = engine_phase(torch, da_ops)
    workflow = workflow_phase(torch, fa_ops)
    calcjob = workflow["in_process"]["launches"]
    engine17 = engine_phase_17(torch, fa_ops,
                               workflow["in_process"]["losses"])
    pretrain = engine17["in_process"]["launches"]
    moe = moe_serve_phase(torch, da_ops, fa_ops)
    vlm = vlm_serve_phase(torch, da_ops, fa_ops)
    family_parity = family_parity_phase(torch, da_ops, fa_ops)
    family_train = family_train_phase(torch, fa_ops)
    audio = audio_serve_phase(torch, da_ops, fa_ops)
    audio_parity = audio_parity_phase(torch, da_ops, fa_ops)
    mesh = mesh_serve_phase(torch, da_ops, fa_ops, smi)
    mesh_train = mesh_train_phase(torch, fa_ops, smi)

    def trained_families(name):
        return sum(family_train[a]["launches"][name] for a in (MOE, VLM))

    def audio_train(name):
        return family_train[AUDIO]["launches"][name]

    # launches on each main path (serving, training, hybrid and ssm
    # serving, the engine, the calcjob, the pretraining chain, MoE and
    # VLM serving, their training, whisper's serving and training, the
    # dense LM served and trained through a mesh), each counted from 0
    by_path = {
        "decode_attention": {
            "serve": served["decode_launches"],
            "engine": engine["decode_launches"],
            "moe_serve": moe["launches"]["decode_attention"],
            "vlm_serve": vlm["launches"]["decode_attention"],
            "audio_serve": audio["launches"]["decode_attention"],
            "mesh_serve": mesh["launches"]["decode_attention"]},
        "flash_attention_fwd": {
            "serve": served["flash_launches"],
            "train": trained["launches"]["flash_attention_fwd"],
            "calcjob": calcjob["flash_attention_fwd"],
            "pretrain": pretrain["flash_attention_fwd"],
            "moe_serve": moe["launches"]["flash_attention_fwd"],
            "vlm_serve": vlm["launches"]["flash_attention_fwd"],
            "family_train": trained_families("flash_attention_fwd"),
            "audio_serve": audio["launches"]["flash_attention_fwd"],
            "audio_train": audio_train("flash_attention_fwd"),
            "mesh_serve": mesh["launches"]["flash_attention_fwd"],
            "mesh_train": mesh_train["launches"]["flash_attention_fwd"]},
        "flash_attention_bwd_dq": {
            "train": trained["launches"]["flash_attention_bwd_dq"],
            "calcjob": calcjob["flash_attention_bwd_dq"],
            "pretrain": pretrain["flash_attention_bwd_dq"],
            "family_train": trained_families("flash_attention_bwd_dq"),
            "audio_train": audio_train("flash_attention_bwd_dq"),
            "mesh_train": mesh_train["launches"]["flash_attention_bwd_dq"]},
        "flash_attention_bwd_dkv": {
            "train": trained["launches"]["flash_attention_bwd_dkv"],
            "calcjob": calcjob["flash_attention_bwd_dkv"],
            "pretrain": pretrain["flash_attention_bwd_dkv"],
            "family_train": trained_families("flash_attention_bwd_dkv"),
            "audio_train": audio_train("flash_attention_bwd_dkv"),
            "mesh_train": mesh_train["launches"]["flash_attention_bwd_dkv"]},
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
         "ssm_parity": ssm_parity, "engine": engine,
         "workflow": workflow, "engine17": engine17, "moe_serve": moe,
         "vlm_serve": vlm, "family_parity": family_parity,
         "family_train": family_train, "audio_serve": audio,
         "audio_parity": audio_parity, "mesh_serve": mesh,
         "mesh_train": mesh_train,
         "smoke_wall_s": time.perf_counter() - t_start}, indent=1))
    keys = ("name", "route", "body", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(f"smoke wall: {time.perf_counter() - t_start:.1f} s")
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
