"""Where a benchmark cell's train step spends the card's time, by the
program's own regions, and what the regions cost.

    python3 scripts/train_regions_card.py --workload granite-3-2b.train.4x4096 [--seed N]

Card only. Builds the cell's train state and donated step as
``cardbench/drivers/train.py`` does and warms them through the mix's
check steps, then:

1. times ``trace_steps`` steps without a profiler and as many under one,
   each between two synchronizes, and reads what the model's
   ``layer_slice`` counters moved by a step over both sets;
2. reduces the traced steps with ``cardbench.devtrace`` (device time by
   kernel kind, launches, idle) and ``cardbench.spans`` (device time by
   the region that owns it);
3. takes one donated step from a copy of the state without a profiler and
   one from the same copy under ``torch.profiler``, and compares every
   state leaf and metric with ``torch.equal`` (the copy is kept in host
   memory: two states do not fit the card).

Prints a summary and, last, one JSON line, also written to
``chiprun_out/train_regions.<workload>.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

#: the train step's phases that are neither forward nor backward
OPTIMIZER = ("train.own", "train.clip", "train.optimizer")


def owned(name: str) -> bool:
    """A region below the step's forward and backward phases."""
    return name.startswith("model.") or name in OPTIMIZER


def largest_gaps(prof, n: int = 5) -> list[list]:
    """The window's ``n`` longest stretches with no device operation:
    [start from the window's start (ms), length (ms), the host op then]."""
    from torch.autograd import DeviceType

    from cardbench import devtrace

    device, host, window = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            if not e.is_user_annotation:
                device.append((a, b))
        elif e.name == devtrace.WINDOW_RANGE:
            window = (a, b)
        else:
            host.append((a, b, e.name))
    lo, hi = window
    holes = sorted(devtrace.gaps(devtrace.union(device), lo, hi),
                   key=lambda g: g[0] - g[1])[:n]
    labels = devtrace.host_activity(host, [(a + b) / 2 for a, b in holes])
    return [[(a - lo) / 1e3, (b - a) / 1e3, label]
            for (a, b), label in zip(holes, labels)]


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from cardbench import bench, devtrace, inputs, spans
    from repro_torch.models.common import layer_slice, map_tree, tree_leaves
    from repro_torch.models.registry import build
    from repro_torch.training import optim
    from repro_torch.training.train_step import TrainConfig, make_train_step

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 34)
    args = ap.parse_args(argv)
    spec = bench.spec()
    w = bench.workload(spec, args.workload)
    cfg, traffic = bench.config(spec, w["config"]), bench.traffic(w["traffic"])
    drv = bench.driver(traffic["driver"])
    device = torch.device("cuda")
    sync = torch.cuda.synchronize

    bundle = build(drv.port_config(cfg))
    ocfg = optim.OptimConfig(**cfg["optimizer"])
    params = drv.program_params(cfg, bundle, args.seed, device)
    state = {"step": torch.zeros((), dtype=torch.int32, device=device),
             "params": params, "opt": optim.opt_init(ocfg, params)}
    del params
    step = make_train_step(bundle, TrainConfig(optim=ocfg), donate=True)
    feed = inputs.Feed(args.seed, traffic["rows"], traffic["seq_len"],
                       cfg["vocab_size"], device)
    for _ in range(traffic["check_steps"]):
        state, _ = step(state, feed.next())
    sync()
    out: dict = {"workload": args.workload, "seed": args.seed,
                 "card": torch.cuda.get_device_name(0),
                 "torch": torch.__version__}

    # 1. and 2. steps untraced, then traced as the benchmark traces them
    n = traffic["trace_steps"]
    counted = (layer_slice.gathered, layer_slice.selected)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = step(state, feed.next())
    sync()
    out["step_s_untraced"] = (time.perf_counter() - t0) / n
    out["peak_bytes_untraced"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.WINDOW_RANGE):
            t0 = time.perf_counter()
            for _ in range(n):
                state, _ = step(state, feed.next())
            sync()
            out["step_s_traced"] = (time.perf_counter() - t0) / n
    out["peak_bytes_traced"] = torch.cuda.max_memory_allocated()
    out["layer_slice_per_step"] = {
        "gathered": (layer_slice.gathered - counted[0]) / (2 * n),
        "selected": (layer_slice.selected - counted[1]) / (2 * n)}
    tr = devtrace.from_profiler(prof, bench.kinds())
    sp = spans.from_profiler(prof)
    ms = {k: 1e3 * v / n for k, v in sp.by_owner.items()}
    out["trace"] = {
        "launches_per_step": tr.launches / n,
        "step_device_ms": 1e3 * tr.busy_s / n,
        "device_idle": 100.0 * (1.0 - tr.busy_s / tr.window_s),
        "device_ms_by_kind": {k: 1e3 * v / n
                              for k, v in tr.device_s_by_kind.items()},
        "idle_gaps_ms": {k: 1e3 * v
                         for k, v in tr.breakdown()["idle_gaps"]},
        "largest_gaps_ms": largest_gaps(prof)}
    out["regions"] = {
        "device_ms_summed": 1e3 * sp.device_s / n,
        "device_ms_by_owner": dict(sorted(ms.items(), key=lambda kv: -kv[1])),
        "ranges_per_step": {k: v / n for k, v in sorted(sp.ranges.items())},
        "top_ops_ms": {
            o: [[name[:90], 1e3 * s / n] for (oo, name), s in sorted(
                sp.by_owner_op.items(), key=lambda kv: -kv[1])
                if oo == o][:6]
            for o in ms},
        "optimizer_ms": 1e3 * sp.seconds(*OPTIMIZER) / n,
        "grad_gather_ms": 1e3 * sp.seconds("model.layer_slice.bwd") / n,
        "norm_ms": 1e3 * sp.seconds("model.norm", "model.norm.bwd") / n,
        "ce_ms": 1e3 * sp.seconds("model.ce", "model.ce.bwd") / n,
        "span_coverage": sp.share(owned)}
    del prof

    # 3. one step from the same state and batch, without and with a profiler
    batch = feed.next()
    start = map_tree(lambda t: t.to("cpu", copy=True), state)
    state, m_plain = step(state, batch)
    plain = {k: t.to("cpu", copy=True) for k, t in tree_leaves(state)}
    m_plain = {k: v.to("cpu", copy=True) for k, v in m_plain.items()}
    for (_, t), (_, s) in zip(tree_leaves(state), tree_leaves(start)):
        t.copy_(s)
    del start
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        state, m_traced = step(state, batch)
        sync()
    moved = [k for k, t in tree_leaves(state)
             if not torch.equal(t.to("cpu", copy=True), plain[k])]
    moved += [k for k, v in m_traced.items()
              if not torch.equal(v.to("cpu", copy=True), m_plain[k])]
    out["bit_equal"] = {"leaves": len(plain), "metrics": len(m_plain),
                        "differ": moved}
    del plain

    for k in ("bit_equal", "step_s_untraced", "step_s_traced",
              "peak_bytes_untraced", "peak_bytes_traced",
              "layer_slice_per_step"):
        print(k, out[k])
    for k in ("launches_per_step", "step_device_ms", "device_idle",
              "largest_gaps_ms"):
        print(k, out["trace"][k])
    for k, v in out["regions"]["device_ms_by_owner"].items():
        print(f"{v:10.3f} ms  {k}")
    dest = ROOT / "chiprun_out" / f"train_regions.{args.workload}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 1 if moved else 0


if __name__ == "__main__":
    sys.exit(main())
