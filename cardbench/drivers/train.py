"""The ``train`` driver: one training job on the port's donated train step.

Set-up builds one train state (the seed's weights, AdamW's zero moments)
and one step, ``repro_torch.training.train_step.make_train_step(...,
donate=True)``, and drives them through the mix's first ``check_steps``
steps on the feed the window uses. Those steps warm every shape the window
runs and give the check its readings of the program: each step's loss and
gradient norm, the first step's gradient as AdamW got it (its first moment
over 1 - b1), and the parameters' change over the steps (against a fresh
draw of the start). The same state and step then run back to back for the
window. Untraced, the window lasts until the first step dispatched after
``seconds`` and ends at a synchronize after it; the rate is every window
step's tokens over that time. Traced, it is ``trace_steps`` steps under
``torch.profiler``. Once the window has closed and the peak memory is read,
the program's state is freed and the reference (``cardbench.reference.
train``) takes the same first steps from the same inputs.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from cardbench import bench, compare, devtrace, inputs
from cardbench.reference import train as reference

#: the port's ModelConfig field of each key of a configuration file
PORT_FIELDS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "head_dim": "head_dim",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "embedding_multiplier": "embedding_multiplier",
    "residual_multiplier": "residual_multiplier",
    "attention_multiplier": "attention_multiplier",
    "logits_scaling": "logits_scaling",
}


def port_config(cfg: dict):
    """The port's registered config of this model, with every size and
    multiplier of the file and the file's run options."""
    from repro_torch.configs import get_config

    if cfg["hidden_act"] != "silu":
        raise ValueError(f"the train driver runs a SwiGLU MLP, not "
                         f"{cfg['hidden_act']!r}")
    port = get_config(cfg["port"]["config"])
    if port.family != "dense":
        raise ValueError(f"{port.name} is {port.family}, not dense")
    fields = {f: cfg[k] for k, f in PORT_FIELDS.items() if k in cfg}
    return port.replace(mlp_act="silu", **fields, **cfg["port"]["options"])


def _nest(flat: dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, t in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def program_params(cfg: dict, bundle, seed: int, device) -> dict:
    """The seed's weights in the port's tree: the embedding padded with
    zero rows to the port's table; every other leaf as drawn. Raises
    where the port's leaves differ in path, shape or dtype."""
    from repro_torch.models.common import tree_leaves

    flat = inputs.raw_weights(cfg, seed, device)
    want = dict(tree_leaves(bundle.param_shapes()))
    emb = flat["embedding"]
    padded = torch.zeros(want["embedding"].shape, dtype=emb.dtype,
                         device=device)
    padded[:emb.shape[0]].copy_(emb)
    flat["embedding"] = padded
    del emb
    got = {p: (tuple(t.shape), t.dtype) for p, t in flat.items()}
    expect = {p: (tuple(s.shape), s.dtype) for p, s in want.items()}
    if got != expect:
        raise ValueError(f"the port's parameter tree differs from the "
                         f"benchmark's: {expect} vs {got}")
    return _nest(flat)


def _leaves(tree: dict, vocab: int) -> dict[str, torch.Tensor]:
    """The tree's leaves by path, the embedding cut to the model's rows."""
    from repro_torch.models.common import tree_leaves

    flat = dict(tree_leaves(tree))
    flat["embedding"] = flat["embedding"][:vocab]
    return flat


def first_gradient(state: dict, cfg: dict) -> dict[str, float]:
    """Each slice's norm of the first step's gradient as AdamW got it:
    its first moment after one step over 1 - b1."""
    out: dict[str, float] = {}
    for path, mu in _leaves(state["opt"]["mu"], cfg["vocab_size"]).items():
        out.update(inputs.layer_norms(
            path, mu / (1.0 - cfg["optimizer"]["b1"])))
    return out


def change(state: dict, cfg: dict, seed: int, device) -> dict[str, float]:
    """Each slice's norm of the parameters' change since the seed's
    weights, drawn again leaf by leaf."""
    out: dict[str, float] = {}
    for path, p in _leaves(state["params"], cfg["vocab_size"]).items():
        start = inputs.draw_leaf(cfg, seed, path, tuple(p.shape), device)
        out.update(inputs.layer_norms(path, p - start))
        del start
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell) -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.registry import build
    from repro_torch.training import optim
    from repro_torch.training.train_step import TrainConfig, make_train_step

    cfg, traffic = cell.cfg, cell.traffic
    device = torch.device(cell.device)
    bundle = build(port_config(cfg))
    ocfg = optim.OptimConfig(**cfg["optimizer"])
    params = program_params(cfg, bundle, cell.seed, device)
    state = {"step": torch.zeros((), dtype=torch.int32, device=device),
             "params": params, "opt": optim.opt_init(ocfg, params)}
    del params
    step = make_train_step(bundle, TrainConfig(optim=ocfg), donate=True)
    feed = inputs.Feed(cell.seed, traffic["rows"], traffic["seq_len"],
                       cfg["vocab_size"], device)

    # the first steps: they warm every shape and give the check its readings
    check_s = 0.0
    losses, norms = [], []
    got: dict = {}
    for t in range(1, traffic["check_steps"] + 1):
        state, metrics = step(state, feed.next())
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
        if t == 1:
            c = time.perf_counter()
            got["grad"] = first_gradient(state, cfg)
            check_s += time.perf_counter() - c
    c = time.perf_counter()
    got["change"] = change(state, cfg, cell.seed, device)
    got["loss"] = [float(x) for x in losses]
    got["grad_norm"] = [float(x) for x in norms]
    check_s += time.perf_counter() - c
    _sync(device)
    setup_s = time.perf_counter() - cell.t0 - check_s

    out: dict = {"setup_s": setup_s}
    window_losses = []
    if cell.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        calls0 = (fa_ops.flash_attention_fwd.launches,
                  fa_ops.flash_attention_bwd_dq.launches)
        _sync(device)
        with profile(activities=activities) as prof:
            with record_function(devtrace.WINDOW_RANGE):
                for _ in range(traffic["trace_steps"]):
                    state, metrics = step(state, feed.next())
                    window_losses.append(metrics["loss"])
                _sync(device)
        tr = devtrace.from_profiler(prof, cell.kinds)
        del prof
        out["trace"] = tr
        out["reader_ctx"] = {
            "trace": tr, "steps": traffic["trace_steps"], "cfg": cfg,
            "traffic": traffic, "peaks": cell.peaks, "work": bench.work,
            "attn_calls": {
                "attn_fwd": fa_ops.flash_attention_fwd.launches - calls0[0],
                "attn_bwd": fa_ops.flash_attention_bwd_dq.launches
                - calls0[1]}}
    else:
        _sync(device)
        t0 = time.perf_counter()
        while True:
            state, metrics = step(state, feed.next())
            window_losses.append(metrics["loss"])
            if time.perf_counter() - t0 >= cell.seconds:
                break
        _sync(device)
        wall = time.perf_counter() - t0
        out["train_tokens_per_s"] = (len(window_losses) * traffic["rows"]
                                     * traffic["seq_len"] / wall)
        out["window_s"] = wall
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    out["peak_mem_gb"] = out["memory_peak_bytes"] / 1e9
    finite = [math.isfinite(float(x)) for x in window_losses]
    out["attempted"] = len(finite)
    out["failed"] = finite.count(False)

    # the program's state goes before the reference runs
    del state, step, metrics, window_losses, losses, norms, feed, bundle
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    c = time.perf_counter()
    want = reference.run(cfg, traffic, cell.seed, device,
                         steps=traffic["check_steps"])
    out["reference_s"] = time.perf_counter() - c
    out["numbers"], out["worst_at"] = compare.gaps(got, want)
    out["readings"] = {"program": {"loss": got["loss"],
                                   "grad_norm": got["grad_norm"]},
                       "reference": {"loss": want["loss"],
                                     "grad_norm": want["grad_norm"]}}
    return out
