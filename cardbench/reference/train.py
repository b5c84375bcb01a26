"""The reference's first training steps, and the readings they give.

AdamW as it is usually written (decoupled weight decay on every leaf, the
bias corrections of step t, eps outside the square root), after clipping
the gradients by their global norm; the learning rate warms up linearly
from step 1 and then decays on a cosine to ``min_lr_ratio`` of its peak.
All of it in float32, TF32 off.

The readings, the same the driver takes of the program:

* ``loss``: each step's loss;
* ``grad_norm``: each step's global gradient norm before clipping;
* ``grad``: the norm of each layer's slice of each leaf of the first
  step's gradient as the optimizer gets it (clipped);
* ``change``: the norm of each slice's change over the steps taken.

``half_batch`` plants a fault the check must catch in the reference put
in the program's place: each step's loss is the mean over the first half
of its rows.
"""

from __future__ import annotations

import contextlib
import math

import torch

from cardbench import inputs
from cardbench.reference.dense_lm import DenseLM


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def learning_rate(opt: dict, t: int) -> float:
    """The rate of step ``t`` (1-based)."""
    warm = min(1.0, t / max(opt["warmup_steps"], 1))
    prog = min(1.0, max(0.0, (t - opt["warmup_steps"])
                        / max(opt["total_steps"] - opt["warmup_steps"], 1)))
    decay = opt["min_lr_ratio"] + (1.0 - opt["min_lr_ratio"]) * 0.5 * (
        1.0 + math.cos(math.pi * prog))
    return opt["lr"] * warm * decay


def slice_norms(w: dict[str, torch.Tensor]) -> dict[str, float]:
    out: dict[str, float] = {}
    for path, t in w.items():
        out.update(inputs.layer_norms(path, t))
    return out


def run(cfg: dict, traffic: dict, seed: int, device, *, steps: int,
        precision: str = "fp32", half_batch: bool = False) -> dict:
    """``steps`` steps of the reference from the seed's weights on the
    seed's first batches; returns the readings."""
    opt = cfg["optimizer"]
    model = DenseLM(cfg, precision)
    feed = inputs.Feed(seed, traffic["rows"], traffic["seq_len"],
                       cfg["vocab_size"], device)
    w = {p: t.requires_grad_(True)
         for p, t in inputs.raw_weights(cfg, seed, device).items()}
    paths = sorted(w)
    mu = {p: torch.zeros_like(w[p]) for p in paths}
    nu = {p: torch.zeros_like(w[p]) for p in paths}
    out: dict = {"loss": [], "grad_norm": []}
    with no_tf32():
        for t in range(1, steps + 1):
            batch = feed.next()
            tokens, labels = batch["tokens"], batch["labels"]
            if half_batch:
                half = tokens.shape[0] // 2
                tokens, labels = tokens[:half], labels[:half]
            loss = model.loss(w, tokens, labels)
            grads = dict(zip(paths, torch.autograd.grad(
                loss, [w[p] for p in paths])))
            with torch.no_grad():
                norm = torch.sqrt(sum(g.square().sum() for g in
                                      grads.values()))
                scale = min(1.0, opt["grad_clip"] / max(float(norm), 1e-9))
                for g in grads.values():
                    g.mul_(scale)
                out["loss"].append(float(loss))
                out["grad_norm"].append(float(norm))
                if t == 1:
                    out["grad"] = slice_norms(grads)
                lr = learning_rate(opt, t)
                bc1 = 1.0 - opt["b1"] ** t
                bc2 = 1.0 - opt["b2"] ** t
                for p in paths:
                    g = grads[p]
                    mu[p].mul_(opt["b1"]).add_(g, alpha=1.0 - opt["b1"])
                    nu[p].mul_(opt["b2"]).addcmul_(g, g,
                                                   value=1.0 - opt["b2"])
                    upd = (mu[p] / bc1) / ((nu[p] / bc2).sqrt() + opt["eps"])
                    upd.add_(w[p], alpha=opt["weight_decay"])
                    w[p].sub_(upd, alpha=lr)
            del grads, loss
    del mu, nu
    with torch.no_grad():
        change = {}
        for p in paths:
            start = inputs.draw_leaf(cfg, seed, p, tuple(w[p].shape), device)
            change.update(inputs.layer_norms(p, w[p] - start))
            w[p] = None
    out["change"] = change
    return out
