"""mfu.train: the model FLOPs of the traced training steps over the traced
window's seconds, as a share (%) of the card's bf16 peak. The FLOPs come
from the work function the configuration names (``train_flops``)."""


def read(ctx):
    cfg, traffic, trace = ctx["cfg"], ctx["traffic"], ctx["trace"]
    if not ctx["steps"] or trace.window_s <= 0:
        return None
    flops = ctx["work"](cfg["train_flops"]).flops(
        cfg, traffic["rows"], traffic["seq_len"]) * ctx["steps"]
    return 100.0 * flops / trace.window_s / \
        ctx["peaks"]["flops_per_s"]["bfloat16"]
