"""attn_fwd_roofline: the least time the traced steps' attention
forward work needs (for each call the larger of its FLOPs over the
bf16 peak and its bytes over the memory bandwidth, from
``work/attn_fwd.py``) over the device time of the kernels of kind
``attn_fwd`` (``kinds/attn_fwd.json``), as a share (%). The calls are
counted by the program's own counter of them; a window without such
kernels or calls reads nothing."""

KIND = "attn_fwd"


def read(ctx):
    calls = ctx["attn_calls"].get(KIND, 0)
    seconds = ctx["trace"].device_s_by_kind.get(KIND, 0.0)
    if not calls or seconds <= 0:
        return None
    cfg, traffic, peaks = ctx["cfg"], ctx["traffic"], ctx["peaks"]
    h = cfg["num_attention_heads"]
    flops, nbytes = ctx["work"](KIND).work(
        traffic["rows"], traffic["seq_len"], h, cfg["num_key_value_heads"],
        cfg.get("head_dim") or cfg["hidden_size"] // h)
    least = max(flops / peaks["flops_per_s"]["bfloat16"],
                nbytes / peaks["bytes_per_s"])
    return 100.0 * calls * least / seconds
