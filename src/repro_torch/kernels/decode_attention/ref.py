"""Plain PyTorch version of the decode-attention kernel.

Follows the kernel, not the reference's ``ref.py``: the arithmetic is
the Pallas kernel's (q scaled in fp32, fp32 logits and softmax,
probabilities rounded to the cache dtype before P.V), ``kv_len`` is
clamped to ``[0, Smax]``, and a row with ``kv_len = 0`` gives exact zeros
where the reference's oracle softmaxes an all-masked row.
"""

from __future__ import annotations

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor, *, scale: float
                         ) -> torch.Tensor:
    """q: (B, H, hd) one token; k/v: (B, Smax, Hkv, hd); kv_len: (B,) int.

    Attends to cache positions [0, kv_len) per batch row."""
    b, h, hd = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.float().reshape(b, hkv, g, hd) * scale
    logits = torch.einsum("bkgh,btkh->bkgt", qg, k.float())
    lens = kv_len.to(device=q.device, dtype=torch.int64).clamp(0, smax)
    live = torch.arange(smax, device=q.device)[None, :] < lens[:, None]
    logits = logits.masked_fill(~live[:, None, None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)   # kv_len = 0
    p = torch.exp(logits - m)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgt,btkh->bkgh", p.to(v.dtype).float(), v.float())
    return (out / den).reshape(b, h, hd).to(q.dtype)
