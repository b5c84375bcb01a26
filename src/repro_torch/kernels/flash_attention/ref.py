"""Plain PyTorch version of the flash-attention forward kernel (GQA +
causal with a query offset + local window + softcap), returning ``out``
and the fp32 row ``lse``. Materialises the full (Sq, Skv) logits.

Arithmetic as in the kernel: q scaled in fp32, fp32 logits and softmax,
probabilities rounded to v's dtype before P.V. A row with no live key
(possible only with a negative ``q_offset``) gives zeros and
``lse = -inf``. Differentiable by autograd.
"""

from __future__ import annotations

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int, scale: float,
                        softcap: float, q_offset: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd) -> (out (B, Sq, H, hd) in
    q's dtype, lse (B, H, Sq) float32)."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.float().reshape(b, sq, hkv, g, hd) * scale
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    if softcap and softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None] + int(q_offset)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    live = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        live &= k_pos <= q_pos
    if window > 0:
        live &= k_pos > q_pos - window
    logits = logits.masked_fill(~live, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)  # no live key
    p = torch.exp(logits - m)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype).float(), v.float())
    out = out / den.clamp_min(1e-30).permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(den)).reshape(b, h, sq)
    return out.reshape(b, sq, h, hd).to(q.dtype), lse
