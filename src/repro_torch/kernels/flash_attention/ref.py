"""Plain PyTorch versions of the flash-attention kernels (GQA + causal
with a query offset + local window + softcap): the forward, returning
``out`` and the fp32 row ``lse``, and the backward, returning dq, dk and
dv. Both materialise the full (Sq, Skv) logits.

Forward arithmetic as in the kernel: q scaled in fp32, fp32 logits and
softmax, probabilities rounded to v's dtype before P.V. A row with no live
key (possible only with a negative ``q_offset``) gives zeros and
``lse = -inf``. The forward is differentiable by autograd as well.
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


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, *, causal: bool, window: int,
                            scale: float, softcap: float, q_offset: int
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Gradients of the forward for the cotangent ``do`` of ``out``, given
    the forward's ``out`` and fp32 ``lse`` (B, H, Sq) -> (dq, dk, dv) in
    q's, k's and v's dtypes.

    Explicit fp32 math in the reference's formulas (its ``_bwd_dq_kernel``
    and ``_bwd_dkv_kernel``), not autograd: p = exp(cap(q.k^T scale) -
    lse), delta = rowsum(do * out), ds = p (do.v^T - delta) (1 - t^2),
    masked ds = 0; dq = ds.k scale, dk = ds^T.(q scale), dv = p^T.do. A row
    with lse = -inf (no live key) gives p = 0."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.float().reshape(b, sq, hkv, g, hd) * scale
    kf, vf = k.float(), v.float()
    dog = do.float().reshape(b, sq, hkv, g, hd)
    raw = torch.einsum("bskgh,btkh->bkgst", qg, kf)
    if softcap and softcap > 0.0:
        t = torch.tanh(raw / softcap)
        logits, dcap = softcap * t, 1.0 - t * t
    else:
        logits, dcap = raw, None
    q_pos = torch.arange(sq, device=q.device)[:, None] + int(q_offset)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    live = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        live &= k_pos <= q_pos
    if window > 0:
        live &= k_pos > q_pos - window
    lse_g = lse.float().reshape(b, hkv, g, sq)[..., None]
    live = live & torch.isfinite(lse_g)
    p = torch.where(live, torch.exp(logits - torch.where(live, lse_g, 0.0)),
                    0.0)
    delta = (dog * out.float().reshape(b, sq, hkv, g, hd)).sum(-1)
    dp = torch.einsum("bskgh,btkh->bkgst", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if dcap is not None:
        ds = ds * dcap
    ds = torch.where(live, ds, 0.0)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
