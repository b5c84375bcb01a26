"""Plain PyTorch versions of the chunkwise mLSTM kernel.

* :func:`mlstm_recurrent_ref` is the exact sequential recurrence, the
  reference's oracle for every chunkwise form (``repro.models.xlstm``'s
  function of the same name).
* :func:`mlstm_chunkwise_ref` computes what the TPU kernel's body
  computes (``repro.kernels.mlstm_chunk.kernel._kernel``), one chunk after
  the other: the intra-chunk decay matrix masked with ``NEG_BIG``, the
  stabiliser ``m_out``, the inter/intra combine, the denominator
  ``max(|den|, exp(-m_out))`` and the state update, from a carried
  ``(C0, n0, max(m0, NEG_BIG))``. The cumsum of the log forget gates is
  summed in order, as the kernel sums it (:func:`cumsum_in_order`). It
  is the wrapper's version for CPU tensors and the model's chunkwise
  path; it is differentiable.

q, k, v: (B, H, S, hd); li, lf: (B, H, S) log input / log forget gates;
C0: (B, H, hd, hd); n0: (B, H, hd); m0: (B, H). Both return (hs (B, H, S,
hd) in q's dtype, (C, n, m) in fp32).
"""

from __future__ import annotations

import torch

NEG_BIG = -1.0e30


def chunk_len(s: int, chunk: int) -> int:
    """The reference's chunk rule: ``min(chunk, s)``, halved until it
    divides ``s`` (an odd ``s`` past ``chunk`` gives 1)."""
    L = min(chunk, s)
    while s % L:
        L //= 2
    return L


def cumsum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last dim in x's dtype, one add at a time
    from the first element, as the kernel sums. The chunkwise form uses
    differences of these sums (``b_t - b_s``, ``total - b_s``) in
    exponents, at magnitudes near 128 for L = 128: summed in order, each
    difference carries only the rounding of the adds between s and t; a
    parallel scan (``torch.cumsum`` on the card) or separately rounded
    sums (``torch.cumsum`` on the CPU accumulates in float64) give it the
    whole error of both sums."""
    sums = [x[..., 0]]
    for t in range(1, x.shape[-1]):
        sums.append(sums[-1] + x[..., t])
    return torch.stack(sums, dim=-1)


def mlstm_recurrent_ref(q, k, v, li, lf, C0, n0, m0):
    """Exact sequential recurrence (oracle for the chunkwise forms)."""
    s, hd = q.shape[2], q.shape[3]
    scale = 1.0 / float(hd) ** 0.5
    C, n, m = C0.float(), n0.float(), m0.float()
    li, lf = li.float(), lf.float()
    hs = []
    for t in range(s):
        kt, vt = k[:, :, t].float(), v[:, :, t].float()
        m_new = torch.maximum(lf[..., t] + m, li[..., t])
        fp = torch.exp(lf[..., t] + m - m_new)
        ip = torch.exp(li[..., t] - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * \
            torch.einsum("bhd,bhv->bhdv", kt, vt)
        n = fp[..., None] * n + ip[..., None] * kt
        qf = q[:, :, t].float() * scale
        num = torch.einsum("bhd,bhdv->bhv", qf, C)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2).to(q.dtype), (C, n, m)


def mlstm_chunkwise_ref(q, k, v, li, lf, C0, n0, m0, *, chunk: int):
    """The TPU kernel's chunkwise computation, chunk by chunk, batched
    over (B, H). ``chunk`` follows :func:`chunk_len`."""
    s, hd = q.shape[2], q.shape[3]
    L = chunk_len(s, chunk)
    scale = 1.0 / float(hd) ** 0.5
    C, n = C0.float(), n0.float()
    m = torch.clamp_min(m0.float(), NEG_BIG)
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c0 in range(0, s, L):
        sl = slice(c0, c0 + L)
        qc = q[:, :, sl].float() * scale                     # (B,H,L,hd)
        kc, vc = k[:, :, sl].float(), v[:, :, sl].float()
        lic, lfc = li[:, :, sl].float(), lf[:, :, sl].float()  # (B,H,L)
        b_cum = cumsum_in_order(lfc)                         # inclusive
        total = b_cum[..., -1:]                              # (B,H,1)
        # D[t, s] = b_t - b_s + li_s for s <= t
        D = b_cum[..., :, None] - b_cum[..., None, :] + lic[..., None, :]
        D = torch.where(tri, D, NEG_BIG)
        m_intra = D.amax(dim=-1)
        m_inter = b_cum + m[..., None]
        m_out = torch.clamp_min(torch.maximum(m_intra, m_inter), NEG_BIG)

        inter_scale = torch.exp(m_inter - m_out)
        h_inter = qc @ C
        den_inter = (qc @ n[..., None])[..., 0]
        P = torch.exp(D - m_out[..., None])
        att = (qc @ kc.transpose(-1, -2)) * P
        h_intra = att @ vc
        den_intra = att.sum(dim=-1)
        num = h_inter * inter_scale[..., None] + h_intra
        den = den_inter * inter_scale + den_intra
        denom = torch.maximum(den.abs(), torch.exp(-m_out))
        hs.append(num / denom[..., None])

        # inter-chunk state update with a per-chunk stabiliser
        m_cand = (lic + total - b_cum).amax(dim=-1)
        m_new = torch.maximum(m + total[..., 0], m_cand)
        c_scale = torch.exp(m + total[..., 0] - m_new)
        k_scale = torch.exp(lic + total - b_cum - m_new[..., None])
        kk = kc * k_scale[..., None]
        C = C * c_scale[..., None, None] + kk.transpose(-1, -2) @ vc
        n = n * c_scale[..., None] + kk.sum(dim=-2)
        m = m_new
    return torch.cat(hs, dim=2).to(q.dtype), (C, n, m)
