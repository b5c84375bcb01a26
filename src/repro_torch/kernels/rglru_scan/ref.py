"""Plain PyTorch version of the RG-LRU scan kernel: the exact sequential
scan of the reference's oracle (``h_t = a_t * h_{t-1} + x_t`` in fp32)."""

from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, *,
                   reverse: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, x: (B, S, D) any float dtype; h0: (B, D).

    Returns (h for every t (B, S, D), final h (B, D)), both fp32. With
    ``reverse`` the scan runs from t = S-1 down to 0 (``h_t = a_t *
    h_{t+1} + x_t``, starting from h0) and the final h is h_0."""
    a, x = a.float(), x.float()
    h = h0.float()
    steps = range(a.shape[1] - 1, -1, -1) if reverse else range(a.shape[1])
    hs = [None] * a.shape[1]
    for t in steps:
        h = a[:, t] * h + x[:, t]
        hs[t] = h
    if not hs:
        return a.new_zeros(a.shape), h
    return torch.stack(hs, dim=1), h
