"""The weight bridge between the reference's parameter trees and the port.

The port keeps the reference's keys and shapes (stacked leading ``layers``
dim, ``wq (d, h, hd)``, ``wo (h, hd, d)``), so the bridge is a per-leaf
copy. The reference side is a nest of dicts (and, for the hybrid's
layers, lists) of numpy arrays (fp32 master copies, e.g.
``jax.tree.map(np.asarray, params)``); neither direction imports JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.common import map_tree, resolve_device


def params_from_numpy(tree: Any, device: str | torch.device | None = None
                      ) -> Any:
    """Nest of dicts and lists of numpy arrays -> the same nest of tensors
    on ``device``."""
    dev = resolve_device(device)
    return map_tree(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`params_from_numpy` (tensors come back to the host
    in their own dtype; bf16 leaves are widened to fp32, which numpy
    lacks)."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return map_tree(leaf, tree)
