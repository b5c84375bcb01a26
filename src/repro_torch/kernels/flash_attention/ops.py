"""Wrapper of the flash-attention forward kernel.

A CPU tensor goes to the plain version (``ref.py``), which autograd can
differentiate. A CUDA tensor goes to the hand-written kernel
(``csrc/flash_attention_fwd.cu``) or raises: there is no fallback, and
asking for a gradient on CUDA raises until the backward kernels land
with the training slice. ``flash_attention_fwd.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


@functools.cache
def _launcher():
    fn = _build.load("flash_attention_fwd").repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, Sq, H, hd) and k/v (B, Skv, Hkv, "
                         f"hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]
            or q.shape[2] % k.shape[2]):
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of float32/bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None, softcap: float = 0.0,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) -> (out (B, Sq, H, hd),
    lse (B, H, Sq) float32). ``q_offset`` is the absolute position of q[0]."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    _check(q, k, v)
    opts = dict(causal=bool(causal), window=int(window), scale=float(scale),
                softcap=float(softcap), q_offset=int(q_offset))
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **opts)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version); got q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention backward on CUDA lands with the training slice")
    b, sq, h, hd = q.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {hd}")
    _build.require_aligned_rows("k", k)
    _build.require_aligned_rows("v", v)
    if q.stride(-1) != 1:
        raise ValueError(f"q must have unit stride on head_dim; strides "
                         f"{q.stride()}")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return out, lse
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    err = _launcher()(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, sq, k.shape[1], h, k.shape[2], hd,
        strides, opts["scale"], opts["softcap"], int(opts["causal"]),
        opts["window"], opts["q_offset"],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    **opts) -> torch.Tensor:
    """:func:`flash_attention_fwd` without the lse: (B, Sq, H, hd)."""
    return flash_attention_fwd(q, k, v, **opts)[0]
