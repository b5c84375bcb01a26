"""Wrapper of the decode-attention kernel.

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor goes
to the hand-written kernel (``csrc/decode_attention.cu``) or raises:
there is no fallback. ``decode_attention.launches`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


@functools.cache
def _launcher():
    fn = _build.load("decode_attention").repro_decode_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lens):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, hd) and k/v (B, Smax, Hkv, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if lens.shape != (b,):
        raise ValueError(f"kv_len must be a scalar or ({b},), "
                         f"got {tuple(lens.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of float32/bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor | int, *,
                     scale: float | None = None) -> torch.Tensor:
    """q: (B, H, hd); k/v: (B, Smax, Hkv, hd); kv_len: (B,) or scalar.

    Returns (B, H, hd) in q's dtype: row b attends to cache positions
    [0, kv_len[b])."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    b = q.shape[0]
    lens = torch.as_tensor(kv_len, device=q.device)
    if lens.dim() == 0:
        lens = lens.expand(b)
    _check(q, k, v, lens)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lens, scale=float(scale))
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"decode_attention runs on cuda (kernel) or cpu "
                         f"(plain version); got q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    hd = q.shape[-1]
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the decode kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {hd}")
    _build.require_aligned_rows("k", k)
    _build.require_aligned_rows("v", v)
    q = q.contiguous()
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _launcher()(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lens.data_ptr(), out.data_ptr(), b, q.shape[1], k.shape[2], hd,
        k.shape[1], *k.stride()[:3], *v.stride()[:3], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
