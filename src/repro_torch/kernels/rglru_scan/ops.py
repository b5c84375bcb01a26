"""Wrapper of the RG-LRU scan kernel, with its backward.

:func:`rglru_scan` goes through one ``torch.autograd.Function``. Its
forward runs the kernel (``csrc/rglru_scan.cu``) on CUDA tensors and the
plain version (``ref.py``) on CPU tensors; a CUDA tensor goes to the
kernel or raises, there is no fallback. Its backward is the reference's
VJP (``repro.kernels.rglru_scan.ops``): the adjoint of a linear recurrence
is the same recurrence run backwards,

    g_t = dL/dh_t + a_{t+1} g_{t+1},  dL/dx_t = g_t,
    dL/da_t = g_t h_{t-1},            dL/dh0 = a_1 g_1,

so it runs the same scan time-reversed (the kernel's ``reverse`` flag,
which saves the reference's three flips). ``rglru_scan.launches`` counts
the kernel's launches, forward and backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = _build.load("rglru_scan").repro_rglru_scan
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(a, x, h0):
    if a.dim() != 3 or x.shape != a.shape:
        raise ValueError(f"expected a and x (B, S, D) of one shape; got "
                         f"{tuple(a.shape)}, {tuple(x.shape)}")
    if h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 must be (B, D) = {(a.shape[0], a.shape[2])}, "
                         f"got {tuple(h0.shape)}")
    if a.shape[1] == 0:
        raise ValueError("the scan needs at least one time step")
    for name, t in (("a", a), ("x", x), ("h0", h0)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")


def _scan(a, x, h0, reverse=False):
    """The scan on CPU (plain version) or CUDA (kernel), no autograd."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, x, h0, reverse=reverse)
    if a.device.type != "cuda" or x.device != a.device \
            or h0.device != a.device:
        raise ValueError(f"rglru_scan runs on cuda (kernel) or cpu (plain "
                         f"version); got a on {a.device}, x on {x.device}, "
                         f"h0 on {h0.device}")
    if x.dtype != a.dtype:         # widening bf16 to fp32 is exact
        a, x = a.float(), x.float()
    a, x = a.contiguous(), x.contiguous()
    h0 = h0.float().contiguous()
    b, s, d = a.shape
    hs = torch.empty((b, s, d), dtype=torch.float32, device=a.device)
    h_last = torch.empty((b, d), dtype=torch.float32, device=a.device)
    err = _launcher()(
        _DTYPE_CODES[a.dtype], a.data_ptr(), x.data_ptr(), h0.data_ptr(),
        hs.data_ptr(), h_last.data_ptr(), b, s, d, int(reverse),
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError "
                           f"{err}")
    rglru_scan.launches += 1
    return hs, h_last


class _RGLRUScan(torch.autograd.Function):
    """hs, h_last = the scan; backward = the reversed scan."""

    @staticmethod
    def forward(ctx, a, x, h0):
        hs, h_last = _scan(a, x, h0)
        ctx.save_for_backward(a, hs, h0)
        ctx.x_dtype = x.dtype
        return hs, h_last

    @staticmethod
    def backward(ctx, dhs, dh_last):
        a, hs, h0 = ctx.saved_tensors
        b, s, d = a.shape
        # the final state's cotangent joins the last step's
        dhs = dhs.float().clone()
        dhs[:, -1] += dh_last.float()
        # g_t = dhs_t + a_{t+1} g_{t+1}, from g_S = 0
        a32 = a.float()
        a_next = torch.cat([a32[:, 1:], a32.new_zeros((b, 1, d))], dim=1)
        g, _ = _scan(a_next, dhs, a32.new_zeros((b, d)), reverse=True)
        h_prev = torch.cat([h0.float()[:, None], hs[:, :-1]], dim=1)
        da = g * h_prev
        dh0 = a32[:, 0] * g[:, 0]
        return da.to(a.dtype), g.to(ctx.x_dtype), dh0.to(h0.dtype)


def rglru_scan(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, *,
               block_t: int = 128, block_d: int = 512
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + x_t. a, x: (B, S, D) float32 or bfloat16;
    h0: (B, D). Returns (hs (B, S, D), h_last (B, D)), both float32.

    ``block_t`` and ``block_d`` are the reference's tile sizes and change
    no result; the Hopper kernel takes its own schedule (32 channels by 16
    time segments per block) and any S and D."""
    if block_t < 1 or block_d < 1:
        raise ValueError(f"block sizes must be positive, got {block_t}, "
                         f"{block_d}")
    _check(a, x, h0)
    return _RGLRUScan.apply(a, x, h0)


rglru_scan.launches = 0
