"""Wrappers of the flash-attention kernels, forward and backward.

:func:`flash_attention` and :func:`flash_attention_fwd` go through one
``torch.autograd.Function`` when a gradient is to be taken: its forward
runs the forward kernel (``csrc/flash_attention_fwd.cu``) and saves q, k,
v, out and lse; its backward runs the dq and dk/dv kernels
(``csrc/flash_attention_bwd.cu``) through :func:`flash_attention_bwd`.
Without one (serving, under ``no_grad``) the forward runs alone. A CPU
tensor goes to the plain versions (``ref.py``) by the same routes; a CUDA
tensor goes to the kernels or raises: there is no fallback.
``flash_attention_fwd.launches``, ``flash_attention_bwd_dq.launches`` and
``flash_attention_bwd_dkv.launches`` count each kernel's launches, and
``.tensor_core_launches`` on each of the three those that ran its
tensor-core (bfloat16) body. q, k, v and do whose rows the kernels cannot
read with 16-byte loads or TMA (an odd-offset view, a stride-0 cotangent)
are copied contiguous first.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)


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


@functools.cache
def _bwd_launcher(name: str):
    """``repro_flash_attention_bwd_dq`` (one output pointer) or
    ``..._dkv`` (two)."""
    fn = getattr(_build.load("flash_attention_bwd"),
                 f"repro_flash_attention_bwd_{name}")
    n_out = 1 if name == "dq" else 2
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * (6 + n_out)
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


def _check_cuda(*ts) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version); got tensors on "
                         f"{[str(t.device) for t in ts]}")
    hd = ts[0].shape[-1]
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim in {_HEAD_DIMS}, "
                         f"got {hd}")


def _stream(t: torch.Tensor) -> int:
    # the raw handle, as torch's generated kernels take it, without
    # building a torch.cuda.Stream object on every call
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _fwd(q, k, v, opts):
    """The forward on CPU (plain version) or CUDA (kernel), no autograd."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **opts)
    _check_cuda(q, k, v)
    b, sq, h, hd = q.shape
    q, k, v = (_aligned(t) for t in (q, k, v))
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
        opts["window"], opts["q_offset"], _stream(q))
    if err == -1:
        raise RuntimeError("flash_attention_fwd: cuTensorMapEncodeTiled "
                           "failed for q, k or v")
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_fwd.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention_fwd.tensor_core_launches += 1
    return out, lse


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read its rows with 16-byte loads or
    TMA (whose strides must be multiples of 16 bytes), else a contiguous
    copy (a stride-0 cotangent from ``.sum()``, a view at an odd offset)."""
    if _build.rows_aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _bwd_args(q, k, v, do, lse, delta, opts):
    b, sq, h, hd = q.shape
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *do.stride()[:3])
    head = (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = (b, sq, k.shape[1], h, k.shape[2], hd, strides, opts["scale"],
            opts["softcap"], int(opts["causal"]), opts["window"],
            opts["q_offset"], _stream(q))
    return head, tail


def _bwd_done(counter, what: str, err: int, dtype) -> None:
    """Raise on a failed launch, else count it on ``counter``."""
    if err == -1:
        raise RuntimeError(f"flash_attention_bwd {what}: "
                           "cuTensorMapEncodeTiled failed for q, k, v or do")
    if err:
        raise RuntimeError(f"flash_attention_bwd {what} kernel launch "
                           f"failed: cudaError {err}")
    counter.launches += 1
    if dtype == torch.bfloat16:
        counter.tensor_core_launches += 1


def flash_attention_bwd_dq(q, k, v, do, lse, delta, opts) -> torch.Tensor:
    """Launch the dq pass (CUDA tensors, checked by the caller)."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    head, tail = _bwd_args(q, k, v, do, lse, delta, opts)
    err = _bwd_launcher("dq")(*head, dq.data_ptr(), *tail)
    _bwd_done(flash_attention_bwd_dq, "dq", err, q.dtype)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, opts
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv pass (CUDA tensors, checked by the caller)."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    head, tail = _bwd_args(q, k, v, do, lse, delta, opts)
    err = _bwd_launcher("dkv")(*head, dk.data_ptr(), dv.data_ptr(), *tail)
    _bwd_done(flash_attention_bwd_dkv, "dk/dv", err, q.dtype)
    return dk, dv


def _opts(q, causal, window, scale, softcap, q_offset) -> dict:
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    return dict(causal=bool(causal), window=int(window), scale=float(scale),
                softcap=float(softcap), q_offset=int(q_offset))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, scale: float | None = None,
                        softcap: float = 0.0, q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of the forward for the cotangent ``do`` of
    ``out``, given the forward's ``out`` and fp32 ``lse`` (B, H, Sq).

    On the CPU the plain version; on CUDA delta = rowsum(do * out) in fp32
    (a torch op, as in the reference, where it is outside any Pallas
    kernel), then the dq kernel and the dk/dv kernel."""
    _check(q, k, v)
    opts = _opts(q, causal, window, scale, softcap, q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, do, **opts)
    _check_cuda(q, k, v, out, lse, do)
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} and out {tuple(out.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    q, k, v, do = (_aligned(t) for t in (q, k, v, do.to(q.dtype)))
    lse = lse.float().contiguous()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, opts)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, opts)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """out, lse = forward kernel; backward = dq and dk/dv kernels. lse is
    returned without a gradient, as in the reference, whose custom VJP
    differentiates out alone."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        out, lse = _fwd(q, k, v, opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None, softcap: float = 0.0,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) -> (out (B, Sq, H, hd),
    lse (B, H, Sq) float32). ``q_offset`` is the absolute position of q[0].
    Differentiable in q, k and v through ``out``."""
    _check(q, k, v)
    opts = _opts(q, causal, window, scale, softcap, q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, opts)
    return _fwd(q, k, v, opts)      # nothing to save for a backward


flash_attention_fwd.launches = 0
flash_attention_fwd.tensor_core_launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.tensor_core_launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.tensor_core_launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    **opts) -> torch.Tensor:
    """:func:`flash_attention_fwd` without the lse: (B, Sq, H, hd)."""
    return flash_attention_fwd(q, k, v, **opts)[0]
