"""Wrapper of the chunkwise mLSTM kernel (xLSTM matrix memory).

:func:`mlstm_chunk` runs the kernel (``csrc/mlstm_chunk.cu``) on CUDA
tensors and the plain chunkwise version (``ref.py``) on CPU tensors; a
CUDA tensor goes to the kernel or raises, there is no fallback. The
carried state (C0, n0, m0) is an input, so a prefill that continues from
a state is exact. Forward only, as in the reference (its Pallas kernel has
no VJP; training goes through the model's chunkwise path): an input that
requires grad raises. ``mlstm_chunk.launches`` counts the kernel's
launches, and ``mlstm_chunk.tensor_core_launches`` those that ran its
tensor-core body (:func:`takes_tensor_cores`: bfloat16 q/k/v, chunks of
128 rows, head dims that are a multiple of 64). That body reads q, k and
v by TMA; one whose rows are not 16-byte aligned is copied contiguous
first.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mlstm_chunk.ref import chunk_len, mlstm_chunkwise_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: what the kernel takes: chunks of at most MAX_CHUNK rows, head dims that
#: are a multiple of HD_MULTIPLE up to MAX_HD (its C tile and score matrix
#: live in shared memory)
MAX_CHUNK = 128
HD_MULTIPLE = 32
MAX_HD = 512
#: what the tensor-core body takes: its chunk and the width of its hd slices
TC_CHUNK = 128
TC_HD_MULTIPLE = 64
_MAX_GRID = 65535


def takes_tensor_cores(dtype: torch.dtype, L: int, hd: int) -> bool:
    """Whether a CUDA call with q/k/v of ``dtype``, chunks of ``L`` rows and
    head dim ``hd`` runs the tensor-core body; every other call runs the
    CUDA-core body. The C entry point applies the same rule."""
    return (dtype == torch.bfloat16 and L == TC_CHUNK
            and hd % TC_HD_MULTIPLE == 0)


@functools.cache
def _launcher():
    fn = _build.load("mlstm_chunk").repro_mlstm_chunk
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong] * 9 + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, li, lf, C0, n0, m0, chunk):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v (B, H, S, hd) of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, hd = q.shape
    want = {"li": (b, h, s), "lf": (b, h, s), "C0": (b, h, hd, hd),
            "n0": (b, h, hd), "m0": (b, h)}
    for name, t in (("li", li), ("lf", lf), ("C0", C0), ("n0", n0),
                    ("m0", m0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be a float tensor, got {t.dtype}")
    if s == 0:
        raise ValueError("the mLSTM needs at least one time step")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, float32 or bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    ins = (q, k, v, li, lf, C0, n0, m0)
    if any(t.requires_grad for t in ins):
        raise RuntimeError("mlstm_chunk is forward only (the reference's "
                           "kernel has no VJP); differentiate the model's "
                           "chunkwise path instead")
    if any(t.device != q.device for t in ins):
        raise ValueError("mlstm_chunk inputs must share one device; got "
                         f"{sorted({str(t.device) for t in ins})}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mlstm_chunk runs on cuda (kernel) or cpu (plain "
                         f"version); got {q.device}")


def _kernel(q, k, v, li, lf, C0, n0, m0, L):
    b, h, s, hd = q.shape
    if L > MAX_CHUNK:
        raise ValueError(f"the kernel takes chunks of at most {MAX_CHUNK} "
                         f"rows; S={s} with this chunk gives {L}")
    if hd == 0 or hd % HD_MULTIPLE or hd > MAX_HD:
        raise ValueError(f"the kernel takes head dims that are a multiple of "
                         f"{HD_MULTIPLE} up to {MAX_HD}, got {hd}")
    if b > _MAX_GRID or h > _MAX_GRID:
        raise ValueError(f"B and H must be at most {_MAX_GRID}, got {b}, {h}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride on its last dim "
                             f"(the kernel reads rows of hd); strides "
                             f"{t.stride()}")
    tensor_cores = takes_tensor_cores(q.dtype, L, hd)
    if tensor_cores:
        q, k, v = (t if _build.rows_aligned(t)
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    li, lf = li.float().contiguous(), lf.float().contiguous()
    C0, n0 = C0.float().contiguous(), n0.float().contiguous()
    m0 = m0.float().contiguous()
    hs = torch.empty((b, h, s, hd), dtype=q.dtype, device=q.device)
    C = torch.empty((b, h, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    err = _launcher()(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        li.data_ptr(), lf.data_ptr(), C0.data_ptr(), n0.data_ptr(),
        m0.data_ptr(), hs.data_ptr(), C.data_ptr(), n.data_ptr(),
        m.data_ptr(), b, h, s, hd, L, 1.0 / float(hd) ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err == -1:
        raise RuntimeError("mlstm_chunk: cuTensorMapEncodeTiled failed for "
                           "q, k or v")
    if err:
        raise RuntimeError(f"mlstm_chunk kernel launch failed: cudaError "
                           f"{err}")
    mlstm_chunk.launches += 1
    if tensor_cores:
        mlstm_chunk.tensor_core_launches += 1
    return hs, (C, n, m)


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                li: torch.Tensor, lf: torch.Tensor, C0: torch.Tensor,
                n0: torch.Tensor, m0: torch.Tensor, *, chunk: int = 128
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Chunkwise mLSTM from a carried state.

    q, k, v: (B, H, S, hd), float32 or bfloat16, unit stride on hd (any
    other strides; the model hands over transposed views); li, lf: (B, H,
    S); C0: (B, H, hd, hd); n0: (B, H, hd); m0: (B, H). Chunks follow the
    reference's rule (``min(chunk, S)`` halved until it divides S).
    Returns (hs (B, H, S, hd) in q's dtype, (C, n, m) in fp32)."""
    chunk = int(chunk)
    _check(q, k, v, li, lf, C0, n0, m0, chunk)
    L = chunk_len(q.shape[2], chunk)
    if q.device.type == "cpu":
        return mlstm_chunkwise_ref(q, k, v, li, lf, C0, n0, m0, chunk=chunk)
    return _kernel(q, k, v, li, lf, C0, n0, m0, L)


mlstm_chunk.launches = 0
mlstm_chunk.tensor_core_launches = 0
