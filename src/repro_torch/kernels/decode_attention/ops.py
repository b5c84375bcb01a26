"""Wrapper of the decode-attention kernel.

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor goes
to the hand-written kernel (``csrc/decode_attention.cu``) or raises:
there is no fallback. ``decode_attention.launches`` counts the kernel's
launches.

The kernel splits each (batch row, KV head)'s cache positions across
blocks and merges the blocks' partial softmax states in the same launch
(:func:`split_plan`). Its workspace and its tickets (zero between
launches) are allocated once per device and stream and kept.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
#: positions per tile of the kernel; a split is a multiple of it
TILE = 64
#: at most this many splits per (batch row, KV head)
MAX_SPLITS = 64
#: aim for at most this many blocks per SM before positions per split grow
BLOCKS_PER_SM = 4
_WORKSPACES: dict = {}


@functools.lru_cache(maxsize=256)
def split_plan(b: int, hkv: int, g: int, smax: int, sms: int
               ) -> tuple[int, int, int]:
    """(query heads per block, splits, positions per split) of a launch
    over B = ``b``, ``hkv`` KV heads with ``g`` query heads each, a cache of
    ``smax`` positions, on a card of ``sms`` SMs. Splits start at one tile
    of positions and double while there are more than ``MAX_SPLITS`` of
    them or more than ``BLOCKS_PER_SM`` blocks per SM."""
    gc = 4 if g <= 4 else 8
    rows = b * hkv * -(-g // gc)
    per = TILE
    while per < smax and (-(-smax // per) > MAX_SPLITS
                          or rows * -(-smax // per) > BLOCKS_PER_SM * sms):
        per *= 2
    return gc, max(1, -(-smax // per)), per


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _workspace(device: torch.device, stream: int, n_ws: int, n_tickets: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kept (workspace, tickets) of ``device`` and ``stream``, grown to
    at least ``n_ws`` floats and ``n_tickets`` zeroed int32 tickets. The
    kernel leaves every ticket at zero, so they are zeroed only here."""
    key = (device.index, stream)
    ws, tickets = _WORKSPACES.get(key, (None, None))
    if ws is None or ws.numel() < n_ws or tickets.numel() < n_tickets:
        ws = torch.empty(max(n_ws, 1), dtype=torch.float32, device=device)
        tickets = torch.zeros(max(n_tickets, 1), dtype=torch.int32,
                              device=device)
        _WORKSPACES[key] = ws, tickets
    return ws, tickets


@functools.cache
def _launcher():
    fn = _build.load("decode_attention").repro_decode_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 6
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
    h, hkv, smax = q.shape[1], k.shape[2], k.shape[1]
    gc, splits, per = split_plan(b, hkv, h // hkv, smax,
                                 _sm_count(q.device.index))
    rows = b * hkv * -(-(h // hkv) // gc)
    # the raw handle, without building a torch.cuda.Stream on every call
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    ws, tickets = _workspace(q.device, stream,
                             rows * splits * gc * (hd + 2), rows)
    err = _launcher()(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lens.data_ptr(), out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
        b, h, hkv, hd, smax, gc, splits, per, *k.stride()[:3],
        *v.stride()[:3], float(scale), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
