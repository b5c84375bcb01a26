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

The kernel is one pass over time tiles with a decoupled look-back
(:func:`tile_plan`, :func:`tile_of`). Its workspace, status words and
counters are allocated once per device and stream and kept: the kernel
stamps status words with a generation it keeps on the device, so nothing
is cleared per call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: warps of a block, each scanning one time segment of the tile
WARPS = 16
#: time steps x channels of a and x that a thread holds in registers
ELEMS = 16
#: aim for at least this many tiles per SM before steps per thread shrink
TILES_PER_SM = 4
#: ... but cut no chain into more tiles than this (the look-back walks them)
MAX_TILES_PER_CHAIN = 64
#: resident blocks per SM (512 threads at 64 registers); the launch has at
#: most this many per SM, each taking tiles until they run out
BLOCKS_PER_SM = 2
_WORKSPACES: dict = {}


class TilePlan(NamedTuple):
    """The kernel's launch geometry for one (B, S, D)."""
    vec: int         # channels a lane owns: 2 (D even) or 1
    steps: int       # time steps a thread holds, 1 to ELEMS // vec
    tile_t: int      # time steps per tile: WARPS * steps
    tile_c: int      # channels per tile: 32 * vec
    chunks: int      # channel groups per batch row
    chains: int      # B * chunks independent chains of tiles
    ntiles: int      # tiles per chain
    tiles: int       # chains * ntiles, one ticket each
    ws_floats: int   # tiles * 3 * tile_c: (A, H) and the inclusive carry
    blocks: int      # persistent blocks of the launch


@functools.lru_cache(maxsize=256)
def tile_plan(b: int, s: int, d: int, sms: int) -> TilePlan:
    """The tiles of a scan over (``b``, ``s``, ``d``) on a card of ``sms``
    SMs; the dtype and ``reverse`` do not change them. A lane owns 2
    channels when ``d`` is even, else 1. Each thread holds
    ``ELEMS // vec`` steps, halved while the launch has fewer than
    ``TILES_PER_SM`` tiles per SM and a chain would still have at most
    ``MAX_TILES_PER_CHAIN`` tiles."""
    vec = 2 if d % 2 == 0 else 1
    tile_c = 32 * vec
    chunks = -(-d // tile_c)
    chains = b * chunks
    steps = ELEMS // vec

    def ntiles(st):
        return -(-s // (WARPS * st))

    while (steps > 1 and chains * ntiles(steps) < TILES_PER_SM * sms
           and ntiles(steps // 2) <= MAX_TILES_PER_CHAIN):
        steps //= 2
    n = ntiles(steps)
    return TilePlan(vec, steps, WARPS * steps, tile_c, chunks, chains, n,
                    chains * n, chains * n * 3 * tile_c,
                    min(chains * n, BLOCKS_PER_SM * sms))


def tile_of(plan: TilePlan, ticket: int, s: int, d: int, reverse: bool
            ) -> tuple[int, int, int, int, int, int]:
    """What the block holding ``ticket`` scans, as the kernel computes it:
    (batch row, first channel, channel end, first time step, time end, j),
    with j the tile's place in its chain's processing order. Tickets run
    in time order within each chain (backwards in time under
    ``reverse``); ticket - chains is the tile's predecessor."""
    j, chain = divmod(ticket, plan.chains)
    b, c = divmod(chain, plan.chunks)
    d0 = c * plan.tile_c
    p0 = j * plan.tile_t
    p1 = min(p0 + plan.tile_t, s)
    t0, t1 = (s - p1, s - p0) if reverse else (p0, p1)
    return b, d0, min(d0 + plan.tile_c, d), t0, t1, j


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _workspace(device: torch.device, stream: int, n_floats: int,
               n_status: int) -> tuple[torch.Tensor, ...]:
    """The kept (workspace, status words, counters) of ``device`` and
    ``stream``, grown to at least ``n_floats`` floats and ``n_status``
    words. Status words and counters are zeroed only here: the kernel
    leaves them ready for its next launch."""
    key = (device.index, stream)
    kept = _WORKSPACES.get(key)
    if kept is None or kept[0].numel() < n_floats \
            or kept[1].numel() < n_status:
        kept = (torch.empty(max(n_floats, 1), dtype=torch.float32,
                            device=device),
                torch.zeros(max(n_status, 1), dtype=torch.int64,
                            device=device),
                torch.zeros(3, dtype=torch.int64, device=device))
        _WORKSPACES[key] = kept
    return kept


@functools.cache
def _launcher():
    fn = _build.load("rglru_scan").repro_rglru_scan
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
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
    b, s, d = a.shape
    plan = tile_plan(b, s, d, _sm_count(a.device.index))
    # widening bf16 to fp32 is exact; the kernel copies at least 4 bytes
    if x.dtype != a.dtype or plan.vec == 1:
        a, x = a.float(), x.float()
    # a contiguous view at an odd offset is copied: the kernel copies vec
    # elements at a time
    align = plan.vec * a.element_size()
    a, x = (t if t.is_contiguous() and t.data_ptr() % align == 0
            else t.clone(memory_format=torch.contiguous_format)
            for t in (a, x))
    h0 = h0.float().contiguous()
    hs = torch.empty((b, s, d), dtype=torch.float32, device=a.device)
    h_last = torch.empty((b, d), dtype=torch.float32, device=a.device)
    # the raw handle, without building a torch.cuda.Stream on every call
    stream = torch._C._cuda_getCurrentRawStream(a.device.index)
    ws, status, ctrl = _workspace(a.device, stream, plan.ws_floats,
                                  plan.tiles)
    err = _launcher()(
        _DTYPE_CODES[a.dtype], plan.vec, a.data_ptr(), x.data_ptr(),
        h0.data_ptr(), hs.data_ptr(), h_last.data_ptr(), ws.data_ptr(),
        status.data_ptr(), ctrl.data_ptr(), b, s, d, plan.steps,
        plan.blocks, int(reverse), stream)
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
    no result. The Hopper kernel takes any S and D and its own schedule
    (:func:`tile_plan`): one pass over tiles of 64 channels (32 for an odd
    D) by 16 time segments, taken in time order by persistent blocks and
    chained by a decoupled look-back."""
    if block_t < 1 or block_d < 1:
        raise ValueError(f"block sizes must be positive, got {block_t}, "
                         f"{block_d}")
    _check(a, x, h0)
    return _RGLRUScan.apply(a, x, h0)


rglru_scan.launches = 0
