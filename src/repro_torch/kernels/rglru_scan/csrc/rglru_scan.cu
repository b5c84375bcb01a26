// RG-LRU linear scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t over
// the time axis of (B, S, D) inputs, from a given h0, in fp32.
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py, rglru_scan_kernel
//   (body _kernel), the Pallas TPU blocked scan. Its custom VJP
//   (src/repro/kernels/rglru_scan/ops.py) runs the same scan time-reversed;
//   here that is the `reverse` flag, so the backward needs no flipped copies.
//
// Bound on this card: bytes. Per element the function reads a and x once
//   and writes hs once (12 bytes in fp32) and does one multiply-add: about
//   0.2 flop per byte, far below the ~20 flop per byte at which the H100's
//   fp32 units would become the limit.
//
// Design:
//   * one block per (batch row, 32 consecutive channels). A lane owns one
//     channel, so each load and store of a warp covers 32 neighbouring
//     channels of one time step: one 128-byte row segment in fp32;
//   * the time axis is split too. One channel per thread would give only
//     B * D threads (10,240 at the serving shape, about 2.4 warps per SM),
//     each walking a dependent chain of S steps. Here the block's 16 warps
//     each take one of 16 consecutive time segments:
//       pass 1: each thread scans its segment from h = 0, keeping the
//               segment's end value and the product of its decays;
//       combine: warp 0 walks the 16 segments in order from h0, giving
//               each segment its carry-in, in shared memory;
//       pass 2: each thread scans its segment again from its carry-in and
//               writes hs. The thread that owns the last step writes h_last.
//     Re-reading a and x in pass 2 costs 8 bytes per element where a
//     read-modify-write of hs would cost as much and needs the decay
//     prefix too, so the kernel moves 20 bytes per element against the
//     12-byte bound;
//   * loads are issued 8 steps ahead of the dependent multiply-add chain,
//     so a warp waits on memory once per 8 steps;
//   * no divisibility rule: lanes past D idle and segments are clamped to
//     S (the TPU wrapper halved its blocks until they divided S and D);
//   * a and x are fp32 or bf16 (widened exactly); h0, hs and h_last fp32.
//
// Left for later changes: one pass with a decoupled look-back across
// blocks (12 bytes per element), wider loads, splitting time across blocks
// when B * D is small next to the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;    // channels per block
constexpr int kSegs = 16;     // warps per block, one time segment each
constexpr int kAhead = 8;     // steps whose loads are issued together

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Walk n steps of one channel from h, starting at element `off` and moving
// `step` elements per time step. kWrite: store each h into hs; otherwise
// keep the product of the decays in *prod. Returns the last h.
template <typename T, bool kWrite>
__device__ __forceinline__ float walk(const T* __restrict__ a,
                                      const T* __restrict__ x,
                                      float* __restrict__ hs, long long off,
                                      long long step, int n, float h,
                                      float* prod) {
  float p = 1.f;
  int i = 0;
  for (; i + kAhead <= n; i += kAhead) {
    float av[kAhead], xv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      av[u] = to_float(a[off + u * step]);
      xv[u] = to_float(x[off + u * step]);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      h = fmaf(av[u], h, xv[u]);
      if (kWrite)
        hs[off + u * step] = h;
      else
        p *= av[u];
    }
    off += kAhead * step;
  }
  for (; i < n; ++i) {
    const float at = to_float(a[off]);
    h = fmaf(at, h, to_float(x[off]));
    if (kWrite)
      hs[off] = h;
    else
      p *= at;
    off += step;
  }
  if (!kWrite) *prod = p;
  return h;
}

template <typename T>
__global__ void __launch_bounds__(kLanes* kSegs)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                      const float* __restrict__ h0, float* __restrict__ hs,
                      float* __restrict__ h_last, int S, int D, int chunks,
                      int reverse) {
  __shared__ float seg_prod[kSegs][kLanes];
  __shared__ float seg_h[kSegs][kLanes];
  const int lane = threadIdx.x, seg = threadIdx.y;
  const int b = blockIdx.x / chunks;
  const int d = (blockIdx.x - b * chunks) * kLanes + lane;
  const bool live = d < D;
  const long long bd = static_cast<long long>(b) * D + d;

  // this warp's segment [lo, lo + n) in processing order; its first
  // element in memory and the stride to the next step
  const int len = (S + kSegs - 1) / kSegs;
  const int lo = min(seg * len, S);
  const int n = min(lo + len, S) - lo;
  const long long first = reverse ? S - 1 - lo : lo;
  const long long off = (static_cast<long long>(b) * S + first) * D + d;
  const long long step = reverse ? -static_cast<long long>(D) : D;

  // pass 1: the segment from h = 0
  float prod = 1.f, end = 0.f;
  if (live && n > 0) end = walk<T, false>(a, x, hs, off, step, n, 0.f, &prod);
  seg_prod[seg][lane] = prod;
  seg_h[seg][lane] = end;
  __syncthreads();

  // combine: carry-in of each segment, in order from h0
  if (seg == 0) {
    float h = live ? h0[bd] : 0.f;
#pragma unroll
    for (int k = 0; k < kSegs; ++k) {
      const float pk = seg_prod[k][lane], ek = seg_h[k][lane];
      seg_h[k][lane] = h;
      h = fmaf(pk, h, ek);
    }
    if (live && S == 0) h_last[bd] = h;
  }
  __syncthreads();

  // pass 2: the segment again from its carry-in, writing hs
  if (live && n > 0) {
    const float h = walk<T, true>(a, x, hs, off, step, n, seg_h[seg][lane],
                                  &prod);
    if (lo + n == S) h_last[bd] = h;
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const void* h0, void* hs,
                   void* h_last, int B, int S, int D, int reverse,
                   cudaStream_t stream) {
  const int chunks = (D + kLanes - 1) / kLanes;
  const long long blocks = static_cast<long long>(B) * chunks;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  rglru_scan_kernel<T><<<static_cast<unsigned>(blocks), dim3(kLanes, kSegs),
                         0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(h_last), S, D, chunks, reverse);
  return cudaGetLastError();
}

}  // namespace

// dtype of a and x: 0 = float32, 1 = bfloat16. a, x, hs: (B, S, D)
// contiguous; h0, h_last: (B, D) contiguous float32. reverse = 1 scans
// from t = S-1 down to 0 (h_t = a_t * h_{t+1} + x_t) and h_last is then h
// at t = 0. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_rglru_scan(int dtype, const void* a, const void* x,
                                const void* h0, void* hs, void* h_last, int B,
                                int S, int D, int reverse, void* stream) {
  if (B < 0 || S < 0 || D < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, x, h0, hs, h_last, B, S, D, reverse, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, x, h0, hs, h_last, B, S, D, reverse, s);
  return cudaErrorInvalidValue;
}
