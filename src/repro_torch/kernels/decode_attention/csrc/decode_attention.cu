// Decode attention for Hopper (sm_90a): one query token per batch row
// against the KV cache, with ragged per-row cache lengths.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
//   decode_attention_kernel (body _kernel), the Pallas TPU flash-decode.
//
// Bound on this card: bytes. A step reads the live part of the cache once,
//   2 * sum_b(kv_len[b]) * Hkv * hd elements, and does 4 flops per element
//   and query head of the group (G = 3 for aiida-demo-110m): about 3 flop
//   per byte in bf16, two orders of magnitude below the ~295 flop/byte at
//   which the H100's bf16 tensor cores would become the limit.
//
// Design:
//   * one block per (batch row, KV head, chunk of up to GC query heads):
//     every query head of a GQA group shares each K/V row the block reads,
//     so the cache is read once per group. G = H / Hkv need not be a power
//     of two; GC is 4 or 8, picked from G by the launcher;
//   * the cache is read in place through its strides, in its native
//     (B, Smax, Hkv, hd) layout. There is no transpose copy (the TPU
//     wrapper transposed the whole cache on every call);
//   * the block's warps split the live positions [0, kv_len) into tiles of
//     32. A warp starts copying its tile's V rows into shared memory with
//     cp.async, then for Q.K^T each lane takes one position and reads its
//     K row with 16-byte loads; for P.V each lane takes hd/32 head dims of
//     the staged V rows. So a tile waits on memory about twice, not once
//     per position. Each warp keeps its own fp32 online-softmax state; the
//     warps are merged through shared memory at the end. Tiles past
//     kv_len are never read;
//   * kv_len is clamped to [0, Smax], and kv_len = 0 gives exact zeros.
//   * as in the reference, q is scaled in fp32 and the probabilities are
//     rounded to the cache dtype before P.V; sums are fp32.
//
// Left for later changes: split-K across blocks when B * Hkv is small
// next to the 132 SMs, double-buffered tiles, TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte asynchronous copy from device to shared memory (sm_80+)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_len, T* __restrict__ out,
                        int H, int G, int smax, long long ksb, long long kss,
                        long long ksh, long long vsb, long long vss,
                        long long vsh, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int DPL = HD / 32;         // head dims per lane in P.V
  const int b = blockIdx.x, kvh = blockIdx.y, g0 = blockIdx.z * GC;
  const int ng = min(GC, G - g0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  __shared__ float q_s[GC][HD];
  __shared__ float m_s[kWarps][GC];
  __shared__ float l_s[kWarps][GC];
  __shared__ float acc_s[kWarps][HD];
  // this warp's V tile, 32 rows of HD, staged with cp.async
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* v_s = reinterpret_cast<T*>(dyn_smem) + warp * 32 * HD;

  // q is (B, H, hd) contiguous; this block's heads are kvh*G + g0 + [0, ng)
  const long long head0 = (long long)b * H + (long long)kvh * G + g0;
  const T* qb = q + head0 * HD;
  for (int i = threadIdx.x; i < GC * HD; i += blockDim.x) {
    const int g = i / HD;
    q_s[g][i % HD] = g < ng ? to_float(qb[i]) * scale : 0.f;
  }
  __syncthreads();

  const int len = max(0, min(kv_len[b], smax));
  const T* kb = k + (long long)b * ksb + (long long)kvh * ksh;
  const T* vb = v + (long long)b * vsb + (long long)kvh * vsh;

  float m[GC], l[GC], acc[GC][DPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

  const int ntiles = (len + 31) >> 5;
  for (int tile = warp; tile < ntiles; tile += kWarps) {
    const int t0 = tile << 5;
    const int pos = t0 + lane;
    const bool live = pos < len;
    const int nlive = min(32, len - t0);

    // start copying the tile's live V rows; they land while Q.K^T runs
#pragma unroll
    for (int i = lane; i < 32 * (HD / VEC); i += 32) {
      const int r = i / (HD / VEC), c = (i % (HD / VEC)) * VEC;
      if (r < nlive) cp_async16(v_s + r * HD + c, vb + (long long)(t0 + r) * vss + c);
    }

    float s[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) s[g] = 0.f;
    if (live) {
      const T* kr = kb + (long long)pos * kss;
#pragma unroll
      for (int c = 0; c < HD; c += VEC) {
        union {
          uint4 u;
          T e[VEC];
        } x;
        x.u = *reinterpret_cast<const uint4*>(kr + c);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float kf = to_float(x.e[j]);
#pragma unroll
          for (int g = 0; g < GC; ++g) s[g] = fmaf(q_s[g][c + j], kf, s[g]);
        }
      }
    }

    // online softmax over this tile; the tile holds at least one live
    // position, so m_new is finite
    float p[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float m_new = fmaxf(m[g], warp_max(live ? s[g] : -INFINITY));
      const float alpha = expf(m[g] - m_new);
      const float pg = live ? expf(s[g] - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(pg);
      m[g] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] *= alpha;
      p[g] = to_float(from_float<T>(pg));
    }

    cp_async_wait_all();
    __syncwarp();
    for (int t = 0; t < nlive; ++t) {
      const T* vr = v_s + t * HD + lane * DPL;
      float vf[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) vf[j] = to_float(vr[j]);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float pt = __shfl_sync(kFull, p[g], t);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = fmaf(pt, vf[j], acc[g][j]);
      }
    }
    __syncwarp();  // every lane is done with v_s before the next tile
  }

  // merge the warps' partial softmax states
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  __syncthreads();
  T* ob = out + head0 * HD;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g >= ng) break;  // uniform across the block
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    const float mine = mx == -INFINITY ? 0.f : expf(m[g] - mx);
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc_s[warp][lane * DPL + j] = acc[g][j] * mine;
    __syncthreads();
    if (threadIdx.x < HD) {
      float tot = 0.f, sum = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = mx == -INFINITY ? 0.f : expf(m_s[w][g] - mx);
        tot = fmaf(l_s[w][g], f, tot);
        sum += acc_s[w][threadIdx.x];
      }
      ob[g * HD + threadIdx.x] = from_float<T>(sum / fmaxf(tot, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int HD, int GC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, int B, int H, int Hkv,
                   int smax, long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh, float scale,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  const dim3 grid(B, Hkv, (G + GC - 1) / GC);
  constexpr int smem = kWarps * 32 * HD * sizeof(T);
  static bool smem_set = false;  // opt in above 48 KB once per kernel
  if (smem > 48 * 1024 && !smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, HD, GC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  decode_attention_kernel<T, HD, GC><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), H, G, smax, ksb, kss, ksh, vsb, vss, vsh, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const void* kv_len, void* out, int B, int H, int Hkv,
                     int smax, long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh, float scale,
                     cudaStream_t stream) {
  if (H / Hkv <= 4)
    return launch<T, HD, 4>(q, k, v, kv_len, out, B, H, Hkv, smax, ksb, kss,
                            ksh, vsb, vss, vsh, scale, stream);
  return launch<T, HD, 8>(q, k, v, kv_len, out, B, H, Hkv, smax, ksb, kss,
                          ksh, vsb, vss, vsh, scale, stream);
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      const void* kv_len, void* out, int B, int H, int Hkv,
                      int smax, long long ksb, long long kss, long long ksh,
                      long long vsb, long long vss, long long vsh, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_g<T, 32>(q, k, v, kv_len, out, B, H, Hkv, smax, ksb, kss,
                             ksh, vsb, vss, vsh, scale, stream);
    case 64:
      return launch_g<T, 64>(q, k, v, kv_len, out, B, H, Hkv, smax, ksb, kss,
                             ksh, vsb, vss, vsh, scale, stream);
    case 128:
      return launch_g<T, 128>(q, k, v, kv_len, out, B, H, Hkv, smax, ksb, kss,
                              ksh, vsb, vss, vsh, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, out: (B, H, hd) contiguous;
// k, v: (B, Smax, Hkv, hd) with unit stride on hd and the given element
// strides for batch, position and head; kv_len: (B,) int32 on the device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* kv_len,
                                      void* out, int B, int H, int Hkv,
                                      int hd, int smax, long long ksb,
                                      long long kss, long long ksh,
                                      long long vsb, long long vss,
                                      long long vsh, float scale,
                                      void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, kv_len, out, B, H, Hkv, smax, ksb,
                            kss, ksh, vsb, vss, vsh, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, kv_len, out, B, H, Hkv, smax,
                                    ksb, kss, ksh, vsb, vss, vsh, scale, s);
  return cudaErrorInvalidValue;
}
