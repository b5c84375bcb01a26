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
//   which the H100's bf16 tensor cores would become the limit. So the
//   kernel must keep many loads in flight across the whole card.
//
// Design: split-KV across the card, merged inside the same launch.
//   * the grid is (splits, Hkv x group chunks, B): block (sp, y, b) reads
//     positions [sp P, sp P + P) of its (batch row, KV head), for a chunk
//     of up to GC query heads of the group (GC = 4 or 8; G = H / Hkv need
//     not be a power of two). The wrapper picks P (a multiple of 64) from
//     Smax and B * Hkv so that the card has blocks for every SM (P = 64 at
//     the serving shape: 256 blocks of which ~110 have live positions).
//     Every query head of the chunk shares each K/V row the block reads;
//   * a block whose positions all lie at or past kv_len exits at once;
//     kv_len is clamped to [0, Smax], and kv_len = 0 gives exact zeros
//     (written by split 0);
//   * the cache is read in place through its strides, in its native
//     (B, Smax, Hkv, hd) layout, in tiles of 64 positions (32 for float32
//     at hd = 256, for shared memory): each tile's K and V rows are two
//     cp.async groups, and the next tile's are in flight while this one is
//     used (16-byte copies into rows padded by 16 bytes, so the reads below
//     are conflict-free). Q.K^T: two threads per position (four in a tile
//     of 32), each over every other (fourth) 16-byte piece of the row, for
//     all GC heads; the softmax: one warp per head; P.V: each thread owns
//     (head, dim) outputs, two dims of each head at hd = 256;
//   * each block keeps an fp32 online-softmax state (m, l, acc) per head.
//     With one live block for its (b, head chunk) it writes out directly.
//     Otherwise it writes its partial to a workspace, and the last block
//     to finish, found by an atomic ticket in global memory, merges the
//     partials, writes out and resets the ticket to zero for the next
//     launch. The wrapper keeps the workspace and the zeroed tickets per
//     device and stream: no per-call memset and no second kernel;
//   * as in the reference, q is scaled in fp32 and the probabilities are
//     rounded to the cache dtype before P.V; sums are fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // a split is a multiple of this
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
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

// Shared-memory plan of one (dtype, head_dim): K and V rows of a tile of
// KT positions, padded by 16 bytes, in two stages. KT is 64 (the split's
// unit), 32 for float32 at hd = 256, whose two stages of 64 would take
// 266 KB.
template <typename T, int HD>
struct Plan {
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte copy
  static constexpr int CPR = HD / VEC;         // copies per row
  static constexpr int LD = HD + VEC;          // padded row, elements
  static constexpr int KT = sizeof(T) == 4 && HD == 256 ? 32 : kTile;
  static constexpr int TILE = KT * LD;         // one K or V tile
  static constexpr int SMEM = 4 * TILE * sizeof(T);
  static_assert(kTile % KT == 0 && kThreads % KT == 0, "tile plan");
  static_assert(SMEM <= 232448, "over the shared memory a block can use");
};

// Start copying tile t of the split [start, end) into stage t % 2: its K
// rows as one cp.async group, then its V rows as another.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(T* kv_s, const T* kb, const T* vb,
                                           long long kss, long long vss,
                                           int start, int end, int t) {
  using PL = Plan<T, HD>;
  const int p0 = start + t * PL::KT, rows = min(PL::KT, end - p0);
  T* ks = kv_s + (t & 1) * PL::TILE;
  T* vs = kv_s + (2 + (t & 1)) * PL::TILE;
  for (int i = threadIdx.x; i < rows * PL::CPR; i += kThreads) {
    const int r = i / PL::CPR, c = (i % PL::CPR) * PL::VEC;
    cp_async16(ks + r * PL::LD + c, kb + (long long)(p0 + r) * kss + c);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < rows * PL::CPR; i += kThreads) {
    const int r = i / PL::CPR, c = (i % PL::CPR) * PL::VEC;
    cp_async16(vs + r * PL::LD + c, vb + (long long)(p0 + r) * vss + c);
  }
  cp_async_commit();
}

// (one block per SM is enough: without the minimum, ptxas caps some
// instantiations at 64 registers and spills)
template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads, 1)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_len, T* __restrict__ out,
                        float* __restrict__ ws, int* __restrict__ tickets,
                        int H, int G, int smax, int P, long long ksb,
                        long long kss, long long ksh, long long vsb,
                        long long vss, long long vsh, float scale) {
  using PL = Plan<T, HD>;
  constexpr int VEC = PL::VEC, CPR = PL::CPR, LD = PL::LD, KT = PL::KT;
  constexpr int TPP = kThreads / KT;        // threads per position in Q.K^T
  constexpr int NPL = KT / 32;              // positions per lane, softmax
  constexpr int DPD = HD > kThreads ? HD / kThreads : 1;  // dims per thread
  constexpr int DW = HD / DPD;              // threads along the dims in P.V
  constexpr int DG = kThreads / DW;         // thread groups over the heads
  constexpr int HPT = GC / DG;              // heads per thread in P.V
  static_assert(HPT >= 1 && GC >= kWarps, "GC too small for this head_dim");
  static_assert(CPR % TPP == 0, "a row splits evenly over its threads");

  const int sp = blockIdx.x, y = blockIdx.y, b = blockIdx.z;
  const int chunks = gridDim.y / (H / G);   // query-head chunks per KV head
  const int kvh = y / chunks, g0 = (y % chunks) * GC;
  const int ng = min(GC, G - g0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int len = max(0, min(kv_len[b], smax));
  const long long head0 = (long long)b * H + (long long)kvh * G + g0;
  T* ob = out + head0 * HD;
  if (len == 0) {                 // no live key: exact zeros, from split 0
    if (sp == 0)
      for (int i = tid; i < ng * HD; i += kThreads) ob[i] = from_float<T>(0.f);
    return;
  }
  const int start = sp * P;
  if (start >= len) return;
  const int end = min(start + P, len);
  const int n_live = (len + P - 1) / P;     // blocks with live positions

  __shared__ float q_s[GC][HD];
  __shared__ float s_s[GC][KT];             // logits, then probabilities
  __shared__ float alpha_s[GC];
  __shared__ float m_s[GC];                 // the running max and sum of
  __shared__ float l_s[GC];                 // each head, kept by its warp
  __shared__ int last_s;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* kv_s = reinterpret_cast<T*>(dyn_smem);  // K[2], V[2]

  // the first tiles' copies go out before q's loads, so that the two
  // wait on memory together
  const T* kb = k + (long long)b * ksb + (long long)kvh * ksh;
  const T* vb = v + (long long)b * vsb + (long long)kvh * vsh;
  const int nt = (end - start + KT - 1) / KT;
  stage_tile<T, HD>(kv_s, kb, vb, kss, vss, start, end, 0);
  if (nt > 1) stage_tile<T, HD>(kv_s, kb, vb, kss, vss, start, end, 1);
  const T* qb = q + head0 * HD;
  for (int i = tid; i < GC * HD; i += kThreads) {
    const int g = i / HD;
    q_s[g][i % HD] = g < ng ? to_float(qb[i]) * scale : 0.f;
  }

  // the P.V sums of heads pg + DG jj at dims pd + DW dd (this thread's);
  // head g's softmax state belongs to warp g % kWarps
  if (tid < GC) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[HPT][DPD];
#pragma unroll
  for (int jj = 0; jj < HPT; ++jj)
#pragma unroll
    for (int dd = 0; dd < DPD; ++dd) acc[jj][dd] = 0.f;
  const int pd = tid % DW, pg = tid / DW;

  for (int t = 0; t < nt; ++t) {
    const int p0 = start + t * KT, rows = min(KT, end - p0);
    const bool more = t + 1 < nt;
    const T* ks = kv_s + (t & 1) * PL::TILE;
    const T* vs = kv_s + (2 + (t & 1)) * PL::TILE;
    cp_async_wait(more ? 3 : 1);  // this tile's K rows have landed
    __syncthreads();

    // Q.K^T: position tid / TPP, every TPP-th 16-byte piece of its row
    {
      const int pos = tid / TPP, part = tid % TPP;
      float s[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) s[g] = 0.f;
      if (pos < rows) {
#pragma unroll
        for (int i = 0; i < CPR / TPP; ++i) {
          const int ci = TPP * i + part;
          union {
            uint4 u;
            T e[VEC];
          } x;
          x.u = *reinterpret_cast<const uint4*>(ks + pos * LD + ci * VEC);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float kf = to_float(x.e[e]);
#pragma unroll
            for (int g = 0; g < GC; ++g)
              s[g] = fmaf(q_s[g][ci * VEC + e], kf, s[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
#pragma unroll
        for (int o = 1; o < TPP; o <<= 1)
          s[g] += __shfl_xor_sync(kFull, s[g], o);
        if (part == 0) s_s[g][pos] = pos < rows ? s[g] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax of this tile, one warp per head; the tile holds at
    // least one live position, so m_new is finite
    for (int g = warp; g < GC; g += kWarps) {
      float x[NPL], mx = -INFINITY, sum = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        x[j] = s_s[g][lane + 32 * j];
        mx = fmaxf(mx, x[j]);
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(mx));
      const float alpha = expf(m_old - m_new);
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        x[j] = expf(x[j] - m_new);
        sum += x[j];
      }
      const float l_new = l_s[g] * alpha + warp_sum(sum);
#pragma unroll
      for (int j = 0; j < NPL; ++j)
        s_s[g][lane + 32 * j] = to_float(from_float<T>(x[j]));
      __syncwarp();
      if (lane == 0) {
        alpha_s[g] = alpha;
        m_s[g] = m_new;
        l_s[g] = l_new;
      }
    }
    cp_async_wait(more ? 2 : 0);  // this tile's V rows have landed
    __syncthreads();

    // P.V
#pragma unroll
    for (int jj = 0; jj < HPT; ++jj)
#pragma unroll
      for (int dd = 0; dd < DPD; ++dd) acc[jj][dd] *= alpha_s[pg + DG * jj];
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int dd = 0; dd < DPD; ++dd) {
        const float vf = to_float(vs[r * LD + pd + DW * dd]);
#pragma unroll
        for (int jj = 0; jj < HPT; ++jj)
          acc[jj][dd] = fmaf(s_s[pg + DG * jj][r], vf, acc[jj][dd]);
      }
    }
    __syncthreads();              // every thread is done with this stage
    if (t + 2 < nt) stage_tile<T, HD>(kv_s, kb, vb, kss, vss, start, end, t + 2);
  }

  if (n_live == 1) {              // the only live block: write out
#pragma unroll
    for (int jj = 0; jj < HPT; ++jj) {
      const int g = pg + DG * jj;
      if (g < ng)
#pragma unroll
        for (int dd = 0; dd < DPD; ++dd)
          ob[g * HD + pd + DW * dd] =
              from_float<T>(acc[jj][dd] / fmaxf(l_s[g], 1e-30f));
    }
    return;
  }

  // this block's partial: m[GC], l[GC], acc[GC][HD]
  const int splits = gridDim.x;
  const long long slot = ((long long)b * gridDim.y + y);
  float* part = ws + (slot * splits + sp) * (GC * (HD + 2));
  if (tid < GC) {
    part[tid] = m_s[tid];
    part[GC + tid] = l_s[tid];
  }
#pragma unroll
  for (int jj = 0; jj < HPT; ++jj)
#pragma unroll
    for (int dd = 0; dd < DPD; ++dd)
      part[2 * GC + (pg + DG * jj) * HD + pd + DW * dd] = acc[jj][dd];
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(tickets + slot, 1);
    last_s = ticket == n_live - 1;
    if (last_s) tickets[slot] = 0;       // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the last block merges every live split's partial
  const float* all = ws + slot * splits * (GC * (HD + 2));
#pragma unroll
  for (int jj = 0; jj < HPT; ++jj) {
    const int g = pg + DG * jj;
    float mx = -INFINITY;
    for (int i = 0; i < n_live; ++i)
      mx = fmaxf(mx, __ldcg(all + i * (GC * (HD + 2)) + g));
    float tot = 0.f, sum[DPD];
#pragma unroll
    for (int dd = 0; dd < DPD; ++dd) sum[dd] = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const float* pi = all + i * (GC * (HD + 2));
      const float f = expf(__ldcg(pi + g) - mx);
      tot = fmaf(__ldcg(pi + GC + g), f, tot);
#pragma unroll
      for (int dd = 0; dd < DPD; ++dd)
        sum[dd] = fmaf(__ldcg(pi + 2 * GC + g * HD + pd + DW * dd), f,
                       sum[dd]);
    }
    if (g < ng)
#pragma unroll
      for (int dd = 0; dd < DPD; ++dd)
        ob[g * HD + pd + DW * dd] =
            from_float<T>(sum[dd] / fmaxf(tot, 1e-30f));
  }
}

template <typename T, int HD, int GC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, void* ws, void* tickets,
                   int B, int H, int Hkv, int smax, int splits, int P,
                   const long long* st, float scale, cudaStream_t stream) {
  using PL = Plan<T, HD>;
  const int G = H / Hkv;
  const dim3 grid(splits, Hkv * ((G + GC - 1) / GC), B);
  static bool smem_set = false;  // opt in above 48 KB once per kernel
  if (PL::SMEM > 48 * 1024 && !smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, HD, GC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, PL::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  decode_attention_kernel<T, HD, GC><<<grid, kThreads, PL::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<int*>(tickets), H, G, smax, P, st[0], st[1], st[2], st[3],
      st[4], st[5], scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_g(int gc, const void* q, const void* k, const void* v,
                     const void* kv_len, void* out, void* ws, void* tickets,
                     int B, int H, int Hkv, int smax, int splits, int P,
                     const long long* st, float scale, cudaStream_t stream) {
  if (gc == 4)
    return launch<T, HD, 4>(q, k, v, kv_len, out, ws, tickets, B, H, Hkv,
                            smax, splits, P, st, scale, stream);
  if (gc == 8)
    return launch<T, HD, 8>(q, k, v, kv_len, out, ws, tickets, B, H, Hkv,
                            smax, splits, P, st, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_hd(int hd, int gc, const void* q, const void* k,
                      const void* v, const void* kv_len, void* out, void* ws,
                      void* tickets, int B, int H, int Hkv, int smax,
                      int splits, int P, const long long* st, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_g<T, 32>(gc, q, k, v, kv_len, out, ws, tickets, B, H, Hkv,
                             smax, splits, P, st, scale, stream);
    case 64:
      return launch_g<T, 64>(gc, q, k, v, kv_len, out, ws, tickets, B, H, Hkv,
                             smax, splits, P, st, scale, stream);
    case 128:
      return launch_g<T, 128>(gc, q, k, v, kv_len, out, ws, tickets, B, H,
                              Hkv, smax, splits, P, st, scale, stream);
    case 256:
      return launch_g<T, 256>(gc, q, k, v, kv_len, out, ws, tickets, B, H,
                              Hkv, smax, splits, P, st, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, out: (B, H, hd) contiguous;
// k, v: (B, Smax, Hkv, hd) with unit stride on hd, 16-byte aligned rows
// and the given element strides for batch, position and head; kv_len:
// (B,) int32 on the device. gc: query heads per block (4 or 8); the grid
// is (splits, Hkv * ceil(G / gc), B) with `per_block` positions per split
// (a multiple of 64, splits * per_block >= Smax). ws: at least B * Hkv *
// ceil(G / gc) * splits * gc * (hd + 2) floats; tickets: B * Hkv *
// ceil(G / gc) int32, zero before the launch and zero again after it.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_decode_attention(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_len, void* out, void* ws, void* tickets, int B, int H,
    int Hkv, int hd, int smax, int gc, int splits, int per_block,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || splits <= 0 ||
      per_block <= 0 || per_block % kTile || (long long)splits * per_block < smax)
    return cudaErrorInvalidValue;
  const long long st[6] = {ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, gc, q, k, v, kv_len, out, ws, tickets, B, H,
                            Hkv, smax, splits, per_block, st, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, gc, q, k, v, kv_len, out, ws,
                                    tickets, B, H, Hkv, smax, splits,
                                    per_block, st, scale, s);
  return cudaErrorInvalidValue;
}
