// Chunkwise mLSTM forward for Hopper (sm_90a): the xLSTM matrix memory
// over (B, H, S, hd) inputs in chunks of L rows, from a carried state
// (C: hd x hd, n: hd, m: a scalar per (b, h)), all state in fp32.
//
// Replaces: src/repro/kernels/mlstm_chunk/kernel.py, mlstm_chunk_kernel
//   (body _kernel), the Pallas TPU kernel whose sequential grid axis walks
//   the chunks and keeps C, n and m in VMEM scratch. The arithmetic is the
//   body's, in its order: the inclusive cumsum b of the log forget gates,
//   the decay matrix D[t, s] = (b_t - b_s) + li_s (s <= t, NEG_BIG
//   elsewhere), the stabiliser m_out, the inter-chunk term q C and q n,
//   the intra-chunk term (q k^T * exp(D - m_out)) v, the denominator
//   max(|den|, exp(-m_out)), then the state update with the per-chunk
//   stabiliser m_new. The initial state is loaded (m clamped to NEG_BIG),
//   as the body's code does, whatever its docstring says.
//
// Bound on this card: at the serving prefill shape (B = 4, H = 4,
//   S = 2048, hd = 512, L = 128, bf16) the function moves ~151 MB (q, k,
//   v, hs and the fp32 state) and does ~43 GFLOP: 0.045 ms of bytes
//   against 0.043 ms of bf16 tensor-core work. This kernel computes in
//   fp32 on the CUDA cores (67 TFLOP/s) and repeats q k^T in every value
//   tile (below), so it is bound by its fp32 arithmetic, far from either.
//
// Design (simple and right first; tensor cores, TMA and a chunk-parallel
// schedule are later work):
//   * hd = 512 makes C 1 MiB per (b, h): no block can hold it (227 KB of
//     shared memory at most), and a grid of (B, H) would be 16 blocks on
//     132 SMs. So one block owns (b, h, a tile of BV = 32 columns of C, v
//     and hs) and walks all chunks in order, holding C[:, tile] in shared
//     memory. At (4, 4, 2048, 512) that is 256 blocks. Blocks of one (b, h)
//     are adjacent in the grid, so their repeated reads of q and k mostly
//     hit the L2;
//   * every block recomputes, identically, what does not depend on its
//     tile: the gates' cumsum and stabilisers, the L x L scores q k^T
//     (streamed through shared memory in 32-wide slices of hd) and n. The
//     scores are repeated hd / BV times, about 2.5x the useful flops at
//     hd = 512. Tile 0 writes the final n and m;
//   * the cumsum of the log forget gates is SEQUENTIAL over the chunk, in
//     fp32, by one thread (L <= 128 adds), as the plain version computes
//     it. Its sums reach ~-128, where an ulp is 1.5e-5, and the kernel
//     uses their differences (b_t - b_s, total - b_s) in exponents: a
//     sequential sum gives every such difference the rounding of only the
//     adds between s and t, where a parallel scan (or independently
//     rounded prefix sums) would give it the whole error of both sums; at
//     S = 2048 that moves hs by up to ~6e-4 and m past the oracle's 1e-5;
//   * per 32-wide slice of hd: q (scaled) and k go to shared memory; each
//     of the 256 threads accumulates an 8 x 8 tile of the scores and an
//     8 x 2 tile of q C_prev in registers; then the slice's 32 rows of C
//     and n are updated from k * k_scale and v (after every thread has
//     read the old rows);
//   * then att = scores * exp(D - m_out), zero above the diagonal, goes to
//     shared memory (in the space the q/k slices used), each thread sums
//     its 8 x 2 tile of att v and writes hs;
//   * dynamic shared memory, per block: C tile hd x 32 fp32 (64 KB at
//     hd = 512), n (2 KB), att 128 x 129 fp32 (66 KB; aliases the two
//     32 x 132 q/k slices), v tile 128 x 32 fp32 (16 KB), six gate
//     vectors of 128 (3 KB): 153,104 bytes at hd = 512, above the 48 KB
//     static limit, so the launch raises the block's limit with
//     cudaFuncSetAttribute. One block per SM (8 warps);
//   * takes hd a multiple of 32 up to 512, any chunk length L <= 128 that
//     divides S, fp32 or bf16 q/k/v with any strides but a unit stride on
//     hd; hs is written in q's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBV = 32;                 // columns of C, v and hs per block
constexpr int kMaxL = 128;              // longest chunk
constexpr int kDK = 32;                 // depth of one q/k slice of hd
constexpr int kThreads = 256;           // 16 x 16 threads
constexpr int kWarps = kThreads / 32;
constexpr int kQKStride = kMaxL + 4;    // q/k slice rows: float4 aligned
constexpr int kAttStride = kMaxL + 1;   // att rows: conflict-free row walks
constexpr int kUnion = kMaxL * kAttStride > 2 * kDK * kQKStride
                           ? kMaxL * kAttStride
                           : 2 * kDK * kQKStride;
constexpr float kNegBig = -1.0e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

size_t smem_floats(int hd) {
  return static_cast<size_t>(hd) * kBV + hd + kUnion + kMaxL * kBV +
         6 * kMaxL + 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, long long qsb, long long qsh,
                       long long qss, long long ksb, long long ksh,
                       long long kss, long long vsb, long long vsh,
                       long long vss, const float* __restrict__ li,
                       const float* __restrict__ lf,
                       const float* __restrict__ C0,
                       const float* __restrict__ n0,
                       const float* __restrict__ m0, T* __restrict__ hs,
                       float* __restrict__ Cf, float* __restrict__ nf,
                       float* __restrict__ mf, int H, int S, int hd, int L,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                       // [hd][kBV]
  float* ns = Cs + hd * kBV;              // [hd]
  float* Qs = ns + hd;                    // [kDK][kQKStride], q * scale
  float* Ks = Qs + kDK * kQKStride;       // [kDK][kQKStride]
  float* Att = Qs;                        // [kMaxL][kAttStride], aliases Qs/Ks
  float* Vs = Qs + kUnion;                // [kMaxL][kBV]
  float* li_s = Vs + kMaxL * kBV;         // [kMaxL] log input gates
  float* bcum = li_s + kMaxL;             // [kMaxL] inclusive cumsum of lf
  float* mout = bcum + kMaxL;             // [kMaxL] m_out
  float* iscale = mout + kMaxL;           // [kMaxL] exp(m_inter - m_out)
  float* kscale = iscale + kMaxL;         // [kMaxL] k_scale
  float* denom = kscale + kMaxL;          // [kMaxL] max(|den|, exp(-m_out))
  float* scal = denom + kMaxL;            // m_prev, total, m_new, c_scale

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int v0 = blockIdx.x * kBV;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;
  const float* lib = li + bh * S;
  const float* lfb = lf + bh * S;
  T* hsb = hs + bh * S * hd;

  for (int i = tid; i < hd * kBV; i += kThreads)
    Cs[i] = C0[(bh * hd + i / kBV) * hd + v0 + i % kBV];
  for (int d = tid; d < hd; d += kThreads) ns[d] = n0[bh * hd + d];
  if (tid == 0) scal[0] = fmaxf(m0[bh], kNegBig);

  const int r0 = ty * 8;      // this thread's 8 rows (scores, output)
  const int c0 = tx * 8;      // its 8 score columns
  const int oc = tx * 2;      // its 2 output columns of the tile
  const int dr = warp * 4;    // its warp's 4 rows of a slice's C update
  const int nc = S / L;
  const bool rows_live = r0 < L;
  // some (t, s) of the thread's score tile with s <= t < L
  const bool cols_live = rows_live && c0 < L && c0 <= r0 + 7;

  for (int ch = 0; ch < nc; ++ch) {
    const long long t0 = static_cast<long long>(ch) * L;
    __syncthreads();          // the previous chunk is done with every buffer
    if (tid < L) {
      li_s[tid] = lib[t0 + tid];
      bcum[tid] = lfb[t0 + tid];
    }
    for (int r = warp; r < L; r += kWarps)
      Vs[r * kBV + lane] = to_float(vb[(t0 + r) * vss + v0 + lane]);
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;        // sequential inclusive cumsum
      for (int t = 0; t < L; ++t) {
        acc += bcum[t];
        bcum[t] = acc;
      }
      const float total = bcum[L - 1];
      float m_cand = -INFINITY;
      for (int s = 0; s < L; ++s)
        m_cand = fmaxf(m_cand, (li_s[s] + total) - bcum[s]);
      const float m_prev = scal[0];
      const float m_new = fmaxf(m_prev + total, m_cand);
      scal[1] = total;
      scal[2] = m_new;
      scal[3] = expf((m_prev + total) - m_new);
    }
    __syncthreads();
    const float m_prev = scal[0], total = scal[1], m_new = scal[2],
                c_scale = scal[3];
    if (tid < L) {
      const float bt = bcum[tid];
      float m_intra = kNegBig;
      for (int s = 0; s <= tid; ++s)
        m_intra = fmaxf(m_intra, (bt - bcum[s]) + li_s[s]);
      const float m_inter = bt + m_prev;
      const float mo = fmaxf(fmaxf(m_intra, m_inter), kNegBig);
      mout[tid] = mo;
      iscale[tid] = expf(m_inter - mo);
      kscale[tid] = expf(((li_s[tid] + total) - bt) - m_new);
    }

    float sacc[8][8], hacc[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sacc[i][j] = 0.f;
      hacc[i][0] = hacc[i][1] = 0.f;
    }
    float dacc = 0.f;         // q . n_prev of row tid

    for (int d0 = 0; d0 < hd; d0 += kDK) {
      __syncthreads();        // gates visible; the last slice is used up
#pragma unroll 4
      for (int r = warp; r < L; r += kWarps) {
        Qs[lane * kQKStride + r] =
            to_float(qb[(t0 + r) * qss + d0 + lane]) * scale;
        Ks[lane * kQKStride + r] = to_float(kb[(t0 + r) * kss + d0 + lane]);
      }
      __syncthreads();
      if (rows_live) {
#pragma unroll 4
        for (int dd = 0; dd < kDK; ++dd) {
          const float4 qa = *reinterpret_cast<const float4*>(
              Qs + dd * kQKStride + r0);
          const float4 qb4 = *reinterpret_cast<const float4*>(
              Qs + dd * kQKStride + r0 + 4);
          const float a[8] = {qa.x, qa.y, qa.z, qa.w,
                              qb4.x, qb4.y, qb4.z, qb4.w};
          const float2 cv = *reinterpret_cast<const float2*>(
              Cs + (d0 + dd) * kBV + oc);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            hacc[i][0] = fmaf(a[i], cv.x, hacc[i][0]);
            hacc[i][1] = fmaf(a[i], cv.y, hacc[i][1]);
          }
          if (cols_live) {
            const float4 ka = *reinterpret_cast<const float4*>(
                Ks + dd * kQKStride + c0);
            const float4 kb4 = *reinterpret_cast<const float4*>(
                Ks + dd * kQKStride + c0 + 4);
            const float kk[8] = {ka.x, ka.y, ka.z, ka.w,
                                 kb4.x, kb4.y, kb4.z, kb4.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                sacc[i][j] = fmaf(a[i], kk[j], sacc[i][j]);
          }
        }
      }
      if (tid < L) {
#pragma unroll 8
        for (int dd = 0; dd < kDK; ++dd)
          dacc = fmaf(Qs[dd * kQKStride + tid], ns[d0 + dd], dacc);
      }
      __syncthreads();        // every read of the slice's old C and n rows

      // C[d, tile] = C[d, tile] * c_scale + sum_s (k_sd * k_scale_s) v_s
      float cacc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < L; ++s) {
        const float ks = kscale[s];
        const float vv = Vs[s * kBV + lane];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cacc[j] = fmaf(Ks[(dr + j) * kQKStride + s] * ks, vv, cacc[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* c = Cs + (d0 + dr + j) * kBV + lane;
        *c = fmaf(*c, c_scale, cacc[j]);
      }
      // n[d] = n[d] * c_scale + sum_s k_sd * k_scale_s
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = 0.f;
        for (int s = lane; s < L; s += 32)
          p += Ks[(dr + j) * kQKStride + s] * kscale[s];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
        if (lane == 0) ns[d0 + dr + j] = fmaf(ns[d0 + dr + j], c_scale, p);
      }
    }
    __syncthreads();          // the slices are used up: att takes their space

    // att[t, s] = (q_t . k_s) * exp(D[t, s] - m_out[t]) for s <= t, else 0
    if (rows_live) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = r0 + i;
        if (t < L) {
          const float bt = bcum[t], mo = mout[t];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int s = c0 + j;
            float a = 0.f;
            if (cols_live && s <= t)
              a = sacc[i][j] * expf(((bt - bcum[s]) + li_s[s]) - mo);
            Att[t * kAttStride + s] = a;
          }
        }
      }
    }
    __syncthreads();
    if (tid < L) {
      float den_intra = 0.f;
      for (int s = 0; s <= tid; ++s) den_intra += Att[tid * kAttStride + s];
      const float den = fmaf(dacc, iscale[tid], den_intra);
      denom[tid] = fmaxf(fabsf(den), expf(-mout[tid]));
    }
    float oacc[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) oacc[i][0] = oacc[i][1] = 0.f;
    if (rows_live) {
      const int s_end = min(L, r0 + 8);
      for (int s = 0; s < s_end; ++s) {
        const float2 vv = *reinterpret_cast<const float2*>(Vs + s * kBV + oc);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = Att[(r0 + i) * kAttStride + s];
          oacc[i][0] = fmaf(a, vv.x, oacc[i][0]);
          oacc[i][1] = fmaf(a, vv.y, oacc[i][1]);
        }
      }
    }
    __syncthreads();          // denom
    if (rows_live) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = r0 + i;
        if (t < L) {
          const float sc = iscale[t], dn = denom[t];
          store2(hsb + (t0 + t) * hd + v0 + oc,
                 fmaf(hacc[i][0], sc, oacc[i][0]) / dn,
                 fmaf(hacc[i][1], sc, oacc[i][1]) / dn);
        }
      }
    }
    if (tid == 0) scal[0] = m_new;
  }
  __syncthreads();

  for (int i = tid; i < hd * kBV; i += kThreads)
    Cf[(bh * hd + i / kBV) * hd + v0 + i % kBV] = Cs[i];
  if (blockIdx.x == 0) {
    for (int d = tid; d < hd; d += kThreads) nf[bh * hd + d] = ns[d];
    if (tid == 0) mf[bh] = scal[0];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const long long* st, const void* li, const void* lf,
                   const void* C0, const void* n0, const void* m0, void* hs,
                   void* Cf, void* nf, void* mf, int B, int H, int S, int hd,
                   int L, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(hd) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(hd / kBV, H, B);
  mlstm_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], static_cast<const float*>(li),
      static_cast<const float*>(lf), static_cast<const float*>(C0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<T*>(hs), static_cast<float*>(Cf), static_cast<float*>(nf),
      static_cast<float*>(mf), H, S, hd, L, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype of q, k, v and hs: 0 = float32, 1 = bfloat16. q, k, v: (B, H, S,
// hd) with element strides (batch, head, time) each and a unit stride on
// hd; li, lf: (B, H, S), C0: (B, H, hd, hd), n0: (B, H, hd), m0: (B, H),
// all contiguous float32; hs: (B, H, S, hd) contiguous; Cf, nf, mf: the
// final state, contiguous float32. L: the chunk length (divides S, at most
// 128); hd a multiple of 32 up to 512; scale = 1 / sqrt(hd) in float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_mlstm_chunk(
    int dtype, const void* q, const void* k, const void* v, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss,
    const void* li, const void* lf, const void* C0, const void* n0,
    const void* m0, void* hs, void* Cf, void* nf, void* mf, int B, int H,
    int S, int hd, int L, float scale, void* stream) {
  if (B < 0 || H < 0 || S < 1 || B > 65535 || H > 65535 || hd < kBV ||
      hd % kBV || hd > 512 || L < 1 || L > kMaxL || S % L)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, st, li, lf, C0, n0, m0, hs, Cf, nf, mf, B,
                         H, S, hd, L, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, st, li, lf, C0, n0, m0, hs, Cf, nf,
                                 mf, B, H, S, hd, L, scale, s);
  return cudaErrorInvalidValue;
}
