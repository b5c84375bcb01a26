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
//   S = 2048, hd = 512, L = 128, bf16) the function moves ~168 MB (q, k,
//   v, hs, the gates and the fp32 state) and does ~43 GFLOP: 0.050 ms of
//   bytes against 0.043 ms of bf16 tensor-core work.
//
// Two bodies, chosen by the call:
//
// bfloat16 q/k/v with L = 128 and hd a multiple of 64, on the tensor cores
//   (mlstm_chunk_wgmma_kernel); the serving prefill's every call:
//   * hd = 512 makes C 1 MiB per (b, h), more than a block can hold, so a
//     block owns (b, h, BV = 64 columns of C, v and hs) and walks the
//     chunks in order with C[:, tile] in shared memory as its fp32 master
//     (128 KB at hd = 512). 128 blocks at the serving shape: one wave;
//   * a block is two warpgroups, each over 64 of the chunk's 128 rows, and
//     nothing else: a third warpgroup (a producer warp, a gate warp) would
//     cap every thread at 168 registers, where the slice loop's ~205 live
//     ones spill. Thread 0 keeps a 2-stage TMA ring of q and k slices (128
//     rows x 64 of hd, 128-byte swizzle) one slice ahead, issued after the
//     barrier that frees a stage, and the chunk's v tile (two 32-column
//     halves, 64-byte swizzle), issued as soon as the previous chunk's
//     att v is done;
//   * each chunk starts with its gate vectors (the in-order fp32 cumsum by
//     one warp, then m_out, exp(m_inter - m_out) and k_scale with two
//     threads per row, and c_scale), the log gates read one chunk ahead.
//     The cumsum stays sequential: its sums reach ~-128 and the kernel uses
//     their differences in exponents, where a parallel scan would move m
//     past the oracle's 1e-5;
//   * per slice of 64 rows of hd, in the reference body's order:
//     S += q k^T (wgmma shared x shared, m64n128k16) and H += q C_prev
//     (m64n64k16; C_prev's slice split into bf16 hi and lo = bf16(C - hi),
//     each through one staging tile read MN-major, lo after hi's products
//     are done); then the slice's rows of the tile are updated,
//     C = C c_scale + kk^T v with kk = k k_scale: k comes transposed out of
//     the ring by ldmatrix, kk is formed in fp32 and split into
//     hi = bf16(kk) and lo = bf16(kk - hi), and both go through wgmma
//     (register x shared, m64n32k16, each warpgroup one 32-column half of
//     the tile) into one fp32 accumulator: the split keeps C within 5e-5
//     of the fp32 plain version, where kk rounded once to bf16 misses it
//     by ~270x. n, q n_prev and the gates stay fp32 on the CUDA cores;
//   * after the slices: att = S scale exp(D - m_out), zero above the
//     diagonal, on the accumulator registers; den_intra is summed from the
//     fp32 att; att goes to bf16 hi + lo as wgmma's A operand for O = att v
//     (the first warpgroup's rows see only the first 64 columns); hs = (H
//     scale iscale + O) / denom is stored in bf16. Rounding C_prev or att
//     once to bf16 moves a few elements of hs past its 2e-2 bar at S =
//     2048; with the splits hs stays ~1e-4 of its norm from the plain
//     version;
//   * shared memory at hd = 512: ring 64 KB, v 16 KB, staging 8 KB, C
//     128 KB, n (two buffers, the chunk's old and new) 4 KB, gates 2.5 KB:
//     228,904 bytes with the alignment slack, one block per SM.
//
// Everything else (float32, L != 128, hd not a multiple of 64), on the CUDA
//   cores (mlstm_chunk_f32_kernel), the first port's body:
//   * one block owns (b, h, a tile of BV = 32 columns of C, v and hs) and
//     walks all chunks in order, holding C[:, tile] in shared memory. Blocks
//     of one (b, h) are adjacent in the grid, so their repeated reads of q
//     and k mostly hit the L2;
//   * every block recomputes, identically, what does not depend on its
//     tile: the gates' cumsum and stabilisers, the L x L scores q k^T
//     (streamed through shared memory in 32-wide slices of hd) and n. Tile
//     0 writes the final n and m;
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
//     vectors of 128 (3 KB): 153,104 bytes at hd = 512;
//   * takes hd a multiple of 32 up to 512, any chunk length L <= 128 that
//     divides S, fp32 or bf16 q/k/v with any strides but a unit stride on
//     hd; hs is written in q's dtype.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../_hopper/hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// everything else: the CUDA-core body
// ---------------------------------------------------------------------------

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
    mlstm_chunk_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                   const long long* st, const void* li, const void* lf,
                   const void* C0, const void* n0, const void* m0, void* hs,
                   void* Cf, void* nf, void* mf, int B, int H, int S, int hd,
                   int L, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(hd) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_f32_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(hd / kBV, H, B);
  mlstm_chunk_f32_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], static_cast<const float*>(li),
      static_cast<const float*>(lf), static_cast<const float*>(C0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<T*>(hs), static_cast<float*>(Cf), static_cast<float*>(nf),
      static_cast<float*>(mf), H, S, hd, L, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16, L = 128: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int TC_L = 128;                  // chunk rows
constexpr int TC_DK = 64;                  // hd rows of one q/k slice
constexpr int TC_BV = 64;                  // columns of C, v, hs per block
// two warpgroups and nothing else: ten or more warps put three on an SM
// sub-partition and cap every thread at 168 registers, where the slice
// loop's ~205 live ones spill (setmaxnreg does not change what ptxas
// allots)
constexpr int TC_THREADS = 256;
constexpr int TC_TILE = TC_L * TC_DK * 2;  // a q or k slice, 16 KB
constexpr int TC_VHALF = TC_L * 32 * 2;    // 32 columns of v, 8 KB
constexpr int TC_STG = TC_DK * TC_BV * 2;  // bf16 C_prev slice, 8 KB
// the gate buffer, floats: li, the cumsum b, m_out, exp(m_inter - m_out)
// and k_scale per row, then c_scale, m_prev, the chunk's total and m_new
constexpr int G_LI = 0, G_B = TC_L, G_MOUT = 2 * TC_L, G_ISC = 3 * TC_L,
              G_KSC = 4 * TC_L, G_CSC = 5 * TC_L, G_MPREV = G_CSC + 1,
              G_TOT = G_CSC + 2, G_MNEW = G_CSC + 3, TC_GATES = G_CSC + 4;
// byte offsets from the 1024-aligned base: q[2], k[2], v halves, staging,
// then the C master, n[2], the gates and the mbarriers
constexpr int OFF_Q = 0, OFF_K = 2 * TC_TILE, OFF_V = 4 * TC_TILE,
              OFF_STG = OFF_V + 2 * TC_VHALF, OFF_C = OFF_STG + TC_STG;
constexpr int TC_BARS = 3;                 // full[2], v_full

constexpr size_t tc_smem_bytes(int hd) {
  return 1024 + OFF_C + 4 * (static_cast<size_t>(hd) * TC_BV + 2 * hd +
                             TC_GATES) + 8 * TC_BARS;
}
static_assert(tc_smem_bytes(512) <= 232448,
              "over the shared memory a block can use");

// The fp32 master of C[:, tile]: row d, column j, the column's 8-float
// groups swizzled by d % 4, so that a warp's accumulator-layout accesses
// (8 rows x 4 column pairs) fall in distinct banks.
__device__ __forceinline__ int cm(int d, int j) {
  return d * TC_BV + (j ^ ((d & 3) << 3));
}

// K-major descriptor of columns c .. c + 15 of a 64-column bf16 tile with
// 128-byte rows (q and k slices: A and B of S = q k^T, A of H = q C).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int c) {
  return smem_desc(tile + 2 * c, 16, 1024, 1);
}

// MN-major descriptor of rows r .. r + 15 of the 64-row, 64-column bf16
// staging tile (128-byte swizzle): B of H = q C_prev.
__device__ __forceinline__ uint64_t desc_stg(uint32_t tile, int r) {
  return smem_desc(tile + 128 * r, 64 * 128, 1024, 1);
}

// MN-major descriptor of rows r .. r + 15 of a 128-row, 32-column bf16
// v half (64-byte swizzle): B of the update and of O = att v.
__device__ __forceinline__ uint64_t desc_v(uint32_t tile, int r) {
  return smem_desc(tile + 64 * r, TC_L * 64, 512, 2);
}

// x, as a value the compiler cannot see through: descriptors formed from
// it are formed where they are used, not hoisted out of the chunk loop
// (sixteen live 64-bit descriptors spill)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// The update's A operand for 2 k-steps (32 rows of the chunk from s0 = 32
// quarter): kk^T = (k k_scale)^T at hd rows 16 wi + g8 (+ 8) of the k
// slice, which ldmatrix reads transposed out of the 128-byte swizzled tile;
// kk in fp32 is split into bf16 hi and lo = bf16(kk - hi). n's sums over
// this thread's rows of the chunk ride along in fp32.
__device__ __forceinline__ void update_operand(uint32_t k_tile,
                                               const float* ksc, int quarter,
                                               int lane, int wi,
                                               uint32_t (&ahi)[2][4],
                                               uint32_t (&alo)[2][4],
                                               float& nsum0, float& nsum1) {
  const int tq = lane % 4, mj = lane >> 3;
#pragma unroll
  for (int k2 = 0; k2 < 2; ++k2) {
    const int s0 = 16 * (2 * quarter + k2);
    const int s = s0 + (lane & 7) + 8 * (mj >> 1);
    const int chunk = 2 * wi + (mj & 1);
    uint32_t r[4];
    ldmatrix_x4_trans(r, k_tile + s * 128 + ((chunk ^ (s & 7)) << 4));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int sp = s0 + 8 * (j >> 1) + 2 * tq;
      const float2 ks = *reinterpret_cast<const float2*>(ksc + sp);
      const float2 kv = unpack_bf16(r[j]);
      const float x0 = kv.x * ks.x, x1 = kv.y * ks.y;
      if (j & 1) nsum1 += x0 + x1; else nsum0 += x0 + x1;
      const uint32_t hi = pack_bf16(x0, x1);
      const float2 hf = unpack_bf16(hi);
      ahi[k2][j] = hi;
      alo[k2][j] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
  }
}

// Rows d0 + 0 .. 63 of the C master as bf16 hi (lo = false) or lo =
// bf16(C - hi) into the 128-byte swizzled staging tile, 16 bytes a thread
// twice.
__device__ __forceinline__ void stage_c(const float* Cs, uint8_t* stg,
                                        int d0, int tid, bool lo) {
#pragma unroll
  for (int rep = 0; rep < 2; ++rep) {
    const int id = tid + TC_THREADS * rep;
    const int d = id >> 3, ch = id & 7;
    const float* src = Cs + cm(d0 + d, 8 * ch);
    const float4 x = *reinterpret_cast<const float4*>(src);
    const float4 y = *reinterpret_cast<const float4*>(src + 4);
    const float f[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w[e] = pack_bf16(f[2 * e], f[2 * e + 1]);
      if (lo) {
        const float2 hf = unpack_bf16(w[e]);
        w[e] = pack_bf16(f[2 * e] - hf.x, f[2 * e + 1] - hf.y);
      }
    }
    *reinterpret_cast<uint4*>(stg + d * 128 + ((ch ^ (d & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Slice it of the walk (chunk it / nsl, hd rows 64 (it % nsl)) of q and k
// into ring stage it % 2, completing on its mbarrier.
__device__ __forceinline__ void load_slice(const CUtensorMap* tm_q,
                                           const CUtensorMap* tm_k,
                                           uint32_t base, uint32_t bars,
                                           int it, int nsl, int h, int b) {
  const int st = it & 1, t0 = (it / nsl) * TC_L, d0 = TC_DK * (it % nsl);
  const uint32_t bar = bars + 8 * st;
  mbar_expect_tx(bar, 2 * TC_TILE);
  tma_load(base + OFF_Q + st * TC_TILE, tm_q, bar, d0, t0, h, b);
  tma_load(base + OFF_K + st * TC_TILE, tm_k, bar, d0, t0, h, b);
}

// Chunk c's 32-column halves of the block's 64 columns of v.
__device__ __forceinline__ void load_v(const CUtensorMap* tm_v, uint32_t s_v,
                                       uint32_t v_full, int c, int v0, int h,
                                       int b) {
  mbar_expect_tx(v_full, 2 * TC_VHALF);
  tma_load(s_v, tm_v, v_full, v0, c * TC_L, h, b);
  tma_load(s_v + TC_VHALF, tm_v, v_full, v0 + 32, c * TC_L, h, b);
}

__global__ void __launch_bounds__(TC_THREADS, 1)
mlstm_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ li,
                         const float* __restrict__ lf,
                         const float* __restrict__ C0,
                         const float* __restrict__ n0,
                         const float* __restrict__ m0,
                         __nv_bfloat16* __restrict__ hs,
                         float* __restrict__ Cf, float* __restrict__ nf,
                         float* __restrict__ mf, int H, int S, int hd,
                         float scale) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* Cs = reinterpret_cast<float*>(gbase + OFF_C);   // [hd][64]
  float* ns = Cs + hd * TC_BV;                           // [2][hd]
  float* g = ns + 2 * hd;                                // [TC_GATES]
  const uint32_t bars = base + OFF_C + 4 * (hd * TC_BV + 2 * hd + TC_GATES);
  const uint32_t v_full = bars + 16;                     // after full[2]
  const uint32_t s_v = base + OFF_V;
  const uint8_t* q_gen = gbase + OFF_Q;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int v0 = blockIdx.x * TC_BV, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  const int nsl = hd / TC_DK, nc = S / TC_L, n_it = nc * nsl;
  const float* lib = li + bh * S;
  const float* lfb = lf + bh * S;

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init(v_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < hd * (TC_BV / 4); i += TC_THREADS) {
    const int d = i / (TC_BV / 4), j = 4 * (i % (TC_BV / 4));
    *reinterpret_cast<float4*>(Cs + cm(d, j)) =
        *reinterpret_cast<const float4*>(C0 + (bh * hd + d) * hd + v0 + j);
  }
  for (int d = tid; d < hd; d += TC_THREADS) ns[d] = n0[bh * hd + d];
  if (tid == 0) g[G_MNEW] = fmaxf(m0[bh], kNegBig);   // chunk 0's m_prev
  __syncthreads();
  if (tid == 0) {
    load_slice(&tm_q, &tm_k, base, bars, 0, nsl, h, b);
    load_v(&tm_v, s_v, v_full, 0, v0, h, b);
  }
  // the next chunk's log gates, one row per thread of the first 128
  float li_next = 0.f, lf_next = 0.f;
  if (tid < TC_L) {
    li_next = lib[tid];
    lf_next = lfb[tid];
  }

  // warpgroup wg owns the chunk's rows 64 wg .. 64 wg + 63; in the update,
  // columns 32 wg .. 32 wg + 31 of the tile
  const int wg = warp / 4, wi = warp % 4;
  const int g8 = lane / 4, tq = lane % 4;
  const int r0 = 64 * wg + 16 * wi + g8;     // rows r0 and r0 + 8

  for (int c = 0; c < nc; ++c) {
    const int p = c & 1, t0 = c * TC_L;
    const float* n_prev = ns + p * hd;
    float* n_next = ns + (p ^ 1) * hd;

    // the chunk's gates: the previous chunk's readers are done
    __syncthreads();
    if (tid < TC_L) {
      g[G_LI + tid] = li_next;
      g[G_B + tid] = lf_next;            // the raw log forget gates first
      if (c + 1 < nc) {
        li_next = lib[t0 + TC_L + tid];
        lf_next = lfb[t0 + TC_L + tid];
      }
    }
    __syncthreads();
    if (warp == 0) {
      // the inclusive cumsum, one add at a time from row 0, in fp32: its
      // sums reach ~-128 and exponents use their differences, where a
      // parallel scan would move m past the oracle's 1e-5
      float acc = 0.f, bc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          acc += g[G_B + 32 * r + j];
          if (j == lane) bc[r] = acc;
        }
      }
      __syncwarp();
      const float total = __shfl_sync(kFull, bc[3], 31);
      float m_cand = -INFINITY;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        g[G_B + 32 * r + lane] = bc[r];
        m_cand = fmaxf(m_cand, (g[G_LI + 32 * r + lane] + total) - bc[r]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m_cand = fmaxf(m_cand, __shfl_xor_sync(kFull, m_cand, o));
      const float m_prev = g[G_MNEW];
      const float m_new = fmaxf(m_prev + total, m_cand);
      __syncwarp();
      if (lane == 0) {
        g[G_MPREV] = m_prev;
        g[G_TOT] = total;
        g[G_MNEW] = m_new;
        g[G_CSC] = expf((m_prev + total) - m_new);
      }
    }
    __syncthreads();
    {
      // row t's stabiliser: two threads per row, every other s <= t
      const int t = tid >> 1, half = tid & 1;
      const float bt = g[G_B + t], m_prev = g[G_MPREV];
      float m_intra = kNegBig;
      for (int s = half; s <= t; s += 2)
        m_intra = fmaxf(m_intra, (bt - g[G_B + s]) + g[G_LI + s]);
      m_intra = fmaxf(m_intra, __shfl_xor_sync(kFull, m_intra, 1));
      const float m_inter = bt + m_prev;
      const float mo = fmaxf(fmaxf(m_intra, m_inter), kNegBig);
      if (half == 0) {
        g[G_MOUT + t] = mo;
        g[G_ISC + t] = expf(m_inter - mo);
      } else {
        g[G_KSC + t] =
            expf(((g[G_LI + t] + g[G_TOT]) - bt) - g[G_MNEW]);
      }
    }
    const float c_scale = g[G_CSC];
    const float* ksc = g + G_KSC;

    float sacc[64], hacc[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) hacc[i] = 0.f;
    float dn0 = 0.f, dn1 = 0.f;        // q . n_prev of rows r0, r0 + 8

    for (int i = 0; i < nsl; ++i) {
      const int it = c * nsl + i, st = it & 1;
      const uint32_t sb = opaque(base);
      const uint32_t q_tile = sb + OFF_Q + st * TC_TILE;
      const uint32_t k_tile = sb + OFF_K + st * TC_TILE;
      const uint32_t s_stg = sb + OFF_STG;
      const uint32_t s_v = sb + OFF_V;
      const uint32_t q_rows = q_tile + 64 * 128 * wg;
      const int d0 = TC_DK * i;

      // every thread is done with the previous slice (its ring stage and
      // the staging tile) and with the gates' writes: the next slice goes
      // into the free stage, and C_prev's slice, as bf16 hi + lo, goes
      // through the staging tile for H += q C_prev: hi now, lo after the
      // hi products are done
      __syncthreads();
      if (tid == 0 && it + 1 < n_it)
        load_slice(&tm_q, &tm_k, base, bars, it + 1, nsl, h, b);
      stage_c(Cs, gbase + OFF_STG, d0, tid, false);
      fence_proxy_async();
      __syncthreads();
      mbar_wait(bars + 8 * st, (it >> 1) & 1);

      // S += q k^T and H += q C_prev_hi over this slice
      fence_regs(sacc);
      fence_regs(hacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_DK / 16; ++kk)
        wgmma_ss(sacc, desc_k(q_rows, 16 * kk), desc_k(k_tile, 16 * kk), 1);
#pragma unroll
      for (int kk = 0; kk < TC_DK / 16; ++kk)
        wgmma_ss_tb(hacc, desc_k(q_rows, 16 * kk), desc_stg(s_stg, 16 * kk));
      wgmma_commit();

      // meanwhile on the CUDA cores: q . n_prev over the slice, lane tq
      // taking hd rows d0 + 16 tq .. d0 + 16 tq + 15 of both its rows
      {
        float dot[2] = {0.f, 0.f};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float4* nn = reinterpret_cast<const float4*>(
              n_prev + d0 + 16 * tq + 8 * hf);
          const float4 na = nn[0], nb = nn[1];
          const float nv[8] = {na.x, na.y, na.z, na.w, nb.x, nb.y, nb.z, nb.w};
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = r0 + 8 * half;
            const uint4 x = *reinterpret_cast<const uint4*>(
                q_gen + st * TC_TILE + r * 128 +
                (((2 * tq + hf) ^ (r & 7)) << 4));
            const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 qq = unpack_bf16(w[e]);
              dot[half] = fmaf(qq.x, nv[2 * e], dot[half]);
              dot[half] = fmaf(qq.y, nv[2 * e + 1], dot[half]);
            }
          }
        }
        dn0 += dot[0];
        dn1 += dot[1];
      }

      // the update's A operand for the chunk's first 32 rows
      float nsum0 = 0.f, nsum1 = 0.f;
      uint32_t ahA[2][4], alA[2][4], ahB[2][4], alB[2][4];
      update_operand(k_tile, ksc, 0, lane, wi, ahA, alA, nsum0, nsum1);
      wgmma_wait_all();           // S and H_hi are done: the staging is free
      fence_regs(sacc);
      fence_regs(hacc);
      __syncthreads();
      stage_c(Cs, gbase + OFF_STG, d0, tid, true);
      fence_proxy_async();
      __syncthreads();

      // H += q C_prev_lo, then the update kk^T v of this warpgroup's 32
      // columns, hi and lo products into one fp32 accumulator, a quarter
      // of the chunk's rows (two k-steps) at a time: each quarter's operand
      // is formed while the one before it is in the tensor cores
      mbar_wait(v_full, c & 1);
      const uint32_t v_half = s_v + wg * TC_VHALF;
      float dacc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) dacc[e] = 0.f;
      fence_regs(hacc);
      fence_regs(dacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_DK / 16; ++kk)
        wgmma_ss_tb(hacc, desc_k(q_rows, 16 * kk), desc_stg(s_stg, 16 * kk));
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const uint64_t dv = desc_v(v_half, 16 * k2);
        wgmma_rs(dacc, ahA[k2], dv);
        wgmma_rs(dacc, alA[k2], dv);
      }
      wgmma_commit();
#pragma unroll
      for (int quarter = 1; quarter < 4; ++quarter) {
        uint32_t (&ah)[2][4] = quarter & 1 ? ahB : ahA;
        uint32_t (&al)[2][4] = quarter & 1 ? alB : alA;
        if (quarter > 1) wgmma_wait<1>();   // quarter - 2 is done with these
        update_operand(k_tile, ksc, quarter, lane, wi, ah, al, nsum0, nsum1);
        wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          const uint64_t dv = desc_v(v_half, 16 * (2 * quarter + k2));
          wgmma_rs(dacc, ah[k2], dv);
          wgmma_rs(dacc, al[k2], dv);
        }
        wgmma_commit();
      }
      wgmma_wait_all();
      fence_regs(hacc);
      fence_regs(dacc);

      // C[slice, this half] = C c_scale + kk^T v; n[slice] likewise (the
      // first warpgroup), into the chunk's new n buffer
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int d = d0 + 16 * wi + g8 + 8 * half;
          float2* cp = reinterpret_cast<float2*>(
              Cs + cm(d, 32 * wg + 8 * ii + 2 * tq));
          float2 cv = *cp;
          cv.x = fmaf(cv.x, c_scale, dacc[4 * ii + 2 * half]);
          cv.y = fmaf(cv.y, c_scale, dacc[4 * ii + 2 * half + 1]);
          *cp = cv;
        }
      }
      nsum0 = quad_sum(nsum0);
      nsum1 = quad_sum(nsum1);
      if (wg == 0 && tq == 0) {
        const int d = d0 + 16 * wi + g8;
        n_next[d] = fmaf(n_prev[d], c_scale, nsum0);
        n_next[d + 8] = fmaf(n_prev[d + 8], c_scale, nsum1);
      }
    }

    // att = S scale exp(D - m_out) below the diagonal, in fp32 for
    // den_intra, and split into bf16 hi + lo as the A operand of O = att v
    // (att rounded once to bf16 moves hs past its 2e-2 bar)
    const float* gb = g + G_B;
    const float* gl = g + G_LI;
    float bt[2], mo[2], den_intra[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      bt[half] = gb[r0 + 8 * half];
      mo[half] = g[G_MOUT + r0 + 8 * half];
    }
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int ii = 0; ii < 16; ++ii) {
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, t = r0 + 8 * half;
        const int s = 8 * ii + 2 * tq + (e & 1);
        a[e] = s <= t ? sacc[4 * ii + e] * scale *
                            expf(((bt[half] - gb[s]) + gl[s]) - mo[half])
                      : 0.f;
        den_intra[half] += a[e];
      }
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const uint32_t hi = pack_bf16(a[e], a[e + 1]);
        const float2 hf = unpack_bf16(hi);
        ph[ii / 2][2 * (ii & 1) + e / 2] = hi;
        pl[ii / 2][2 * (ii & 1) + e / 2] =
            pack_bf16(a[e] - hf.x, a[e + 1] - hf.y);
      }
    }
    const uint32_t s_v_o = opaque(s_v);
    float o0[16], o1[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) o0[e] = o1[e] = 0.f;
    fence_regs(o0);
    fence_regs(o1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_L / 16; ++kk) {
      if (kk < 4 * (wg + 1)) {        // past that, this warpgroup's att is 0
        const uint64_t va = desc_v(s_v_o, 16 * kk);
        const uint64_t vb = desc_v(s_v_o + TC_VHALF, 16 * kk);
        wgmma_rs(o0, ph[kk], va);
        wgmma_rs(o0, pl[kk], va);
        wgmma_rs(o1, ph[kk], vb);
        wgmma_rs(o1, pl[kk], vb);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o0);
    fence_regs(o1);
    __syncthreads();                  // both warpgroups are done with v
    if (tid == 0 && c + 1 < nc) load_v(&tm_v, s_v, v_full, c + 1, v0, h, b);

    // hs = (H scale iscale + O) / max(|den|, exp(-m_out)) in bf16
    const float dns[2] = {quad_sum(dn0), quad_sum(dn1)};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = r0 + 8 * half;
      const float isc = g[G_ISC + t];
      const float den = (dns[half] * scale) * isc + quad_sum(den_intra[half]);
      const float denom = fmaxf(fabsf(den), expf(-mo[half]));
      __nv_bfloat16* out = hs + (bh * S + t0 + t) * hd + v0 + 2 * tq;
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int oi = 4 * (ii & 3) + 2 * half;
        const float ox = ii < 4 ? o0[oi] : o1[oi];
        const float oy = ii < 4 ? o0[oi + 1] : o1[oi + 1];
        const float x = ((hacc[4 * ii + 2 * half] * scale) * isc + ox) / denom;
        const float y =
            ((hacc[4 * ii + 2 * half + 1] * scale) * isc + oy) / denom;
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * ii) =
            __floats2bfloat162_rn(x, y);
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < hd * (TC_BV / 4); i += TC_THREADS) {
    const int d = i / (TC_BV / 4), j = 4 * (i % (TC_BV / 4));
    *reinterpret_cast<float4*>(Cf + (bh * hd + d) * hd + v0 + j) =
        *reinterpret_cast<const float4*>(Cs + cm(d, j));
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < hd; d += TC_THREADS)
      nf[bh * hd + d] = ns[(nc & 1) * hd + d];
    if (tid == 0) mf[bh] = g[G_MNEW];
  }
}

int launch_wgmma(const void* q, const void* k, const void* v,
                 const long long* st, const void* li, const void* lf,
                 const void* C0, const void* n0, const void* m0, void* hs,
                 void* Cf, void* nf, void* mf, int B, int H, int S, int hd,
                 float scale, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeFailed;
  CUtensorMap tq, tk, tv;
  if (!(encode(fn, &tq, q, hd, S, H, B, st[2], st[1], st[0], TC_DK, TC_L,
               CU_TENSOR_MAP_SWIZZLE_128B) &&
        encode(fn, &tk, k, hd, S, H, B, st[5], st[4], st[3], TC_DK, TC_L,
               CU_TENSOR_MAP_SWIZZLE_128B) &&
        encode(fn, &tv, v, hd, S, H, B, st[8], st[7], st[6], 32, TC_L,
               CU_TENSOR_MAP_SWIZZLE_64B)))
    return kEncodeFailed;
  static bool raised = false;      // the largest hd's need, once
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlstm_chunk_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tc_smem_bytes(512)));
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const dim3 grid(hd / TC_BV, H, B);
  mlstm_chunk_wgmma_kernel<<<grid, TC_THREADS, tc_smem_bytes(hd), stream>>>(
      tq, tk, tv, static_cast<const float*>(li), static_cast<const float*>(lf),
      static_cast<const float*>(C0), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<__nv_bfloat16*>(hs),
      static_cast<float*>(Cf), static_cast<float*>(nf), static_cast<float*>(mf),
      H, S, hd, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype of q, k, v and hs: 0 = float32, 1 = bfloat16. q, k, v: (B, H, S,
// hd) with element strides (batch, head, time) each and a unit stride on
// hd; li, lf: (B, H, S), C0: (B, H, hd, hd), n0: (B, H, hd), m0: (B, H),
// all contiguous float32; hs: (B, H, S, hd) contiguous; Cf, nf, mf: the
// final state, contiguous float32. L: the chunk length (divides S, at most
// 128); hd a multiple of 32 up to 512; scale = 1 / sqrt(hd) in float32.
// bfloat16 with L = 128 and hd a multiple of 64 runs the tensor-core body,
// which reads q, k and v by TMA: their base addresses and strides must be
// multiples of 16 bytes. Returns cudaGetLastError() after the launch (0 on
// success), a cudaError_t before it, or -1 if a tensor map failed to
// encode.
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
  if (dtype == 1 && L == TC_L && hd % TC_DK == 0)
    return launch_wgmma(q, k, v, st, li, lf, C0, n0, m0, hs, Cf, nf, mf, B,
                        H, S, hd, scale, s);
  if (dtype == 0)
    return launch_f32<float>(q, k, v, st, li, lf, C0, n0, m0, hs, Cf, nf,
                             mf, B, H, S, hd, L, scale, s);
  if (dtype == 1)
    return launch_f32<__nv_bfloat16>(q, k, v, st, li, lf, C0, n0, m0, hs, Cf,
                                     nf, mf, B, H, S, hd, L, scale, s);
  return cudaErrorInvalidValue;
}
