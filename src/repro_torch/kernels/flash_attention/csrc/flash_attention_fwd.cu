// Flash attention forward for Hopper (sm_90a): GQA, causal with a query
// offset, local window, tanh softcap; writes out and the fp32 row lse.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_fwd (bodies _fwd_kernel, _mask, _block_needed; the
//   pallas_call at :132), the Pallas TPU flash attention forward.
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s): each
//   live (query, key) pair of a head costs 4 * hd flops, and q, k, v, out
//   and lse move once. At the training shape (B = 8, S = 1024, 12 query and
//   4 KV heads, hd = 64, causal) that is 12.9 GFLOP against 34 MB, so
//   operations set the bound: 0.0130 ms. At the serving shapes (B = 1,
//   one prompt of 96 to 700 tokens) bytes set it: 0.12 to 0.87 us, 0.48 us
//   on average, well under the cost of a launch. At recurrentgemma-2b's
//   prefill (B = 4, S = 4096, 10 query heads on one KV head, hd = 256,
//   window 2048: 6,292,480 live pairs a head) it is 258 GFLOP against
//   185 MB: operations, 0.261 ms.
//
// Two bodies, chosen by dtype:
//
// bfloat16, on the tensor cores (flash_fwd_wgmma_kernel):
//   * one block of one warpgroup per (query head, batch row, 64-row query
//     tile); at 253 registers two blocks share an SM, independent, so one
//     block's softmax can overlap the other's products (on an H100 SXM a
//     block of two warpgroups over 128 rows took 1.15-1.44x the device
//     time at every shape chip_smoke.py times);
//     GQA folds into the index, kv_head = h / G; the heaviest (last) query
//     tiles are scheduled first;
//   * S = Q.K^T and O += P.V on wgmma with fp32 accumulators. Q and K come
//     from shared memory, both K-major (hd contiguous), 16 deep per step.
//     P is the S accumulator rounded to bf16 pairs, which is exactly
//     wgmma's A-register layout, so it never leaves registers; rounding it
//     there is the reference's rounding of p to the input dtype before P.V.
//     V is read MN-major through the instruction's transpose-B bit;
//   * scale, softcap, masks, the online max and exp2f (log2 e folded into
//     the scale) run on the accumulator registers, four lanes to a row;
//     masks only on tiles that cross the causal diagonal, the window's
//     edge or Skv; KV tiles no row of the block can see are skipped
//     (the reference's _block_needed);
//   * Q is copied once and K/V tiles of 128 rows (64 from hd = 128 on, for
//     registers) stream through a 2-stage ring by TMA, completion on
//     mbarriers: one thread issues tile j+1's copies before the warpgroup
//     computes on tile j. 128-byte swizzle at hd >= 64 (hd = 128 and 256 as
//     two and four 64-column boxes), 64-byte at hd = 32, matching the wgmma
//     descriptors. TMA zero-fills rows past Sq and Skv, so a ragged edge
//     needs only the mask. Tensor maps are encoded per call on the host
//     through the runtime's driver entry point (no -lcuda) and passed as
//     __grid_constant__ parameters;
//   * hd = 256 (recurrentgemma-2b): O is 128 fp32 registers a thread beside
//     S's 32, P.V one m64n256 product per 16 keys; Q and two stages of K and
//     V take 161 KB of shared memory, so one block per SM.
//
// float32, on the CUDA cores (flash_fwd_f32_kernel): wgmma has no fp32
//   operands and TF32 would miss the 5e-5 bar that the float32 parity
//   checks rest on. One block per (32 query rows, head, batch row), 4
//   threads per row, K and V tiles of 32 rows staged in static shared
//   memory (at hd = 256: 8 threads per row and tiles of 16 rows, inside its
//   48 KB).
//
// Both: a row with no live key gives zeros and lse = -inf; any length
// works with fixed tiles (the TPU wrapper shrank its tiles until they
// divided the length).
//
// Later work: warp specialisation (a producer warp with setmaxnreg), an
// explicit ping-pong of two warpgroups' softmax against each other's
// products, and a TMA store of O.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "../../_hopper/hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 32;    // query rows per block

// Tile plan of one head_dim's float32 instantiation: TPR threads share a
// query row; K and V tiles of BKV rows are staged in static shared memory,
// which holds at most 48 KB (so 16 rows at hd = 256, where 8 threads share
// a row to keep q and the accumulator at 32 registers each).
template <int HD>
struct F32Tile {
  static constexpr int TPR = HD == 256 ? 8 : 4;       // threads per row
  static constexpr int BKV = HD == 256 ? 16 : 32;     // keys per staged tile
  static constexpr int NT = F32_BQ * TPR;             // threads per block
  static_assert(2 * BKV * HD * 4 <= 48 * 1024, "over static shared memory");
};

template <int HD>
__global__ void __launch_bounds__(F32Tile<HD>::NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Skv, int H, int G,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh, float scale,
                     float softcap, int causal, int window, int q_offset) {
  using P = F32Tile<HD>;
  constexpr int TPR = P::TPR, BKV = P::BKV, NT = P::NT;
  constexpr int DPT = HD / TPR;          // head dims per thread
  constexpr int VEC = 4;                 // floats per 16-byte load
  constexpr int CPR = HD / VEC;          // 16-byte chunks per row
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qi = qt * F32_BQ + row;
  const bool row_live = qi < Sq;
  const int qpos = qi + q_offset;

  __shared__ float k_s[BKV][HD];
  __shared__ float v_s[BKV][HD];

  float qr[DPT], acc[DPT];
  const float* qp =
      q + (long long)b * qsb + (long long)qi * qss + (long long)h * qsh;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row_live ? qp[i * TPR + part] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  // the key range any row of this block can see
  const int qpos_lo = qt * F32_BQ + q_offset;
  const int qpos_hi = min(qt * F32_BQ + F32_BQ, Sq) - 1 + q_offset;
  const int kv_hi = causal ? min(Skv, qpos_hi + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;

  const float* kb = k + (long long)b * ksb + (long long)kvh * ksh;
  const float* vb = v + (long long)b * vsb + (long long)kvh * vsh;
  for (int k0 = (kv_lo / BKV) * BKV; k0 < kv_hi; k0 += BKV) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < BKV * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * VEC;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < Skv) {
        kx = *reinterpret_cast<const float4*>(kb + (long long)(k0 + r) * kss + c);
        vx = *reinterpret_cast<const float4*>(vb + (long long)(k0 + r) * vss + c);
      }
      *reinterpret_cast<float4*>(&k_s[r][c]) = kx;
      *reinterpret_cast<float4*>(&v_s[r][c]) = vx;
    }
    __syncthreads();

    float s[BKV];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        d = fmaf(qr[i], k_s[j][i * TPR + part], d);
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) d += __shfl_xor_sync(kFull, d, o);
      if (softcap > 0.f) d = softcap * tanhf(d / softcap);
      const int kpos = k0 + j;
      bool ok = row_live && kpos < Skv;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s[j] = ok ? d : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no live key yet
    const float alpha = expf(m - m_use);
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float p = expf(s[j] - m_use);
      psum += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(p, v_s[j][i * TPR + part], acc[i]);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (row_live) {
    // out is (B, Sq, H, hd) contiguous, lse (B, H, Sq)
    float* op = out + (((long long)b * Sq + qi) * H + h) * HD;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i * TPR + part] = acc[i] / den;
    if (part == 0)
      lse[((long long)b * H + h) * Sq + qi] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int Sq, int Skv, int H, int Hkv,
                       const long long* st, float scale, float softcap,
                       int causal, int window, int q_offset,
                       cudaStream_t stream) {
  const dim3 grid((Sq + F32_BQ - 1) / F32_BQ, H, B);
  flash_fwd_f32_kernel<HD><<<grid, F32Tile<HD>::NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Skv, H, H / Hkv, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale, softcap, causal,
      window, q_offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core body
// ---------------------------------------------------------------------------

// Tile plan of one head_dim's instantiation: a block is one warpgroup
template <int HD>
struct Tile {
  static constexpr int BQ = 64;                       // query rows per block
  // keys per ring stage: 64 from hd = 128 on, for registers (O is HD / 2
  // fp32 accumulators a thread, S is BKV / 2)
  static constexpr int BKV = HD >= 128 ? 64 : 128;
  static constexpr int SW = HD == 32 ? 64 : 128;      // swizzle span = slab row, bytes
  static constexpr int SWC = SW / 2;                  // bf16 columns per slab
  static constexpr int SLABS = HD / SWC;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;   // descriptor swizzle
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;       // one K or V tile
  // Q, K and V in 2 stages, 3 mbarriers, and room to align the base to
  // 1024 bytes (the 128-byte swizzle's repeat)
  static constexpr int SMEM = 1024 + Q_BYTES + 4 * KV_BYTES + 64;
  static_assert(SMEM <= 232448, "over the shared memory a block can use");
};

template <int HD>
__global__ void __launch_bounds__(128, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Skv, int H, int G,
                       float scale, float softcap, int causal, int window,
                       int q_offset) {
  using T = Tile<HD>;
  constexpr int BQ = T::BQ, BKV = T::BKV, SW = T::SW, SWC = T::SWC;
  constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;     // Q, then K[2], V[2]
  const uint32_t s_k = s_q + T::Q_BYTES;
  const uint32_t s_v = s_k + 2 * T::KV_BYTES;
  const uint32_t bar_q = s_v + 2 * T::KV_BYTES;   // then bar_kv[0], [1]
  auto bar_kv = [&](int stage) { return bar_q + 8 * (1 + stage); };

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;     // heaviest tiles first
  const int kvh = h / G;
  const int q0 = qt * BQ;

  // the block's query positions and the KV tiles any of its rows can see
  const int qp_lo = q0 + q_offset, qp_hi = min(q0 + BQ, Sq) - 1 + q_offset;
  const int kv_hi = causal ? min(Skv, qp_hi + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, qp_lo - window + 1) : 0;
  const int t0 = kv_lo / BKV;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + BKV - 1) / BKV - t0 : 0;

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = q0 + 16 * warp + lane / 4;      // rows r0 and r0 + 8
  const int cb = 2 * (lane % 4);                 // columns cb, cb + 1 of 8

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv(0), 1);
    mbar_init(bar_kv(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_kv = [&](int t) {                    // thread 0 only
    const int stage = t & 1, k0 = (t0 + t) * BKV;
    mbar_expect_tx(bar_kv(stage), 2 * T::KV_BYTES);
#pragma unroll
    for (int sl = 0; sl < T::SLABS; ++sl) {
      const uint32_t off = stage * T::KV_BYTES + sl * BKV * SW;
      tma_load(s_k + off, map_k, bar_kv(stage), sl * SWC, k0, kvh, b);
      tma_load(s_v + off, map_v, bar_kv(stage), sl * SWC, k0, kvh, b);
    }
  };

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // log2 units

  if (n_tiles > 0) {
    if (tid == 0) {
      mbar_expect_tx(bar_q, T::Q_BYTES);
#pragma unroll
      for (int sl = 0; sl < T::SLABS; ++sl)
        tma_load(s_q + sl * BQ * SW, &tm_q, bar_q, sl * SWC, q0, h, b);
      load_kv(0);
    }
    mbar_wait(bar_q, 0);
  }

  const float scale_log2 = scale * kLog2e;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();           // every warp is done with tile t - 1
    if (tid == 0 && t + 1 < n_tiles) load_kv(t + 1);
    const int stage = t & 1, k0 = (t0 + t) * BKV;
    mbar_wait(bar_kv(stage), (t >> 1) & 1);
    __syncwarp();
    const bool masked = k0 + BKV > Skv || (causal && k0 + BKV - 1 > qp_lo) ||
                        (window > 0 && k0 <= qp_hi - window);

    // S = Q K^T, 64 x BKV
    float s[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t slab = kk * 16 / SWC, col = kk * 16 % SWC;
      const uint64_t da = smem_desc(
          s_q + slab * BQ * SW + col * 2, 16, 8 * SW, T::LAYOUT);
      const uint64_t db = smem_desc(
          s_k + stage * T::KV_BYTES + slab * BKV * SW + col * 2, 16, 8 * SW,
          T::LAYOUT);
      wgmma_ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // logits in log2 units: s[4i + e] is row r0 (e < 2) or r0 + 8, key
    // k0 + 8i + cb + (e & 1)
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i)
      s[i] = softcap > 0.f ? softcap * kLog2e * tanhf(s[i] * cap_in)
                           : s[i] * scale_log2;
    if (masked) {
      const int qp0 = r0 + q_offset;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int kp = k0 + 8 * (i / 4) + cb + (i & 1);
        const int qp = qp0 + ((i & 2) ? 8 : 0);
        const bool ok = kp < Skv && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        if (!ok) s[i] = -INFINITY;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float mu0 = mx0 == -INFINITY ? 0.f : mx0;   // no live key yet
    const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
    const float a0 = exp2f(m0 - mu0), a1 = exp2f(m1 - mu1);
    m0 = mx0;
    m1 = mx1;

    // P in bf16, laid out as wgmma's A operand: p[kk] covers keys
    // 16kk .. 16kk + 15; l sums the unrounded p, as the reference does
    uint32_t p[BKV / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
      const float e0 = exp2f(s[4 * i] - mu0), e1 = exp2f(s[4 * i + 1] - mu0);
      const float e2 = exp2f(s[4 * i + 2] - mu1);
      const float e3 = exp2f(s[4 * i + 3] - mu1);
      ps0 += e0 + e1;
      ps1 += e2 + e3;
      p[i / 2][2 * (i & 1)] = pack_bf16(e0, e1);
      p[i / 2][2 * (i & 1) + 1] = pack_bf16(e2, e3);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[4 * i] *= a0;
      o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1;
      o[4 * i + 3] *= a1;
    }

    // O += P V: V is (keys, hd) with hd contiguous, read MN-major
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t db = smem_desc(s_v + stage * T::KV_BYTES + kk * 16 * SW,
                                    BKV * SW, 8 * SW, T::LAYOUT);
      wgmma_rs(o, p[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  // epilogue: out (B, Sq, H, hd) contiguous, lse (B, H, Sq)
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= Sq) continue;
    const float l = half ? l1 : l0, m = half ? m1 : m0;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* op = out + (((long long)b * Sq + r) * H + h) * HD + cb;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * i) = __floats2bfloat162_rn(
          o[4 * i + 2 * half] * inv, o[4 * i + 2 * half + 1] * inv);
    if (lane % 4 == 0)
      lse[((long long)b * H + h) * Sq + r] =
          l > 0.f ? m * kLn2 + logf(l) : -INFINITY;
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 void* lse, int B, int Sq, int Skv, int H, int Hkv,
                 const long long* st, float scale, float softcap, int causal,
                 int window, int q_offset, cudaStream_t stream) {
  using T = Tile<HD>;
  const auto kernel = flash_fwd_wgmma_kernel<HD>;
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeFailed;
  const CUtensorMapSwizzle sw = T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B;
  // with Skv = 0 no block reads K or V, and a map over an empty tensor
  // cannot be encoded: theirs stay zero
  CUtensorMap tq, tk, tv;
  memset(&tq, 0, sizeof tq);
  memset(&tk, 0, sizeof tk);
  memset(&tv, 0, sizeof tv);
  if (!encode(fn, &tq, q, HD, Sq, H, B, st[1], st[2], st[0], T::SWC, T::BQ,
              sw))
    return kEncodeFailed;
  if (Skv > 0 &&
      !(encode(fn, &tk, k, HD, Skv, Hkv, B, st[4], st[5], st[3], T::SWC,
               T::BKV, sw) &&
        encode(fn, &tv, v, HD, Skv, Hkv, B, st[7], st[8], st[6], T::SWC,
               T::BKV, sw)))
    return kEncodeFailed;
  const dim3 grid(H, B, (Sq + T::BQ - 1) / T::BQ);
  kernel<<<grid, 128, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      Sq, Skv, H, H / Hkv, scale, softcap, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core body), 1 = bfloat16 (the tensor-core
// body). q: (B, Sq, H, hd), k, v: (B, Skv, Hkv, hd), each
// with unit stride on hd and the element strides given in `strides` as
// (q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h); out: (B, Sq, H, hd)
// contiguous; lse: (B, H, Sq) float32 contiguous. Returns
// cudaGetLastError() after the launch (0 on success), a cudaError_t
// before it, or -1 if a tensor map failed to encode.
extern "C" int repro_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* lse, int B, int Sq, int Skv, int H, int Hkv, int hd,
    const long long* strides, float scale, float softcap, int causal,
    int window, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv < 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (hd) {
      case 32:
        return launch_f32<32>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, strides,
                              scale, softcap, causal, window, q_offset, s);
      case 64:
        return launch_f32<64>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, strides,
                              scale, softcap, causal, window, q_offset, s);
      case 128:
        return launch_f32<128>(q, k, v, out, lse, B, Sq, Skv, H, Hkv,
                               strides, scale, softcap, causal, window,
                               q_offset, s);
      case 256:
        return launch_f32<256>(q, k, v, out, lse, B, Sq, Skv, H, Hkv,
                               strides, scale, softcap, causal, window,
                               q_offset, s);
    }
    return cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    switch (hd) {
      case 32:
        return launch_wgmma<32>(q, k, v, out, lse, B, Sq, Skv, H, Hkv,
                                strides, scale, softcap, causal, window,
                                q_offset, s);
      case 64:
        return launch_wgmma<64>(q, k, v, out, lse, B, Sq, Skv, H, Hkv,
                                strides, scale, softcap, causal, window,
                                q_offset, s);
      case 128:
        return launch_wgmma<128>(q, k, v, out, lse, B, Sq, Skv, H, Hkv,
                                 strides, scale, softcap, causal, window,
                                 q_offset, s);
      case 256:
        return launch_wgmma<256>(q, k, v, out, lse, B, Sq, Skv, H, Hkv,
                                 strides, scale, softcap, causal, window,
                                 q_offset, s);
    }
  }
  return cudaErrorInvalidValue;
}
