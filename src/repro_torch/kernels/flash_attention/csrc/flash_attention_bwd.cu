// Flash attention backward for Hopper (sm_90a): the dq pass and the dk/dv
// pass, for GQA, causal with a query offset, local window, tanh softcap.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_bwd: _bwd_dq_kernel (its pallas_call at :298) and
//   _bwd_dkv_kernel (its pallas_call at :329), the Pallas TPU flash
//   attention backward.
//
// Inputs: q, k, v, the cotangent do of out, the forward's fp32 lse
//   (B, H, Sq) (m + log l over softcapped, scaled logits; -inf for a row
//   with no live key) and delta = rowsum(do * out) in fp32 (B, H, Sq),
//   which the wrapper computes. A row with lse = -inf gets p = 0.
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s): at the
//   training shape (B = 8, S = 1024, 12 query and 4 KV heads, hd = 64,
//   bf16, causal) each pass moves ~50 MB once, about 15 us, and does
//   6 * hd (dq) or 8 * hd (dk/dv) flops per live (query, key) pair and
//   head, 20 and 26 us: the bound is the operations. So it is at
//   recurrentgemma-2b's training batch (B = 2, S = 1024, 10 query heads on
//   one KV head, hd = 256): 16 and 22 us.
//
// Two bodies per pass, chosen by dtype:
//
// bfloat16, on the tensor cores (flash_bwd_dq_wgmma_kernel and
//   flash_bwd_dkv_wgmma_kernel), the forward's design turned around:
//   * a block is one warpgroup; the 64 rows of its wgmma accumulators are
//     query rows (dq pass) or keys (dk/dv pass). Under 255 registers two
//     blocks share an SM, so one block's elementwise work can overlap the
//     other's products;
//   * dq pass: one block per (query head, batch row, 64-row query tile),
//     the heaviest (last) tiles first; GQA folds into the index, kv_head =
//     h / G. Q and dO come in once by TMA; K/V tiles of 128 keys (64 at
//     hd = 128, 32 at hd = 256, for registers) stream through a 2-stage
//     ring, only those some row of the block can see (the reference's
//     _block_needed).
//     S = Q.K^T and dP = dO.V^T are wgmma products from shared memory,
//     all four operands K-major; dQ += dS.K reads K MN-major through the
//     transpose-B bit, as the forward reads V;
//   * dk/dv pass: one block per (KV head, batch row, 64-key tile), the
//     first (under causal the heaviest) tiles first. K and V come in once;
//     Q and dO tiles of 64 query rows (32 from hd = 128 on, for registers)
//     stream through the ring over the G query heads x the live query
//     tiles, and the threads stage each tile's lse and delta in shared
//     memory one tile ahead. S^T = K.Q^T and dP^T = V.dO^T (K-major), then
//     dV += P^T.dO and dK += dS^T.Q read dO and Q MN-major from the same
//     swizzled tiles. One owner per output tile: no atomics, and the
//     result is deterministic;
//   * hd = 256 (recurrentgemma-2b): dq's accumulator is 128 fp32 registers
//     a thread (dQ += dS.K one m64n256 product per 16 keys). dK and dV
//     would be 256, more than a thread has, so a dk/dv block is two
//     warpgroups, each owning 128 of the columns of both: each computes
//     the whole S^T and dP^T (64 x 32, 32 registers) for itself from the
//     shared tiles, which costs 4 * hd of the pass's 8 * hd flops a pair
//     once more, and keeps 176 accumulator registers a thread;
//   * p = exp2(s scale log2e - lse log2e), softcap, masks and dS = p (dP -
//     delta) dcap run on the accumulator registers, masks only on tiles
//     that cross the causal diagonal, the window's edge or Skv. P and dS
//     are rounded to bf16 in wgmma's A-register layout and never leave
//     registers. That is a rounding the reference does not make (it keeps
//     them in fp32), as FlashAttention does; products accumulate in fp32;
//   * ragged edges: TMA zero-fills rows past Sq and Skv. A query row past
//     Sq, or whose lse is -inf, takes lse = +inf, so p = exp2(s - inf) = 0
//     and it adds nothing; keys past Skv are masked out of dQ and their
//     dK and dV rows are not written.
//
// float32, on the CUDA cores (flash_bwd_dq_f32_kernel and
//   flash_bwd_dkv_f32_kernel): wgmma has no fp32 operands, and TF32 would
//   miss the 1e-4 bar that the float32 train-step parity rests on.
//   * blocks of 32 rows; DPT = 16 head dims per thread (32 at hd = 256), so
//     HD / DPT threads share one row, read consecutive shared-memory banks,
//     and sum their partial dot products with log2(HD / DPT) shuffles; the
//     other side's tiles are staged in static shared memory, 32 rows (16 at
//     hd = 256, inside its 48 KB);
//   * dq pass: one block per (query tile, query head, batch row). The
//     row's q (scaled), do and fp32 dq accumulator stay in registers; K
//     and V tiles are staged in shared memory, and only the live KV tiles
//     are visited;
//   * dk/dv pass: one block owns one (KV tile, KV head, batch row). The
//     row's k, v and dk/dv accumulators stay in registers; the block walks
//     the G query heads of its group and, for each, the live query tiles,
//     staging q (scaled), do, lse and delta in shared memory;
//   * staged rows past the end are zero-filled, and a pair is live only if
//     both its query row and its key row exist. Masked pairs get p = ds =
//     0, as in the reference.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../_hopper/hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // (B, H, Sq)
  const float* delta;   // (B, H, Sq)
  void* dq;             // (B, Sq, H, hd) contiguous
  void* dk;             // (B, Skv, Hkv, hd) contiguous
  void* dv;             // (B, Skv, Hkv, hd) contiguous
  int B, Sq, Skv, H, Hkv;
  // element strides (batch, seq, head) of q, k, v, do
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh;
  float scale, softcap;
  int causal, window, q_offset;
};

// ---------------------------------------------------------------------------
// float32: the CUDA-core bodies
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 32;    // query rows per block (dq pass)
constexpr int F32_BKV = 32;   // key rows per block (dk/dv pass)
// head dims per thread: 16, so HD / 16 threads share a row; 32 at
// hd = 256, whose 16 threads a row would make blocks of 512 threads, held
// to 128 registers each (the dk/dv pass spilled)
template <int HD>
constexpr int kDpt = HD == 256 ? 32 : 16;

// Rows of the K/V (dq pass) or Q/dO (dk/dv pass) tiles staged in static
// shared memory, which holds at most 48 KB: 16 at hd = 256.
template <int HD>
constexpr int kF32StageRows = HD == 256 ? 16 : 32;

// Sum a partial dot product over the TPR consecutive lanes of one row.
template <int TPR>
__device__ __forceinline__ float row_sum(float d) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) d += __shfl_xor_sync(kFull, d, o);
  return d;
}

// Stage rows [r0, r0 + ROWS) of a (rows, HD) slab with row stride `rs`
// into shared memory times `mul`, 16-byte loads, zeros past `n_rows`.
template <int HD, int NT, int ROWS>
__device__ __forceinline__ void stage(float (*dst)[HD], const float* src,
                                      long long rs, int r0, int n_rows,
                                      float mul) {
  constexpr int CPR = HD / 4;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows)
      x = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * rs + c);
    dst[r][c] = x.x * mul;
    dst[r][c + 1] = x.y * mul;
    dst[r][c + 2] = x.z * mul;
    dst[r][c + 3] = x.w * mul;
  }
}

__device__ __forceinline__ bool pair_live(const BwdArgs& a, int qpos,
                                          int kpos) {
  bool ok = kpos < a.Skv;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && kpos > qpos - a.window;
  return ok;
}

// logits from the raw scaled dot product; dcap = d logits / d raw
__device__ __forceinline__ float cap(float s, float softcap, float& dcap) {
  dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    dcap = 1.f - t * t;
    return softcap * t;
  }
  return s;
}

template <int HD>
__global__ void __launch_bounds__(F32_BQ * HD / kDpt<HD>)
flash_bwd_dq_f32_kernel(const BwdArgs a) {
  constexpr int DPT = kDpt<HD>;
  constexpr int TPR = HD / DPT;
  constexpr int NT = F32_BQ * TPR;
  constexpr int KT = kF32StageRows<HD>;   // keys per staged tile
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.Hkv);
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qi = qt * F32_BQ + row;
  const bool row_live = qi < a.Sq;
  const int qpos = qi + a.q_offset;

  __shared__ float k_s[KT][HD];
  __shared__ float v_s[KT][HD];

  const float* q = static_cast<const float*>(a.q);
  const float* dout = static_cast<const float*>(a.dout);
  float qr[DPT], dor[DPT], acc[DPT];
  const long long qo = (long long)b * a.qsb + (long long)qi * a.qss +
                       (long long)h * a.qsh;
  const long long doo = (long long)b * a.dsb + (long long)qi * a.dss +
                        (long long)h * a.dsh;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row_live ? q[qo + i * TPR + part] * a.scale : 0.f;
    dor[i] = row_live ? dout[doo + i * TPR + part] : 0.f;
    acc[i] = 0.f;
  }
  const long long li = ((long long)b * a.H + h) * a.Sq + qi;
  const float lse = row_live ? a.lse[li] : -INFINITY;
  const float delta = row_live ? a.delta[li] : 0.f;
  const bool has_keys = lse > -INFINITY;   // false for padded rows too

  // the key range any row of this block can see
  const int qpos_lo = qt * F32_BQ + a.q_offset;
  const int qpos_hi = min(qt * F32_BQ + F32_BQ, a.Sq) - 1 + a.q_offset;
  const int kv_hi = a.causal ? min(a.Skv, qpos_hi + 1) : a.Skv;
  const int kv_lo = a.window > 0 ? max(0, qpos_lo - a.window + 1) : 0;

  const float* kb = static_cast<const float*>(a.k) + (long long)b * a.ksb +
                    (long long)kvh * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + (long long)b * a.vsb +
                    (long long)kvh * a.vsh;
  for (int k0 = (kv_lo / KT) * KT; k0 < kv_hi; k0 += KT) {
    __syncthreads();  // every thread is done with the previous tile
    stage<HD, NT, KT>(k_s, kb, a.kss, k0, a.Skv, 1.f);
    stage<HD, NT, KT>(v_s, vb, a.vss, k0, a.Skv, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        s = fmaf(qr[i], k_s[j][i * TPR + part], s);
        dp = fmaf(dor[i], v_s[j][i * TPR + part], dp);
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      float dcap;
      s = cap(s, a.softcap, dcap);
      const bool ok = has_keys && pair_live(a, qpos, k0 + j);
      const float p = ok ? expf(s - lse) : 0.f;
      const float ds = ok ? p * (dp - delta) * dcap : 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(ds, k_s[j][i * TPR + part], acc[i]);
    }
  }

  if (row_live) {
    float* dq = static_cast<float*>(a.dq) +
                (((long long)b * a.Sq + qi) * a.H + h) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i) dq[i * TPR + part] = acc[i] * a.scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(F32_BKV * HD / kDpt<HD>)
flash_bwd_dkv_f32_kernel(const BwdArgs a) {
  constexpr int DPT = kDpt<HD>;
  constexpr int TPR = HD / DPT;
  constexpr int NT = F32_BKV * TPR;
  constexpr int QT = kF32StageRows<HD>;   // query rows per staged tile
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int ki = kt * F32_BKV + row;
  const bool row_live = ki < a.Skv;

  __shared__ float q_s[QT][HD];
  __shared__ float do_s[QT][HD];
  __shared__ float lse_s[QT];
  __shared__ float delta_s[QT];

  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float kr[DPT], vr[DPT], dk[DPT], dv[DPT];
  const long long ko = (long long)b * a.ksb + (long long)ki * a.kss +
                       (long long)kvh * a.ksh;
  const long long vo = (long long)b * a.vsb + (long long)ki * a.vss +
                       (long long)kvh * a.vsh;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    kr[i] = row_live ? k[ko + i * TPR + part] : 0.f;
    vr[i] = row_live ? v[vo + i * TPR + part] : 0.f;
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  // the query rows that can see any key of this tile
  const int kpos_lo = kt * F32_BKV;
  const int kpos_hi = min(kt * F32_BKV + F32_BKV, a.Skv) - 1;
  const int q_lo = a.causal ? max(0, kpos_lo - a.q_offset) : 0;
  const int q_hi = a.window > 0
                       ? min(a.Sq, kpos_hi + a.window - a.q_offset)
                       : a.Sq;   // exclusive

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qb = static_cast<const float*>(a.q) + (long long)b * a.qsb +
                      (long long)h * a.qsh;
    const float* db = static_cast<const float*>(a.dout) +
                      (long long)b * a.dsb + (long long)h * a.dsh;
    const long long lb = ((long long)b * a.H + h) * a.Sq;
    for (int q0 = (q_lo / QT) * QT; q0 < q_hi; q0 += QT) {
      __syncthreads();  // every thread is done with the previous tile
      stage<HD, NT, QT>(q_s, qb, a.qss, q0, a.Sq, a.scale);
      stage<HD, NT, QT>(do_s, db, a.dss, q0, a.Sq, 1.f);
      for (int i = threadIdx.x; i < QT; i += NT) {
        const bool live = q0 + i < a.Sq;
        lse_s[i] = live ? a.lse[lb + q0 + i] : -INFINITY;
        delta_s[i] = live ? a.delta[lb + q0 + i] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < QT; ++r) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          s = fmaf(q_s[r][i * TPR + part], kr[i], s);
          dp = fmaf(do_s[r][i * TPR + part], vr[i], dp);
        }
        s = row_sum<TPR>(s);
        dp = row_sum<TPR>(dp);
        float dcap;
        s = cap(s, a.softcap, dcap);
        const float lse = lse_s[r];   // -inf for padded and keyless rows
        const bool ok = row_live && lse > -INFINITY &&
                        pair_live(a, q0 + r + a.q_offset, ki);
        const float p = ok ? expf(s - lse) : 0.f;
        const float ds = ok ? p * (dp - delta_s[r]) * dcap : 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          dv[i] = fmaf(p, do_s[r][i * TPR + part], dv[i]);
          dk[i] = fmaf(ds, q_s[r][i * TPR + part], dk[i]);
        }
      }
    }
  }

  if (row_live) {
    const long long o = (((long long)b * a.Skv + ki) * a.Hkv + kvh) * HD;
    float* dkp = static_cast<float*>(a.dk) + o;
    float* dvp = static_cast<float*>(a.dv) + o;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dkp[i * TPR + part] = dk[i];
      dvp[i * TPR + part] = dv[i];
    }
  }
}

template <int HD>
cudaError_t launch_f32(int pass, const BwdArgs& a, cudaStream_t stream) {
  constexpr int NT = 32 * HD / kDpt<HD>;
  if (pass == 0) {
    const dim3 grid((a.Sq + F32_BQ - 1) / F32_BQ, a.H, a.B);
    flash_bwd_dq_f32_kernel<HD><<<grid, NT, 0, stream>>>(a);
  } else {
    const dim3 grid((a.Skv + F32_BKV - 1) / F32_BKV, a.Hkv, a.B);
    flash_bwd_dkv_f32_kernel<HD><<<grid, NT, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core bodies
// ---------------------------------------------------------------------------

// How one head_dim's tiles lie in shared memory: rows of SW bytes (hd = 128
// as two 64-column slabs), swizzled over SW bytes to match the wgmma
// descriptors.
template <int HD>
struct Swizzle {
  static constexpr int SW = HD == 32 ? 64 : 128;      // slab row, bytes
  static constexpr int SWC = SW / 2;                  // bf16 columns per slab
  static constexpr int SLABS = HD / SWC;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;   // descriptor swizzle
};

// Tile plan of the dq pass: a block is one warpgroup over 64 query rows.
// Keys per ring stage: fewer as hd grows, for registers (dQ is HD / 2 fp32
// accumulators a thread, S and dP BKV / 2 each).
template <int HD>
struct DqTile : Swizzle<HD> {
  static constexpr int BQ = 64;                       // query rows per block
  static constexpr int BKV = HD == 256 ? 32 : HD == 128 ? 64 : 128;
  static constexpr int Q_BYTES = BQ * HD * 2;         // Q or dO
  static constexpr int KV_BYTES = BKV * HD * 2;       // one K or V stage
  // Q, dO, K and V in 2 stages, 3 mbarriers, and room to align the base to
  // 1024 bytes (the 128-byte swizzle's repeat)
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 4 * KV_BYTES + 64;
  static_assert(SMEM <= 232448, "over the shared memory a block can use");
};

// Tile plan of the dk/dv pass: a block is WG warpgroups over 64 keys.
// dK and dV are 2 x HD / 2 fp32 accumulators a thread in one warpgroup,
// too many at hd = 256: there two warpgroups each own CW = 128 of their
// columns (and compute S^T and dP^T, 32 registers, each for itself).
template <int HD>
struct DkvTile : Swizzle<HD> {
  static constexpr int BKV = 64;                      // keys per block
  static constexpr int BQ = HD >= 128 ? 32 : 64;      // query rows per stage
  static constexpr int WG = HD == 256 ? 2 : 1;        // warpgroups per block
  static constexpr int CW = HD / WG;                  // columns per warpgroup
  static constexpr int KV_BYTES = BKV * HD * 2;       // K or V
  static constexpr int Q_BYTES = BQ * HD * 2;         // one Q or dO stage
  // K, V, Q and dO in 2 stages, lse and delta in 2 stages, 3 mbarriers,
  // and room to align the base
  static constexpr int SMEM =
      1024 + 2 * KV_BYTES + 4 * Q_BYTES + 4 * BQ * 4 + 64;
  static_assert(SMEM <= 232448, "over the shared memory a block can use");
};

// Descriptor of the K-major operand at columns c .. c + 15 of a `rows`-row
// tile (A, or B of D = A B^T with hd contiguous).
template <int HD>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int rows, int c) {
  using S = Swizzle<HD>;
  return smem_desc(tile + (c / S::SWC) * rows * S::SW + (c % S::SWC) * 2, 16,
                   8 * S::SW, S::LAYOUT);
}

// Descriptor of the MN-major B operand at rows r .. r + 15 of a `rows`-row
// tile, its columns from c0 (a multiple of the slab width) on (the
// transpose-B bit): LBO is the slab stride.
template <int HD>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int rows, int r,
                                             int c0 = 0) {
  using S = Swizzle<HD>;
  return smem_desc(tile + (c0 / S::SWC) * rows * S::SW + r * S::SW,
                   rows * S::SW, 8 * S::SW, S::LAYOUT);
}

// logits in log2 units from the raw dot product s, and dcap = d logits /
// d raw (1 without softcap)
__device__ __forceinline__ float logit2(float s, float scale_log2,
                                        float cap_in, float cap_log2,
                                        float& dcap) {
  if (cap_in > 0.f) {
    const float t = tanhf(s * cap_in);
    dcap = 1.f - t * t;
    return cap_log2 * t;
  }
  dcap = 1.f;
  return s * scale_log2;
}

// lse in log2 units, +inf where the row has no live key or lies past Sq,
// so that exp2(logit - lse) is 0 there
__device__ __forceinline__ float lse_log2(const float* lse, long long i,
                                          bool live) {
  const float l = live ? lse[i] : -INFINITY;
  return l > -INFINITY ? l * kLog2e : INFINITY;
}

template <int HD>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int Sq, int Skv,
                          int H, int G, float scale, float softcap,
                          int causal, int window, int q_offset) {
  using T = DqTile<HD>;
  constexpr int BQ = T::BQ, BKV = T::BKV, SW = T::SW, SWC = T::SWC;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;     // Q, dO, then K[2], V[2]
  const uint32_t s_do = s_q + T::Q_BYTES;
  const uint32_t s_k = s_do + T::Q_BYTES;
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
  float lse2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const long long i = ((long long)b * H + h) * Sq + r;
    lse2[half] = lse_log2(lse, i, r < Sq);
    dl[half] = r < Sq ? delta[i] : 0.f;
  }

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

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  if (n_tiles > 0) {
    if (tid == 0) {
      mbar_expect_tx(bar_q, 2 * T::Q_BYTES);
#pragma unroll
      for (int sl = 0; sl < T::SLABS; ++sl) {
        tma_load(s_q + sl * BQ * SW, &tm_q, bar_q, sl * SWC, q0, h, b);
        tma_load(s_do + sl * BQ * SW, &tm_do, bar_q, sl * SWC, q0, h, b);
      }
      load_kv(0);
    }
    mbar_wait(bar_q, 0);
  }

  const float scale_log2 = scale * kLog2e;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_log2 = softcap * kLog2e;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();           // every warp is done with tile t - 1
    if (tid == 0 && t + 1 < n_tiles) load_kv(t + 1);
    const int stage = t & 1, k0 = (t0 + t) * BKV;
    const uint32_t k_tile = s_k + stage * T::KV_BYTES;
    const uint32_t v_tile = s_v + stage * T::KV_BYTES;
    mbar_wait(bar_kv(stage), (t >> 1) & 1);
    __syncwarp();
    const bool masked = k0 + BKV > Skv || (causal && k0 + BKV - 1 > qp_lo) ||
                        (window > 0 && k0 <= qp_hi - window);

    // S = Q K^T and dP = dO V^T, 64 x BKV each
    float s[BKV / 2], dp[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(s, k_major<HD>(s_q, BQ, 16 * kk),
               k_major<HD>(k_tile, BKV, 16 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(dp, k_major<HD>(s_do, BQ, 16 * kk),
               k_major<HD>(v_tile, BKV, 16 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS = p (dP - delta) dcap in bf16, laid out as wgmma's A operand:
    // ds[kk] covers keys 16kk .. 16kk + 15. s[4i + e] is row r0 (e < 2) or
    // r0 + 8, key k0 + 8i + cb + (e & 1)
    uint32_t ds[BKV / 16][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * i + e, half = e >> 1;
        float dcap;
        const float lg = logit2(s[j], scale_log2, cap_in, cap_log2, dcap);
        float p = exp2f(lg - lse2[half]);
        if (masked) {
          const int kp = k0 + 8 * i + cb + (e & 1);
          const int qp = r0 + 8 * half + q_offset;
          const bool ok = kp < Skv && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          if (!ok) p = 0.f;
        }
        d[e] = p * (dp[j] - dl[half]) * dcap;
      }
      ds[i / 2][2 * (i & 1)] = pack_bf16(d[0], d[1]);
      ds[i / 2][2 * (i & 1) + 1] = pack_bf16(d[2], d[3]);
    }

    // dQ += dS K: K is (keys, hd) with hd contiguous, read MN-major
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs(acc, ds[kk], mn_major<HD>(k_tile, BKV, 16 * kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  // epilogue: dq (B, Sq, H, hd) contiguous, scaled once
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= Sq) continue;
    __nv_bfloat16* op = dq + (((long long)b * Sq + r) * H + h) * HD + cb;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i + 2 * half] * scale, acc[4 * i + 2 * half + 1] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(128 * DkvTile<HD>::WG, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                           int H, int G, float scale, float softcap,
                           int causal, int window, int q_offset) {
  using T = DkvTile<HD>;
  constexpr int BQ = T::BQ, BKV = T::BKV, SW = T::SW, SWC = T::SWC;
  constexpr int CW = T::CW;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_k = (raw + 1023) & ~1023u;     // K, V, then Q[2], dO[2]
  const uint32_t s_v = s_k + T::KV_BYTES;
  const uint32_t s_q = s_v + T::KV_BYTES;
  const uint32_t s_do = s_q + 2 * T::Q_BYTES;
  const uint32_t s_rows = s_do + 2 * T::Q_BYTES;  // lse[2][BQ], delta[2][BQ]
  float* lse_s = reinterpret_cast<float*>(smem_raw + (s_rows - raw));
  float* dl_s = lse_s + 2 * BQ;
  const uint32_t bar_kv = s_rows + 4 * BQ * 4;    // then bar_q[0], [1]
  auto bar_q = [&](int stage) { return bar_kv + 8 * (1 + stage); };

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;  // heaviest first under causal
  const int Hkv = gridDim.x;

  // the query rows that can see any key of this block (exclusive q_hi)
  const int kp_hi = min(k0 + BKV, Skv) - 1;
  const int q_lo = causal ? max(0, k0 - q_offset) : 0;
  const int q_hi = window > 0 ? min(Sq, kp_hi + window - q_offset) : Sq;
  const int t0 = q_lo / BQ;
  const int n_qt = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - t0 : 0;
  const int n_tiles = G * n_qt;                  // query heads x query tiles

  const int wg = tid / 128;                      // owns columns c0 .. + CW
  const int c0 = wg * CW;
  const int warp = tid % 128 / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;           // keys k0 + r0, k0 + r0 + 8
  const int cb = 2 * (lane % 4);                 // columns cb, cb + 1 of 8

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_q(0), 1);
    mbar_init(bar_q(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile t is query tile t0 + t % n_qt of query head kvh * G + t / n_qt
  const CUtensorMap* map_q = &tm_q;
  const CUtensorMap* map_do = &tm_do;
  auto load_q = [&](int t) {                     // thread 0 only
    const int stage = t & 1, h = kvh * G + t / n_qt;
    const int q0 = (t0 + t % n_qt) * BQ;
    mbar_expect_tx(bar_q(stage), 2 * T::Q_BYTES);
#pragma unroll
    for (int sl = 0; sl < T::SLABS; ++sl) {
      const uint32_t off = stage * T::Q_BYTES + sl * BQ * SW;
      tma_load(s_q + off, map_q, bar_q(stage), sl * SWC, q0, h, b);
      tma_load(s_do + off, map_do, bar_q(stage), sl * SWC, q0, h, b);
    }
  };
  // threads 0 .. BQ - 1 stage lse (in log2 units) and BQ .. 2 BQ - 1 delta
  // of row tid % BQ of tile t
  const bool stager = tid < 2 * BQ;
  auto fetch = [&](int t) {
    const int q = (t0 + t % n_qt) * BQ + tid % BQ;
    const long long i = ((long long)b * H + kvh * G + t / n_qt) * Sq + q;
    if (tid < BQ) return lse_log2(lse, i, q < Sq);
    return q < Sq ? delta[i] : 0.f;
  };
  auto put = [&](int t, float x) {
    (tid < BQ ? lse_s : dl_s)[(t & 1) * BQ + tid % BQ] = x;
  };

  float dka[CW / 2], dva[CW / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  if (n_tiles > 0) {
    if (tid == 0) {
      mbar_expect_tx(bar_kv, 2 * T::KV_BYTES);
#pragma unroll
      for (int sl = 0; sl < T::SLABS; ++sl) {
        tma_load(s_k + sl * BKV * SW, &tm_k, bar_kv, sl * SWC, k0, kvh, b);
        tma_load(s_v + sl * BKV * SW, &tm_v, bar_kv, sl * SWC, k0, kvh, b);
      }
      load_q(0);
    }
    if (stager) put(0, fetch(0));
    mbar_wait(bar_kv, 0);
  }

  const float scale_log2 = scale * kLog2e;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_log2 = softcap * kLog2e;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();           // tile t - 1 is done; tile t's rows are staged
    if (tid == 0 && t + 1 < n_tiles) load_q(t + 1);
    // tile t + 1's lse and delta, read now and staged after the products
    const float next = stager && t + 1 < n_tiles ? fetch(t + 1) : 0.f;
    const int stage = t & 1, q0 = (t0 + t % n_qt) * BQ;
    const uint32_t q_tile = s_q + stage * T::Q_BYTES;
    const uint32_t do_tile = s_do + stage * T::Q_BYTES;
    const float* ls = lse_s + stage * BQ;
    const float* dls = dl_s + stage * BQ;
    mbar_wait(bar_q(stage), (t >> 1) & 1);
    __syncwarp();
    const bool masked = (causal && k0 + BKV - 1 > q0 + q_offset) ||
                        (window > 0 && k0 <= q0 + BQ - 1 + q_offset - window);

    // S^T = K Q^T and dP^T = V dO^T, 64 x BQ each
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      st[i] = 0.f;
      dpt[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(st, k_major<HD>(s_k, BKV, 16 * kk),
               k_major<HD>(q_tile, BQ, 16 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(dpt, k_major<HD>(s_v, BKV, 16 * kk),
               k_major<HD>(do_tile, BQ, 16 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T in bf16, laid out as wgmma's A operand: [kk] covers
    // query rows 16kk .. 16kk + 15. st[4i + e] is key k0 + r0 (e < 2) or
    // k0 + r0 + 8, query row q0 + 8i + cb + (e & 1)
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * i + e, c = 8 * i + cb + (e & 1);
        float dcap;
        const float lg = logit2(st[j], scale_log2, cap_in, cap_log2, dcap);
        float p = exp2f(lg - ls[c]);
        if (masked) {
          const int kp = k0 + r0 + 8 * (e >> 1), qp = q0 + c + q_offset;
          const bool ok = (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          if (!ok) p = 0.f;
        }
        pv[e] = p;
        dsv[e] = p * (dpt[j] - dls[c]) * dcap;
      }
      pa[i / 2][2 * (i & 1)] = pack_bf16(pv[0], pv[1]);
      pa[i / 2][2 * (i & 1) + 1] = pack_bf16(pv[2], pv[3]);
      sa[i / 2][2 * (i & 1)] = pack_bf16(dsv[0], dsv[1]);
      sa[i / 2][2 * (i & 1) + 1] = pack_bf16(dsv[2], dsv[3]);
    }

    // dV += P^T dO and dK += dS^T Q over this warpgroup's columns: dO and
    // Q are (rows, hd) with hd contiguous, read MN-major from the tiles
    // S^T and dP^T read K-major
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs(dva, pa[kk], mn_major<HD>(do_tile, BQ, 16 * kk, c0));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs(dka, sa[kk], mn_major<HD>(q_tile, BQ, 16 * kk, c0));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    if (stager && t + 1 < n_tiles) put(t + 1, next);
  }

  // epilogue: dk, dv (B, Skv, Hkv, hd) contiguous; dk scaled once (the
  // reference's dS^T.(q scale))
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = k0 + r0 + 8 * half;
    if (kp >= Skv) continue;
    const long long o =
        (((long long)b * Skv + kp) * Hkv + kvh) * HD + c0 + cb;
#pragma unroll
    for (int i = 0; i < CW / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * i) =
          __floats2bfloat162_rn(dka[4 * i + 2 * half] * scale,
                                dka[4 * i + 2 * half + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * i) =
          __floats2bfloat162_rn(dva[4 * i + 2 * half],
                                dva[4 * i + 2 * half + 1]);
    }
  }
}

// Raise a kernel's dynamic shared-memory limit once.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& raised) {
  if (raised) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  raised = e == cudaSuccess;
  return e;
}

template <int HD>
int launch_wgmma(int pass, const BwdArgs& a, cudaStream_t stream) {
  using S = Swizzle<HD>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeFailed;
  const CUtensorMapSwizzle sw = S::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B;
  // boxes of q_rows query rows (q, do) and kv_rows keys (k, v)
  const int q_rows = pass == 0 ? DqTile<HD>::BQ : DkvTile<HD>::BQ;
  const int kv_rows = pass == 0 ? DqTile<HD>::BKV : DkvTile<HD>::BKV;
  CUtensorMap tq, tk, tv, tdo;
  if (!(encode(fn, &tq, a.q, HD, a.Sq, a.H, a.B, a.qss, a.qsh, a.qsb, S::SWC,
               q_rows, sw) &&
        encode(fn, &tdo, a.dout, HD, a.Sq, a.H, a.B, a.dss, a.dsh, a.dsb,
               S::SWC, q_rows, sw) &&
        encode(fn, &tk, a.k, HD, a.Skv, a.Hkv, a.B, a.kss, a.ksh, a.ksb,
               S::SWC, kv_rows, sw) &&
        encode(fn, &tv, a.v, HD, a.Skv, a.Hkv, a.B, a.vss, a.vsh, a.vsb,
               S::SWC, kv_rows, sw)))
    return kEncodeFailed;
  const int G = a.H / a.Hkv;
  if (pass == 0) {
    using T = DqTile<HD>;
    const auto kernel = flash_bwd_dq_wgmma_kernel<HD>;
    static bool raised = false;
    const cudaError_t e = allow_smem(kernel, T::SMEM, raised);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.H, a.B, (a.Sq + T::BQ - 1) / T::BQ);
    kernel<<<grid, 128, T::SMEM, stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq),
        a.Sq, a.Skv, a.H, G, a.scale, a.softcap, a.causal, a.window,
        a.q_offset);
  } else {
    using T = DkvTile<HD>;
    const auto kernel = flash_bwd_dkv_wgmma_kernel<HD>;
    static bool raised = false;
    const cudaError_t e = allow_smem(kernel, T::SMEM, raised);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.Hkv, a.B, (a.Skv + T::BKV - 1) / T::BKV);
    kernel<<<grid, 128 * T::WG, T::SMEM, stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
        static_cast<__nv_bfloat16*>(a.dv), a.Sq, a.Skv, a.H, G, a.scale,
        a.softcap, a.causal, a.window, a.q_offset);
  }
  return cudaGetLastError();
}

int run(int pass, int dtype, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, int B, int Sq, int Skv, int H, int Hkv, int hd,
        const long long* st, float scale, float softcap, int causal,
        int window, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, dk, dv,
                  B, Sq, Skv, H, Hkv,
                  st[0], st[1], st[2], st[3], st[4], st[5],
                  st[6], st[7], st[8], st[9], st[10], st[11],
                  scale, softcap, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (hd) {
      case 32: return launch_f32<32>(pass, a, s);
      case 64: return launch_f32<64>(pass, a, s);
      case 128: return launch_f32<128>(pass, a, s);
      case 256: return launch_f32<256>(pass, a, s);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: return launch_wgmma<32>(pass, a, s);
      case 64: return launch_wgmma<64>(pass, a, s);
      case 128: return launch_wgmma<128>(pass, a, s);
      case 256: return launch_wgmma<256>(pass, a, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core bodies), 1 = bfloat16 (the tensor-core
// bodies). q, do: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd); each with unit
// stride on hd, 16-byte aligned rows, and the element strides given in
// `strides` as (q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s,
// do_h). lse, delta: (B, H, Sq) float32 contiguous. Outputs are
// contiguous: dq (B, Sq, H, hd) for the dq pass, dk and dv (B, Skv, Hkv,
// hd) for the dk/dv pass. Each returns cudaGetLastError() after its launch
// (0 on success), a cudaError_t before it, or -1 if a tensor map failed to
// encode.
extern "C" int repro_flash_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Sq, int Skv,
    int H, int Hkv, int hd, const long long* strides, float scale,
    float softcap, int causal, int window, int q_offset, void* stream) {
  return run(0, dtype, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B,
             Sq, Skv, H, Hkv, hd, strides, scale, softcap, causal, window,
             q_offset, stream);
}

extern "C" int repro_flash_attention_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Skv, int H, int Hkv, int hd, const long long* strides, float scale,
    float softcap, int causal, int window, int q_offset, void* stream) {
  return run(1, dtype, q, k, v, dout, lse, delta, nullptr, dk, dv, B, Sq,
             Skv, H, Hkv, hd, strides, scale, softcap, causal, window,
             q_offset, stream);
}
