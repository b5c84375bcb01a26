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
// Bound on this card: at the training shapes (B = 8, S = 1024, 12 query
//   and 4 KV heads, hd = 64, bf16, causal) each pass moves ~50 MB once,
//   about 15 us at 3.35 TB/s, and does 6 * hd (dq) or 8 * hd (dk/dv)
//   flops per live (query, key) pair and head, 20-26 us at the bf16
//   tensor-core rate: the bound is the operations. These first kernels
//   run every product on the CUDA cores in fp32, so they are bound by the
//   fp32 FMA issue rate, well above that. wgmma and TMA are for a later
//   change.
//
// Design (the forward's, turned around for each pass):
//   * tiles of 32 rows; DPT = 16 head dims per thread, so HD / 16 threads
//     share one row, read consecutive shared-memory banks, and sum their
//     partial dot products with log2(HD / 16) shuffles;
//   * dq pass: one block per (query tile, query head, batch row). The
//     row's q (scaled), do and fp32 dq accumulator stay in registers; K
//     and V tiles are staged in shared memory as fp32, and only the KV
//     tiles the causal and window masks leave live are visited (the
//     reference's _block_needed). dq is written once, in q's dtype;
//   * dk/dv pass: one block owns one (KV tile, KV head, batch row). The
//     row's k, v and fp32 dk/dv accumulators stay in registers; the block
//     walks the G query heads of its group and, for each, the live query
//     tiles, staging q (scaled), do, lse and delta in shared memory. One
//     owner per output tile: no atomics, and the result is deterministic;
//   * ragged edges: staged rows past the end are zero-filled, and a pair
//     is live only if both its query row and its key row exist, so a
//     padded query row adds nothing to dk/dv and a padded key row nothing
//     to dq. Masked pairs get p = ds = 0, as in the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;    // query rows per tile
constexpr int BKV = 32;   // key rows per tile
constexpr int DPT = 16;   // head dims per thread
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

// Sum a partial dot product over the TPR consecutive lanes of one row.
template <int TPR>
__device__ __forceinline__ float row_sum(float d) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) d += __shfl_xor_sync(kFull, d, o);
  return d;
}

// Stage rows [r0, r0 + 32) of a (rows, HD) slab with row stride `rs` into
// shared memory as fp32 times `mul`, 16-byte loads, zeros past `n_rows`.
template <typename T, int HD, int NT>
__device__ __forceinline__ void stage(float (*dst)[HD], const T* src,
                                      long long rs, int r0, int n_rows,
                                      float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;
  for (int i = threadIdx.x; i < 32 * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    union {
      uint4 u;
      T e[VEC];
    } x;
    x.u = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows)
      x.u = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[r][c + j] = to_float(x.e[j]) * mul;
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

template <typename T, int HD>
__global__ void __launch_bounds__(BQ * HD / DPT)
flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int TPR = HD / DPT;
  constexpr int NT = BQ * TPR;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.Hkv);
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qi = qt * BQ + row;
  const bool row_live = qi < a.Sq;
  const int qpos = qi + a.q_offset;

  __shared__ float k_s[BKV][HD];
  __shared__ float v_s[BKV][HD];

  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  float qr[DPT], dor[DPT], acc[DPT];
  const long long qo = (long long)b * a.qsb + (long long)qi * a.qss +
                       (long long)h * a.qsh;
  const long long doo = (long long)b * a.dsb + (long long)qi * a.dss +
                        (long long)h * a.dsh;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row_live ? to_float(q[qo + i * TPR + part]) * a.scale : 0.f;
    dor[i] = row_live ? to_float(dout[doo + i * TPR + part]) : 0.f;
    acc[i] = 0.f;
  }
  const long long li = ((long long)b * a.H + h) * a.Sq + qi;
  const float lse = row_live ? a.lse[li] : -INFINITY;
  const float delta = row_live ? a.delta[li] : 0.f;
  const bool has_keys = lse > -INFINITY;   // false for padded rows too

  // the key range any row of this block can see
  const int qpos_lo = qt * BQ + a.q_offset;
  const int qpos_hi = min(qt * BQ + BQ, a.Sq) - 1 + a.q_offset;
  const int kv_hi = a.causal ? min(a.Skv, qpos_hi + 1) : a.Skv;
  const int kv_lo = a.window > 0 ? max(0, qpos_lo - a.window + 1) : 0;

  const T* kb = static_cast<const T*>(a.k) + (long long)b * a.ksb +
                (long long)kvh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + (long long)b * a.vsb +
                (long long)kvh * a.vsh;
  for (int k0 = (kv_lo / BKV) * BKV; k0 < kv_hi; k0 += BKV) {
    __syncthreads();  // every thread is done with the previous tile
    stage<T, HD, NT>(k_s, kb, a.kss, k0, a.Skv, 1.f);
    stage<T, HD, NT>(v_s, vb, a.vss, k0, a.Skv, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
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
    T* dq = static_cast<T*>(a.dq) + (((long long)b * a.Sq + qi) * a.H + h) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      dq[i * TPR + part] = from_float<T>(acc[i] * a.scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(BKV * HD / DPT)
flash_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int TPR = HD / DPT;
  constexpr int NT = BKV * TPR;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int ki = kt * BKV + row;
  const bool row_live = ki < a.Skv;

  __shared__ float q_s[BQ][HD];
  __shared__ float do_s[BQ][HD];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  float kr[DPT], vr[DPT], dk[DPT], dv[DPT];
  const long long ko = (long long)b * a.ksb + (long long)ki * a.kss +
                       (long long)kvh * a.ksh;
  const long long vo = (long long)b * a.vsb + (long long)ki * a.vss +
                       (long long)kvh * a.vsh;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    kr[i] = row_live ? to_float(k[ko + i * TPR + part]) : 0.f;
    vr[i] = row_live ? to_float(v[vo + i * TPR + part]) : 0.f;
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  // the query rows that can see any key of this tile
  const int kpos_lo = kt * BKV;
  const int kpos_hi = min(kt * BKV + BKV, a.Skv) - 1;
  const int q_lo = a.causal ? max(0, kpos_lo - a.q_offset) : 0;
  const int q_hi = a.window > 0
                       ? min(a.Sq, kpos_hi + a.window - a.q_offset)
                       : a.Sq;   // exclusive

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = static_cast<const T*>(a.q) + (long long)b * a.qsb +
                  (long long)h * a.qsh;
    const T* db = static_cast<const T*>(a.dout) + (long long)b * a.dsb +
                  (long long)h * a.dsh;
    const long long lb = ((long long)b * a.H + h) * a.Sq;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // every thread is done with the previous tile
      stage<T, HD, NT>(q_s, qb, a.qss, q0, a.Sq, a.scale);
      stage<T, HD, NT>(do_s, db, a.dss, q0, a.Sq, 1.f);
      for (int i = threadIdx.x; i < BQ; i += NT) {
        const bool live = q0 + i < a.Sq;
        lse_s[i] = live ? a.lse[lb + q0 + i] : -INFINITY;
        delta_s[i] = live ? a.delta[lb + q0 + i] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
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
    T* dkp = static_cast<T*>(a.dk) + o;
    T* dvp = static_cast<T*>(a.dv) + o;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dkp[i * TPR + part] = from_float<T>(dk[i]);
      dvp[i * TPR + part] = from_float<T>(dv[i]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(int pass, const BwdArgs& a, cudaStream_t stream) {
  constexpr int NT = 32 * HD / DPT;
  if (pass == 0) {
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    flash_bwd_dq_kernel<T, HD><<<grid, NT, 0, stream>>>(a);
  } else {
    const dim3 grid((a.Skv + BKV - 1) / BKV, a.Hkv, a.B);
    flash_bwd_dkv_kernel<T, HD><<<grid, NT, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int pass, int hd, const BwdArgs& a,
                      cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(pass, a, stream);
    case 64:
      return launch<T, 64>(pass, a, stream);
    case 128:
      return launch<T, 128>(pass, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  if (dtype == 0) return launch_hd<float>(pass, hd, a, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(pass, hd, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, do: (B, Sq, H, hd); k, v: (B, Skv,
// Hkv, hd); each with unit stride on hd, 16-byte aligned rows, and the
// element strides given in `strides` as (q_b, q_s, q_h, k_b, k_s, k_h,
// v_b, v_s, v_h, do_b, do_s, do_h). lse, delta: (B, H, Sq) float32
// contiguous. Outputs are contiguous: dq (B, Sq, H, hd) for the dq pass,
// dk and dv (B, Skv, Hkv, hd) for the dk/dv pass. Each returns
// cudaGetLastError() after its launch (0 on success).
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
