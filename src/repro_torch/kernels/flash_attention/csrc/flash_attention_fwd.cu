// Flash attention forward for Hopper (sm_90a): GQA, causal with a query
// offset, local window, tanh softcap; writes out and the fp32 row lse.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_fwd (bodies _fwd_kernel, _mask, _block_needed), the
//   Pallas TPU flash attention forward.
//
// Bound on this card: for the prefill of one prompt (S <= 1024, hd = 64,
//   12 query and 4 KV heads) bytes and operations are of the same order:
//   q, k, v and out move once, S * (2H + 2Hkv) * hd elements, and each live
//   (query, key) pair of the causal triangle costs 4 * hd flops per head.
//   At these sizes the card's bound is a few microseconds either way, and
//   this first kernel, which runs both products on the CUDA cores in fp32,
//   sits well above it: it is bound by the fp32 FMA issue rate. wgmma and
//   TMA are for a later change.
//
// Design:
//   * one block per (query tile of 32 rows, query head, batch row); GQA
//     folds into the index, kv_head = h / G;
//   * 4 threads per query row, each owning every 4th head dim, so the four
//     read consecutive shared-memory banks; the q row (scaled in fp32) and
//     the fp32 accumulator stay in registers, and the row's partial dot
//     products are summed with two shuffles;
//   * K and V tiles of 32 rows are staged in shared memory as fp32 with
//     16-byte loads, the ragged tail zero-filled and masked, so any length
//     works with fixed tiles (the TPU wrapper shrank its tiles until they
//     divided the length, down to one row for a prime length);
//   * KV tiles that the causal and window masks rule out for every row of
//     the block are never loaded;
//   * as in the reference, probabilities are rounded to the input dtype
//     before P.V, and a row with no live key gives zeros (lse = -inf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;    // query rows per block
constexpr int BKV = 32;   // keys per staged tile
constexpr int TPR = 4;    // threads per query row
constexpr int kThreads = BQ * TPR;
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int H, int G,
                 long long qsb, long long qss, long long qsh, long long ksb,
                 long long kss, long long ksh, long long vsb, long long vss,
                 long long vsh, float scale, float softcap, int causal,
                 int window, int q_offset) {
  constexpr int DPT = HD / TPR;          // head dims per thread
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  constexpr int CPR = HD / VEC;          // 16-byte chunks per row
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qi = qt * BQ + row;
  const bool row_live = qi < Sq;
  const int qpos = qi + q_offset;

  __shared__ float k_s[BKV][HD];
  __shared__ float v_s[BKV][HD];

  float qr[DPT], acc[DPT];
  const T* qp = q + (long long)b * qsb + (long long)qi * qss + (long long)h * qsh;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row_live ? to_float(qp[i * TPR + part]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  // the key range any row of this block can see
  const int qpos_lo = qt * BQ + q_offset;
  const int qpos_hi = min(qt * BQ + BQ, Sq) - 1 + q_offset;
  const int kv_hi = causal ? min(Skv, qpos_hi + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;

  const T* kb = k + (long long)b * ksb + (long long)kvh * ksh;
  const T* vb = v + (long long)b * vsb + (long long)kvh * vsh;
  for (int k0 = (kv_lo / BKV) * BKV; k0 < kv_hi; k0 += BKV) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < BKV * CPR; i += kThreads) {
      const int r = i / CPR, c = (i % CPR) * VEC;
      union {
        uint4 u;
        T e[VEC];
      } kx, vx;
      kx.u = make_uint4(0, 0, 0, 0);
      vx.u = kx.u;
      if (k0 + r < Skv) {
        kx.u = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * kss + c);
        vx.u = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * vss + c);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        k_s[r][c + j] = to_float(kx.e[j]);
        v_s[r][c + j] = to_float(vx.e[j]);
      }
    }
    __syncthreads();

    float s[BKV];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) d = fmaf(qr[i], k_s[j][i * TPR + part], d);
      d += __shfl_xor_sync(kFull, d, 1);
      d += __shfl_xor_sync(kFull, d, 2);
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
      const float pr = to_float(from_float<T>(p));
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(pr, v_s[j][i * TPR + part], acc[i]);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (row_live) {
    // out is (B, Sq, H, hd) contiguous, lse (B, H, Sq)
    T* op = out + (((long long)b * Sq + qi) * H + h) * HD;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i * TPR + part] = from_float<T>(acc[i] / den);
    if (part == 0)
      lse[((long long)b * H + h) * Sq + qi] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int Sq, int Skv, int H, int Hkv,
                   const long long* st, float scale, float softcap,
                   int causal, int window, int q_offset, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Skv, H, H / Hkv, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale, softcap, causal,
      window, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* out, void* lse, int B, int Sq, int Skv, int H,
                      int Hkv, const long long* st, float scale, float softcap,
                      int causal, int window, int q_offset,
                      cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, st, scale,
                           softcap, causal, window, q_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, st, scale,
                           softcap, causal, window, q_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, st, scale,
                            softcap, causal, window, q_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q: (B, Sq, H, hd), k, v: (B, Skv, Hkv,
// hd), each with unit stride on hd and the element strides given in
// `strides` as (q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h); out: (B, Sq,
// H, hd) contiguous; lse: (B, H, Sq) float32 contiguous. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* lse, int B, int Sq, int Skv, int H, int Hkv, int hd,
    const long long* strides, float scale, float softcap, int causal,
    int window, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, out, lse, B, Sq, Skv, H, Hkv,
                            strides, scale, softcap, causal, window, q_offset,
                            s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, lse, B, Sq, Skv, H, Hkv,
                                    strides, scale, softcap, causal, window,
                                    q_offset, s);
  return cudaErrorInvalidValue;
}
