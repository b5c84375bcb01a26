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
//   on average, well under the cost of a launch.
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
//   * Q is copied once and K/V tiles of 128 rows (64 at hd = 128, for
//     registers) stream through a 2-stage ring by TMA, completion on
//     mbarriers: one thread issues tile j+1's copies before the warpgroup
//     computes on tile j. 128-byte swizzle at hd >= 64 (hd = 128 as two
//     64-column boxes), 64-byte at hd = 32, matching the wgmma descriptors.
//     TMA zero-fills rows past Sq and Skv, so a ragged edge needs only the
//     mask. Tensor maps are encoded per call on the host through the
//     runtime's driver entry point (no -lcuda) and passed as
//     __grid_constant__ parameters.
//
// float32, on the CUDA cores (flash_fwd_f32_kernel): wgmma has no fp32
//   operands and TF32 would miss the 5e-5 bar that the float32 parity
//   checks rest on. One block per (32 query rows, head, batch row), 4
//   threads per row, K and V tiles of 32 rows staged in shared memory.
//
// Both: a row with no live key gives zeros and lse = -inf; any length
// works with fixed tiles (the TPU wrapper shrank its tiles until they
// divided the length).
//
// Later work: warp specialisation (a producer warp with setmaxnreg), an
// explicit ping-pong of two warpgroups' softmax against each other's
// products, a TMA store of O, and head_dim 256.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEncodeFailed = -1;      // returned when a tensor map fails

// ---------------------------------------------------------------------------
// float32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 32;    // query rows per block
constexpr int F32_BKV = 32;   // keys per staged tile
constexpr int F32_TPR = 4;    // threads per query row
constexpr int kF32Threads = F32_BQ * F32_TPR;

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Skv, int H, int G,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh, float scale,
                     float softcap, int causal, int window, int q_offset) {
  constexpr int DPT = HD / F32_TPR;      // head dims per thread
  constexpr int VEC = 4;                 // floats per 16-byte load
  constexpr int CPR = HD / VEC;          // 16-byte chunks per row
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int row = threadIdx.x / F32_TPR, part = threadIdx.x % F32_TPR;
  const int qi = qt * F32_BQ + row;
  const bool row_live = qi < Sq;
  const int qpos = qi + q_offset;

  __shared__ float k_s[F32_BKV][HD];
  __shared__ float v_s[F32_BKV][HD];

  float qr[DPT], acc[DPT];
  const float* qp =
      q + (long long)b * qsb + (long long)qi * qss + (long long)h * qsh;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row_live ? qp[i * F32_TPR + part] * scale : 0.f;
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
  for (int k0 = (kv_lo / F32_BKV) * F32_BKV; k0 < kv_hi; k0 += F32_BKV) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < F32_BKV * CPR; i += kF32Threads) {
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

    float s[F32_BKV];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < F32_BKV; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        d = fmaf(qr[i], k_s[j][i * F32_TPR + part], d);
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
    for (int j = 0; j < F32_BKV; ++j) {
      const float p = expf(s[j] - m_use);
      psum += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(p, v_s[j][i * F32_TPR + part], acc[i]);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (row_live) {
    // out is (B, Sq, H, hd) contiguous, lse (B, H, Sq)
    float* op = out + (((long long)b * Sq + qi) * H + h) * HD;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i * F32_TPR + part] = acc[i] / den;
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
  flash_fwd_f32_kernel<HD><<<grid, kF32Threads, 0, stream>>>(
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
  static constexpr int BKV = HD == 128 ? 64 : 128;    // keys per ring stage
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instruction.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, fp32) {=, +=} A (64 x 16) * B (128 x 16)^T; A and B in shared
// memory, both K-major; accumulate != 0 adds to D.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32) {=, +=} A (64 x 16) * B (64 x 16)^T; A and B in shared
// memory, both K-major; accumulate != 0 adds to D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 in registers) * B (16 x 32); B in
// shared memory, MN-major (the transpose-B bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers) * B (16 x 64); B in
// shared memory, MN-major (the transpose-B bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 in registers) * B (16 x 128); B in
// shared memory, MN-major (the transpose-B bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// -lcuda; nullptr if the driver does not have it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (batch, rows, heads, hd) tensor with unit stride on hd and element
// strides ss, sh, sb, read in boxes of (box_cols, box_rows) of one head.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int hd,
            int rows, int heads, int batch, long long ss, long long sh,
            long long sb, int box_cols, int box_rows,
            CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
    }
  }
  return cudaErrorInvalidValue;
}
