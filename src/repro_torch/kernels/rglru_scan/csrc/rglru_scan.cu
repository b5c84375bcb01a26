// RG-LRU linear scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t over
// the time axis of (B, S, D) inputs, from a given h0, in fp32.
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py, rglru_scan_kernel
//   (body _kernel), the Pallas TPU blocked scan. Its custom VJP
//   (src/repro/kernels/rglru_scan/ops.py) runs the same scan time-reversed;
//   here that is the `reverse` flag, so the backward needs no flipped copies.
//
// Bound on this card: bytes. Per element the function reads a and x once
//   and writes hs once (12 bytes in fp32, 8 with bf16 a and x) and does one
//   multiply-add: about 0.2 flop per byte, far below the ~20 flop per byte
//   at which the H100's fp32 units would become the limit.
//
// Design: one pass over time tiles with a decoupled look-back. Each element
// of a and x is read from device memory once and each element of hs
// written once: 12 bytes per element in fp32, 8 with bf16 a and x. Per
// tile, 3 floats per channel (its aggregate and its inclusive carry) and
// one status word go through a small workspace: at B=4, S=4096, D=2560,
// 5,120 tiles of 64 channels by 128 steps, 3.9 MB written, about 0.13
// bytes per element with the one read of each predecessor's carry (a
// two-pass scan that reads a and x again moves 20 bytes). Why this over
// thread-block clusters exchanging carries in distributed shared memory: a
// cluster holds at most 16 blocks, so a chain of more tiles still needs
// carries across clusters, while a ticket-ordered look-back has no limit.
//   * a tile is (batch row, 32 * V channels, 16 * steps time steps). A lane
//     owns V consecutive channels: V = 2 when D is even, else 1 (bf16 a
//     and x with an odd D come widened to fp32: cp.async copies at least 4
//     bytes). The block's 16 warps each take one time segment of `steps`
//     steps (16 / V at most: 32 floats of a and x per thread);
//   * blocks are persistent (2 per SM, 512 threads at 64 registers) and
//     take tiles from an atomic ticket, in time order within each chain
//     (ticket = j * chains + chain, j the tile's place in the chain's
//     processing order, which runs backwards in time under `reverse`). A
//     block takes its next ticket before it scans the current tile, and
//     its threads cp.async their segments of the next tile into their own
//     slots of a 64 KB staging buffer, so that tile's loads are in flight
//     while this one is scanned, walked back and written (a one-pass body
//     that loaded each tile only when it started it was markedly slower).
//     A tile's predecessors hold earlier tickets and every block
//     finishes its tickets in order, so waiting on them cannot deadlock.
//     Consecutive tickets are neighbouring channel groups of one time tile;
//   * each thread scans its segment from h = 0 (end value and decay
//     product) out of registers; warp 0 chains the 16 segments into the
//     tile's aggregate (A, H), keeping each segment's exclusive prefix in
//     shared memory (and its own a and x there, to free registers);
//   * warp 0 publishes (A, H), walks back over predecessors until one has
//     published its inclusive carry, and rolls that carry forward over the
//     aggregates it passed, h = A h + H tile by tile: the carry equals the
//     serial chain of inclusive carries bit for bit, so results do not
//     depend on how far a walk went and repeated calls are bit-equal
//     (composing the aggregates first, (A2, H2) o (A1, H1) = (A1 A2, A2 H1
//     + H2), would round differently from call to call). It publishes its
//     own inclusive carry A h_in + H and hands h_in to the block. Tile 0
//     starts from h0; the last tile of a chain publishes nothing;
//   * every thread rescans its segment from its carry-in out of registers
//     and writes hs; the thread that owns the chain's last step writes
//     h_last (so h_last equals the last hs bit for bit);
//   * status words are stamped with a generation kept on the device: the
//     last block to leave (a second counter) resets both counters and
//     bumps the generation, so no call clears anything and no host epoch
//     is passed in (a captured graph of the call stays right). Status is
//     published with st.release.gpu after a fence of every writing lane and
//     read with ld.acquire.gpu; the data behind it with ld.cg (L2);
//   * the wrapper keeps the workspace per device and stream and picks the
//     steps per thread so that a small B * D still gives the card several
//     tiles per SM (ops.py::tile_plan; the same arithmetic as below);
//   * no divisibility rule: lanes past D idle and segments are clamped to
//     S (the TPU wrapper halved its blocks until they divided S and D);
//   * a and x are fp32 or bf16 (widened exactly); h0, hs and h_last fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;              // time segments per tile
constexpr int kThreads = 32 * kWarps;
constexpr int kElems = 16;              // steps * V a thread holds of a and x
typedef unsigned long long u64;
constexpr u64 kAggregate = 1, kInclusive = 2;   // status = gen * 4 + state

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  *p = v[0];
}
__device__ __forceinline__ void store(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// a lane's V floats of a workspace row, through L2
__device__ __forceinline__ void ld_cg(const float* p, float (&v)[1]) {
  v[0] = __ldcg(p);
}
__device__ __forceinline__ void ld_cg(const float* p, float (&v)[2]) {
  const float2 q = __ldcg(reinterpret_cast<const float2*>(p));
  v[0] = q.x, v[1] = q.y;
}
__device__ __forceinline__ void st_cg(float* p, const float (&v)[1]) {
  __stcg(p, v[0]);
}
__device__ __forceinline__ void st_cg(float* p, const float (&v)[2]) {
  __stcg(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}

// Publish a workspace row written by every lane of the calling warp:
// each lane's writes are fenced before lane 0 releases the status word.
__device__ __forceinline__ void publish(u64* status, u64 value, int lane) {
  __threadfence();
  __syncwarp();
  if (lane == 0) st_release(status, value);
}

// one asynchronous copy of kBytes (4 or 8) from device to shared memory
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst),
               "l"(src), "n"(kBytes)
               : "memory");
}

// Where a thread's segment of tile `ticket` lies: its first element, the
// stride to its next step and its number of steps (0 past S or D).
struct Segment {
  long long off, stride;
  int j, b, d, p0, cnt;
};

__device__ __forceinline__ Segment segment(int ticket, int chains,
                                           int chunks, int C, int S, int D,
                                           int steps, int reverse) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Segment g;
  g.j = ticket / chains;
  const int chain = ticket - g.j * chains;
  g.b = chain / chunks;
  g.d = (chain - g.b * chunks) * C + lane * (C / 32);
  g.p0 = g.j * kWarps * steps + warp * steps;   // processing order
  g.cnt = g.d < D ? max(0, min(steps, S - g.p0)) : 0;
  g.stride = reverse ? -static_cast<long long>(D) : D;
  g.off = (static_cast<long long>(g.b) * S + (reverse ? S - 1 - g.p0 : g.p0))
              * D + g.d;
  return g;
}

// Issue this thread's copies of its segment of one tile (kBytes = V
// elements of a or x per step) into its own slots of the block's staging
// buffer, in one cp.async group. Slot (input q, step i) of thread tid is at
// ((q * L + i) * kThreads + tid) * kBytes: a warp's slots are contiguous.
template <typename T, int V>
__device__ __forceinline__ void prefetch(uint32_t buf, const T* a,
                                         const T* x, const Segment& g) {
  constexpr int L = kElems / V, kBytes = V * sizeof(T);
#pragma unroll
  for (int i = 0; i < L; ++i)
    if (i < g.cnt) {
      const uint32_t slot = buf + (i * kThreads + threadIdx.x) * kBytes;
      cp_async<kBytes>(slot, a + g.off + i * g.stride);
      cp_async<kBytes>(slot + L * kThreads * kBytes, x + g.off + i * g.stride);
    }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// V elements of T in shared memory, widened to fp32
__device__ __forceinline__ void widen(const float* p, float (&v)[1]) {
  v[0] = *p;
}
__device__ __forceinline__ void widen(const float* p, float (&v)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x, v[1] = q.y;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float (&v)[2]) {
  const unsigned int q = *reinterpret_cast<const unsigned int*>(p);
  v[0] = __uint_as_float(q << 16), v[1] = __uint_as_float(q & 0xffff0000u);
}

// ws: per ticket 3 rows of C floats (aggregate A, aggregate H, inclusive
// carry); status: one word per ticket; ctrl: {ticket, done, generation}.
// A persistent block takes tickets until they run out; it prefetches the
// next tile's a and x into shared memory while it scans the current one
// out of registers.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                      const float* __restrict__ h0, float* __restrict__ hs,
                      float* __restrict__ h_last, float* __restrict__ ws,
                      u64* __restrict__ status, u64* __restrict__ ctrl,
                      int S, int D, int chunks, int chains, int steps,
                      int reverse) {
  constexpr int L = kElems / V;         // steps a thread can hold
  constexpr int C = 32 * V;             // channels per tile
  extern __shared__ __align__(16) unsigned char staging[];
  // segment (decay product, end value), then each segment's exclusive
  // prefix within the tile; channel lane * V + v sits at v * 32 + lane
  __shared__ float seg_a[kWarps][C];
  __shared__ float seg_h[kWarps][C];
  __shared__ float carry[C];
  // warp 0's a and x while it walks back (its registers go to the walk)
  __shared__ float stash[2 * kElems][32];
  __shared__ int s_next;
  __shared__ u64 s_gen;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = (S + kWarps * steps - 1) / (kWarps * steps);
  const int tiles = chains * ntiles;
  const uint32_t buf = static_cast<uint32_t>(__cvta_generic_to_shared(staging));
  const T* mine_a = reinterpret_cast<const T*>(staging);
  if (threadIdx.x == 0) {
    s_next = static_cast<int>(atomicAdd(ctrl, 1ull));
    s_gen = *reinterpret_cast<volatile u64*>(ctrl + 2);
  }
  __syncthreads();
  const u64 agg_flag = s_gen * 4 + kAggregate;
  const u64 inc_flag = s_gen * 4 + kInclusive;
  int ticket = s_next;
  if (ticket < tiles)
    prefetch<T, V>(buf, a, x,
                   segment(ticket, chains, chunks, C, S, D, steps, reverse));

  while (ticket < tiles) {
    __syncthreads();              // every thread has read s_next
    if (threadIdx.x == 0) s_next = static_cast<int>(atomicAdd(ctrl, 1ull));
    const Segment cur =
        segment(ticket, chains, chunks, C, S, D, steps, reverse);
    // this tile's a and x, from this thread's own slots
    asm volatile("cp.async.wait_all;" ::: "memory");
    float av[L][V], xv[L][V];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (i < cur.cnt) {
        const T* slot = mine_a + (i * kThreads + threadIdx.x) * V;
        widen(slot, av[i]);
        widen(slot + L * kThreads * V, xv[i]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) av[i][v] = xv[i][v] = 0.f;
      }
    }
    __syncthreads();              // s_next is written; the slots are read
    const int next = s_next;
    if (next < tiles)
      prefetch<T, V>(buf, a, x,
                     segment(next, chains, chunks, C, S, D, steps, reverse));

    // the segment from h = 0
    {
      float p[V], h[V];
#pragma unroll
      for (int v = 0; v < V; ++v) p[v] = 1.f, h[v] = 0.f;
#pragma unroll
      for (int i = 0; i < L; ++i)
        if (i < cur.cnt) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            h[v] = fmaf(av[i][v], h[v], xv[i][v]);
            p[v] *= av[i][v];
          }
        }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        seg_a[warp][v * 32 + lane] = p[v];
        seg_h[warp][v * 32 + lane] = h[v];
      }
    }
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < L; ++i)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          stash[i * V + v][lane] = av[i][v];
          stash[kElems + i * V + v][lane] = xv[i][v];
        }
    }
    __syncthreads();

    if (warp == 0) {
      // the tile's aggregate; each segment's exclusive prefix in its place
      float A[V], H[V];
#pragma unroll
      for (int v = 0; v < V; ++v) A[v] = 1.f, H[v] = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float pk = seg_a[k][v * 32 + lane];
          const float hk = seg_h[k][v * 32 + lane];
          seg_a[k][v * 32 + lane] = A[v];
          seg_h[k][v * 32 + lane] = H[v];
          H[v] = fmaf(pk, H[v], hk);
          A[v] *= pk;
        }

      float* row = ws + static_cast<long long>(ticket) * 3 * C + lane * V;
      const bool last = cur.j == ntiles - 1;
      float cin[V];
      if (cur.j == 0) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          cin[v] = cur.d < D
                       ? h0[static_cast<long long>(cur.b) * D + cur.d + v]
                       : 0.f;
      } else {
        if (!last) {
          st_cg(row, A);
          st_cg(row + C, H);
          publish(status + ticket, agg_flag, lane);
        }
        // walk back to the nearest tile with an inclusive carry, past tiles
        // with an aggregate (an inclusive carry is published after its
        // tile's aggregate, so a lane that saw either may read the
        // aggregate)
        int k = ticket - chains;
        for (;;) {
          const u64 f = ld_acquire(status + k);
          if (__all_sync(0xffffffffu, f == inc_flag)) break;
          if (__all_sync(0xffffffffu, f == agg_flag || f == inc_flag))
            k -= chains;
          else
            __nanosleep(64);
        }
        // then roll forward over the aggregates: the carry is the serial
        // chain's A h + H, bit for bit, however far the walk went
        ld_cg(ws + static_cast<long long>(k) * 3 * C + lane * V + 2 * C, cin);
        for (k += chains; k < ticket; k += chains) {
          const float* prow =
              ws + static_cast<long long>(k) * 3 * C + lane * V;
          float pa[V], ph[V];
          ld_cg(prow, pa);
          ld_cg(prow + C, ph);
#pragma unroll
          for (int v = 0; v < V; ++v) cin[v] = fmaf(pa[v], cin[v], ph[v]);
        }
      }
      if (!last) {
        float inc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) inc[v] = fmaf(A[v], cin[v], H[v]);
        st_cg(row + 2 * C, inc);
        publish(status + ticket, inc_flag, lane);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) carry[v * 32 + lane] = cin[v];
#pragma unroll
      for (int i = 0; i < L; ++i)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          av[i][v] = stash[i * V + v][lane];
          xv[i][v] = stash[kElems + i * V + v][lane];
        }
    }
    __syncthreads();

    // the segment again from its carry-in, out of registers, writing hs
    if (cur.cnt > 0) {
      float h[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        h[v] = fmaf(seg_a[warp][v * 32 + lane], carry[v * 32 + lane],
                    seg_h[warp][v * 32 + lane]);
#pragma unroll
      for (int i = 0; i < L; ++i)
        if (i < cur.cnt) {
#pragma unroll
          for (int v = 0; v < V; ++v) h[v] = fmaf(av[i][v], h[v], xv[i][v]);
          store(hs + cur.off + i * cur.stride, h);
        }
      if (cur.p0 + cur.cnt == S) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          h_last[static_cast<long long>(cur.b) * D + cur.d + v] = h[v];
      }
    }
    ticket = next;
  }

  // the last block to leave readies the counters for the next launch
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctrl + 1, 1ull) == gridDim.x - 1ull) {
      ctrl[0] = 0;
      ctrl[1] = 0;
      ctrl[2] = s_gen + 1;
    }
  }
}

template <typename T, int V>
cudaError_t launch(const void* a, const void* x, const void* h0, void* hs,
                   void* h_last, void* ws, void* status, void* ctrl, int B,
                   int S, int D, int steps, int blocks, int reverse,
                   cudaStream_t stream) {
  if (steps < 1 || steps > kElems / V) return cudaErrorInvalidValue;
  const long long chunks = (D + 32 * V - 1) / (32 * V);
  const long long chains = B * chunks;
  const long long tile_t = static_cast<long long>(kWarps) * steps;
  const long long tiles = chains * ((S + tile_t - 1) / tile_t);
  if (tiles == 0) return cudaSuccess;
  if (tiles > INT_MAX || blocks < 1 || blocks > tiles)
    return cudaErrorInvalidValue;
  constexpr int kStaging = 2 * kElems * kThreads * sizeof(T);
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        rglru_scan_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStaging);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  rglru_scan_kernel<T, V><<<blocks, kThreads, kStaging, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(h_last), static_cast<float*>(ws),
      static_cast<u64*>(status), static_cast<u64*>(ctrl), S, D,
      static_cast<int>(chunks), static_cast<int>(chains), steps, reverse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(int vec, const void* a, const void* x, const void* h0,
                       void* hs, void* h_last, void* ws, void* status,
                       void* ctrl, int B, int S, int D, int steps,
                       int blocks, int reverse, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {   // cp.async copies 4, 8 or 16 bytes
    if (vec == 1)
      return launch<T, 1>(a, x, h0, hs, h_last, ws, status, ctrl, B, S, D,
                          steps, blocks, reverse, stream);
  }
  if (vec == 2 && D % 2 == 0)
    return launch<T, 2>(a, x, h0, hs, h_last, ws, status, ctrl, B, S, D,
                        steps, blocks, reverse, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype of a and x: 0 = float32, 1 = bfloat16. a, x, hs: (B, S, D)
// contiguous, aligned to vec elements; h0, h_last: (B, D) contiguous
// float32. reverse = 1 scans from t = S-1 down to 0 (h_t = a_t * h_{t+1} +
// x_t) and h_last is then h at t = 0. vec (2 when D is even, else 1 and a
// and x in float32), steps (1 to 16 / vec) and blocks
// (at most the tiles) are the tile plan's; the launch has B * ceil(D / (32
// vec)) * ceil(S / (16 steps)) tiles. ws holds 3 * 32 * vec floats per
// tile; status one zero-initialised 64-bit word per tile; ctrl three
// zero-initialised 64-bit words. The kernel leaves status and ctrl ready
// for the next launch on the same stream. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int repro_rglru_scan(int dtype, int vec, const void* a,
                                const void* x, const void* h0, void* hs,
                                void* h_last, void* ws, void* status,
                                void* ctrl, int B, int S, int D, int steps,
                                int blocks, int reverse, void* stream) {
  if (B < 0 || S < 1 || D < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_vec<float>(vec, a, x, h0, hs, h_last, ws, status, ctrl, B,
                             S, D, steps, blocks, reverse, s);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16>(vec, a, x, h0, hs, h_last, ws, status,
                                     ctrl, B, S, D, steps, blocks, reverse,
                                     s);
  return cudaErrorInvalidValue;
}
