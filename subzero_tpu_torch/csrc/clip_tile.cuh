// Shared pieces of the parity-integral clip kernels for Hopper (sm_90a):
// csrc/clip.cu (the XLA twin's math) and csrc/clip_pallas.cu (the Pallas
// kernel's math) stage their pairs, compact the real edges and share them out
// to lane groups in the same way; only their edge loops differ.
//
//   * A block of kThreads threads takes a tile of Bt = kThreads / G
//     consecutive pairs, whose [Bt, Vp, 2] and [Bt, Vq, 2] rows are one
//     contiguous span each, and copies both spans into shared memory with
//     16-byte loads (element loads for a misaligned span or its tail).
//   * One warp segment per pair reduces eps over all vertices, padding
//     included, then writes each polygon's edges of non-zero length, in their
//     original order, into shared memory (ballot and prefix count): x0, y0,
//     dx = x1 - x0, dy = y1 - y0, with the pair's eps and real-edge counts
//     beside them.  Lists are stored [slot][pair] with a padded stride, so
//     the lanes of a warp read consecutive entries without bank conflicts.
//   * The grid is persistent: as many blocks as fit on the SMs, each walking
//     tiles; the last tile is masked.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace clip_tile {

constexpr int kThreads = 128;  // threads per block; Bt = kThreads / G pairs

template <typename T>
struct alignas(16) Edge {  // one real edge: start point and edge vector
  T x0, y0, dx, dy;
};

// Dynamic shared memory of one block; kernels/clip.py:tile_bytes mirrors it.
__host__ __device__ inline long long tile_bytes(int g, int vp, int vq,
                                                int itemsize) {
  const long long bt = kThreads / g, ld = bt + 1, v = vp + vq;
  return bt * v * 2 * itemsize          // raw staged rows
         + v * ld * 4 * itemsize        // Edge lists
         + bt * itemsize                // eps per pair
         + 2 * bt * 4;                  // real-edge counts per pair
}

template <typename T>
__device__ __forceinline__ T clamp01(T v, T hi) {
  return v < T(0) ? T(0) : (v > hi ? hi : v);
}

template <typename T>
__device__ __forceinline__ T inv_len_of(T elen2) {
  return elen2 > T(0) ? T(1) / sqrt(elen2) : T(0);
}

// Cooperative copy of n elements from device memory to shared memory: 16-byte
// loads where the source is 16-byte aligned, element loads for the rest.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      long long n) {
  constexpr int kPer = 16 / sizeof(T);
  long long head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const long long nv = n / kPer;
    for (long long c = threadIdx.x; c < nv; c += kThreads) {
      *reinterpret_cast<int4*>(dst + c * kPer) =
          __ldg(reinterpret_cast<const int4*>(src + c * kPer));
    }
    head = nv * kPer;
  }
  for (long long i = head + threadIdx.x; i < n; i += kThreads) {
    dst[i] = __ldg(src + i);
  }
}

// Compact one polygon's edges of non-zero length (in their original order)
// into its [slot][pair] lists; run by the S lanes of one warp segment, all 32
// lanes of the warp together.  Returns the real-edge count.
template <typename T>
__device__ __forceinline__ int compact(const T* r, int v, bool act, int s, int seg_lane, int seg_base,
                                       Edge<T>* edges, int ld) {
  const unsigned seg_mask =
      s == 32 ? 0xffffffffu : (((1u << s) - 1u) << seg_base);
  int count = 0;
  for (int base = 0; base < v; base += s) {
    const int i = base + seg_lane;
    bool real = false;
    T x0 = T(0), y0 = T(0), dx = T(0), dy = T(0);
    if (act && i < v) {
      const int in = (i + 1 == v) ? 0 : i + 1;
      x0 = r[2 * i];
      y0 = r[2 * i + 1];
      dx = r[2 * in] - x0;
      dy = r[2 * in + 1] - y0;
      real = !(dx == T(0) && dy == T(0));
    }
    const unsigned mine =
        (__ballot_sync(0xffffffffu, real) & seg_mask) >> seg_base;
    if (real) {
      const int slot = count + __popc(mine & ((1u << seg_lane) - 1u));
      edges[slot * ld] = Edge<T>{x0, y0, dx, dy};
    }
    count += __popc(mine);
  }
  return count;
}

// One block's shared memory, carved from the dynamic allocation.
template <typename T>
struct Tile {
  T* raw;          // [Bt, Vp, 2] then [Bt, Vq, 2] staged rows
  Edge<T>* ep;     // P's real edges, [Vp][ld]
  Edge<T>* eq;     // Q's real edges, [Vq][ld]
  T* eps;          // [Bt]
  int* np;         // [Bt] real-edge counts
  int* nq;
};

template <typename T>
__device__ __forceinline__ Tile<T> carve(unsigned char* smem, int bt, int ld,
                                         int vp, int vq) {
  Tile<T> tl;
  tl.raw = reinterpret_cast<T*>(smem);
  tl.ep = reinterpret_cast<Edge<T>*>(tl.raw + bt * (vp + vq) * 2);
  tl.eq = tl.ep + vp * ld;
  tl.eps = reinterpret_cast<T*>(tl.eq + vq * ld);
  tl.np = reinterpret_cast<int*>(tl.eps + bt);
  tl.nq = tl.np + bt;
  return tl;
}

// Stage the tile of pairs k0 .. k0 + bt - 1 and fill its eps and real-edge
// lists; every thread of the block calls it, and it ends in __syncthreads().
// eps = max(max|coords of P and Q|, 1) * eps_scale, over all slots.
template <typename T>
__device__ __forceinline__ void load_tile(const Tile<T>& tl,
                                          const T* __restrict__ p,
                                          const T* __restrict__ q, long long b,
                                          long long k0, int bt, int ld, int vp,
                                          int vq, T eps_scale) {
  const long long nv = (b - k0 < bt) ? b - k0 : bt;
  stage(tl.raw, p + k0 * 2 * vp, nv * 2 * vp);
  stage(tl.raw + bt * 2 * vp, q + k0 * 2 * vq, nv * 2 * vq);
  __syncthreads();

  // Warp segments for compaction: S lanes per pair, S a power of two.
  int s = 1;
  while (s < 32 && s < (vp > vq ? vp : vq)) s <<= 1;
  const int lane = threadIdx.x & 31;
  const int seg_lane = lane & (s - 1);
  const int seg_base = lane & ~(s - 1);
  const int seg = threadIdx.x / s;
  const int nseg = kThreads / s;

  const T* rp0 = tl.raw;
  const T* rq0 = tl.raw + bt * 2 * vp;
  for (int it = 0; it * nseg < bt; ++it) {
    const int tt = seg + it * nseg;
    const bool act = tt < bt && k0 + tt < b;
    const T* rp = rp0 + tt * 2 * vp;
    const T* rq = rq0 + tt * 2 * vq;
    T m = T(0);
    if (act) {
      for (int i = seg_lane; i < vp; i += s)
        m = fmax(m, fmax(fabs(rp[2 * i]), fabs(rp[2 * i + 1])));
      for (int j = seg_lane; j < vq; j += s)
        m = fmax(m, fmax(fabs(rq[2 * j]), fabs(rq[2 * j + 1])));
    }
    for (int off = s >> 1; off > 0; off >>= 1)
      m = fmax(m, __shfl_xor_sync(0xffffffffu, m, off));
    const T eps = fmax(m, T(1)) * eps_scale;
    const int ttc = tt < bt ? tt : 0;  // inactive segments write nothing
    const int n_p = compact(rp, vp, act, s, seg_lane, seg_base, tl.ep + ttc,
                            ld);
    const int n_q = compact(rq, vq, act, s, seg_lane, seg_base, tl.eq + ttc,
                            ld);
    if (seg_lane == 0 && tt < bt) {
      tl.eps[tt] = eps;
      tl.np[tt] = n_p;
      tl.nq[tt] = n_q;
    }
  }
  __syncthreads();
}

// Blocks of a persistent grid for `kernel` at `smem` bytes of dynamic shared
// memory over b pairs in tiles of bt, for the current device.  Set up on
// every launch: no state is kept between launches, devices or host threads.
template <typename K>
inline cudaError_t persistent_grid(K kernel, long long smem, long long b,
                                   int bt, unsigned* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long ntiles = (b + bt - 1) / bt;
  long long n = (long long)per_sm * sms;
  if (n > ntiles) n = ntiles;
  *blocks = (unsigned)n;
  return cudaSuccess;
}

}  // namespace clip_tile
