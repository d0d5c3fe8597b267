// Dense broad phase: the bounding-circle neighbour table — CUDA C++ kernel
// for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package writes this layer as plain XLA
// (subzero_tpu/dynamics/broadphase.py:neighbor_candidates), which fuses the
// [N, M] circle test into its top-K.  The port's plain PyTorch version
// (subzero_tpu_torch/dynamics/broadphase.py:neighbor_candidates_plain)
// materialises the [N, M] key and runs K masked max passes over it.  This
// kernel computes the same NeighborTable in one launch, bit for bit.  For
// each query row i it takes every source slot j whose bounding circle
// overlaps i's (r2 < (r_i + r_j)^2, both alive, not i itself among the first
// n_self slots, row i not among the first n_skip rows).  It ranks them by
// (r2 ascending, j ascending), the order that K first-index max passes over
// -r2 give.  The best K go to idx / valid / shift; the row's other slots take
// idx = i and the shift of source slot min(i, M - 1).  The largest row count
// goes to demand.
//
// Exactness.  Every operation the plain version makes on the card is made
// here in the same order and precision: dx = x_i - x_j; on the torus
// dx - L * rint(dx * (1 / L)) with L = 2 lx (PyTorch on CUDA divides a tensor
// by a Python scalar as a product with the scalar's reciprocal, taken in
// double and rounded to the tensor's type: the card test
// test_plain_divides_by_the_reciprocal_on_card pins this); r2 = dx * dx +
// dy * dy; r2 < rsum * rsum.  Built with --fmad=false, so no product is
// contracted into an FMA.
//
// What bounds it on this card.  N x M pair tests of 8 operations (16 on the
// torus).  At 10,000 x 10,000 in float64, walled, that is 8e8 operations:
// 0.024 ms at 34 TFLOP/s.  The bytes are small: the source arrays (25 B a
// slot in float64) fit in L2, and the table is N x K.  So operations bound
// it.  The plain version instead writes [N, M] tensors and reads the key K
// times (K = 47: ~38 GB a step at 10,000 slots).
//
// What the design does about it.
//   * One warp per query row, kWarps rows a block.  The block stages kTile
//     source slots at a time in shared memory, so a tile is read from L2 once
//     per block; the lanes test 32 consecutive j.  A dead or skipped row
//     tests nothing.
//   * A ballot and a popcount append the passing (r2, j) to the row's buffer
//     of `cap` entries (cap >= K + 32), in j order.  A row has tens of
//     candidates against thousands of tests: the append is rare.
//   * When the buffer would overflow, the warp ranks it into the row's own K
//     table slots and copies the best K back, in order, to the buffer's
//     head.  From then on a new j enters only if its r2 is below the K-th
//     kept r2 (its j is larger, so a tie loses).  At the end the warp ranks
//     the buffer into the table.  Ranking: each lane counts the entries
//     before its own, reading one entry for the whole warp at a time (one
//     broadcast load).
//   * The row count goes to `demand` by atomicMax, which is deterministic.
//   * The buffer lives in scratch arrays the wrapper allocates, cap entries a
//     row, at every K up to N.  The appends are rare and the warp reads them
//     back through L1: at the cells' K = 47 a buffer in device memory times
//     no slower than one in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                // query rows a block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;              // source slots staged at a time
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float round_even(float v) { return rintf(v); }
__device__ __forceinline__ double round_even(double v) { return rint(v); }
__device__ __forceinline__ float infinity(float) {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ double infinity(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// Whether candidate (ra, ja) ranks before (rb, jb).
template <typename T>
__device__ __forceinline__ bool before(T ra, int ja, T rb, int jb) {
  return ra < rb || (ra == rb && ja < jb);
}

// Ranks entries [0, count) of (r2, j) among themselves and calls
// put(rank, r2, j) for each of rank below `keep`.  Lane l ranks entries l,
// l + 32, ...; the inner loop reads one entry for all lanes at a time.
template <typename T, typename Put>
__device__ __forceinline__ void rank_into(const T* r2, const int* j,
                                          int count, int keep, int lane,
                                          Put put) {
  for (int e = lane; e < count; e += 32) {
    const T re = r2[e];
    const int je = j[e];
    int rank = 0;
    for (int f = 0; f < count; ++f) rank += before(r2[f], j[f], re, je);
    if (rank < keep) put(rank, re, je);
  }
}

template <typename T, bool kPeriodic>
__global__ void __launch_bounds__(kThreads)
broadphase_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  const T* __restrict__ r,
                  const unsigned char* __restrict__ alive, int n,
                  const T* __restrict__ xs, const T* __restrict__ ys,
                  const T* __restrict__ rs,
                  const unsigned char* __restrict__ alive_s, int m,
                  int n_self, int n_skip, int k, int cap, double two_lx,
                  double two_ly, T* scratch_r2, int* scratch_j,
                  int* __restrict__ idx, unsigned char* __restrict__ valid,
                  T* __restrict__ shift, int* __restrict__ demand) {
  // The staged tile: 25 KB a block in float64.
  extern __shared__ __align__(16) unsigned char smem[];
  T* sx = reinterpret_cast<T*>(smem);
  T* sy = sx + kTile;
  T* sr = sy + kTile;
  unsigned char* sa = reinterpret_cast<unsigned char*>(sr + kTile);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + warp;
  const bool row = i < n;

  // The row's buffer of cap candidates (r2, j).
  T* const br2 = scratch_r2 + (size_t)(row ? i : 0) * cap;
  int* const bj = scratch_j + (size_t)(row ? i : 0) * cap;

  const T tlx = (T)two_lx, tly = (T)two_ly;
  const T ilx = (T)(1.0 / two_lx), ily = (T)(1.0 / two_ly);
  const bool live = row && i >= n_skip && alive[i] != 0;
  const T xi = row ? x[i] : T(0);
  const T yi = row ? y[i] : T(0);
  const T ri = row ? r[i] : T(0);
  int count = 0;      // the buffer's entries
  int total = 0;      // the row's candidates (demand)
  T thr = infinity(T(0));  // a new j enters only below the K-th kept r2

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int len = min(kTile, m - t0);
    __syncthreads();
    for (int s = threadIdx.x; s < len; s += kThreads) {
      sx[s] = xs[t0 + s];
      sy[s] = ys[t0 + s];
      sr[s] = rs[t0 + s];
      sa[s] = alive_s[t0 + s];
    }
    __syncthreads();
    if (!live) continue;
    for (int b = 0; b < len; b += 32) {
      const int s = b + lane;
      const int j = t0 + s;
      bool ok = false;
      T r2 = T(0);
      if (s < len) {
        T dx = xi - sx[s];
        T dy = yi - sy[s];
        if (kPeriodic) {
          dx = dx - tlx * round_even(dx * ilx);
          dy = dy - tly * round_even(dy * ily);
        }
        r2 = dx * dx + dy * dy;
        const T rsum = ri + sr[s];
        ok = r2 < rsum * rsum && sa[s] != 0 && !(j == i && j < n_self);
      }
      const unsigned hit = __ballot_sync(kFull, ok);
      if (hit == 0) continue;
      total += __popc(hit);
      bool keep = ok && r2 < thr;
      unsigned take = __ballot_sync(kFull, keep);
      if (take == 0) continue;
      if (count + __popc(take) > cap) {
        // count > cap - 32 >= k: cut the buffer back to its best k, in
        // order, by way of the row's k table slots (idx and shift's first
        // component), and raise the bar to the k-th (a ballot orders no
        // memory: __syncwarp makes the lanes' writes visible)
        __syncwarp();
        T* const to_r2 = shift + 2 * (size_t)i * k;
        int* const to_j = idx + (size_t)i * k;
        rank_into(br2, bj, count, k, lane, [&](int rank, T re, int je) {
          to_r2[2 * rank] = re;
          to_j[rank] = je;
        });
        __syncwarp();
        for (int e = lane; e < k; e += 32) {
          br2[e] = to_r2[2 * e];
          bj[e] = to_j[e];
        }
        __syncwarp();
        count = k;
        thr = br2[k - 1];
        keep = ok && r2 < thr;
        take = __ballot_sync(kFull, keep);
      }
      if (keep) {
        const int pos = count + __popc(take & ((1u << lane) - 1u));
        br2[pos] = r2;
        bj[pos] = j;
      }
      count += __popc(take);
    }
  }
  if (!row) return;
  __syncwarp();
  if (lane == 0 && total > 0) atomicMax(demand, total);

  const size_t o = (size_t)i * k;
  auto put_shift = [&](size_t slot, int j) {
    T shx = T(0), shy = T(0);
    if (kPeriodic) {
      shx = tlx * round_even((xi - xs[j]) * ilx);
      shy = tly * round_even((yi - ys[j]) * ily);
    }
    shift[2 * slot] = shx;
    shift[2 * slot + 1] = shy;
  };
  rank_into(br2, bj, count, k, lane, [&](int rank, T, int je) {
    idx[o + rank] = je;
    valid[o + rank] = 1;
    put_shift(o + rank, je);
  });
  const int g = min(i, m - 1);
  for (int s = min(count, k) + lane; s < k; s += 32) {
    idx[o + s] = i;
    valid[o + s] = 0;
    put_shift(o + s, g);
  }
}

template <typename T>
int launch(const T* x, const T* y, const T* r, const unsigned char* alive,
           int n, const T* xs, const T* ys, const T* rs,
           const unsigned char* alive_s, int m, int n_self, int n_skip,
           int k, int cap, int periodic, double two_lx, double two_ly,
           T* scratch_r2, int* scratch_j, int* idx, unsigned char* valid,
           T* shift, int* demand, cudaStream_t stream) {
  if (n < 1 || m < 1 || k < 1 || cap % 32 != 0 || cap < k + 32 ||
      scratch_r2 == nullptr || scratch_j == nullptr)
    return (int)cudaErrorInvalidValue;
  auto kernel = periodic ? broadphase_kernel<T, true>
                         : broadphase_kernel<T, false>;
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  // the staged tile, under the 48 KB a block takes without opting in
  const size_t smem = (size_t)kTile * (3 * sizeof(T) + 1);
  kernel<<<blocks, kThreads, smem, stream>>>(
      x, y, r, alive, n, xs, ys, rs, alive_s, m, n_self, n_skip, k, cap,
      two_lx, two_ly, scratch_r2, scratch_j, idx, valid, shift, demand);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = success).
// scratch_r2 and scratch_j hold cap entries a query row.  demand must be
// zero on entry.
int broadphase_f32(const float* x, const float* y, const float* r,
                   const unsigned char* alive, int n, const float* xs,
                   const float* ys, const float* rs,
                   const unsigned char* alive_s, int m, int n_self,
                   int n_skip, int k, int cap, int periodic, double two_lx,
                   double two_ly, float* scratch_r2, int* scratch_j,
                   int* idx, unsigned char* valid, float* shift, int* demand,
                   void* stream) {
  return launch<float>(x, y, r, alive, n, xs, ys, rs, alive_s, m, n_self,
                       n_skip, k, cap, periodic, two_lx, two_ly, scratch_r2,
                       scratch_j, idx, valid, shift, demand,
                       (cudaStream_t)stream);
}

int broadphase_f64(const double* x, const double* y, const double* r,
                   const unsigned char* alive, int n, const double* xs,
                   const double* ys, const double* rs,
                   const unsigned char* alive_s, int m, int n_self,
                   int n_skip, int k, int cap, int periodic, double two_lx,
                   double two_ly, double* scratch_r2, int* scratch_j,
                   int* idx, unsigned char* valid, double* shift, int* demand,
                   void* stream) {
  return launch<double>(x, y, r, alive, n, xs, ys, rs, alive_s, m, n_self,
                        n_skip, k, cap, periodic, two_lx, two_ly, scratch_r2,
                        scratch_j, idx, valid, shift, demand,
                        (cudaStream_t)stream);
}

}  // extern "C"
