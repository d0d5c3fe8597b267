// The births' Monte-Carlo mask: which sample points lie inside their floe —
// CUDA C++ kernel for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package computes this mask on the host,
// in numpy (subzero_tpu/state.py:make_floe_arrays), for every floe it
// builds: the initial field and every birth and reshape of the lifecycle.
// The port's plain version is that same numpy broadcast
// (subzero_tpu_torch/state.py:mc_inside), which builds [n, P, V] float64
// temporaries on the host: ~1 ms a floe at P = 400, V = 64.  The mask's only
// reader is the state's mc_in on the device, so this kernel computes it where
// it is read, from the same float64 points and body-frame vertices, bit for
// bit.
//
// Exactness.  The crossing-number test of the plain version, in its
// operations and order, in float64:
//   cond = (y0 > py) != (y1 > py)
//   t    = (py - y0) / (y1 - y0)        (cond implies y1 != y0; IEEE division)
//   xint = x0 + t * (x1 - x0)
//   the point is inside when an odd number of edges has cond && px < xint.
// Edge e runs from vertex e to vertex (e + 1) mod V, as numpy's roll.  Only
// the first nv edges are tested: the padding repeats vertex 0
// (geometry/polygon.py:pad_polygon), so edge nv - 1 is the closing edge and
// every later edge has zero length and never crosses.  Built with
// --fmad=false, so t * (x1 - x0) is not contracted into an FMA.
//
// What bounds it on this card.  B x P points, each tested against the nv
// real edges of its floe: ~8 operations an edge (two compares, and on a
// crossing a subtraction, a division, a product and a sum) in float64.
// winter-10k's births, ~4,000 floes x 400 points x ~30 edges, are ~5e7 edge
// tests: ~12 us at 34 TFLOP/s.  The bytes are the points (16 B each) and
// the mask (1 B each): 27 MB, ~8 us at 3.35 TB/s.  Both are small against a
// launch; the upload of the points from the host is the real cost and lies
// outside the kernel.
//
// What the design does about it.
//   * One block a floe.  The block stages its floe's edges (x0, y0, y1,
//     x1 - x0, y1 - y0) in shared memory, kEdgeTile at a time, so every
//     thread reads each edge as one broadcast load.
//   * Each thread takes points p = tid, tid + kThreads, ... and XORs a
//     parity over the staged edges.  The divide runs only on a crossing
//     (about two edges of thirty a point).
//   * A floe with more than kEdgeTile real edges (none of the cells': the
//     vertex rungs stop at 64) takes more tiles; the mask in device memory
//     carries the parity from one tile to the next, each point owned by one
//     thread throughout.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kEdgeTile = 256;

__global__ void __launch_bounds__(kThreads)
    mc_mask_kernel(const double* __restrict__ verts,
                   const int* __restrict__ nv, int v,
                   const double* __restrict__ pts, int p,
                   unsigned char* __restrict__ mask) {
  __shared__ double s_x0[kEdgeTile], s_y0[kEdgeTile], s_y1[kEdgeTile];
  __shared__ double s_dx[kEdgeTile], s_dy[kEdgeTile];

  const int b = blockIdx.x;
  const int n = min(max(nv[b], 0), v);
  const double* vb = verts + (size_t)b * v * 2;
  const double2* pb = reinterpret_cast<const double2*>(pts) + (size_t)b * p;
  unsigned char* mb = mask + (size_t)b * p;

  for (int e0 = 0; e0 == 0 || e0 < n; e0 += kEdgeTile) {
    const int cnt = min(kEdgeTile, n - e0);
    if (e0 > 0) __syncthreads();  // the previous tile is read by all
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const int e = e0 + k;
      const int f = e + 1 == v ? 0 : e + 1;
      const double x0 = vb[2 * e], y0 = vb[2 * e + 1];
      const double x1 = vb[2 * f], y1 = vb[2 * f + 1];
      s_x0[k] = x0;
      s_y0[k] = y0;
      s_y1[k] = y1;
      s_dx[k] = x1 - x0;
      s_dy[k] = y1 - y0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < p; i += kThreads) {
      const double2 q = pb[i];
      unsigned in = e0 == 0 ? 0u : (unsigned)mb[i];
      for (int k = 0; k < cnt; ++k) {
        const double y0 = s_y0[k];
        if ((y0 > q.y) != (s_y1[k] > q.y)) {
          const double t = (q.y - y0) / s_dy[k];
          const double xint = s_x0[k] + t * s_dx[k];
          in ^= (unsigned)(q.x < xint);
        }
      }
      mb[i] = (unsigned char)in;
    }
  }
}

}  // namespace

extern "C" {

// verts [b, v, 2] float64 body-frame vertices (padded with vertex 0), nv [b]
// int32 real vertex counts, pts [b, p, 2] float64 points (16-byte aligned);
// writes mask [b, p] as 0 / 1 bytes.  Returns cudaGetLastError() after the
// launch (0 = success); b = 0 launches nothing.
int mc_mask_f64(const double* verts, const int* nv, int b, int v,
                const double* pts, int p, unsigned char* mask, void* stream) {
  if (b < 0 || v < 1 || p < 1) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  mc_mask_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>(verts, nv, v, pts,
                                                           p, mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
