// Parity-integral polygon clip statistics — CUDA C++ kernel for Hopper (sm_90a).
//
// The hand-written kernel of the XLA twin
// subzero_tpu/geometry/clip_integral.py:clip_integral_bm ("integral", the
// default contact_impl), which is XLA code in the JAX package and no TPU
// kernel.  The Pallas TPU kernel clip_pallas.py:_clip_kernel computes another
// float32 function of the same pairs and has its own Hopper kernel,
// csrc/clip_pallas.cu.  For each pair of padded CCW polygons P [B, Vp, 2] and
// Q [B, Vq, 2] this one writes the area, centroid and contact chord of P ∩ Q
// (or P \ Q) and the count of proper edge crossings, without building the
// clipped polygon: every edge of each polygon is weighted by the
// inside-the-other indicator integrals (I0, I1) on two carrier lines offset by
// ±eps, and Green's theorem sums the weighted edges.  The math is the written
// spec in subzero_tpu_torch/geometry/clip_integral.py (the plain PyTorch
// version); this kernel evaluates every (P edge, Q edge) pair with the same
// expressions in the same order: each crossing once, the ±eps offsets as
// linear corrections.
//
// What bounds it on this card.  Only edges of non-zero length do work (the
// padding slots repeat vertex 0, and a zero-length edge adds nothing to any
// sum).  At the main path's overlap shape (B = 81,920 quads padded to
// Vp = Vq = 16) that is 4 x 4 real edge pairs per pair: ~2.4e8 operations
// (3.5 us at 67 TFLOP/s f32) against 23 MB of input and output (6.8 us at
// 3.35 TB/s), so bytes bound it.  Only at many real vertices (tens per
// polygon) do the operations take over.  The pair-local work is divisions,
// comparisons and clamps, not a matrix product: tensor cores do not apply.
//
// What the design does about it.
//   * Coalesced staging and compacted real-edge lists (csrc/clip_tile.cuh,
//     shared with clip_pallas.cu): the edge loops run over n_p x n_q real
//     edge pairs instead of Vp x Vq slots.  Each edge's eps factors ct_f,
//     cs_f (a square root and a division) are computed once, by the lane
//     that takes it as its outer edge, and kept in registers: stored in the
//     lists they cost a third more shared memory, fewer resident blocks, and
//     measured slower (PERF.md).
//   * Lane groups.  G lanes (a template parameter, 1..32) share a pair: in the
//     P pass they take P's real edges in turn, each looping over Q's list in
//     order; in the Q pass the other way round.  The per-lane Green sums and
//     crossing counts are then reduced with __shfl_xor_sync.  The wrapper
//     picks G from (B, Vp, Vq): more lanes where B is small or V large, so
//     the card fills at the wall shape and at wide polygons.
//   * Float and double instances: the f64 one lets the step be checked on the
//     card against the CPU at float64 tolerances.
//
// Exactness of n_cross.  The crossing count is an integer decision on
// t0, s0 ∈ [0, 1).  Build with --fmad=false (no contraction of a*b - c*d into
// an FMA) and without --use_fast_math, so that products, differences, 1/x and
// sqrt round as IEEE operations, exactly as the plain version computes them on
// the CPU and on the card.  Every (P edge, Q edge) pair is evaluated in the
// plain version's operation order and the inner sums run in the original edge
// order; only the order of the outer Green sums (split over G lanes) differs.

#include "clip_tile.cuh"

namespace {

using clip_tile::Edge;
using clip_tile::clamp01;
using clip_tile::inv_len_of;
using clip_tile::kThreads;
using clip_tile::tile_bytes;

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
clip_kernel(const T* __restrict__ p, const T* __restrict__ q, long long b,
            int vp, int vq, bool difference, T eps_scale,
            T* __restrict__ area_out, T* __restrict__ cent_out,
            T* __restrict__ chord_out, int* __restrict__ ncross_out) {
  constexpr int Bt = kThreads / G;
  constexpr int ld = Bt + 1;
  const long long ntiles = (b + Bt - 1) / Bt;

  extern __shared__ __align__(16) unsigned char smem[];
  const clip_tile::Tile<T> tl = clip_tile::carve<T>(smem, Bt, ld, vp, vq);
  // Lane groups for the edge loops.
  const int t = threadIdx.x / G;
  const int g = threadIdx.x % G;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // ---- stage the tile, eps and the compacted real-edge lists
    const long long k0 = tile * Bt;
    clip_tile::load_tile(tl, p, q, b, k0, Bt, ld, vp, vq, eps_scale);

    const int n_p = tl.np[t], n_q = tl.nq[t];
    const T eps = tl.eps[t];
    const Edge<T>* lp = tl.ep + t;
    const Edge<T>* lq = tl.eq + t;

    // ---- P edges against Q (+ proper crossing count) ----------------------
    T a_p = T(0), mx_p = T(0), my_p = T(0), chx = T(0), chy = T(0);
    int ncr = 0;
    for (int i = g; i < n_p; i += G) {
      const Edge<T> e = lp[i * ld];
      const T px0 = e.x0, py0 = e.y0, dx = e.dx, dy = e.dy;
      const T elen2 = dx * dx + dy * dy;
      const T inv_len = inv_len_of(elen2);
      const T ct_f = eps * inv_len;           // ct = ddq * ct_f * inv_denom
      const T cs_f = eps * elen2 * inv_len;   // cs = cs_f * inv_denom
      T s0p = T(0), s0m = T(0), s1p = T(0), s1m = T(0);
      for (int j = 0; j < n_q; ++j) {
        const Edge<T> o = lq[j * ld];
        const T qx0 = o.x0, qy0 = o.y0, dqx = o.dx, dqy = o.dy;
        const T denom = dx * dqy - dy * dqx;
        if (!(fabs(denom) > T(0))) continue;   // parallel: no crossing
        const T inv_denom = T(1) / denom;
        const T delta = denom > T(0) ? T(-1) : T(1);
        const T relx = qx0 - px0, rely = qy0 - py0;
        const T t0 = (relx * dqy - rely * dqx) * inv_denom;
        const T s0 = (relx * dy - rely * dx) * inv_denom;
        const T ddq = dx * dqx + dy * dqy;
        const T ct = ddq * ct_f * inv_denom;
        const T cs = cs_f * inv_denom;
        {  // carrier line offset +eps
          const T tt = t0 - ct, ss = s0 - cs;
          if (ss >= T(0) && ss < T(1)) {
            const T tc = clamp01(tt, T(1));
            s0p += delta * (T(1) - tc);
            s1p += delta * (T(1) - tc * tc);
          }
        }
        {  // carrier line offset -eps
          const T tt = t0 + ct, ss = s0 + cs;
          if (ss >= T(0) && ss < T(1)) {
            const T tc = clamp01(tt, T(1));
            s0m += delta * (T(1) - tc);
            s1m += delta * (T(1) - tc * tc);
          }
        }
        if (t0 >= T(0) && t0 < T(1) && s0 >= T(0) && s0 < T(1)) ++ncr;
      }
      T i0 = clamp01(T(0.5) * (s0p + s0m), T(1));
      T i1 = clamp01(T(0.25) * (s1p + s1m), T(0.5));
      if (difference) {  // P \ Q keeps the part of dP OUTSIDE Q
        i0 = T(1) - i0;
        i1 = T(0.5) - i1;
      }
      const T c = px0 * dy - py0 * dx;
      a_p += c * i0;
      mx_p += c * (px0 * i0 + dx * i1);
      my_p += c * (py0 * i0 + dy * i1);
      chx += dx * i0;
      chy += dy * i0;
    }

    // ---- Q edges against P ------------------------------------------------
    // Same crossing geometry as above (P-first orientation, so every value is
    // bit-identical to the first pass); the Q side reads (s0, t0) and the
    // corrections pick up a sign through -inv_denom.
    T a_q = T(0), mx_q = T(0), my_q = T(0);
    for (int j = g; j < n_q; j += G) {
      const Edge<T> o = lq[j * ld];
      const T qx0 = o.x0, qy0 = o.y0, dqx = o.dx, dqy = o.dy;
      const T elen2 = dqx * dqx + dqy * dqy;
      const T inv_len = inv_len_of(elen2);
      const T ct_f = eps * inv_len;           // ct = ddq * ct_f * inv_denom
      const T cs_f = eps * elen2 * inv_len;   // cs = cs_f * inv_denom
      T s0p = T(0), s0m = T(0), s1p = T(0), s1m = T(0);
      for (int i = 0; i < n_p; ++i) {
        const Edge<T> e = lp[i * ld];
        const T px0 = e.x0, py0 = e.y0, dx = e.dx, dy = e.dy;
        const T denom = dx * dqy - dy * dqx;
        if (!(fabs(denom) > T(0))) continue;
        const T inv_denom = T(1) / denom;
        const T neg_inv = -inv_denom;
        const T delta_q = denom > T(0) ? T(1) : T(-1);  // -delta
        const T relx = qx0 - px0, rely = qy0 - py0;
        const T t0 = (relx * dqy - rely * dqx) * inv_denom;
        const T s0 = (relx * dy - rely * dx) * inv_denom;
        const T ddq = dx * dqx + dy * dqy;
        const T ct = ddq * ct_f * neg_inv;
        const T cs = cs_f * neg_inv;
        {
          const T tq = s0 - ct, sq = t0 - cs;
          if (sq >= T(0) && sq < T(1)) {
            const T tc = clamp01(tq, T(1));
            s0p += delta_q * (T(1) - tc);
            s1p += delta_q * (T(1) - tc * tc);
          }
        }
        {
          const T tq = s0 + ct, sq = t0 + cs;
          if (sq >= T(0) && sq < T(1)) {
            const T tc = clamp01(tq, T(1));
            s0m += delta_q * (T(1) - tc);
            s1m += delta_q * (T(1) - tc * tc);
          }
        }
      }
      const T i0 = clamp01(T(0.5) * (s0p + s0m), T(1));
      const T i1 = clamp01(T(0.25) * (s1p + s1m), T(0.5));
      const T c = qx0 * dqy - qy0 * dqx;
      a_q += c * i0;
      mx_q += c * (qx0 * i0 + dqx * i1);
      my_q += c * (qy0 * i0 + dqy * i1);
    }

    // ---- reduce over the G lanes of the pair -----------------------------
#pragma unroll
    for (int off = G >> 1; off > 0; off >>= 1) {
      a_p += __shfl_xor_sync(0xffffffffu, a_p, off);
      mx_p += __shfl_xor_sync(0xffffffffu, mx_p, off);
      my_p += __shfl_xor_sync(0xffffffffu, my_p, off);
      chx += __shfl_xor_sync(0xffffffffu, chx, off);
      chy += __shfl_xor_sync(0xffffffffu, chy, off);
      a_q += __shfl_xor_sync(0xffffffffu, a_q, off);
      mx_q += __shfl_xor_sync(0xffffffffu, mx_q, off);
      my_q += __shfl_xor_sync(0xffffffffu, my_q, off);
      ncr += __shfl_xor_sync(0xffffffffu, ncr, off);
    }
    const long long k = k0 + t;
    if (g == 0 && k < b) {
      a_p = T(0.5) * a_p;
      mx_p = mx_p / T(3);
      my_p = my_p / T(3);
      a_q = T(0.5) * a_q;
      mx_q = mx_q / T(3);
      my_q = my_q / T(3);
      T area, mx, my;
      if (difference) {
        area = a_p - a_q; mx = mx_p - mx_q; my = my_p - my_q;
      } else {
        area = a_p + a_q; mx = mx_p + mx_q; my = my_p + my_q;
      }
      const bool ok = fabs(area) > T(1e-9);
      area_out[k] = area;
      cent_out[2 * k] = ok ? mx / area : T(0);
      cent_out[2 * k + 1] = ok ? my / area : T(0);
      chord_out[2 * k] = chx;
      chord_out[2 * k + 1] = chy;
      ncross_out[k] = ncr;
    }
  }
}

template <typename T, int G>
int launch_g(const T* p, const T* q, long long b, int vp, int vq,
             int difference, double eps_scale, T* area, T* cent, T* chord,
             int* ncross, cudaStream_t stream) {
  auto kernel = clip_kernel<T, G>;
  const long long smem = tile_bytes(G, vp, vq, (int)sizeof(T));
  unsigned blocks = 0;
  const cudaError_t err = clip_tile::persistent_grid(kernel, smem, b,
                                                     kThreads / G, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, (size_t)smem, stream>>>(
      p, q, b, vp, vq, difference != 0, (T)eps_scale, area, cent, chord,
      ncross);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* p, const T* q, long long b, int vp, int vq, int difference,
           double eps_scale, int lanes, T* area, T* cent, T* chord,
           int* ncross, cudaStream_t stream) {
  switch (lanes) {
#define CLIP_CASE(G)                                                       \
  case G:                                                                  \
    return launch_g<T, G>(p, q, b, vp, vq, difference, eps_scale, area,    \
                          cent, chord, ncross, stream);
    CLIP_CASE(1) CLIP_CASE(2) CLIP_CASE(4) CLIP_CASE(8) CLIP_CASE(16)
    CLIP_CASE(32)
#undef CLIP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block takes at (lanes, vp, vq, itemsize).
long long clip_tile_bytes(int lanes, int vp, int vq, int itemsize) {
  return tile_bytes(lanes, vp, vq, itemsize);
}

// Each returns cudaGetLastError() after the launch (0 = success).  `lanes` is
// the lane-group width G: 1, 2, 4, 8, 16 or 32.
int clip_stats_f32(const float* p, const float* q, long long b, int vp, int vq,
                   int difference, double eps_scale, int lanes, float* area,
                   float* cent, float* chord, int* ncross, void* stream) {
  return launch<float>(p, q, b, vp, vq, difference, eps_scale, lanes, area,
                       cent, chord, ncross, (cudaStream_t)stream);
}

int clip_stats_f64(const double* p, const double* q, long long b, int vp,
                   int vq, int difference, double eps_scale, int lanes,
                   double* area, double* cent, double* chord, int* ncross,
                   void* stream) {
  return launch<double>(p, q, b, vp, vq, difference, eps_scale, lanes, area,
                        cent, chord, ncross, (cudaStream_t)stream);
}

}  // extern "C"
