// Parity-integral polygon clip statistics — CUDA C++ kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel subzero_tpu/geometry/clip_pallas.py:_clip_kernel
// (called through _clip_pallas, clip_pallas.py:179).  For each pair of padded
// CCW polygons P [B, Vp, 2] and Q [B, Vq, 2] it writes the area, centroid and
// contact chord of P ∩ Q (or P \ Q) and the count of proper edge crossings,
// without building the clipped polygon: every edge of each polygon is weighted
// by the inside-the-other indicator integrals (I0, I1) on two carrier lines
// offset by ±eps, and Green's theorem sums the weighted edges.  The math is the
// written spec in subzero_tpu_torch/geometry/clip_integral.py (the plain
// PyTorch version); this kernel evaluates the same expressions in the same
// order, per pair.
//
// What bounds it on this card.  Per pair it does ~90 floating-point operations
// for every (P edge, Q edge) pair and side, against 8·(Vp+Vq) bytes of input
// (f32): at the main path's overlap shape (B = 81,920, Vp = Vq = 16) that is
// ~3.8 GFLOP against 23 MB, so the dense formulation is bound by f32
// arithmetic, not by memory.
//
// What this simple design does about it.
//   * One thread per pair, grid-stride loop; nothing is shared between pairs,
//     so there is no synchronisation and no shared memory.
//   * It reads P and Q from the public [B, V, 2] layout (no rolled copy, no
//     [V, B] transpose in device memory, no padding copy: the ragged tail is
//     masked by the loop bound).  Each vertex comes from device memory once;
//     the inner loops re-read it from L1.
//   * Zero-length edges (the padding slots repeat vertex 0) contribute exactly
//     nothing to any sum, so both loops skip them.  On the quad lattice of the
//     main path that removes 15/16 of the edge pairs; the work then scales with
//     the real vertex counts instead of the padded capacity.
//   * It loops over P's edges against Q's edges, then Q's edges against P's
//     (as _side_sums does in the Pallas kernel), recomputing the crossing
//     geometry in the second pass rather than holding [Vq] accumulators; the
//     proper-crossing count rides on the first pass.
//   * Templated on float and double: the f64 instance lets the step be checked
//     on the card against the CPU at float64 tolerances.
//
// Exactness of n_cross.  The crossing count is an integer decision on
// t0, s0 ∈ [0, 1).  Build with --fmad=false (no contraction of a*b - c*d into
// an FMA) and without --use_fast_math, so that products, differences, 1/x and
// sqrt round as IEEE operations, exactly as the plain version computes them on
// the CPU and on the card.

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T clamp01(T v, T hi) {
  return v < T(0) ? T(0) : (v > hi ? hi : v);
}

template <typename T>
__device__ __forceinline__ T inv_len_of(T elen2) {
  return elen2 > T(0) ? T(1) / sqrt(elen2) : T(0);
}

template <typename T>
__global__ void clip_kernel(const T* __restrict__ p, const T* __restrict__ q,
                            long long b, int vp, int vq, bool difference,
                            T eps_scale, T* __restrict__ area_out,
                            T* __restrict__ cent_out, T* __restrict__ chord_out,
                            int* __restrict__ ncross_out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < b;
       k += stride) {
    const T* P = p + k * (2LL * vp);
    const T* Q = q + k * (2LL * vq);

    // eps = max(max|coords of P and Q|, 1) * eps_T^(2/3)
    T m = T(0);
    for (int i = 0; i < vp; ++i) {
      m = fmax(m, fmax(fabs(__ldg(P + 2 * i)), fabs(__ldg(P + 2 * i + 1))));
    }
    for (int j = 0; j < vq; ++j) {
      m = fmax(m, fmax(fabs(__ldg(Q + 2 * j)), fabs(__ldg(Q + 2 * j + 1))));
    }
    const T eps = fmax(m, T(1)) * eps_scale;

    // ---- P edges against Q (+ proper crossing count) ----------------------
    T a_p = T(0), mx_p = T(0), my_p = T(0), chx = T(0), chy = T(0);
    int ncr = 0;
    for (int i = 0; i < vp; ++i) {
      const int in = (i + 1 == vp) ? 0 : i + 1;
      const T px0 = __ldg(P + 2 * i), py0 = __ldg(P + 2 * i + 1);
      const T dx = __ldg(P + 2 * in) - px0, dy = __ldg(P + 2 * in + 1) - py0;
      if (dx == T(0) && dy == T(0)) continue;  // padded edge: contributes 0
      const T elen2 = dx * dx + dy * dy;
      const T inv_len = inv_len_of(elen2);
      const T ct_f = eps * inv_len;            // ct = ddq * ct_f * inv_denom
      const T cs_f = eps * elen2 * inv_len;    // cs = cs_f * inv_denom
      T s0p = T(0), s0m = T(0), s1p = T(0), s1m = T(0);
      for (int j = 0; j < vq; ++j) {
        const int jn = (j + 1 == vq) ? 0 : j + 1;
        const T qx0 = __ldg(Q + 2 * j), qy0 = __ldg(Q + 2 * j + 1);
        const T dqx = __ldg(Q + 2 * jn) - qx0, dqy = __ldg(Q + 2 * jn + 1) - qy0;
        if (dqx == T(0) && dqy == T(0)) continue;
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
          const T t = t0 - ct, s = s0 - cs;
          if (s >= T(0) && s < T(1)) {
            const T tc = clamp01(t, T(1));
            s0p += delta * (T(1) - tc);
            s1p += delta * (T(1) - tc * tc);
          }
        }
        {  // carrier line offset -eps
          const T t = t0 + ct, s = s0 + cs;
          if (s >= T(0) && s < T(1)) {
            const T tc = clamp01(t, T(1));
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
    a_p = T(0.5) * a_p;
    mx_p = mx_p / T(3);
    my_p = my_p / T(3);

    // ---- Q edges against P ------------------------------------------------
    // Same crossing geometry as above (P-first orientation, so every value is
    // bit-identical to the first pass); the Q side reads (s0, t0) and the
    // corrections pick up a sign through -inv_denom.
    T a_q = T(0), mx_q = T(0), my_q = T(0);
    for (int j = 0; j < vq; ++j) {
      const int jn = (j + 1 == vq) ? 0 : j + 1;
      const T qx0 = __ldg(Q + 2 * j), qy0 = __ldg(Q + 2 * j + 1);
      const T dqx = __ldg(Q + 2 * jn) - qx0, dqy = __ldg(Q + 2 * jn + 1) - qy0;
      if (dqx == T(0) && dqy == T(0)) continue;
      const T elen2 = dqx * dqx + dqy * dqy;
      const T inv_len = inv_len_of(elen2);
      const T ct_f = eps * inv_len;
      const T cs_f = eps * elen2 * inv_len;
      T s0p = T(0), s0m = T(0), s1p = T(0), s1m = T(0);
      for (int i = 0; i < vp; ++i) {
        const int in = (i + 1 == vp) ? 0 : i + 1;
        const T px0 = __ldg(P + 2 * i), py0 = __ldg(P + 2 * i + 1);
        const T dx = __ldg(P + 2 * in) - px0, dy = __ldg(P + 2 * in + 1) - py0;
        if (dx == T(0) && dy == T(0)) continue;
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

constexpr int kThreads = 128;

template <typename T>
int launch(const T* p, const T* q, long long b, int vp, int vq, int difference,
           double eps_scale, T* area, T* cent, T* chord, int* ncross,
           cudaStream_t stream) {
  long long blocks = (b + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride covers the rest
  clip_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      p, q, b, vp, vq, difference != 0, (T)eps_scale, area, cent, chord,
      ncross);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = success).
int clip_stats_f32(const float* p, const float* q, long long b, int vp, int vq,
                   int difference, double eps_scale, float* area, float* cent,
                   float* chord, int* ncross, void* stream) {
  return launch<float>(p, q, b, vp, vq, difference, eps_scale, area, cent,
                       chord, ncross, (cudaStream_t)stream);
}

int clip_stats_f64(const double* p, const double* q, long long b, int vp,
                   int vq, int difference, double eps_scale, double* area,
                   double* cent, double* chord, int* ncross, void* stream) {
  return launch<double>(p, q, b, vp, vq, difference, eps_scale, area, cent,
                        chord, ncross, (cudaStream_t)stream);
}

}  // extern "C"
