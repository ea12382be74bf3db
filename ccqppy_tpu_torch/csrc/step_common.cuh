// What the fused step kernels (apgd_sc_step.cu, mprgp_step.cu, pcg_step.cu)
// share: the eager body's arithmetic, rounded as written, PyTorch's clamps
// and minima with their NaN rules, the closed form of a Lorentz block's
// projection with its activity and apex tests, and a box's coordinate
// math.
//
// Each operation is the one PyTorch runs on the card, in the state's type
// and to nearest (`__fmul_rn` and the rest: nvcc never contracts them into
// an FMA), so that every branch test sees the eager body's operands.  The
// sets are ops/projections.py's LorentzConeProj and BoxProj; the kernels'
// card tests hold each kernel to its eager body.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace {

// ops/projections.py: ACTIVE_ATOL, ACTIVE_RTOL (numpy.isclose's defaults).
constexpr double ACTIVE_ATOL = 1e-8;
constexpr double ACTIVE_RTOL = 1e-5;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float magnitude(float a) { return fabsf(a); }
__device__ __forceinline__ double magnitude(double a) { return fabs(a); }
template <typename T>
__device__ __forceinline__ T sub(T a, T b) { return add(a, -b); }  // exact, as a - b
__device__ __forceinline__ float epsilon(float) { return FLT_EPSILON; }
__device__ __forceinline__ double epsilon(double) { return DBL_EPSILON; }

// torch.clamp(v, min=0) and torch.clamp(v, max=0): NaN propagates.
template <typename T>
__device__ __forceinline__ T at_least0(T v) { return v != v ? v : (v < T(0) ? T(0) : v); }
template <typename T>
__device__ __forceinline__ T at_most0(T v) { return v != v ? v : (v > T(0) ? T(0) : v); }
// torch.minimum / torch.maximum / amin: NaN propagates.
template <typename T>
__device__ __forceinline__ T least(T a, T b) { return a != a ? a : (b != b ? b : (b < a ? b : a)); }
template <typename T>
__device__ __forceinline__ T most(T a, T b) { return a != a ? a : (b != b ? b : (b > a ? b : a)); }
// torch.clamp(v, lo, hi) on the card: NaN propagates, else min(max(v, lo), hi).
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  T m = v < lo ? lo : v;
  return hi < m ? hi : m;
}

// ---- Lorentz blocks --------------------------------------------------------

// LorentzConeProj.project of one block w = (u, z), fixed by these numbers.
template <typename T>
struct Cone {
  T usq;                   // sum of u_i^2 in order
  T un;                    // ||u||
  T z;
  T t;                     // (mu ||u|| + z) / (mu^2 + 1)
  T tmu;                   // t mu
  bool inside;             // ||u|| <= mu z
  bool polar;              // mu ||u|| <= -z
};

template <typename T, typename W>
__device__ __forceinline__ Cone<T> cone(W w, int d, T mu) {
  Cone<T> c;
  c.usq = T(0);
  for (int i = 0; i < d - 1; ++i) {
    const T wi = w(i);
    c.usq = add(c.usq, mul(wi, wi));
  }
  c.un = root(c.usq);
  c.z = w(d - 1);
  c.inside = c.un <= mul(mu, c.z);
  c.polar = mul(mu, c.un) <= -c.z;
  c.t = quot(add(mul(mu, c.un), c.z), add(mul(mu, mu), T(1)));
  c.tmu = mul(c.t, mu);
  return c;
}

// Coordinate i of the projection, w_i its coordinate before.
template <typename T>
__device__ __forceinline__ T cone_at(const Cone<T>& c, T wi, bool last) {
  if (c.inside) return wi;
  if (c.polar) return T(0);
  if (last) return c.t;
  return mul(c.tmu, c.un != T(0) ? quot(wi, c.un) : T(0));
}

// is_active: mu z - ||u|| <= ATOL + RTOL |mu z|.
template <typename T>
__device__ __forceinline__ bool cone_active(const Cone<T>& c, T mu) {
  const T mz = mul(mu, c.z);
  return sub(mz, c.un) <= add(T(ACTIVE_ATOL), mul(T(ACTIVE_RTOL), magnitude(mz)));
}

// is_apex: ||w|| <= ATOL, absolute.
template <typename T>
__device__ __forceinline__ bool cone_apex(const Cone<T>& c) {
  return root(add(c.usq, mul(c.z, c.z))) <= T(ACTIVE_ATOL);
}

// ---- Boxes -----------------------------------------------------------------
// BoxProj, one coordinate x (gradient g) against its bounds lo <= hi.  Its
// projection is clip(x, lo, hi).

// _at_bound: |x - ref| <= 16 eps (1 + |ref|), a few ulps about a bound.
template <typename T>
__device__ __forceinline__ bool box_at(T x, T ref) {
  return magnitude(sub(x, ref)) <= mul(add(magnitude(ref), T(1)), T(16) * epsilon(T(0)));
}

// snap_binding: a coordinate that binds is put exactly on its bound (the
// upper test sees the lower snap, as the two torch.where do).
template <typename T>
__device__ __forceinline__ T box_snap(T x, T g, T lo, T hi) {
  if (box_at(x, lo) && g > T(0)) x = lo;
  if (box_at(x, hi) && g < T(0)) x = hi;
  return x;
}

// binding_mask: 0 where the coordinate binds, else 1.
template <typename T>
__device__ __forceinline__ T box_free(T x, T g, T lo, T hi) {
  return (box_at(x, lo) && g > T(0)) || (box_at(x, hi) && g < T(0)) ? T(0) : T(1);
}

// max_feasible_step before its amin: the largest a >= 0 with x - a q in
// [lo, hi], +inf where q is 0.
template <typename T>
__device__ __forceinline__ T box_max_step(T x, T q, T lo, T hi) {
  const T r_lo = q > T(0) ? quot(at_least0(sub(x, lo)), q) : T(INFINITY);
  const T r_hi = q < T(0) ? quot(at_least0(sub(hi, x)), -q) : T(INFINITY);
  return least(r_lo, r_hi);
}

// pg_residual_vec: clamp(g, (x - ub) / gd, (x - lb) / gd); PyTorch divides
// by the Python float gd as a product with 1 / gd in the state's type.
template <typename T>
__device__ __forceinline__ T box_pg_residual(T x, T g, T lo, T hi, T inv_gd) {
  return clip(g, mul(sub(x, hi), inv_gd), mul(sub(x, lo), inv_gd));
}

}  // namespace
