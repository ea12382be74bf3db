// What the fused step kernels (apgd_sc_step.cu, mprgp_step.cu) share: the
// eager body's arithmetic, rounded as written, and the closed form of a
// Lorentz block's projection with its activity and apex tests.
//
// Each operation is the one PyTorch runs on the card, in the state's type
// and to nearest (`__fmul_rn` and the rest: nvcc never contracts them into
// an FMA), so that every branch test sees the eager body's operands.  The
// projection is ops/projections.py's LorentzConeProj; the kernels' card
// tests hold each kernel to its eager body.

#pragma once

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

}  // namespace
