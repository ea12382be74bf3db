// One iteration of plain PCG's inner loop on a box after its GEMV, fused,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the body of the inner while_loop of
// ccqppy_tpu/models/pcg.py's _solve, which the JAX package runs as XLA
// fusions around its matvec.  The port ran that body as eager PyTorch,
// ~100 small launches an iteration (the step sizes and their two dots, the
// feasible step, the clip, the snap and the binding mask, the
// preconditioned residual, the Eq. 25 residual, the flags and one select
// a field of the state), and the host's launches set the pace wherever the
// GEMV is short.  Here an iteration is the GEMV and one launch, for a box
// whose bounds are shared or one a lane; every other set keeps the eager
// body (models/pcg.py).
//
// What it computes, per lane that runs (`active`: outer-active and not
// inner-done) and in place on the loop's state, from the sweep's A p:
// pAp, alpha_cg, the feasible step alpha_f, the clamped step, the new x
// (clipped, then snapped onto the bounds that bind) and g, the binding mask
// m, whether it changed, r = -m g, z = m M^-1 r (Jacobi's 1 / diag A, or
// none), rr = r.z, the restart, beta, the new direction p = z + beta p,
// the Eq. 25 residual res, mv + 1, it + 1 and the inner done rule, and
// clears the lane's `active` where it is done, so that the loop's next test
// reads `active` alone.  A lane that does not run returns after reading its
// flag: its state is kept.  r is not written: nothing reads it after the
// step.
//
// What bounds it: device-memory bytes at B = 2048, n = 1000, a few dozen
// operations each: a lane reads A p, x, g, m, p (and Jacobi's row) and
// writes x, g, m, p, ~9 n 4-byte values (the bounds are shared, or one row
// more a lane each).  At the phase-2 bucket (<= 256 lanes) it is latency:
// two dependent block reductions a launch.
//
// What the design does about it:
//   * One block a lane, of THREADS = 128, 256 or 512 threads (the wrapper
//     picks the fewest that give every thread at most ELEMS = 4
//     coordinates; n <= 2048): thread t holds coordinates t + k THREADS in
//     registers for the whole launch, so every vector is read once and
//     written once, and the lane's branch is uniform within the block.
//   * Three passes, two block reductions between them: pass 1 the sums
//     p.(m A p) and the least feasible step; pass 2 the new x, g, m and z
//     with the sums r.z and |pg|^2 and the mask's change (or-reduced with
//     the second barrier); pass 3 the new p, then x, g, m, p stored.
//   * Arithmetic: each operation of the eager body (ops/pcg_step.py's
//     cg_step and models/pcg.py's flags), in its order and in the state's
//     type, rounded as written (step_common.cuh's `mul` and the rest, with
//     the box's math there), so every branch test sees the eager body's
//     operands, up to the order of the lane's sums.  A division by a Python
//     float is a product with its reciprocal, as PyTorch computes it on the
//     card (the residual's 1 / (3 n), the box's 1 / gd).
//   * Any n up to 2048 and any base alignment: plain scalar loads.
//     Instances for f32 and f64, as the GEMV has.

#include <cstdint>
#include <cuda_runtime.h>

#include "step_common.cuh"

namespace {

constexpr int ELEMS = 4;   // coordinates a thread holds

// The loop's state, each pointer at lane 0, rows of n.
template <typename T>
struct Step {
  const T* ap;             // A p, the sweep
  T* x;
  T* g;
  T* m;                    // binding mask: 1 free, 0 bound
  T* p;
  T* rr;                   // per lane: r.z
  T* res;
  int32_t* mv;
  int32_t* it;
  uint8_t* done;           // torch.bool
  uint8_t* active;         // the lanes that run; cleared where the step sets done
  const T* dinv;           // Jacobi's 1 / diag A, or null (no preconditioner)
  int64_t dinv_stride;     // 0: (n,) shared by every lane; n: (B, n)
  const T* lb;
  int64_t lb_stride;
  const T* ub;
  int64_t ub_stride;
  int64_t n;
  T inv_gd;                // 1 / gd
  T tiny;                  // the stagnation guard in the step sizes
  T tol;
  int64_t budget;
};

// The sum of a and the least of c over the block; every thread gets the
// same values.
template <int THREADS, typename T>
__device__ __forceinline__ void block_sum_least(T& a, T& c) {
  constexpr int WARPS = THREADS / 32;
  __shared__ T part_a[WARPS], part_c[WARPS];
  for (int off = 16; off > 0; off >>= 1) {
    a = add(a, __shfl_xor_sync(0xffffffffu, a, off));
    c = least(c, __shfl_xor_sync(0xffffffffu, c, off));
  }
  if ((threadIdx.x & 31) == 0) {
    part_a[threadIdx.x >> 5] = a;
    part_c[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  a = part_a[0];
  c = part_c[0];
  for (int w = 1; w < WARPS; ++w) {
    a = add(a, part_a[w]);
    c = least(c, part_c[w]);
  }
}

// Sums of a and b over the block and the or of f; every thread gets the
// same values.
template <int THREADS, typename T>
__device__ __forceinline__ void block_sum2_or(T& a, T& b, bool& f) {
  constexpr int WARPS = THREADS / 32;
  __shared__ T part_a[WARPS], part_b[WARPS];
  for (int off = 16; off > 0; off >>= 1) {
    a = add(a, __shfl_xor_sync(0xffffffffu, a, off));
    b = add(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
  if ((threadIdx.x & 31) == 0) {
    part_a[threadIdx.x >> 5] = a;
    part_b[threadIdx.x >> 5] = b;
  }
  f = __syncthreads_or(f) != 0;
  a = part_a[0];
  b = part_b[0];
  for (int w = 1; w < WARPS; ++w) {
    a = add(a, part_a[w]);
    b = add(b, part_b[w]);
  }
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS) pcg_step_kernel(Step<T> s) {
  const int64_t lane = blockIdx.x;
  if (!s.active[lane]) return;       // uniform in the block: its state is kept
  const int64_t n = s.n;
  const int64_t row = lane * n;
  // Read before the first barrier: thread 0 writes the lane's scalars last.
  const T rr0 = s.rr[lane];
  const int32_t mv = s.mv[lane] + 1;

  T x[ELEMS], g[ELEMS], p[ELEMS], ap[ELEMS], m[ELEMS], lo[ELEMS], hi[ELEMS], z[ELEMS];
  // Pass 1: p.(m A p) and the feasible step along +p (max_feasible_step(x, -p)).
  T pap = T(0), af = T(INFINITY);
#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    const int64_t j = threadIdx.x + k * THREADS;
    if (j < n) {
      x[k] = s.x[row + j];
      g[k] = s.g[row + j];
      p[k] = s.p[row + j];
      ap[k] = s.ap[row + j];
      m[k] = s.m[row + j];
      lo[k] = s.lb[lane * s.lb_stride + j];
      hi[k] = s.ub[lane * s.ub_stride + j];
      pap = add(pap, mul(p[k], mul(m[k], ap[k])));
      af = least(af, box_max_step(x[k], -p[k], lo[k], hi[k]));
    }
  }
  block_sum_least<THREADS>(pap, af);

  const T alpha_cg = quot(rr0, add(pap, s.tiny));
  const T alpha = least(alpha_cg, at_least0(af));

  // Pass 2: x, g, the snap, the mask, r, z and the sums.
  T rr = T(0), ss = T(0);
  bool changed = false;
#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    const int64_t j = threadIdx.x + k * THREADS;
    if (j < n) {
      const T gn = add(g[k], mul(alpha, ap[k]));
      const T xn = box_snap(clip(add(x[k], mul(alpha, p[k])), lo[k], hi[k]), gn, lo[k], hi[k]);
      const T mn = box_free(xn, gn, lo[k], hi[k]);
      changed = changed || mn != m[k];
      const T r = mul(-mn, gn);
      z[k] = mul(mn, s.dinv ? mul(s.dinv[lane * s.dinv_stride + j], r) : r);
      rr = add(rr, mul(r, z[k]));
      const T ri = box_pg_residual(xn, gn, lo[k], hi[k], s.inv_gd);
      ss = add(ss, mul(ri, ri));
      x[k] = xn;
      g[k] = gn;
      m[k] = mn;
    }
  }
  block_sum2_or<THREADS>(rr, ss, changed);

  // The eager body's restart, beta and flags.
  const bool restart = changed || af < alpha_cg;
  const T beta = restart ? T(0) : quot(rr, add(rr0, s.tiny));
  const T res = mul(root(ss), quot(T(1), T(3.0 * (double)n)));
  const bool done = res < s.tol || (int64_t)mv + 1 >= s.budget || rr == T(0);

  // Pass 3: the new direction, and the rows stored.
#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    const int64_t j = threadIdx.x + k * THREADS;
    if (j < n) {
      s.x[row + j] = x[k];
      s.g[row + j] = g[k];
      s.m[row + j] = m[k];
      s.p[row + j] = add(z[k], mul(beta, p[k]));
    }
  }
  if (threadIdx.x == 0) {
    s.rr[lane] = rr;
    s.res[lane] = res;
    s.mv[lane] = mv;
    s.it[lane] += 1;
    s.done[lane] = done;
    s.active[lane] = !done;
  }
}

template <typename T>
int launch(const Step<T>& s, int64_t batch, int64_t threads, cudaStream_t stream) {
  if (batch == 0 || s.n == 0) return 0;
  if (s.n > ELEMS * threads) return (int)cudaErrorInvalidValue;
  switch (threads) {
    case 128: pcg_step_kernel<T, 128><<<(unsigned)batch, 128, 0, stream>>>(s); break;
    case 256: pcg_step_kernel<T, 256><<<(unsigned)batch, 256, 0, stream>>>(s); break;
    case 512: pcg_step_kernel<T, 512><<<(unsigned)batch, 512, 0, stream>>>(s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int box(const void* ap, void* x, void* g, void* m, void* p, void* rr, void* res, void* mv,
        void* it, void* done, void* active, const void* dinv, int64_t dinv_stride,
        const void* lb, int64_t lb_stride, const void* ub, int64_t ub_stride, double gd,
        double tiny, int64_t batch, int64_t n, double tol, int64_t budget, int64_t threads,
        void* stream) {
  // 1 / gd in the state's type, as PyTorch divides by a Python float.
  const Step<T> s{static_cast<const T*>(ap), static_cast<T*>(x), static_cast<T*>(g),
                  static_cast<T*>(m), static_cast<T*>(p), static_cast<T*>(rr),
                  static_cast<T*>(res), static_cast<int32_t*>(mv), static_cast<int32_t*>(it),
                  static_cast<uint8_t*>(done), static_cast<uint8_t*>(active),
                  static_cast<const T*>(dinv), dinv_stride, static_cast<const T*>(lb),
                  lb_stride, static_cast<const T*>(ub), ub_stride, n,
                  T(1) / static_cast<T>(gd), static_cast<T>(tiny), static_cast<T>(tol),
                  budget};
  return launch(s, batch, threads, static_cast<cudaStream_t>(stream));
}

}  // namespace

#define PCG_ARGS                                                                           \
  const void *ap, void *x, void *g, void *m, void *p, void *rr, void *res, void *mv,        \
      void *it, void *done, void *active, const void *dinv, int64_t dinv_stride,            \
      const void *lb, int64_t lb_stride, const void *ub, int64_t ub_stride, double gd,      \
      double tiny, int64_t batch, int64_t n, double tol, int64_t budget, int64_t threads,   \
      void *stream
#define PCG_PASS                                                                           \
  ap, x, g, m, p, rr, res, mv, it, done, active, dinv, dinv_stride, lb, lb_stride, ub,     \
      ub_stride, gd, tiny, batch, n, tol, budget, threads, stream

extern "C" int pcg_step_box_f32(PCG_ARGS) { return box<float>(PCG_PASS); }

extern "C" int pcg_step_box_f64(PCG_ARGS) { return box<double>(PCG_PASS); }
