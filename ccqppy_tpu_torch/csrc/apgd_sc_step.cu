// One iteration of apgd.solve_sc after its GEMV, fused, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the body of solve_sc's
// while_loop as one XLA fusion around its GEMV.  The port ran that body as
// eager PyTorch, ~220 small launches an iteration (two projections, the
// Eq. 25 residual with its normal, activity and apex tests, the restart dot,
// the lane flags and the select of the state), and the host's launches set
// the pace.  Here it is one launch, for a blockwise Lorentz cone (a shared or
// per-block mu) and for a box (bounds shared or per lane); every other set
// keeps the eager body (models/apgd.py).
//
// What bounds it: device-memory bytes, a few flops each.  Per lane it reads
// A v, b, x and y, and writes x, y and v, the next GEMV's input; the trial
// point goes to v between the passes and is read again from L2.
//
// What the design does about it:
//   * One block of THREADS = 128 threads per lane: at 56 registers a
//     thread (f32, Lorentz) 9 blocks fit an SM, so at B = 1024 every block
//     is resident at once (256 threads took two waves and ~20% longer on
//     an H100).  The lane's branch (done, verifying) is uniform within a
//     block, so nothing diverges.
//   * A unit is one Lorentz block of d coordinates (d read at run time) or
//     one coordinate of a box; thread t takes units t, t + THREADS, ...
//     Pass 1, per unit: g = A v + b; the trial point P(w - g / L), w = x
//     on a verifying lane and y otherwise, stored in v;
//     the Eq. 25 residual vector at q = x (verifying) or the trial point,
//     through the set's closed form, summed as squares; the restart dot
//     (y - x1).(x1 - x).  A Lorentz block's projection is fixed by a few
//     numbers (||u||, z, the case), so a unit keeps nothing but those in
//     registers and reads its coordinates again, from L1, where it needs
//     them: one code path for any d and any n.
//   * The two sums are reduced over the block together; every thread then
//     works out the lane's flags from the same sums.
//   * Pass 2, coalesced over the lane's coordinates: x, y and v written in
//     place from the stored trial point.  A lane already done writes only v
//     and keeps every field.
//   * Arithmetic: each operation of the eager body, in its order and in the
//     state's type, rounded as written (step_common.cuh's `mul` and the
//     rest: nvcc never contracts them into an FMA), so every branch test
//     sees the eager body's operands, up to the order of the lane's two long
//     sums.  A division by a Python float is a product with its reciprocal,
//     as PyTorch computes it on the card (the residual's 1 / (3 n), the
//     box's 1 / gd).
//   * Any n and any base alignment: plain scalar loads.  Instances for f32
//     and f64, as the GEMV has.

#include <cstdint>
#include <cuda_runtime.h>

#include "step_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

// The per-lane state, each pointer at lane 0, rows of n.
template <typename T>
struct Step {
  const T* av;             // A v
  const T* b;
  T* x;
  T* y;
  T* v;                    // the next GEMV's input; the trial point between the passes
  T* res;
  int32_t* mv;
  int32_t* it;
  uint8_t* done;           // torch.bool
  uint8_t* verifying;
  const T* L;              // per lane: the step is 1 / L
  const T* beta;           // per lane: the constant momentum
  int64_t n;
  T tol;
  int64_t budget;
  bool restart;
};

// One lane's rows, as pass 1 reads and writes them.
template <typename T>
struct Rows {
  const T* av;
  const T* b;
  const T* x;
  const T* y;
  T* v;
  const T* w;              // where the trial step starts: x (verifying) or y
  const T* q;              // where the residual is taken: x (verifying) or v
  T L;
  bool ver;
};

// ---- Lorentz blocks --------------------------------------------------------

template <typename T>
struct LorentzSet {
  const T* mu;
  int64_t mu_stride;       // 0: one mu for every block; 1: one a block
  int64_t d;

  __device__ int64_t units(int64_t n) const { return n / d; }

  __device__ void pass1(const Rows<T>& r, int64_t k, int64_t, T& ss, T& rd) const {
    const int64_t o = k * d;
    const int dd = (int)d;
    const T m = mu[k * mu_stride];
    const T* av = r.av + o;
    const T* b = r.b + o;
    const T* w = r.w + o;
    T* v = r.v + o;
    auto g = [&](int i) { return add(av[i], b[i]); };
    auto trial = [&](int i) { return sub(w[i], quot(g(i), r.L)); };
    const Cone<T> cp = cone(trial, dd, m);
    for (int i = 0; i < dd; ++i) v[i] = cone_at(cp, trial(i), i == dd - 1);

    // pg_residual_vec at q: -P(-g) at the apex, g - min(n.g, 0) n on the
    // surface, g inside; n = normal(q), taken at P(q) as the eager body does.
    const T* q = r.q + o;
    auto at_q = [&](int i) { return q[i]; };
    const Cone<T> cq = cone(at_q, dd, m);
    const bool apex = cone_apex(cq);
    if (apex) {
      auto neg_g = [&](int i) { return -g(i); };
      const Cone<T> cg = cone(neg_g, dd, m);
      for (int i = 0; i < dd; ++i) {
        const T ri = -cone_at(cg, -g(i), i == dd - 1);
        ss = add(ss, mul(ri, ri));
      }
    } else if (cone_active(cq, m)) {
      auto proj_q = [&](int i) { return cone_at(cq, q[i], i == dd - 1); };
      const Cone<T> cx = cone(proj_q, dd, m);        // xp = P(q): its ||u|| and z
      const bool normal = cone_active(cx, m) && !cone_apex(cx);
      const T denom = root(add(T(1), mul(m, m)));
      auto n_at = [&](int i) -> T {
        if (!normal) return T(0);
        if (i == dd - 1) return quot(-m, denom);
        return quot(cx.un != T(0) ? quot(proj_q(i), cx.un) : T(0), denom);
      };
      T ng = T(0);
      for (int i = 0; i < dd; ++i) ng = add(ng, mul(n_at(i), g(i)));
      const T low = ng != ng ? ng : (ng < T(0) ? ng : T(0));   // clamp(ng, max=0)
      for (int i = 0; i < dd; ++i) {
        const T ri = sub(g(i), mul(low, n_at(i)));
        ss = add(ss, mul(ri, ri));
      }
    } else {
      for (int i = 0; i < dd; ++i) {
        const T gi = g(i);
        ss = add(ss, mul(gi, gi));
      }
    }
    if (!r.ver)
      for (int i = 0; i < dd; ++i)
        rd = add(rd, mul(sub(r.y[o + i], v[i]), sub(v[i], r.x[o + i])));
  }
};

// ---- Box ---------------------------------------------------------------------

template <typename T>
struct BoxSet {
  const T* lb;
  int64_t lb_stride;       // 0: bounds (n,) shared by every lane; n: (B, n)
  const T* ub;
  int64_t ub_stride;
  T inv_gd;                // 1 / gd

  __device__ int64_t units(int64_t n) const { return n; }

  // Bounds are indexed from lane 0.
  __device__ void pass1(const Rows<T>& r, int64_t k, int64_t lane, T& ss, T& rd) const {
    const T lo = lb[lane * lb_stride + k];
    const T hi = ub[lane * ub_stride + k];
    const T g = add(r.av[k], r.b[k]);
    const T t = clip(sub(r.w[k], quot(g, r.L)), lo, hi);
    r.v[k] = t;
    const T ri = box_pg_residual(r.ver ? r.x[k] : t, g, lo, hi, inv_gd);
    ss = add(ss, mul(ri, ri));
    if (!r.ver) rd = add(rd, mul(sub(r.y[k], t), sub(t, r.x[k])));
  }
};

// Sums of a and b over the block; every thread gets the same two values.
template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b) {
  __shared__ T part_a[WARPS], part_b[WARPS];
  for (int off = 16; off > 0; off >>= 1) {
    a = add(a, __shfl_xor_sync(0xffffffffu, a, off));
    b = add(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
  if ((threadIdx.x & 31) == 0) {
    part_a[threadIdx.x >> 5] = a;
    part_b[threadIdx.x >> 5] = b;
  }
  __syncthreads();
  a = part_a[0];
  b = part_b[0];
  for (int w = 1; w < WARPS; ++w) {
    a = add(a, part_a[w]);
    b = add(b, part_b[w]);
  }
}

template <typename T, typename Set>
__global__ void __launch_bounds__(THREADS) apgd_sc_step_kernel(Step<T> s, Set set) {
  const int64_t lane = blockIdx.x;
  const int64_t n = s.n;
  const int64_t row = lane * n;
  T* x = s.x + row;
  T* y = s.y + row;
  T* v = s.v + row;
  const bool ver = s.verifying[lane] != 0;
  if (s.done[lane]) {                // a done lane keeps every field
    for (int64_t j = threadIdx.x; j < n; j += THREADS) v[j] = ver ? x[j] : y[j];
    return;
  }
  // Read before the barrier: thread 0 writes the lane's scalars at the end.
  const int32_t mv = s.mv[lane] + 1;
  const Rows<T> r{s.av + row, s.b + row, x, y, v, ver ? x : y, ver ? x : v, s.L[lane], ver};
  T ss = T(0), rd = T(0);
  const int64_t units = set.units(n);
  for (int64_t k = threadIdx.x; k < units; k += THREADS) set.pass1(r, k, lane, ss, rd);
  block_sum2(ss, rd);                // also orders pass 1's stores before pass 2

  // The eager body's flags.
  const T res = mul(root(ss), quot(T(1), T(3.0 * (double)n)));
  const bool below = res < s.tol;
  const bool done_v = ver && below;
  const bool done = done_v || (int64_t)mv >= s.budget;
  const bool ver_next = !ver && below && !done;
  const T b_eff = s.restart && rd > T(0) ? T(0) : s.beta[lane];

  for (int64_t j = threadIdx.x; j < n; j += THREADS) {
    const T xo = x[j];
    const T t = v[j];
    T xn, yn;
    if (ver) {
      xn = done_v ? xo : t;
      yn = xn;
    } else {
      xn = t;
      yn = add(t, mul(b_eff, sub(t, xo)));
    }
    x[j] = xn;
    y[j] = yn;
    v[j] = ver_next ? xn : yn;
  }
  if (threadIdx.x == 0) {
    s.res[lane] = res;
    s.mv[lane] = mv;
    s.it[lane] += 1;
    s.done[lane] = done;
    s.verifying[lane] = ver_next;
  }
}

template <typename T, typename Set>
int launch(const Step<T>& s, const Set& set, int64_t batch, cudaStream_t stream) {
  if (batch == 0 || s.n == 0) return 0;
  apgd_sc_step_kernel<T, Set><<<(unsigned)batch, THREADS, 0, stream>>>(s, set);
  return (int)cudaGetLastError();
}

template <typename T>
Step<T> step_of(const void* av, const void* b, void* x, void* y, void* v, void* res, void* mv,
                void* it, void* done, void* verifying, const void* L, const void* beta,
                int64_t n, double tol, int64_t budget, int64_t restart) {
  return {static_cast<const T*>(av), static_cast<const T*>(b), static_cast<T*>(x),
          static_cast<T*>(y), static_cast<T*>(v), static_cast<T*>(res),
          static_cast<int32_t*>(mv), static_cast<int32_t*>(it), static_cast<uint8_t*>(done),
          static_cast<uint8_t*>(verifying), static_cast<const T*>(L),
          static_cast<const T*>(beta), n, static_cast<T>(tol), budget, restart != 0};
}

template <typename T>
int lorentz(const void* av, const void* b, void* x, void* y, void* v, void* res, void* mv,
            void* it, void* done, void* verifying, const void* L, const void* beta, const void* mu,
            int64_t mu_stride, int64_t d, int64_t batch, int64_t n, double tol,
            int64_t budget, int64_t restart, void* stream) {
  if (d < 1 || n % d != 0) return (int)cudaErrorInvalidValue;
  const LorentzSet<T> set{static_cast<const T*>(mu), mu_stride, d};
  return launch(step_of<T>(av, b, x, y, v, res, mv, it, done, verifying, L, beta, n, tol,
                           budget, restart),
                set, batch, static_cast<cudaStream_t>(stream));
}

template <typename T>
int box(const void* av, const void* b, void* x, void* y, void* v, void* res, void* mv,
        void* it, void* done, void* verifying, const void* L, const void* beta, const void* lb,
        int64_t lb_stride, const void* ub, int64_t ub_stride, double gd, int64_t batch,
        int64_t n, double tol, int64_t budget, int64_t restart, void* stream) {
  // 1 / gd in the state's type, as PyTorch divides by a Python float.
  const BoxSet<T> set{static_cast<const T*>(lb), lb_stride, static_cast<const T*>(ub),
                      ub_stride, T(1) / static_cast<T>(gd)};
  return launch(step_of<T>(av, b, x, y, v, res, mv, it, done, verifying, L, beta, n, tol,
                           budget, restart),
                set, batch, static_cast<cudaStream_t>(stream));
}

}  // namespace

#define STEP_ARGS                                                                        \
  const void *av, const void *b, void *x, void *y, void *v, void *res, void *mv, void *it, \
      void *done, void *verifying, const void *L, const void *beta
#define STEP_PASS av, b, x, y, v, res, mv, it, done, verifying, L, beta

extern "C" int apgd_sc_step_lorentz_f32(STEP_ARGS, const void* mu, int64_t mu_stride,
                                        int64_t d, int64_t batch, int64_t n, double tol,
                                        int64_t budget, int64_t restart, void* stream) {
  return lorentz<float>(STEP_PASS, mu, mu_stride, d, batch, n, tol, budget, restart, stream);
}

extern "C" int apgd_sc_step_lorentz_f64(STEP_ARGS, const void* mu, int64_t mu_stride,
                                        int64_t d, int64_t batch, int64_t n, double tol,
                                        int64_t budget, int64_t restart, void* stream) {
  return lorentz<double>(STEP_PASS, mu, mu_stride, d, batch, n, tol, budget, restart, stream);
}

extern "C" int apgd_sc_step_box_f32(STEP_ARGS, const void* lb, int64_t lb_stride,
                                    const void* ub, int64_t ub_stride, double gd,
                                    int64_t batch, int64_t n, double tol, int64_t budget,
                                    int64_t restart, void* stream) {
  return box<float>(STEP_PASS, lb, lb_stride, ub, ub_stride, gd, batch, n, tol, budget,
                    restart, stream);
}

extern "C" int apgd_sc_step_box_f64(STEP_ARGS, const void* lb, int64_t lb_stride,
                                    const void* ub, int64_t ub_stride, double gd,
                                    int64_t batch, int64_t n, double tol, int64_t budget,
                                    int64_t restart, void* stream) {
  return box<double>(STEP_PASS, lb, lb_stride, ub, ub_stride, gd, batch, n, tol, budget,
                     restart, stream);
}
