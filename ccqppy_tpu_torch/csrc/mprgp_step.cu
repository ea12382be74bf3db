// One pass of the fused MPRGP loop after its sweep, fused, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the body of the fused MPRGP
// while_loop (models/mprgp.py there) as XLA fusions around its sweep.  The
// port ran that body as eager PyTorch, ~600 small launches a pass (three
// Lorentz projections, two free/chopped splits, the feasible step's
// two-constraint roots, seven dots, the Eq. 25 residual and the four-way
// select of the state), replayed as one CUDA graph a pass; the graph's
// launch and the kernels' latency set the pace.  Here a pass is the sweep
// and one launch, for a blockwise Lorentz cone (a shared or per-block mu);
// every other set keeps the eager body (models/mprgp.py).
//
// What it computes, per lane and in place on the loop's state, from the
// sweep's f64 A v: the branch the lane took when its operand was chosen
// (an expansion's finish or a claim's verification, CG or expansion,
// proportioning), the branch's secant or CG step sizes and the feasible
// step, the new x, g, p, alpha_bb (and x_prev, g_prev after an expansion),
// the Eq. 25 residual, res, done, pending, verifying, mv and it; then what
// the next pass needs before its sweep: the free part psi of the new
// (x, g) (kept in its own row), the proportioning test (a lane flag), and
// the next operand v = x (a finish or a verification owed), p
// (proportional) or P(x - alpha_bb g), in f64, the sweep's input.  A lane
// already done keeps every field.  A second mode computes only that last
// part, from the state as it stands: the first operand of a loop.
//
// What bounds it: device-memory bytes, a few dozen operations each, and at
// B = 1 the latency of a lane's passes.  Per lane it reads A v (8 bytes a
// coordinate), b, x, g, p, psi and one of x_prev/g_prev or v, and writes x,
// g, p, psi and v: ~60 n bytes, all from L2 at the widths the loop runs.
//
// What the design does about it:
//   * The blocks a lane takes follow from B, the SM count and n / d (the
//     wrapper picks; ops/mprgp_step.py): one block of 128 threads a lane
//     (at B = 1024, n = 999 every block is resident at once), or, where a
//     lane carries 2048 Lorentz blocks or more and eight SMs a lane are
//     free, a thread block cluster of eight blocks of 256 threads (B = 1,
//     n = 9999: 0.022 ms a pass on an H100, where one block of 1024 threads
//     took 0.051 ms, the latency of three passes over 3,333 units on one
//     SM, and one of 128 took 0.187 ms).  A cluster's blocks share the
//     lane's units and its sums: each block's totals go to its shared
//     memory, and every block adds all of them in rank order after a
//     cluster barrier, so that every thread of the lane holds the same
//     values.  A lane's branch is uniform
//     across its blocks, so nothing diverges, and only the branch's own
//     values are computed: the eager body computes all four and selects.
//   * A unit is one Lorentz block of d coordinates (d read at run time);
//     thread t of a lane's block r takes units r THREADS + t, then every
//     CLUSTER THREADS, in every pass, so that a thread reads back only what
//     it wrote itself.  A projection is fixed by a few numbers (||u||, z,
//     the case), so a unit keeps those in registers and reads its
//     coordinates again, from L1, where it needs them.
//   * Three passes over the lane, two lane reductions between them:
//     pass 1 the branch's dots (p.Av, psi.p, p.p and the feasible step's
//     min over blocks; or the secant pair's two dots); pass 2 the new x
//     and g, written in place, and the split of (x, g) into psi (written)
//     and chopped part, with the residual's, psi's, the chopped part's and
//     psi.Av's sums; pass 3 p and the next operand.
//   * Arithmetic: each operation of the eager body, in its order and in the
//     state's type, rounded as written (step_common.cuh's `mul` and the
//     rest: nvcc never contracts them into an FMA), so every test sees the
//     eager body's operands, up to the order of a lane's long sums.  A
//     division by a Python float is a product with its reciprocal, as
//     PyTorch computes it on the card (the residual's 1 / (3 n)).  The sweep's A v is rounded
//     to the state's type, and A v + b summed in f64 and then rounded, as
//     models/mprgp.py's _sweep does.
//   * Any n and any base alignment: plain scalar loads.  Instances for f32
//     and f64 state; A v and v are f64 in both.

#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "step_common.cuh"

namespace {

constexpr int STEP = 0;        // a whole pass after the sweep
constexpr int OPERAND = 1;     // the next operand only, from the state as it stands
constexpr int FIN = 0, CGX = 1, CG = 2, EX = 3, PP = 4;  // a lane's branch
// f64 to the state's type, to nearest, as Tensor.to does.
template <typename T>
__device__ __forceinline__ T narrow(double a);
template <>
__device__ __forceinline__ float narrow<float>(double a) { return __double2float_rn(a); }
template <>
__device__ __forceinline__ double narrow<double>(double a) { return a; }

// ---- Lorentz blocks ------------------------------------------------------------

// free_chopped and pg_residual_vec of one block at (x, g), which share the
// normal of P(x) and its tests: calls each(i, free_i, chopped_i, r_i).
template <typename T, typename X, typename G, typename F>
__device__ __forceinline__ void split(X x, G g, int d, T mu, F each) {
  const Cone<T> cx = cone(x, d, mu);
  const bool apex = cone_apex(cx);
  if (apex) {              // free 0; chopped and residual -P(-g)
    auto neg_g = [&](int i) { return -g(i); };
    const Cone<T> cg = cone(neg_g, d, mu);
    for (int i = 0; i < d; ++i) {
      const T ri = -cone_at(cg, -g(i), i == d - 1);
      each(i, T(0), ri, ri);
    }
    return;
  }
  if (!cone_active(cx, mu)) {  // inside: free g, chopped 0, residual g
    for (int i = 0; i < d; ++i) {
      const T gi = g(i);
      each(i, gi, T(0), gi);
    }
    return;
  }
  // On the surface: n = normal(x), taken at P(x) as the eager body does.
  auto px = [&](int i) { return cone_at(cx, x(i), i == d - 1); };
  const Cone<T> cp = cone(px, d, mu);
  const bool normal = cone_active(cp, mu) && !cone_apex(cp);
  const T denom = root(add(T(1), mul(mu, mu)));
  auto n_at = [&](int i) -> T {
    if (!normal) return T(0);
    if (i == d - 1) return quot(-mu, denom);
    return quot(cp.un != T(0) ? quot(px(i), cp.un) : T(0), denom);
  };
  T ng = T(0);
  for (int i = 0; i < d; ++i) ng = add(ng, mul(n_at(i), g(i)));
  const T up = at_least0(ng), down = at_most0(ng);
  for (int i = 0; i < d; ++i) {
    const T ni = n_at(i), gi = g(i);
    each(i, sub(gi, mul(ng, ni)), mul(up, ni), sub(gi, mul(down, ni)));
  }
}

// _min_positive_root: the smallest t >= 0 with a t^2 + b t + c < 0 beyond it.
template <typename T>
__device__ __forceinline__ T min_positive_root(T a, T b, T c) {
  const T inf = T(INFINITY);
  const T lin = b < T(0) ? quot(-c, b) : inf;
  const T disc = sub(mul(b, b), mul(mul(T(4), a), c));
  const T sq = root(at_least0(disc));
  const T a2 = mul(T(2), a);
  const T r1 = a2 != T(0) ? quot(sub(-b, sq), a2) : inf;
  const T r2 = a2 != T(0) ? quot(add(-b, sq), a2) : inf;
  const T up = disc <= T(0) ? inf : (r1 >= T(0) ? r1 : inf);
  const T down = at_least0(most(r1, r2));
  return a == T(0) ? lin : (a > T(0) ? up : down);
}

// LorentzConeProj.max_feasible_step of one block: the largest t with
// x - t p in the cone.
template <typename T>
__device__ __forceinline__ T feasible(const T* x, const T* p, int d, T mu) {
  T pp = T(0), up = T(0), uu = T(0);
  for (int i = 0; i < d - 1; ++i) {
    pp = add(pp, mul(p[i], p[i]));
    up = add(up, mul(x[i], p[i]));
    uu = add(uu, mul(x[i], x[i]));
  }
  const T z = x[d - 1], pz = p[d - 1];
  const T mu2 = mul(mu, mu);
  const T qa = sub(mul(mul(mu2, pz), pz), pp);
  const T qb = add(mul(mul(mul(mu2, T(-2)), z), pz), mul(T(2), up));
  const T qc = sub(mul(mul(mu2, z), z), uu);
  const T zcap = pz > T(0) ? quot(z, pz) : T(INFINITY);
  return least(min_positive_root(qa, qb, qc), zcap);
}

// ---- the lane ------------------------------------------------------------------

// The loop's state, each pointer at lane 0, rows of n.
template <typename T>
struct State {
  const double* av;        // A v, f64
  const T* b;
  T* x;
  T* g;
  T* p;
  T* x_prev;
  T* g_prev;
  T* psi;                  // free part of (x, g), for the next pass
  double* v;               // the sweep's operand
  T* alpha;                // alpha_bb
  T* res;
  int32_t* mv;
  int32_t* it;
  uint8_t* done;           // torch.bool
  uint8_t* pending;
  uint8_t* verifying;
  uint8_t* prop;           // the proportioning test at (x, g)
  const T* mu;
  int64_t mu_stride;       // 0: one mu for every block; 1: one a block
  int64_t d;
  int64_t n;
  T tol;
  int64_t budget;
  T gamma2;
  T tiny;
};

// The part of a lane one thread takes: a lane's CLUSTER blocks (a thread
// block cluster where CLUSTER > 1) share its units, thread t of block r
// taking units r THREADS + t, then every CLUSTER THREADS.
template <int CLUSTER>
__device__ __forceinline__ int rank_in_lane() {
  if constexpr (CLUSTER > 1)
    return (int)cooperative_groups::this_cluster().block_rank();
  else
    return 0;
}

template <int THREADS, int CLUSTER>
struct Part {
  int64_t first;           // this thread's first unit
  static constexpr int64_t stride = (int64_t)CLUSTER * THREADS;
};

// Sums of s[0..K) (and the least of *mn) over the lane's threads, through
// part ((K + 1) x WARPS) and, across a cluster, tot (K + 1) of every block
// in rank order; every thread gets the same values.
template <typename T, int THREADS, int CLUSTER, int K>
__device__ __forceinline__ void lane_reduce(T (&s)[K], T* mn, T* part, T* tot) {
  constexpr int WARPS = (THREADS + 31) / 32;
  for (int off = 16; off > 0; off >>= 1) {
    for (int j = 0; j < K; ++j) s[j] = add(s[j], __shfl_xor_sync(0xffffffffu, s[j], off));
    if (mn) *mn = least(*mn, __shfl_xor_sync(0xffffffffu, *mn, off));
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    for (int j = 0; j < K; ++j) part[j * WARPS + w] = s[j];
    if (mn) part[K * WARPS + w] = *mn;
  }
  __syncthreads();
  for (int j = 0; j < K; ++j) {
    T a = part[j * WARPS];
    for (int i = 1; i < WARPS; ++i) a = add(a, part[j * WARPS + i]);
    s[j] = a;
  }
  if (mn) {
    T a = part[K * WARPS];
    for (int i = 1; i < WARPS; ++i) a = least(a, part[K * WARPS + i]);
    *mn = a;
  }
  if constexpr (CLUSTER > 1) {
    // Each block's totals in its shared memory, read by every block of the
    // cluster once all are written.  tot is not written again in this
    // launch, and no block exits before the cluster's last barrier.
    auto cluster = cooperative_groups::this_cluster();
    if (threadIdx.x == 0) {
      for (int j = 0; j < K; ++j) tot[j] = s[j];
      if (mn) tot[K] = *mn;
    }
    cluster.sync();
    for (int j = 0; j < K; ++j) {
      T a = cluster.map_shared_rank(tot, 0)[j];
      for (int r = 1; r < CLUSTER; ++r) a = add(a, cluster.map_shared_rank(tot, r)[j]);
      s[j] = a;
    }
    if (mn) {
      T a = cluster.map_shared_rank(tot, 0)[K];
      for (int r = 1; r < CLUSTER; ++r) a = least(a, cluster.map_shared_rank(tot, r)[K]);
      *mn = a;
    }
  }
}

// Every block of the lane's cluster is done reading the others' shared
// memory: the last barrier before a block exits.
template <int CLUSTER>
__device__ __forceinline__ void lane_done() {
  if constexpr (CLUSTER > 1) cooperative_groups::this_cluster().sync();
}

// The split of this thread's units of the lane at (x, g), psi written: adds
// psi.psi to sums[0] and chopped.chopped to sums[1], and, with av, the
// residual's r.r to sums[2] and psi.Av to sums[3].
template <typename T, int THREADS, int CLUSTER, int K>
__device__ __forceinline__ void split_lane(const State<T>& s, int64_t row,
                                           Part<THREADS, CLUSTER> part, const double* av,
                                           T (&sums)[K]) {
  const int d = (int)s.d;
  const int64_t units = s.n / s.d;
  for (int64_t k = part.first; k < units; k += part.stride) {
    const int64_t o = row + k * d;
    const T* x = s.x + o;
    const T* g = s.g + o;
    T* psi = s.psi + o;
    split(
        [&](int i) { return x[i]; }, [&](int i) { return g[i]; }, d, s.mu[k * s.mu_stride],
        [&](int i, T f, T c, T r) {
          psi[i] = f;
          sums[0] = add(sums[0], mul(f, f));
          sums[1] = add(sums[1], mul(c, c));
          if constexpr (K > 2) {
            sums[2] = add(sums[2], mul(r, r));
            sums[3] = add(sums[3], mul(f, narrow<T>(av[o + i])));
          }
        });
  }
}

// The next operand at this thread's units: x where a finish or a
// verification is owed, p on a proportional lane, else P(x - alpha g).
template <typename T, int THREADS, int CLUSTER>
__device__ __forceinline__ void operand(const State<T>& s, int64_t row,
                                        Part<THREADS, CLUSTER> part, bool owed, bool prop,
                                        T alpha) {
  const int d = (int)s.d;
  const int64_t units = s.n / s.d;
  for (int64_t k = part.first; k < units; k += part.stride) {
    const int64_t o = row + k * d;
    if (owed || prop) {
      const T* w = (owed ? s.x : s.p) + o;
      for (int i = 0; i < d; ++i) s.v[o + i] = (double)w[i];
      continue;
    }
    const T* x = s.x + o;
    const T* g = s.g + o;
    auto y = [&](int i) { return sub(x[i], mul(alpha, g[i])); };
    const Cone<T> c = cone(y, d, s.mu[k * s.mu_stride]);
    for (int i = 0; i < d; ++i) s.v[o + i] = (double)cone_at(c, y(i), i == d - 1);
  }
}

template <typename T, int THREADS, int CLUSTER>
__global__ void __launch_bounds__(THREADS) mprgp_step_kernel(State<T> s, int mode) {
  constexpr int WARPS = (THREADS + 31) / 32;
  __shared__ T part[2][5 * WARPS];
  __shared__ T tot[2][5];
  const int rank = rank_in_lane<CLUSTER>();
  const Part<THREADS, CLUSTER> mine{(int64_t)rank * THREADS + threadIdx.x};
  const int64_t lane = blockIdx.x / CLUSTER;
  const int64_t n = s.n;
  const int64_t row = lane * n;
  const int d = (int)s.d;
  const int64_t units = n / s.d;
  const bool owed = s.pending[lane] || s.verifying[lane];
  const T alpha = s.alpha[lane];
  const bool lead = rank == 0 && threadIdx.x == 0;   // writes the lane's scalars
  if (s.done[lane]) {        // a done lane keeps every field
    if (mode == OPERAND) operand<T, THREADS, CLUSTER>(s, row, mine, true, false, alpha);
    return;
  }
  if (mode == OPERAND) {
    T sums[2] = {T(0), T(0)};
    split_lane<T, THREADS, CLUSTER>(s, row, mine, nullptr, sums);
    lane_reduce<T, THREADS, CLUSTER>(sums, nullptr, part[0], tot[0]);
    const bool prop = sums[1] < mul(s.gamma2, sums[0]);
    operand<T, THREADS, CLUSTER>(s, row, mine, owed, prop, alpha);
    if (lead) s.prop[lane] = prop;
    lane_done<CLUSTER>();
    return;
  }

  // Read before the first barrier: the lead thread writes the lane's
  // scalars after the last.
  const bool ver = s.verifying[lane] != 0;
  const int br = owed ? FIN : (s.prop[lane] ? CGX : PP);
  const T res_old = s.res[lane];
  const int32_t mv = s.mv[lane] + 1;
  const int32_t it = s.it[lane];
  const double* av = s.av + row;
  const T* b = s.b + row;
  T* x = s.x + row;
  T* g = s.g + row;
  T* p = s.p + row;
  T* x_prev = s.x_prev + row;
  T* g_prev = s.g_prev + row;
  T* psi = s.psi + row;
  double* v = s.v + row;

  // ---- pass 1: the branch's dots ------------------------------------------
  T r1[3] = {T(0), T(0), T(0)};
  T mn = T(INFINITY);
  for (int64_t k = mine.first; k < units; k += mine.stride) {
    const int64_t o = k * d;
    if (br == CGX) {       // p.Av, psi.p, p.p; the feasible step's min over blocks
      for (int i = 0; i < d; ++i) {
        const T pi = p[o + i];
        r1[0] = add(r1[0], mul(pi, narrow<T>(av[o + i])));
        r1[1] = add(r1[1], mul(psi[o + i], pi));
        r1[2] = add(r1[2], mul(pi, pi));
      }
      mn = least(mn, feasible(x + o, p + o, d, s.mu[k * s.mu_stride]));
    } else {               // the secant pair: x - x_prev and g_fin - g_prev (a
                           // finish), or x_prop - x and g_pp - g (proportioning)
      for (int i = 0; i < d; ++i) {
        const int64_t j = o + i;
        const T gj = narrow<T>(add(av[j], (double)b[j]));
        const T dx = br == FIN ? sub(x[j], x_prev[j]) : sub(narrow<T>(v[j]), x[j]);
        const T dg = br == FIN ? sub(gj, g_prev[j]) : sub(gj, g[j]);
        r1[0] = add(r1[0], mul(dx, dx));
        r1[1] = add(r1[1], mul(dx, dg));
      }
    }
  }
  lane_reduce<T, THREADS, CLUSTER>(r1, &mn, part[0], tot[0]);

  // The branch's step sizes.
  T a1 = alpha, pAp = T(0), acg = T(0), af = T(0), acgbb = T(0);
  int bn = br;
  if (br == CGX) {
    pAp = add(r1[0], s.tiny);
    acg = quot(r1[1], pAp);
    af = mn;
    acgbb = quot(r1[2], pAp);
    bn = acg <= af ? CG : EX;
    if (bn == CG) a1 = acgbb;
  } else if (!ver) {       // a verification keeps the carried step
    a1 = quot(r1[0], add(r1[1], s.tiny));
  }
  // A budget exit on an expansion keeps the pre-expansion iterate.
  const bool keep_x = bn == EX && (int64_t)mv >= s.budget;

  // ---- pass 2: the new x and g in place, then the split of (x, g) -------------
  for (int64_t k = mine.first; k < units; k += mine.stride) {
    const int64_t o = k * d;
    if (bn == EX) {        // P(xh - a_cgbb gh), xh = x - alpha_f p, gh = g - alpha_f Av
      auto gh = [&](int i) { return sub(g[o + i], mul(af, narrow<T>(av[o + i]))); };
      auto w = [&](int i) { return sub(sub(x[o + i], mul(af, p[o + i])), mul(acgbb, gh(i))); };
      const Cone<T> c = cone(w, d, s.mu[k * s.mu_stride]);
      for (int i = 0; i < d; ++i) {
        const T xe = cone_at(c, w(i), i == d - 1);
        const T ghi = gh(i);
        x_prev[o + i] = x[o + i];
        g_prev[o + i] = g[o + i];
        if (!keep_x) x[o + i] = xe;
        g[o + i] = ghi;
      }
    } else {
      for (int i = 0; i < d; ++i) {
        const int64_t j = o + i;
        if (bn == CG) {
          x[j] = sub(x[j], mul(acg, p[j]));
          g[j] = sub(g[j], mul(acg, narrow<T>(av[j])));
        } else {
          if (bn == PP) x[j] = narrow<T>(v[j]);
          g[j] = narrow<T>(add(av[j], (double)b[j]));
        }
      }
    }
  }
  // Each thread splits the units it wrote: no barrier needed between.
  T r2[4] = {T(0), T(0), T(0), T(0)};
  split_lane<T, THREADS, CLUSTER>(s, row, mine, s.av, r2);
  lane_reduce<T, THREADS, CLUSTER>(r2, nullptr, part[1], tot[1]);

  // The flags.
  const T res1 = mul(root(r2[2]), quot(T(1), T(3.0 * (double)n)));
  const T res = bn == EX ? res_old : res1;
  const bool done = ((res < s.tol) && (bn == FIN || bn == PP)) || (int64_t)mv >= s.budget;
  const bool ver1 = bn == CG && res1 < s.tol && !done;
  const bool pend1 = bn == EX && !done;
  const bool prop1 = r2[1] < mul(s.gamma2, r2[0]);
  const T bcg = quot(r2[3], pAp);

  // ---- pass 3: p, then the next operand, at this thread's units -----------------
  for (int64_t k = mine.first; k < units; k += mine.stride)
    for (int64_t j = k * d; j < (k + 1) * d; ++j)
      p[j] = bn == CG ? sub(psi[j], mul(bcg, p[j])) : (bn == EX ? T(0) : psi[j]);
  operand<T, THREADS, CLUSTER>(s, row, mine, pend1 || ver1, prop1, a1);
  if (lead) {
    s.alpha[lane] = a1;
    s.res[lane] = res;
    s.mv[lane] = mv;
    s.it[lane] = it + 1;
    s.done[lane] = done;
    s.pending[lane] = pend1;
    s.verifying[lane] = ver1;
    s.prop[lane] = prop1;
  }
  lane_done<CLUSTER>();
}

// ---- launchers ------------------------------------------------------------------

template <typename T, int THREADS, int CLUSTER>
int launch_as(const State<T>& s, int64_t batch, int mode, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * CLUSTER));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, mprgp_step_kernel<T, THREADS, CLUSTER>, s, mode);
}

// (threads, cluster): (128, 1), or (256, 8) where eight SMs a lane are free.
template <typename T>
int launch(const State<T>& s, int64_t batch, int64_t mode, int64_t threads, int64_t cluster,
           cudaStream_t stream) {
  if (s.d < 1 || s.n % s.d != 0 || (mode != STEP && mode != OPERAND))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || s.n == 0) return 0;
  int err;
  if (threads == 128 && cluster == 1)
    err = launch_as<T, 128, 1>(s, batch, (int)mode, stream);
  else if (threads == 256 && cluster == 8)
    err = launch_as<T, 256, 8>(s, batch, (int)mode, stream);
  else
    return (int)cudaErrorInvalidValue;
  return err != 0 ? err : (int)cudaGetLastError();
}

template <typename T>
int lorentz(const void* av, const void* b, void* x, void* g, void* p, void* x_prev,
            void* g_prev, void* psi, void* v, void* alpha, void* res, void* mv, void* it,
            void* done, void* pending, void* verifying, void* prop, const void* mu,
            int64_t mu_stride, int64_t d, int64_t batch, int64_t n, double tol, int64_t budget,
            double gamma2, double tiny, int64_t mode, int64_t threads, int64_t cluster,
            void* stream) {
  // tol, gamma^2 and tiny in the state's type, as PyTorch takes a Python float.
  const State<T> s{static_cast<const double*>(av), static_cast<const T*>(b),
                   static_cast<T*>(x), static_cast<T*>(g), static_cast<T*>(p),
                   static_cast<T*>(x_prev), static_cast<T*>(g_prev), static_cast<T*>(psi),
                   static_cast<double*>(v), static_cast<T*>(alpha), static_cast<T*>(res),
                   static_cast<int32_t*>(mv), static_cast<int32_t*>(it),
                   static_cast<uint8_t*>(done), static_cast<uint8_t*>(pending),
                   static_cast<uint8_t*>(verifying), static_cast<uint8_t*>(prop),
                   static_cast<const T*>(mu), mu_stride, d, n, static_cast<T>(tol), budget,
                   static_cast<T>(gamma2), static_cast<T>(tiny)};
  return launch(s, batch, mode, threads, cluster, static_cast<cudaStream_t>(stream));
}

}  // namespace

#define MPRGP_ARGS                                                                        \
  const void *av, const void *b, void *x, void *g, void *p, void *x_prev, void *g_prev,     \
      void *psi, void *v, void *alpha, void *res, void *mv, void *it, void *done,           \
      void *pending, void *verifying, void *prop, const void *mu, int64_t mu_stride,        \
      int64_t d, int64_t batch, int64_t n, double tol, int64_t budget, double gamma2,       \
      double tiny, int64_t mode, int64_t threads, int64_t cluster, void *stream
#define MPRGP_PASS                                                                        \
  av, b, x, g, p, x_prev, g_prev, psi, v, alpha, res, mv, it, done, pending, verifying, prop, \
      mu, mu_stride, d, batch, n, tol, budget, gamma2, tiny, mode, threads, cluster, stream

extern "C" int mprgp_step_lorentz_f32(MPRGP_ARGS) { return lorentz<float>(MPRGP_PASS); }

extern "C" int mprgp_step_lorentz_f64(MPRGP_ARGS) { return lorentz<double>(MPRGP_PASS); }
