// Batched dense GEMV  y[b] = A[b] @ x[b]  for Hopper (sm_90a).
//
// Replaces the TPU kernel `batched_gemv` in ccqppy_tpu/ops/pallas_kernels.py
// (a Pallas grid of (batch, row-tile) steps, each an MXU dot of a VMEM row
// tile at HIGHEST precision).
//
// Four instances, (A, x = y = sums): (f32, f32), (bf16, f32), (f64, f64)
// and (f32, f64).  The TPU kernel has the first two; the JAX package
// computes an f64 GEMV with an XLA dot, and the f64 instance carries it
// here (the f64 DenseOperator and the exact sweep of the f64-exact rung).
// The last is MPRGP's sweep below f64 (its loop's and its audit's): an f32
// stack times an f64 x with f64 sums, each product of an f32 element and an
// f64 value rounded once in the fused multiply-add, so A x of an f32
// iterate comes out as an f64 audit computes it (up to the order of the f64
// sums), at the f32 sweep's bytes.
//
// What bounds it: device-memory bytes.  Every element of A is read once and
// used for one multiply-add (2 flops per 4 bytes in f32, per 2 bytes in
// bf16, per 8 bytes in f64), far below the card's ridge point (in f64 too:
// 2 flops per 8 bytes at 3.35 TB/s is 0.84 TFLOP/s of the 33.5 the card
// does outside the tensor cores), so the kernel's one job is to keep
// enough bytes of A in flight to stream it at full bandwidth, with few
// instructions per byte.  x and y are n elements per problem against n*n
// elements of A.
//
// What the design does about it: one warp-specialised, persistent pipeline
// of asynchronous bulk copies, the same code for every n, dtype and base
// alignment.
//   * Work units: (problem b, block of R consecutive rows), numbered b-major
//     so that neighbouring units read neighbouring memory and share x[b].
//     Columns are walked in tiles of C = min(n, cmax) elements, cmax being
//     4 KB of a row of A; a stage is one (unit, column tile).
//   * Persistent 1-D grid: as many blocks as fit on the card at once (SM
//     count times the blocks per SM that the shared memory allows); block
//     k takes units k, k + gridDim.x, ...  Nothing waits for a block launch
//     and no grid dimension caps the batch.
//   * One producer warp: for each stage it registers the stage's exact byte
//     count on the stage's `full` mbarrier, then its lanes issue one
//     `cp.async.bulk` each: the R row segments A[b, r, c0:c0+C] and the x
//     segment x[b, c0:c0+C].  Each copy covers the 16-byte aligned span that
//     encloses the segment, so address and size are multiples of 16 at any n
//     and base; the consumers read element j at slot + shift + j.  A ring of
//     up to MAX_STAGES stages (full and empty mbarriers, phase parity
//     flipping on each wrap), as many as the shared memory holds, keeps the
//     next stages in flight while the consumers read the oldest: at n = 1000
//     f32 a stage is 68 KB and 3 fit, one block per SM, so up to 128 KB of A
//     is in flight per SM where the card needs ~20 KB (3.35 TB/s times
//     ~0.8 us over 132 SMs).  In f64 a tile is 512 columns and a stage at
//     n = 1000 is again 68 KB.  A geometry of its own for f64 (whole rows of
//     8 KB a tile, 8 rows a unit, 4 or 8 consumer warps: one contiguous 64 KB
//     span a stage) streamed no faster on an H100: within 0.5% of this one
//     at (B, n) = (64, 1000) and (1024, 1000), device-only
//     (tools/gemv_f64_candidates.py).
//   * The enclosing span may reach past either end of A or x: each copy is
//     clipped to the tensor's 16-byte aligned interior, and the consumers
//     read the at most 16 / sizeof(T) - 1 elements at each end of the tensor
//     that fall outside it with plain loads.  A copy clipped to nothing is
//     not issued and not counted.  The arithmetic is the same either way.
//   * Consumer warps (R / CONSUMERS = 2 rows each, so each x element read
//     from shared memory serves two rows): lane l sums the elements
//     j = l (mod 32) of its rows in increasing j with a fused multiply-add
//     in the sums' type (`fmaf`, or `fma` in f64), carried in registers
//     across the column tiles, then a warp-shuffle reduction.  The order
//     depends only on j, so y is bitwise the same whatever the base
//     alignment of A and x, and from launch to launch.  No tensor cores, no
//     TF32, no atomics: the solver's convergence decisions rest on exact
//     fp32 (f64) products.
//   * A wrong byte count on a `full` barrier would hang the kernel.  The
//     waits are plain spins all the same: bounding each with a clock and
//     `__trap()` cost nothing in f32 but 3.9% in bf16 (1.5766 against
//     1.5175 ms at B = 2048, n = 1000).  The card tests hold the byte counts
//     at every n, alignment and tensor end instead.
//
// bf16 A follows the TPU kernel: x is rounded to bf16 where it is read, each
// product of two bf16 values is exact in fp32, and accumulation is fp32.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, medians
// of 8 interleaved rounds of 25 launches, this code against `einsum`, by a
// timer that held the host's enqueue too (PERF.md has the device-only
// table):
// f32 (B, n) = (2048, 1000) 2.7262 ms (3004.9 GB/s) against 2.8358 ms;
// (1024, 999) 1.3562 ms (3014.1 GB/s) against 1.3716 ms; (120, 1000)
// 0.1798 against 0.1988 ms; (41, 999) 0.0755 against 0.0815 ms; bf16 A
// (2048, 1000) 1.5175 ms (2699.2 GB/s).  PERF.md has the paired table.
//
// Offsets are 64-bit: b * n * n passes 2^31 at B > 2147 for n = 1000.
// The kernel allocates nothing; it launches on the caller's stream and
// returns the CUDA error of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 16;                    // rows per work unit
constexpr int CONSUMERS = 8;             // consumer warps; one producer warp besides
constexpr int ROWS_PER_WARP = R / CONSUMERS;
constexpr int THREADS = (CONSUMERS + 1) * 32;
constexpr int MAX_STAGES = 4;
constexpr int RING_OFFSET = 128;         // the mbarriers sit below the ring
constexpr int MAX_DEVICES = 64;
static_assert(R % CONSUMERS == 0 && R < 32, "R rows and x: one producer lane each");
static_assert(2 * MAX_STAGES * 8 <= RING_OFFSET, "mbarriers overlap the ring");

__host__ __device__ constexpr uint64_t align16(uint64_t v) { return (v + 15) & ~uint64_t(15); }

// Columns per tile: 4 KB of a row of A.  A multiple of 32, so lane l keeps
// the columns = l (mod 32) from tile to tile.
template <typename T> constexpr int64_t cmax() { return 4096 / sizeof(T); }

// A ring slot holds the 16-byte aligned span around a segment of C
// elements; a stage is R row slots of A (elements T) and one slot of x
// (elements X).
template <typename T> __host__ __device__ constexpr uint32_t slot_bytes(int64_t C) {
  return (uint32_t)align16(C * sizeof(T)) + 16;
}
template <typename T, typename X> __host__ __device__ constexpr uint32_t stage_bytes(int64_t C) {
  return R * slot_bytes<T>(C) + slot_bytes<X>(C);
}
constexpr int H100_SMEM_OPTIN = 232448;  // bytes of shared memory a block may use
static_assert(RING_OFFSET + 3 * stage_bytes<float, float>(cmax<float>()) <= H100_SMEM_OPTIN &&
              RING_OFFSET + 3 * stage_bytes<__nv_bfloat16, float>(cmax<__nv_bfloat16>()) <=
                  H100_SMEM_OPTIN &&
              RING_OFFSET + 3 * stage_bytes<double, double>(cmax<double>()) <=
                  H100_SMEM_OPTIN &&
              RING_OFFSET + 3 * stage_bytes<float, double>(cmax<float>()) <= H100_SMEM_OPTIN,
              "three stages of the widest tile fit in a block's shared memory");

// An element of A in the sums' type.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

// x as the product sees it: as it is for f32 or f64 A, rounded to bf16 for
// bf16 A.
__device__ __forceinline__ float x_for(float v, float) { return v; }
__device__ __forceinline__ float x_for(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ double x_for(double v, double) { return v; }
__device__ __forceinline__ double x_for(double v, float) { return v; }

// acc + a * b, rounded once; an f32 element of A against f64 sums is
// widened exactly first.
__device__ __forceinline__ float madd(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ double madd(double a, double b, double acc) { return fma(a, b, acc); }
__device__ __forceinline__ double madd(float a, double b, double acc) {
  return fma((double)a, b, acc);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of `bar` with the given parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  while (!bar_try_wait(addr, parity)) {
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// A tensor's 16-byte aligned interior [lo, hi), as addresses; empty (lo >= hi)
// for a tensor that holds no aligned 16 bytes.
struct Interior {
  uint64_t lo, hi;
};

__device__ __forceinline__ Interior interior(const void* base, uint64_t bytes) {
  const uint64_t a = reinterpret_cast<uint64_t>(base);
  return {align16(a), (a + bytes) & ~uint64_t(15)};
}

// The part of the aligned span enclosing [p, p + bytes) that lies in the
// interior: where it goes in the slot (offset from the span's start), and
// its size; 0 bytes when nothing is left.
struct Span {
  uint64_t src;
  uint32_t offset, bytes;
};

__device__ __forceinline__ Span clip(const void* p, uint64_t bytes, Interior in) {
  const uint64_t a = reinterpret_cast<uint64_t>(p);
  const uint64_t s0 = a & ~uint64_t(15), s1 = align16(a + bytes);
  const uint64_t c0 = s0 > in.lo ? s0 : in.lo, c1 = s1 < in.hi ? s1 : in.hi;
  return {c0, (uint32_t)(c0 - s0), c1 > c0 ? (uint32_t)(c1 - c0) : 0u};
}

// The elements [j0, j1) of a segment at p, of len elements of size sz, that
// lie in the interior and so were copied; the others are read from memory.
__device__ __forceinline__ void copied_range(const void* p, int sz, int len, Interior in,
                                             int& j0, int& j1) {
  const int64_t a = (int64_t)reinterpret_cast<uint64_t>(p);
  const int64_t lo = ((int64_t)in.lo - a) / sz, hi = ((int64_t)in.hi - a) / sz;
  j0 = (int)(lo < 0 ? 0 : lo < len ? lo : len);
  j1 = (int)(hi < j0 ? j0 : hi < len ? hi : len);
}

// One warp's rows of one stage: lane l adds A[row, j] x[j] for j = l (mod 32)
// in increasing j.  EDGE reads the elements outside [j0, j1) from memory;
// it gives the same sums, and runs only at the ends of A and x.
template <typename T, typename X, bool EDGE>
__device__ __forceinline__ void dot_rows(const T* const (&sa)[ROWS_PER_WARP],
                                         const T* const (&ga)[ROWS_PER_WARP],
                                         const int (&aj0)[ROWS_PER_WARP],
                                         const int (&aj1)[ROWS_PER_WARP],
                                         const X* sx, const X* gx, int xj0, int xj1,
                                         int len, int lane, X (&acc)[ROWS_PER_WARP]) {
#pragma unroll 4
  for (int j = lane; j < len; j += 32) {
    X xv = sx[j];
    if (EDGE && (j < xj0 || j >= xj1)) xv = gx[j];
    xv = x_for(xv, T());
#pragma unroll
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
      T av = sa[k][j];
      if (EDGE && (j < aj0[k] || j >= aj1[k])) av = ga[k][j];
      acc[k] = madd(widen(av), xv, acc[k]);
    }
  }
}

template <typename T, typename X>
__global__ void __launch_bounds__(THREADS)
batched_gemv_kernel(const T* __restrict__ A, const X* __restrict__ x,
                    X* __restrict__ y, int64_t batch, int64_t n, int64_t C,
                    int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = smem + RING_OFFSET;
  const uint32_t row_slot = slot_bytes<T>(C), stage_size = stage_bytes<T, X>(C);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);             // the producer's arrive, plus the bytes
      bar_init(&empty[s], CONSUMERS);    // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int64_t row_blocks = (n + R - 1) / R;
  const int64_t units = batch * row_blocks;
  const Interior a_in = interior(A, (uint64_t)(batch * n * n) * sizeof(T));
  const Interior x_in = interior(x, (uint64_t)(batch * n) * sizeof(X));
  int s = 0;
  uint32_t phase = 0;

  if (warp == CONSUMERS) {
    // ---- producer warp: lane i < rows copies row r0 + i, lane R copies x.
    for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
      const int64_t b = u / row_blocks, r0 = (u % row_blocks) * R;
      const int rows = (int)(n - r0 < R ? n - r0 : R);
      for (int64_t c0 = 0; c0 < n; c0 += C) {
        const int64_t len = n - c0 < C ? n - c0 : C;
        Span sp = {0, 0, 0};
        uint32_t slot = 0;
        if (lane < rows) {
          sp = clip(A + ((b * n + r0 + lane) * n + c0), (uint64_t)len * sizeof(T), a_in);
          slot = lane * row_slot;
        } else if (lane == R) {
          sp = clip(x + (b * n + c0), (uint64_t)len * sizeof(X), x_in);
          slot = R * row_slot;
        }
        const uint32_t total = __reduce_add_sync(0xffffffffu, sp.bytes);
        bar_wait(&empty[s], phase ^ 1);  // a fresh barrier passes parity 1 at once
        if (lane == 0) bar_arrive_expect_tx(&full[s], total);
        __syncwarp();
        if (sp.bytes)
          bulk_copy(ring + s * stage_size + slot + sp.offset,
                    reinterpret_cast<const void*>(sp.src), sp.bytes, &full[s]);
        if (++s == stages) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  // ---- consumer warps: rows warp * ROWS_PER_WARP + k of each unit.
  for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
    const int64_t b = u / row_blocks, r0 = (u % row_blocks) * R;
    const int rows = (int)(n - r0 < R ? n - r0 : R);
    X acc[ROWS_PER_WARP];
#pragma unroll
    for (int k = 0; k < ROWS_PER_WARP; ++k) acc[k] = X(0);
    for (int64_t c0 = 0; c0 < n; c0 += C) {
      const int len = (int)(n - c0 < C ? n - c0 : C);
      const unsigned char* st = ring + s * stage_size;
      const X* gx = x + (b * n + c0);
      const X* sx = reinterpret_cast<const X*>(
          st + R * row_slot + (reinterpret_cast<uint64_t>(gx) & 15));
      int xj0, xj1;
      copied_range(gx, sizeof(X), len, x_in, xj0, xj1);
      bool edge = xj0 != 0 || xj1 != len;
      const T* sa[ROWS_PER_WARP];
      const T* ga[ROWS_PER_WARP];
      int aj0[ROWS_PER_WARP], aj1[ROWS_PER_WARP];
#pragma unroll
      for (int k = 0; k < ROWS_PER_WARP; ++k) {
        // A row past the problem's end (last row block) repeats the last
        // row; its sum is not stored.
        int i = warp * ROWS_PER_WARP + k;
        i = i < rows ? i : rows - 1;
        ga[k] = A + ((b * n + r0 + i) * n + c0);
        sa[k] = reinterpret_cast<const T*>(st + i * row_slot +
                                           (reinterpret_cast<uint64_t>(ga[k]) & 15));
        copied_range(ga[k], sizeof(T), len, a_in, aj0[k], aj1[k]);
        edge |= aj0[k] != 0 || aj1[k] != len;
      }
      bar_wait(&full[s], phase);
      if (edge)
        dot_rows<T, X, true>(sa, ga, aj0, aj1, sx, gx, xj0, xj1, len, lane, acc);
      else
        dot_rows<T, X, false>(sa, ga, aj0, aj1, sx, gx, xj0, xj1, len, lane, acc);
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
      if (++s == stages) { s = 0; phase ^= 1; }
    }
#pragma unroll
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
      X v = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      const int i = warp * ROWS_PER_WARP + k;
      if (lane == 0 && i < rows) y[b * n + r0 + i] = v;
    }
  }
}

// Per device: SM count and the shared memory a block may opt in to; per
// kernel instance and device: whether the opt-in is set, and the last
// occupancy asked for.  thread_local, since ctypes calls drop the GIL.
struct DeviceInfo {
  int sms = 0, smem_optin = 0;
};

template <typename T, typename X>
int launch(const void* A, const void* x, void* y, int64_t batch, int64_t n,
           cudaStream_t stream) {
  thread_local DeviceInfo devices[MAX_DEVICES];
  thread_local bool optin_set[MAX_DEVICES];
  thread_local int occ_dev = -1, occ_blocks = 0;
  thread_local size_t occ_smem = 0;

  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceInfo& info = devices[dev];
  if (info.sms == 0) {
    if ((err = cudaDeviceGetAttribute(&info.smem_optin,
                                      cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev)))
      return (int)err;
  }
  if (!optin_set[dev]) {
    err = cudaFuncSetAttribute(batched_gemv_kernel<T, X>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, info.smem_optin);
    if (err != cudaSuccess) return (int)err;
    optin_set[dev] = true;
  }

  const int64_t C = n < cmax<T>() ? n : cmax<T>();
  const size_t stage = stage_bytes<T, X>(C);
  int stages = (int)((info.smem_optin - RING_OFFSET) / stage);
  stages = stages < MAX_STAGES ? stages : MAX_STAGES;
  if (stages < 2) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = RING_OFFSET + stages * stage;

  if (occ_dev != dev || occ_smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_blocks, batched_gemv_kernel<T, X>,
                                                        THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (occ_blocks < 1) return (int)cudaErrorInvalidConfiguration;
    occ_dev = dev;
    occ_smem = smem;
  }
  const int64_t units = batch * ((n + R - 1) / R);
  const int64_t resident = (int64_t)info.sms * occ_blocks;
  const unsigned grid = (unsigned)(units < resident ? units : resident);
  batched_gemv_kernel<T, X><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const X*>(x), static_cast<X*>(y), batch, n, C,
      stages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int batched_gemv_f32(const void* A, const void* x, void* y,
                                int64_t batch, int64_t n, void* stream) {
  return launch<float, float>(A, x, y, batch, n, static_cast<cudaStream_t>(stream));
}

extern "C" int batched_gemv_bf16(const void* A, const void* x, void* y,
                                 int64_t batch, int64_t n, void* stream) {
  return launch<__nv_bfloat16, float>(A, x, y, batch, n, static_cast<cudaStream_t>(stream));
}

extern "C" int batched_gemv_f64(const void* A, const void* x, void* y,
                                int64_t batch, int64_t n, void* stream) {
  return launch<double, double>(A, x, y, batch, n, static_cast<cudaStream_t>(stream));
}

extern "C" int batched_gemv_f32_f64(const void* A, const void* x, void* y,
                                    int64_t batch, int64_t n, void* stream) {
  return launch<float, double>(A, x, y, batch, n, static_cast<cudaStream_t>(stream));
}
