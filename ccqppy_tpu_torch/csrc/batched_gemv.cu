// Batched dense GEMV  y[b] = A[b] @ x[b]  for Hopper (sm_90a).
//
// Replaces the TPU kernel `batched_gemv` in ccqppy_tpu/ops/pallas_kernels.py
// (a Pallas grid of (batch, row-tile) steps, each an MXU dot of a VMEM row
// tile at HIGHEST precision).
//
// What bounds it: memory.  Every element of A is read once and used for one
// multiply-add (2 flops per 4 bytes in f32, per 2 bytes in bf16), far below
// the card's ridge point, so the kernel's only job is to stream A once at
// full device-memory bandwidth.  x and y are n floats per lane against n*n
// elements of A.
//
// What the design does about it:
//   * one warp per output row, WARPS rows per block; grid (row blocks, B);
//   * x[b] is staged once per block in shared memory (in tiles of XTILE
//     floats, so any n works), so A is the only stream from device memory;
//   * 16-byte vector loads of A (4 floats / 8 bf16) when n is a multiple of
//     the vector width and A is 16-byte aligned -- then every row base is
//     aligned too -- and scalar loads otherwise; neighbouring lanes read
//     neighbouring addresses, and the loads bypass L1 (A is read once);
//   * plain fp32 FMA, then a warp-shuffle reduction.  No tensor cores: the
//     solver's convergence decisions rest on exact fp32 products.
//
// bf16 A follows the TPU kernel: x is rounded to bf16, each product of two
// bf16 values is exact in fp32, and accumulation is fp32.
//
// Offsets are 64-bit: b * n * n passes 2^31 at B > 2147 for n = 1000.
// The kernel allocates nothing; it launches on the caller's stream and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // output rows per block
constexpr int THREADS = WARPS * 32;
constexpr int64_t XTILE = 8192;          // floats of x staged per pass (32 KB)
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float stage_x(float v, float) { return v; }
__device__ __forceinline__ float stage_x(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Fused multiply-add of one 16-byte vector of A against shared x.
__device__ __forceinline__ float dot_vec(uint4 raw, const float* xs, float acc, float) {
  const float4 xv = *reinterpret_cast<const float4*>(xs);
  acc = fmaf(__uint_as_float(raw.x), xv.x, acc);
  acc = fmaf(__uint_as_float(raw.y), xv.y, acc);
  acc = fmaf(__uint_as_float(raw.z), xv.z, acc);
  acc = fmaf(__uint_as_float(raw.w), xv.w, acc);
  return acc;
}

__device__ __forceinline__ float dot_vec(uint4 raw, const float* xs, float acc, __nv_bfloat16) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 x0 = *reinterpret_cast<const float4*>(xs);
  const float4 x1 = *reinterpret_cast<const float4*>(xs + 4);
  float2 f;
  f = __bfloat1622float2(a[0]); acc = fmaf(f.x, x0.x, acc); acc = fmaf(f.y, x0.y, acc);
  f = __bfloat1622float2(a[1]); acc = fmaf(f.x, x0.z, acc); acc = fmaf(f.y, x0.w, acc);
  f = __bfloat1622float2(a[2]); acc = fmaf(f.x, x1.x, acc); acc = fmaf(f.y, x1.y, acc);
  f = __bfloat1622float2(a[3]); acc = fmaf(f.x, x1.z, acc); acc = fmaf(f.y, x1.w, acc);
  return acc;
}

__device__ __forceinline__ uint4 load_streaming(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
batched_gemv_kernel(const T* __restrict__ A, const float* __restrict__ x,
                    float* __restrict__ y, int64_t batch, int64_t n) {
  extern __shared__ __align__(16) float xs[];
  constexpr int W = 16 / sizeof(T);      // elements per 16-byte vector
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * WARPS + warp;
  const bool has_row = row < n;

  for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
    const T* arow = A + (b * n + (has_row ? row : 0)) * n;
    const float* xb = x + b * n;
    float acc = 0.f;
    for (int64_t c0 = 0; c0 < n; c0 += XTILE) {
      const int64_t len = n - c0 < XTILE ? n - c0 : XTILE;
      __syncthreads();                   // previous tile fully consumed
      for (int64_t j = threadIdx.x; j < len; j += THREADS)
        xs[j] = stage_x(xb[c0 + j], T());
      __syncthreads();
      if (has_row) {
        if constexpr (VEC) {
          // n % W == 0 and XTILE % W == 0, so len % W == 0.
          const uint4* av = reinterpret_cast<const uint4*>(arow + c0);
          const int64_t nv = len / W;
#pragma unroll 4
          for (int64_t v = lane; v < nv; v += 32)
            acc = dot_vec(load_streaming(av + v), xs + v * W, acc, T());
        } else {
          for (int64_t j = lane; j < len; j += 32)
            acc = fmaf(to_f32(arow[c0 + j]), xs[j], acc);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (has_row && lane == 0) y[b * n + row] = acc;
  }
}

template <typename T>
int launch(const void* A, const float* x, float* y, int64_t batch, int64_t n,
           cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const bool vec = n % W == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const int64_t row_blocks = (n + WARPS - 1) / WARPS;
  const dim3 grid((unsigned)row_blocks,
                  (unsigned)(batch < MAX_GRID_Y ? batch : MAX_GRID_Y));
  const size_t smem = (size_t)(n < XTILE ? n : XTILE) * sizeof(float);
  const T* a = static_cast<const T*>(A);
  if (vec)
    batched_gemv_kernel<T, true><<<grid, THREADS, smem, stream>>>(a, x, y, batch, n);
  else
    batched_gemv_kernel<T, false><<<grid, THREADS, smem, stream>>>(a, x, y, batch, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int batched_gemv_f32(const void* A, const void* x, void* y,
                                int64_t batch, int64_t n, void* stream) {
  return launch<float>(A, static_cast<const float*>(x), static_cast<float*>(y),
                       batch, n, static_cast<cudaStream_t>(stream));
}

extern "C" int batched_gemv_bf16(const void* A, const void* x, void* y,
                                 int64_t batch, int64_t n, void* stream) {
  return launch<__nv_bfloat16>(A, static_cast<const float*>(x), static_cast<float*>(y),
                               batch, n, static_cast<cudaStream_t>(stream));
}
