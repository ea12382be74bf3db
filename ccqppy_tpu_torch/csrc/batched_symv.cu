// Batched symmetric matvec  y[b] = A[b] @ x[b]  from the upper-triangle
// tiles of A, for Hopper (sm_90a).
//
// Replaces the TPU kernels `batched_symv`, `batched_symv_packed` and
// `symv_packed` in ccqppy_tpu/ops/pallas_kernels.py (one Pallas grid step
// per (problem, upper tile), two MXU dots on the tile in VMEM, the output
// block accumulated in VMEM over the problem's T sequential steps).  One
// kernel serves all three: the packed layout (B, T, tile, tile) and the
// full layout (B, n, n), whose strictly-lower off-diagonal tiles are never
// read.  A single problem is B = 1.
//
// What bounds it: memory.  Each stored element of A is used for two
// multiply-adds (four flops per 4 bytes), far below the card's ridge point,
// and the point of the symmetric form is to stream about half the bytes of
// a dense GEMV.  So every tile is read from device memory exactly once, and
// both products come from that one read:
//
//   y_i += T_ij x_j       (a row partial),
//   y_j += T_ij^T x_i     (a column partial, for i < j only).
//
// What the design does about it, and about the card's blocks running in
// parallel in no order (the TPU kernel relied on a sequential grid):
//   * pass 1, one block per (b, t, slice): the tile's rows are cut into S
//     slices of tile / S consecutive rows.  A warp owns tile / (8 S)
//     consecutive rows of its block's slice and streams them straight from device memory with
//     16-byte loads that bypass L1 (a 512x512 f32 tile is 1 MB, more than
//     shared memory holds, so nothing of A is staged), UNROLL rows in flight
//     per warp.  The row dot T[r,:].x_j is reduced by shuffles; each lane
//     keeps the column accumulators T[r,c] x_i[r] of its columns in
//     registers, and the warps sum those through shared memory, in warp
//     order, at the slice's end;
//   * pass 1 writes the row partials of its slice's rows (disjoint between
//     slices) and, for i < j, the slice's column partial to a scratch
//     buffer (B, T, 1 + S, tile) that the caller allocates: slot 0 the row
//     partials, slot 1 + s slice s's column partial;
//   * pass 2, one block per (b, output segment s), a thread per row, sums
//     the partials of segment s in tile order: for each tile (i, s), i < s,
//     its S column partials in slice order, then the row partials of the
//     tiles (s, j), j >= s.
// S is chosen by the caller (ops/symv.py `row_slices`): 1 where B * T
// blocks already fill the card, as at B = 2048; below that enough slices
// for a block an SM, but none shorter than 64 rows (at B = 1, n = 1024,
// tile 256: 10 blocks at S = 1 on 132 SMs, 40 at S = 4).  A slice's column
// partial and its share of pass 2 cost more than its block gains below
// that.  S = 1 is one slice of the whole tile: the same rows a warp, the
// same sums in the same order as a kernel without slices.
// No float atomics and no state across blocks: every sum is taken in a
// fixed order, so the result is bitwise the same run to run.  Diagonal
// tiles are read whole and contribute once (their row partials).  Plain
// fp32 FMA, no tensor cores, as in batched_gemv.cu.
//
// Tiles of 128, 256 and 512; n % tile == 0; S a power of two with slices
// of a multiple of WARPS * UNROLL = 32 rows.  Offsets are 64-bit: B * T * tile^2 passes 2^31 at B = 4096,
// tile = 128.  A and x must be 16-byte aligned.  The kernel allocates
// nothing; it launches on the caller's stream and returns the first CUDA
// error of its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // warps per pass-1 block
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;                // rows of A in flight per warp
constexpr int64_t MAX_GRID_X = 2147483647;

__device__ __forceinline__ float4 load_streaming(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// Coordinates (i, j), i <= j, of upper tile t in row-major order.
__device__ __forceinline__ void tile_coords(int64_t t, int64_t nt, int64_t& i,
                                            int64_t& j) {
  i = 0;
  while (t >= nt - i) {
    t -= nt - i;
    ++i;
  }
  j = i + t;
}

template <int TILE, bool PACKED>
__global__ void __launch_bounds__(THREADS)
symv_tiles_kernel(const float* __restrict__ A, const float* __restrict__ x,
                  float* __restrict__ part, int64_t T, int64_t n, int slices) {
  constexpr int V = TILE / 128;          // float4 per lane per row
  __shared__ __align__(16) float xi_s[TILE];
  __shared__ __align__(16) float col_s[WARPS][TILE];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slice = (int)((int64_t)blockIdx.x % slices);
  const int64_t bt = (int64_t)blockIdx.x / slices;
  const int64_t b = bt / T;
  const int64_t t = bt % T;
  int64_t i, j;
  tile_coords(t, n / TILE, i, j);
  const bool diag = i == j;

  const float* xb = x + b * n;
  const float* tb;
  int64_t ld;
  if constexpr (PACKED) {
    tb = A + (b * T + t) * TILE * TILE;
    ld = TILE;
  } else {
    tb = A + (b * n + i * TILE) * n + j * TILE;
    ld = n;
  }

  for (int k = threadIdx.x; k < TILE; k += THREADS) xi_s[k] = xb[i * TILE + k];
  // This lane's columns of the tile: 4 (lane + 32 v) + 0..3, v < V.
  float4 xj[V], col[V];
  const float4* xj4 = reinterpret_cast<const float4*>(xb + j * TILE);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    xj[v] = __ldg(xj4 + lane + 32 * v);
    col[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  float* rowpart = part + bt * (1 + slices) * TILE;
  float* colpart = rowpart + (1 + slice) * TILE;
  // The slice's rows, WARPS runs of consecutive rows, a multiple of UNROLL
  // each (at S = 1, TILE / WARPS rows a warp).
  const int rows = TILE / slices / WARPS;
  const int r_begin = (slice * WARPS + warp) * rows;
  for (int r0 = r_begin; r0 < r_begin + rows; r0 += UNROLL) {
    float4 a[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float4* row = reinterpret_cast<const float4*>(tb + (int64_t)(r0 + u) * ld);
#pragma unroll
      for (int v = 0; v < V; ++v) a[u][v] = load_streaming(row + lane + 32 * v);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        s = fmaf(a[u][v].x, xj[v].x, s);
        s = fmaf(a[u][v].y, xj[v].y, s);
        s = fmaf(a[u][v].z, xj[v].z, s);
        s = fmaf(a[u][v].w, xj[v].w, s);
      }
      if (!diag) {
        const float xr = xi_s[r0 + u];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          col[v].x = fmaf(a[u][v].x, xr, col[v].x);
          col[v].y = fmaf(a[u][v].y, xr, col[v].y);
          col[v].z = fmaf(a[u][v].z, xr, col[v].z);
          col[v].w = fmaf(a[u][v].w, xr, col[v].w);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) rowpart[r0 + u] = s;
    }
  }

  if (!diag) {                           // uniform over the block
    float4* mine = reinterpret_cast<float4*>(col_s[warp]);
#pragma unroll
    for (int v = 0; v < V; ++v) mine[lane + 32 * v] = col[v];
    __syncthreads();
    for (int c = threadIdx.x; c < TILE; c += THREADS) {
      float s = col_s[0][c];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += col_s[w][c];
      colpart[c] = s;
    }
  }
}

// One block per (b, output segment s) of TILE threads, one a row.
template <int TILE>
__global__ void __launch_bounds__(TILE)
symv_sum_kernel(const float* __restrict__ part, float* __restrict__ y, int64_t T,
                int64_t n, int slices) {
  const int64_t nt = n / TILE;
  const int64_t b = (int64_t)blockIdx.x / nt;
  const int64_t s = (int64_t)blockIdx.x % nt;
  const int64_t stride = (int64_t)(1 + slices) * TILE;   // one tile's partials
  const float* pb = part + b * T * stride + threadIdx.x;
  float acc = 0.f;
  int64_t row_start = 0;                 // index of tile (i, i)
  for (int64_t i = 0; i < s; ++i) {      // column partials of tile (i, s)
    const float* pc = pb + (row_start + s - i) * stride + TILE;
    float c = pc[0];
#pragma unroll 16
    for (int sl = 1; sl < slices; ++sl) c += pc[sl * TILE];
    acc += c;
    row_start += nt - i;
  }
  for (int64_t jj = s; jj < nt; ++jj)    // row partials of tile (s, jj)
    acc += pb[(row_start + jj - s) * stride];
  y[b * n + s * TILE + threadIdx.x] = acc;
}

template <int TILE, bool PACKED>
int launch_tile(const float* A, const float* x, float* y, float* part, int64_t batch,
                int64_t n, int64_t T, int slices, cudaStream_t stream) {
  symv_tiles_kernel<TILE, PACKED>
      <<<(unsigned)(batch * T * slices), THREADS, 0, stream>>>(A, x, part, T, n, slices);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  symv_sum_kernel<TILE><<<(unsigned)(batch * (n / TILE)), TILE, 0, stream>>>(
      part, y, T, n, slices);
  return (int)cudaGetLastError();
}

template <bool PACKED>
int launch(const void* A, const void* x, void* y, void* part, int64_t batch,
           int64_t n, int64_t tile, int64_t slices, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (tile <= 0 || n % tile != 0) return (int)cudaErrorInvalidValue;
  if (slices < 1 || (slices & (slices - 1)) != 0 || tile % (slices * WARPS * UNROLL) != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t nt = n / tile;
  const int64_t T = nt * (nt + 1) / 2;
  if (batch * T * slices > MAX_GRID_X || batch * nt > MAX_GRID_X)
    return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(A);
  const float* xv = static_cast<const float*>(x);
  float* yv = static_cast<float*>(y);
  float* p = static_cast<float*>(part);
  const int S = (int)slices;
  switch (tile) {
    case 128: return launch_tile<128, PACKED>(a, xv, yv, p, batch, n, T, S, stream);
    case 256: return launch_tile<256, PACKED>(a, xv, yv, p, batch, n, T, S, stream);
    case 512: return launch_tile<512, PACKED>(a, xv, yv, p, batch, n, T, S, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int batched_symv_packed_f32(const void* Ap, const void* x, void* y,
                                       void* part, int64_t batch, int64_t n,
                                       int64_t tile, int64_t slices, void* stream) {
  return launch<true>(Ap, x, y, part, batch, n, tile, slices,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int batched_symv_full_f32(const void* Au, const void* x, void* y,
                                     void* part, int64_t batch, int64_t n,
                                     int64_t tile, int64_t slices, void* stream) {
  return launch<false>(Au, x, y, part, batch, n, tile, slices,
                       static_cast<cudaStream_t>(stream));
}
