// A solver loop's test, "does any lane still run?", as one kernel that
// writes the answer to the device, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's loops are XLA while_loops,
// whose test stays on the device.  The port's loop that replays a CUDA
// graph of a pass reads the test on the host after each pass; as two eager
// launches (`~done`, then `any`) the test costs the host two launches a
// pass.  As the last node of the pass's graph it costs none: the host
// reads one int64 (ops/loop_flag.py, models/mprgp.py).
//
// One block: the lanes' flags are a few bytes to a few KB, so its cost is
// a launch's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void loop_flag_kernel(const uint8_t* done, int64_t batch, int64_t* out) {
  int running = 0;
  for (int64_t i = threadIdx.x; i < batch; i += THREADS) running |= done[i] == 0;
  running = __syncthreads_or(running);
  if (threadIdx.x == 0) *out = running;
}

}  // namespace

extern "C" int loop_flag(const void* done, int64_t batch, void* out, void* stream) {
  loop_flag_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(done), batch, static_cast<int64_t*>(out));
  return (int)cudaGetLastError();
}
