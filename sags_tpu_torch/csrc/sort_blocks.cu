// sort_blocks: ascending sort of each block of n int32 keys of a batch.
//
// Replaces the Pallas TPU kernel `sort_blocks` (`sags_tpu/ops/pallas_sort.py`,
// `_sort_kernel` + `bitonic_sort_rl`): block b of the [B, R, L] input,
// flattened row-major to n = R*L keys, is written back sorted ascending.
//
// Bound: device memory at these sizes. A 2048-key block is 8 KB read and
// written once against 67,584 compare-exchanges that never leave the SM; what
// the kernel pays for on top is the barriers and the shuffles of the network.
// Design: one thread block per key block, one thread per 8 keys (256 threads
// for 2048 keys, so eight blocks share an SM; never fewer than a warp). The
// keys are staged in shared memory with coalesced accesses and sorted by
// `bitonic_sort_shared` (bitonic.cuh, shared with
// composite_windowed_sorted.cu), which keeps them in registers and crosses
// warps through shared memory in a few transposed rounds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

__global__ void __launch_bounds__(1024)
sort_blocks_kernel(const int32_t* __restrict__ x, int n, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t keys[];
  const size_t off = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) keys[i] = x[off + i];
  bitonic_sort_shared(keys, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[off + i] = keys[i];
}

extern "C" int sags_sort_blocks(const void* x, int num_blocks, int n, void* out,
                                void* stream) {
  if (n < 2 || (n & (n - 1)) || n > 1024 * sagsbit::E) return (int)cudaErrorInvalidValue;
  if (num_blocks > 0) {
    const int threads = n / sagsbit::E < 32 ? 32 : n / sagsbit::E;
    sort_blocks_kernel<<<num_blocks, threads, (size_t)n * sizeof(int32_t),
                         (cudaStream_t)stream>>>((const int32_t*)x, n,
                                                 (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_sort_blocks_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
