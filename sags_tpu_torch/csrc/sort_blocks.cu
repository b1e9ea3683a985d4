// sort_blocks: ascending sort of each block of n int32 keys of a batch.
//
// Replaces the Pallas TPU kernel `sort_blocks` (`sags_tpu/ops/pallas_sort.py`,
// `_sort_kernel` + `bitonic_sort_rl`): block b of the [B, R, L] input,
// flattened row-major to n = R*L keys, is written back sorted ascending.
//
// Bound: device memory at these sizes. A 2048-key block is 8 KB read and
// written once against 67,584 compare-exchanges that stay in shared memory.
// Design: one thread block per key block; the keys are loaded into shared
// memory with coalesced reads, sorted there by `bitonic_sort_shared`
// (bitonic.cuh, shared with composite_windowed_sorted.cu) and stored back.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

__global__ void sort_blocks_kernel(const int32_t* __restrict__ x, int n,
                                   int32_t* __restrict__ out) {
  extern __shared__ int32_t keys[];
  const size_t off = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) keys[i] = x[off + i];
  bitonic_sort_shared(keys, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[off + i] = keys[i];
}

extern "C" int sags_sort_blocks(const void* x, int num_blocks, int n, void* out,
                                void* stream) {
  if (num_blocks > 0) {
    const int threads = n / 2 < 1024 ? n / 2 : 1024;
    sort_blocks_kernel<<<num_blocks, threads, (size_t)n * sizeof(int32_t),
                         (cudaStream_t)stream>>>((const int32_t*)x, n,
                                                 (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_sort_blocks_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
