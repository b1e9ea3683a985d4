// fill_table: the dense per-tile work table of the classic rasterizer.
//
// Replaces the Pallas TPU kernel `fill_table` (`sags_tpu/ops/pallas_binning.py`,
// `_fill_kernel` + `_extract_window`). Row t of the [NT, K] int32 output is
// gid_sorted[starts[t] : starts[t] + min(count_t, K)], and the rest of the
// row is -1 (count_t = starts[t+1] - starts[t]).
//
// Bound: device memory. It reads each kept id once and writes NT*K ids; there
// is no arithmetic to speak of.
// Design: one block per tile, threads striding over the row so that the
// reads of the tile's contiguous segment and the row writes are both
// coalesced. The TPU version's aligned-window DMA and lane rotates exist
// only because Mosaic cannot slice HBM at arbitrary offsets; a CUDA thread
// reads any address, so none of that is carried over.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void fill_table_kernel(const int32_t* __restrict__ gid_sorted,
                                  int n_sorted,
                                  const int32_t* __restrict__ starts,
                                  int num_tiles, int K,
                                  int32_t* __restrict__ out) {
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int s = starts[t];
    const int cnt = min(starts[t + 1] - s, K);
    int32_t* row = out + (size_t)t * K;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      row[k] = (k < cnt && s + k < n_sorted) ? gid_sorted[s + k] : -1;
    }
  }
}

extern "C" int sags_fill_table(const void* gid_sorted, int n_sorted,
                               const void* starts, int num_tiles, int K,
                               void* out, void* stream) {
  if (num_tiles > 0 && K > 0) {
    const int grid = num_tiles < 65535 ? num_tiles : 65535;
    fill_table_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)gid_sorted, n_sorted, (const int32_t*)starts,
        num_tiles, K, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_fill_table_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
