// fill_table: the dense per-tile work table of the classic rasterizer.
//
// Replaces the Pallas TPU kernel `fill_table` (`sags_tpu/ops/pallas_binning.py`,
// `_fill_kernel` + `_extract_window`). Row t of the [NT, K] int32 output is
// gid_sorted[starts[t] : starts[t] + min(count_t, K)], and the rest of the
// row is -1 (count_t = starts[t+1] - starts[t]).
//
// Bound: device memory, and below that the launch. It reads each kept id
// once and writes NT*K ids (2.6 MB at 1280 tiles and K = 512, 5.2 MB at
// 1024: 0.0016 and 0.0027 ms at 3.35 TB/s); there is no arithmetic. The
// floor (`chip_smoke.py`'s kernels phase, device time from a CUDA graph on
// an H100 80GB HBM3 at 700 W, K = 1024): an empty kernel with this grid
// takes 0.0013 ms, torch.full of the same bytes 0.0024, this kernel 0.0031
// (0.0010, 0.0016 and 0.0023 at K = 512). Launched from Python, any of
// them takes 0.01-0.03 ms: the host.
//
// Design: one thread per 16-byte output vector (t, 4j .. 4j+3), a flat
// grid-stride loop over the NT*K/4 vectors with the grid sized once to the
// SMs (blocks an SM from the occupancy query, times the SM count), so no
// block waits on a dependent `starts` load before its only stores as the
// earlier one-block-per-tile design did. Neighbouring threads share a tile,
// so their `starts` loads (read-only path) coalesce. A vector wholly past
// the tile's count stores -1 without touching `gid_sorted`; one inside reads
// its four ids, neighbouring threads on neighbouring addresses whatever
// starts[t] % 4 is. K % 4 == 0 (the wrapper checks) and torch allocates on
// 256-byte boundaries, so every vector store is aligned. The TPU version's
// aligned-window DMA and lane rotates exist only because Mosaic cannot slice
// device memory at arbitrary offsets; none of that is carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fill_table_kernel(const int32_t* __restrict__ gid_sorted, int n_sorted,
                  const int32_t* __restrict__ starts, int K, int n_vec,
                  int4* __restrict__ out) {
  const int vpr = K >> 2;  // vectors a row
  for (int v = blockIdx.x * kThreads + threadIdx.x; v < n_vec;
       v += gridDim.x * kThreads) {
    const int t = v / vpr;
    const int k0 = (v - t * vpr) << 2;
    const int s = __ldg(starts + t);
    const int cnt = min(__ldg(starts + t + 1) - s, K);
    int4 o = make_int4(-1, -1, -1, -1);
    if (k0 < cnt) {
      const int e = s + k0;
      if (k0 + 0 < cnt && e + 0 < n_sorted) o.x = __ldg(gid_sorted + e + 0);
      if (k0 + 1 < cnt && e + 1 < n_sorted) o.y = __ldg(gid_sorted + e + 1);
      if (k0 + 2 < cnt && e + 2 < n_sorted) o.z = __ldg(gid_sorted + e + 2);
      if (k0 + 3 < cnt && e + 3 < n_sorted) o.w = __ldg(gid_sorted + e + 3);
    }
    out[v] = o;
  }
}

// The floor: a kernel that does nothing, launched with fill_table's grid.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

}  // namespace

extern "C" int sags_fill_table(const void* gid_sorted, int n_sorted,
                               const void* starts, int num_tiles, int K,
                               void* out, void* stream) {
  const long long n_vec = (long long)num_tiles * (K >> 2);
  if ((K & 3) != 0 || n_vec > 0x3fffffffLL) return (int)cudaErrorInvalidValue;
  if (n_vec > 0) {
    const int grid = sagsg::grid_for<fill_table_kernel>(kThreads, n_vec);
    fill_table_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)gid_sorted, n_sorted, (const int32_t*)starts, K,
        (int)n_vec, (int4*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int sags_fill_table_empty(int num_tiles, int K, void* stream) {
  const long long n_vec = (long long)num_tiles * (K >> 2);
  if (n_vec > 0) {
    const int grid = sagsg::grid_for<fill_table_kernel>(kThreads, n_vec);
    empty_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>();
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_fill_table_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
