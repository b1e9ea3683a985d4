// grid.cuh: the grid of a grid-stride kernel, sized to the card once: the
// blocks an SM holds of the kernel (occupancy query) times the SM count, and
// no more blocks than `n` items need. Shared by fill_table.cu and
// expand_pairs.cu.

#pragma once

#include <cuda_runtime.h>

namespace sagsg {

// Blocks of `threads` threads for `n` items of `Kernel`; the cap is taken on
// the first call, one for each kernel.
template <auto Kernel>
int grid_for(int threads, long long n) {
  static int cap = 0;
  if (cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads, 0);
    cap = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (n + threads - 1) / threads;
  return (int)(need < cap ? need : cap);
}

}  // namespace sagsg
