// bitonic.cuh: ascending bitonic sort of int32 keys in shared memory by all
// threads of one block. Included by sort_blocks.cu and
// composite_windowed_sorted.cu.
//
// The TPU formulation (`sags_tpu/ops/pallas_sort.py`, `bitonic_sort_rl`)
// runs the network as whole-array vector rolls over a [R, 128] register
// tile. Here the keys sit in shared memory and each stage is n/2 independent
// compare-exchanges split over the block's threads, one barrier per stage:
// log2(n) (log2(n) + 1) / 2 stages. Keys carry their payload in the low
// bits, so sorting values alone carries the permutation.

#pragma once

#include <stdint.h>

// Sorts keys[0 .. n) ascending; n is a power of two. Starts and ends with a
// block-wide barrier, so the caller may write keys just before and read them
// just after.
__device__ __forceinline__ void bitonic_sort_shared(int32_t* keys, int n) {
  __syncthreads();
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        // the p-th pair (i, i + j): insert a 0 bit at j's position
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i + j;
        const bool ascending = (i & k) == 0;
        const int32_t a = keys[i];
        const int32_t b = keys[l];
        if ((a > b) == ascending) {
          keys[i] = b;
          keys[l] = a;
        }
      }
      __syncthreads();
    }
  }
}
