// bitonic.cuh: ascending bitonic sort of int32 keys in shared memory by all
// threads of one block. Included by sort_blocks.cu and
// composite_windowed_sorted.cu.
//
// The TPU formulation (`sags_tpu/ops/pallas_sort.py`, `bitonic_sort_rl`)
// runs the network as whole-array vector rolls over a [R, 128] register
// tile. The network is the same here: log2(n) (log2(n) + 1) / 2 stages, stage
// (k, j) exchanging key i with key i ^ j, ascending where i & k is 0. Keys
// carry their payload in the low bits, so sorting values alone carries the
// permutation.
//
// Bound: a stage that goes through shared memory costs a block-wide barrier,
// and a block of 2048 keys has 66 stages. Design: the keys live in registers,
// E = 8 consecutive keys a thread, and a stage is placed by its distance j:
//   j < E          compare-exchange between the thread's own registers;
//   E <= j < 32 E  exchange with lane ^ (j / E) by __shfl_xor_sync;
//   j >= 32 E      a transposed round: the keys go to shared memory, every
//                  thread takes the E keys that differ in the three index
//                  bits from j downwards, runs those three stages between
//                  its registers and puts the keys back: two barriers for
//                  three stages, and none for any other stage.
// 2048 keys sort with 8 barriers (three rounds and the two of the contract),
// 8192 with 16. The ownership of E consecutive keys moves through shared
// memory as two 16-byte accesses a thread; the transposed one is conflict
// free (neighbouring lanes, neighbouring words). ops/sort.py holds a plain
// model of this schedule, which the CPU tests run against torch.sort.

#pragma once

#include <stdint.h>

namespace sagsbit {

constexpr int LOG_E = 3;
constexpr int E = 1 << LOG_E;  // keys a thread holds
constexpr int32_t PAD = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

// One block-wide barrier per stage, any n and any block size: the network as
// it reads, taken where the register form does not apply.
__device__ __forceinline__ void sort_by_stages(int32_t* keys, int n) {
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

// The stages j = 2^(b + s_hi) .. 2^b of phase k between a thread's own
// registers: register e holds key index fixed | (e << b), where `fixed` has
// zeros in bits b .. b + LOG_E - 1.
__device__ __forceinline__ void register_stages(int32_t (&v)[E], int fixed, int b, int k,
                                                int s_hi) {
  const int fb = fixed >> b, kb = k >> b;
#pragma unroll
  for (int s = LOG_E - 1; s >= 0; --s) {
    if (s > s_hi) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & (1 << s)) continue;
      const bool ascending = ((fb | e) & kb) == 0;
      const int32_t lo = min(v[e], v[e | (1 << s)]);
      const int32_t hi = max(v[e], v[e | (1 << s)]);
      v[e] = ascending ? lo : hi;
      v[e | (1 << s)] = ascending ? hi : lo;
    }
  }
}

__device__ __forceinline__ void load_own(int32_t (&v)[E], const int32_t* src) {
  const int4 a = reinterpret_cast<const int4*>(src)[0];
  const int4 b = reinterpret_cast<const int4*>(src)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store_own(int32_t* dst, const int32_t (&v)[E]) {
  reinterpret_cast<int4*>(dst)[0] = make_int4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<int4*>(dst)[1] = make_int4(v[4], v[5], v[6], v[7]);
}

// The network on registers. Thread t of the block holds keys t E .. t E + E - 1
// in v (PAD in the threads past n / E, which only keep the barriers and the
// shuffles whole). E <= n <= E blockDim.x, blockDim.x a multiple of 32; `keys`
// is scratch of n words, 16-byte aligned, that no thread reads or writes
// around this call without a barrier.
__device__ __forceinline__ void sort_in_registers(int32_t (&v)[E], int32_t* keys, int n) {
  const int t = threadIdx.x;
  const int own = t << LOG_E;
  const bool active = own < n;
#pragma unroll
  for (int k = 2; k <= E; k <<= 1) {
    int s_hi = 0;
    while ((2 << s_hi) < k) ++s_hi;
    register_stages(v, own, 0, k, s_hi);
  }
  for (int k = 2 * E; k <= n; k <<= 1) {
    int j = k >> 1;
    while (j >= 32 * E) {  // transposed round: stages j, j / 2, j / 4
      const int b = 31 - __clz(j) - (LOG_E - 1);
      const int fixed = ((t >> b) << (b + LOG_E)) | (t & ((1 << b) - 1));
      if (active) store_own(keys + own, v);
      __syncthreads();
      if (active) {
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = keys[fixed | (e << b)];
      }
      register_stages(v, fixed, b, k, LOG_E - 1);
      if (active) {
#pragma unroll
        for (int e = 0; e < E; ++e) keys[fixed | (e << b)] = v[e];
      }
      __syncthreads();
      if (active) load_own(v, keys + own);
      j >>= LOG_E;
    }
    for (; j >= E; j >>= 1) {  // the partner's key e sits in lane ^ (j / E)
      const int lanes = j >> LOG_E;
      const bool keep_min = ((t & lanes) == 0) == ((own & k) == 0);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int32_t other = __shfl_xor_sync(FULL, v[e], lanes);
        v[e] = keep_min ? min(v[e], other) : max(v[e], other);
      }
    }
    register_stages(v, own, 0, k, LOG_E - 1);
  }
}

}  // namespace sagsbit

// Sorts keys[0 .. n) ascending; n is a power of two. Starts and ends with a
// block-wide barrier, so the caller may write keys just before and read them
// just after.
__device__ __forceinline__ void bitonic_sort_shared(int32_t* keys, int n) {
  using namespace sagsbit;
  __syncthreads();
  if (n < E || n > E * (int)blockDim.x || (blockDim.x & 31) ||
      (reinterpret_cast<uintptr_t>(keys) & 15)) {
    sort_by_stages(keys, n);
    return;
  }
  const int own = threadIdx.x << LOG_E;
  int32_t v[E];
  if (own < n) {
    load_own(v, keys + own);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = PAD;
  }
  sort_in_registers(v, keys, n);
  if (own < n) store_own(keys + own, v);
  __syncthreads();
}
