// expand_pairs: the classic rasterizer's pair expansion, one pass over the
// Gaussian slots.
//
// Replaces no TPU kernel: the JAX package leaves this expansion to XLA,
// which fuses its loop over the R x R tile offsets into one pass. In the
// port that loop was ~94 PyTorch ops an offset, each a launch over every
// slot (`ops/binning.py:expand_pairs_plain`, which stays the plain version).
// A pair (slot g, offset j = dy * R + dx) is live iff the slot is valid,
// dx < rect width, dy < rect height, and the exact minimum of the slot's
// conic quadratic over the tile's pixel box (`binning.tile_qmin`) is at most
// the alpha-gate level c^2 (`binning.cull_c2`), each repeated step by step
// with round-to-nearest intrinsics (qmin.cuh). Each live pair's int64 key
//   ((int64)((tile << 16) | dq[g]) << 32) | g,
// tile = (rmin_y + dy) * tiles_x + rmin_x + dx, goes densely into the front
// of the [R * R * P] output, and `n_live` gets their count: the rest of the
// buffer is not written. Their order there is unspecified (warps reserve
// their ranges with atomics), but every key is unique (a slot meets each
// tile of its rect once), so the sorted prefix is the plain version's sorted
// keys bit for bit. `overflow` gets the sum over valid slots of the rect's
// tiles beyond the R x R window (int32, wrapping as the plain version's int64
// sum cast to int32 does): one integer atomic a warp, so the order of the
// additions changes nothing.
//
// Bound: device memory. It reads each slot's valid flag and, for a valid
// slot, its rect, dq, centre, conic and opacity once (44 bytes), and writes
// 8 bytes a live pair, where a key for every slot and offset wrote 8 * R * R
// * P (1.21 GB at P = 2^22 and R = 6). The sort that follows
// (`rasterize.sort_pairs`) then sorts the live prefix alone.
//
// Design: a warp takes 32 neighbouring slots at a time, in a grid-stride loop
// over a grid sized once to the SMs (`grid.cuh`: blocks an SM from the
// occupancy query, times the SM count); each lane loads its slot's columns
// once. The conic test (~60 float32 operations and four IEEE divisions) runs
// only on the offsets inside a slot's rect, a few of the R x R: a loop over
// all of them, one slot a lane, kept every lane busy for the widest rect of
// the warp and took 3.3x the byte bound at the offline shape on an H100. So
// the warp packs its slots' in-rect offsets densely (a prefix sum of the
// counts over the lanes), each lane tests one packed offset a round, reading
// its slot's columns from the owner lane by shuffles (the owner found by a
// binary search over the prefix sums), and sets the pair's bit in the owner's
// live mask in shared memory. Then the warp counts its live pairs (the masks'
// popcounts, a prefix sum over the lanes), reserves that many entries with
// one atomicAdd on `n_live`, and stores them packed in the same way: lane k
// of a round takes the warp's k-th live pair, its owner by the binary
// search, its offset as the owner mask's (k - owner's start)-th set bit, so
// the warp's 32 stores of a round are 256 contiguous bytes. Up to 16 x 16
// offsets (8 mask words a slot). At the offline cell's shape (2^22 slots, 36
// offsets, a random scene with 10% of the keys live) it takes 0.344 ms on an
// H100 against a 0.087 ms byte bound: the conic tests, not the bytes, set
// its time now.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"
#include "qmin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 16;
constexpr int kMaxWords = kMaxR * kMaxR / 32;
constexpr unsigned kFull = 0xffffffffu;

// The position of the r-th set bit (from 0) of m, which has more than r: a
// binary search on the popcounts of the low halves.
__device__ __forceinline__ int nth_bit(unsigned int m, int r) {
  int pos = 0;
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned int lo = m & ((1u << w) - 1u);
    const int c = __popc(lo);
    if (r >= c) {
      r -= c;
      m >>= w;
      pos += w;
    } else {
      m = lo;
    }
  }
  return pos;
}

__global__ void __launch_bounds__(kThreads)
expand_pairs_kernel(const float* __restrict__ mx, const float* __restrict__ my,
                    const float* __restrict__ ca, const float* __restrict__ cb,
                    const float* __restrict__ cc, const float* __restrict__ op,
                    const int32_t* __restrict__ rmin_x, const int32_t* __restrict__ rmin_y,
                    const int32_t* __restrict__ rmax_x, const int32_t* __restrict__ rmax_y,
                    const uint8_t* __restrict__ valid, const int32_t* __restrict__ dq,
                    int P, int R, int tiles_x, float T, float alpha_min,
                    unsigned long long* __restrict__ combined,
                    unsigned int* __restrict__ overflow, unsigned int* __restrict__ n_live) {
  // live[warp][word][lane]: bit j % 32 of word j / 32 is offset j of the
  // lane's slot; word-major, so a lane reading its own words hits its bank
  __shared__ unsigned int live[kWarps][kMaxWords][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int MT = R * R;
  const int words = (MT + 31) >> 5;
  unsigned int ov = 0;
  for (long long base = (long long)(blockIdx.x * kWarps + warp) * 32; base < P;
       base += (long long)gridDim.x * kThreads) {
    const int g = (int)base + lane;
    const bool v = g < P && valid[g];
    int x0 = 0, y0 = 0, wc = 0, hc = 0;
    float x = 0.f, y = 0.f, a = 0.f, b = 0.f, c = 0.f, c2 = 0.f;
    uint32_t d = 0;
    if (v) {
      x0 = rmin_x[g];
      y0 = rmin_y[g];
      const int w = rmax_x[g] - x0, h = rmax_y[g] - y0;
      // torch: (w * h - clamp(w, max=R) * clamp(h, max=R)) in int32
      ov += (unsigned)w * (unsigned)h - (unsigned)min(w, R) * (unsigned)min(h, R);
      wc = max(min(w, R), 0);  // dx < w for dx in [0, R)
      hc = max(min(h, R), 0);
      d = (uint32_t)dq[g];
      if (wc * hc > 0) {
        x = mx[g];
        y = my[g];
        a = ca[g];
        b = cb[g];
        c = cc[g];
        c2 = __fadd_rn(__fmul_rn(sagsq::gate_level(op[g], alpha_min), 1.00001f), 1e-6f);
      }
    }
    for (int i = 0; i < words; ++i) live[warp][i][lane] = 0u;
    // the in-rect offsets of the warp's slots, packed: inclusive prefix sum
    const int n = wc * hc;
    int incl = n;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    __syncwarp();
    for (int k0 = 0; k0 < total; k0 += 32) {
      const int k = k0 + lane;
      int s = 0;  // the owner: the first lane whose prefix sum exceeds k
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kFull, incl, s + step - 1) <= k) s += step;
      }
      s = min(s, 31);
      const int e = k - (__shfl_sync(kFull, incl, s) - __shfl_sync(kFull, n, s));
      const int sw = __shfl_sync(kFull, wc, s);
      const int sx0 = __shfl_sync(kFull, x0, s), sy0 = __shfl_sync(kFull, y0, s);
      const float sx = __shfl_sync(kFull, x, s), sy = __shfl_sync(kFull, y, s);
      const float sa = __shfl_sync(kFull, a, s), sb = __shfl_sync(kFull, b, s);
      const float sc = __shfl_sync(kFull, c, s), sc2 = __shfl_sync(kFull, c2, s);
      if (k < total) {
        const int dy = e / sw, dx = e - dy * sw;
        const float txT = __fmul_rn((float)(sx0 + dx), T);
        const float tyT = __fmul_rn((float)(sy0 + dy), T);
        const float qx0 = __fsub_rn(txT, sx);
        const float qx1 = __fsub_rn(__fadd_rn(txT, T - 1.f), sx);
        const float qy0 = __fsub_rn(tyT, sy);
        const float qy1 = __fsub_rn(__fadd_rn(tyT, T - 1.f), sy);
        if (sagsq::box_qmin(sa, sb, sc, qx0, qx1, qy0, qy1) <= sc2) {
          const int j = dy * R + dx;
          atomicOr(&live[warp][j >> 5][s], 1u << (j & 31));
        }
      }
    }
    __syncwarp();
    // the warp's live pairs, packed: inclusive prefix sum of the popcounts
    int nl = 0;
    for (int i = 0; i < words; ++i) nl += __popc(live[warp][i][lane]);
    int lincl = nl;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, lincl, o);
      if (lane >= o) lincl += t;
    }
    const int n_warp = __shfl_sync(kFull, lincl, 31);
    if (n_warp > 0) {
      unsigned int at = 0;
      if (lane == 0) at = atomicAdd(n_live, (unsigned int)n_warp);
      unsigned long long* out = combined + __shfl_sync(kFull, at, 0);
      for (int k0 = 0; k0 < n_warp; k0 += 32) {
        const int k = k0 + lane;
        int s = 0;  // the owner: the first lane whose prefix sum exceeds k
        for (int step = 16; step > 0; step >>= 1) {
          if (__shfl_sync(kFull, lincl, s + step - 1) <= k) s += step;
        }
        s = min(s, 31);
        int r = k - (__shfl_sync(kFull, lincl, s) - __shfl_sync(kFull, nl, s));
        const int sx0 = __shfl_sync(kFull, x0, s), sy0 = __shfl_sync(kFull, y0, s);
        const uint32_t sd = __shfl_sync(kFull, d, s);
        if (k < n_warp) {
          int j = 0;  // the owner mask's r-th set bit
          for (int i = 0; i < words; ++i) {
            const unsigned int m = live[warp][i][s];
            const int pc = __popc(m);
            if (r < pc) {
              j = (i << 5) + nth_bit(m, r);
              break;
            }
            r -= pc;
          }
          const int dy = j / R, dx = j - dy * R;
          const uint32_t tile = (uint32_t)((sy0 + dy) * tiles_x + sx0 + dx);
          out[k] = ((unsigned long long)(int64_t)(int32_t)((tile << 16) | sd) << 32)
                   | (uint32_t)((int)base + s);
        }
      }
    }
    __syncwarp();
  }
  ov = __reduce_add_sync(kFull, ov);
  if (lane == 0 && ov != 0) atomicAdd(overflow, ov);
}

}  // namespace

// counters: int32 [2], the overflow sum and the live count, zeroed here
extern "C" int sags_expand_pairs(const void* mx, const void* my, const void* ca,
                                 const void* cb, const void* cc, const void* op,
                                 const void* rmin_x, const void* rmin_y,
                                 const void* rmax_x, const void* rmax_y,
                                 const void* valid, const void* dq, int P, int R,
                                 int tiles_x, int num_tiles, float tile, float alpha_min,
                                 void* combined, void* counters, void* stream) {
  if (P < 0 || R < 1 || R > kMaxR || num_tiles < 0 || num_tiles >= (1 << 15) ||
      (long long)R * R * P > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (P > 0) {
    unsigned int* cnt = (unsigned int*)counters;
    const int grid = sagsg::grid_for<expand_pairs_kernel>(kThreads, P);
    expand_pairs_kernel<<<grid, kThreads, 0, s>>>(
        (const float*)mx, (const float*)my, (const float*)ca, (const float*)cb,
        (const float*)cc, (const float*)op, (const int32_t*)rmin_x,
        (const int32_t*)rmin_y, (const int32_t*)rmax_x, (const int32_t*)rmax_y,
        (const uint8_t*)valid, (const int32_t*)dq, P, R, tiles_x, tile, alpha_min,
        (unsigned long long*)combined, cnt, cnt + 1);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_expand_pairs_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
