// expand_pairs: the classic rasterizer's pair expansion, one pass over the
// Gaussian slots.
//
// Replaces no TPU kernel: the JAX package leaves this expansion to XLA,
// which fuses its loop over the R x R tile offsets into one pass. In the
// port that loop was ~94 PyTorch ops an offset, each a launch over every
// slot (`ops/binning.py:expand_pairs_plain`, which stays the plain version).
// For slot g and offset j = dy * R + dx, entry j * P + g of the int64 output
// is
//   ((int64)((tile << 16) | dq[g]) << 32) | g   for a live pair,
//   ((int64)(NT << 16) << 32) | g               otherwise,
// with tile = (rmin_y + dy) * tiles_x + rmin_x + dx. A pair is live iff the
// slot is valid, dx < rect width, dy < rect height, and the exact minimum of
// the slot's conic quadratic over the tile's pixel box (`binning.tile_qmin`)
// is at most the alpha-gate level c^2 (`binning.cull_c2`), each repeated step
// by step with round-to-nearest intrinsics (qmin.cuh), so the array is the
// plain version's bit for bit. `overflow` gets the sum over valid slots of
// the rect's tiles beyond the R x R window (int32, wrapping as the plain
// version's int64 sum cast to int32 does): one integer atomic a warp, so the
// order of the additions changes nothing.
//
// Bound: device memory. It writes MT * P * 8 bytes (1.21 GB at P = 2^22 and
// MT = 36: 0.36 ms at 3.35 TB/s) and reads each slot's valid flag and, for a
// valid slot, its rect, dq, centre, conic and opacity once (44 bytes).
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
// live mask in shared memory. Then each lane stores its slot's R x R entries
// from its mask: the store of offset j goes to j * P + g, so the warp's 32
// stores for one offset are 256 contiguous bytes. Up to 16 x 16 offsets (8
// mask words a slot).

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

__global__ void __launch_bounds__(kThreads)
expand_pairs_kernel(const float* __restrict__ mx, const float* __restrict__ my,
                    const float* __restrict__ ca, const float* __restrict__ cb,
                    const float* __restrict__ cc, const float* __restrict__ op,
                    const int32_t* __restrict__ rmin_x, const int32_t* __restrict__ rmin_y,
                    const int32_t* __restrict__ rmax_x, const int32_t* __restrict__ rmax_y,
                    const uint8_t* __restrict__ valid, const int32_t* __restrict__ dq,
                    int P, int R, int tiles_x, int num_tiles, float T, float alpha_min,
                    unsigned long long* __restrict__ combined,
                    unsigned int* __restrict__ overflow) {
  // live[warp][word][lane]: bit j % 32 of word j / 32 is offset j of the
  // lane's slot; word-major, so a lane reading its own words hits its bank
  __shared__ unsigned int live[kWarps][kMaxWords][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int MT = R * R;
  const int words = (MT + 31) >> 5;
  const unsigned long long dead = (unsigned long long)(uint32_t)(num_tiles << 16) << 32;
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
    unsigned long long* out = combined + g;
    const unsigned long long gid = (uint32_t)g;
    unsigned int m = 0;
    int j = 0;
    for (int dy = 0; dy < R; ++dy) {
      for (int dx = 0; dx < R; ++dx, ++j) {
        if ((j & 31) == 0) m = live[warp][j >> 5][lane];
        unsigned long long key = dead;
        if ((m >> (j & 31)) & 1u) {
          const uint32_t tile = (uint32_t)((y0 + dy) * tiles_x + x0 + dx);
          key = (unsigned long long)(int64_t)(int32_t)((tile << 16) | d) << 32;
        }
        if (g < P) out[(long long)j * P] = key | gid;
      }
    }
    __syncwarp();
  }
  ov = __reduce_add_sync(kFull, ov);
  if (lane == 0 && ov != 0) atomicAdd(overflow, ov);
}

}  // namespace

extern "C" int sags_expand_pairs(const void* mx, const void* my, const void* ca,
                                 const void* cb, const void* cc, const void* op,
                                 const void* rmin_x, const void* rmin_y,
                                 const void* rmax_x, const void* rmax_y,
                                 const void* valid, const void* dq, int P, int R,
                                 int tiles_x, int num_tiles, float tile, float alpha_min,
                                 void* combined, void* overflow, void* stream) {
  if (P < 0 || R < 1 || R > kMaxR || num_tiles < 0 || num_tiles >= (1 << 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(overflow, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (P > 0) {
    const int grid = sagsg::grid_for<expand_pairs_kernel>(kThreads, P);
    expand_pairs_kernel<<<grid, kThreads, 0, s>>>(
        (const float*)mx, (const float*)my, (const float*)ca, (const float*)cb,
        (const float*)cc, (const float*)op, (const int32_t*)rmin_x,
        (const int32_t*)rmin_y, (const int32_t*)rmax_x, (const int32_t*)rmax_y,
        (const uint8_t*)valid, (const int32_t*)dq, P, R, tiles_x, num_tiles, tile,
        alpha_min, (unsigned long long*)combined, (unsigned int*)overflow);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_expand_pairs_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
