// windowed.cuh: the compositing loop shared by composite_windowed.cu (work
// list from the host pair sort) and composite_windowed_sorted.cu (work list
// sorted in the kernel), so both render a tile with the same arithmetic.
//
// A tile's work list holds window-local ids. Span j of the tile numbers the
// rows of the 128-row blocks bases[j] .. bases[j] + nblks[j] - 1 of the
// anchor-sorted store G_s from dests[j] * 128 on, so id i with
// dests[j] * 128 <= i < (dests[j] + nblks[j]) * 128 is global row
// bases[j] * 128 + i - dests[j] * 128. The TPU kernels copy those blocks into
// a VMEM window first; here each id is resolved through the <= R spans and
// its row is gathered straight from G_s.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sagsw {

constexpr int SUB = 32;  // work-list entries staged in shared memory per round
constexpr int CH = 32;   // columns composited: 8 header + 24 feature floats
constexpr int HDR = 8;
constexpr int CF = CH - HDR;
constexpr int MAX_SPAN = 8;

struct Spans {
  int base[MAX_SPAN];
  int dest[MAX_SPAN];
  int nblk[MAX_SPAN];
  int n;
};

// Global row of window-local id `lid`, or -1 (empty slot, or no span).
__device__ __forceinline__ int window_row(int lid, const Spans& s) {
  if (lid < 0) return -1;
  const int b = lid >> 7;
  for (int j = 0; j < s.n; ++j) {
    if (b >= s.dest[j] && b < s.dest[j] + s.nblk[j])
      return (s.base[j] - s.dest[j]) * 128 + lid;
  }
  return -1;
}

// Composite the first `count` entries of a tile's work list, `ids(k)` giving
// the k-th window-local id. One thread per pixel (px, py); the block is the
// tile. The gates are the TPU kernel's (`pallas_windowed.py:264-326`):
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy,  alpha = min(0.99, op e^power)
//   gated iff power <= 0 and alpha >= alpha_min (an empty slot reads a zero
//   row: opacity 0 fails the gate)
//   a gated pair adds w = alpha T and sets T *= (1 - alpha) while
//   T (1 - alpha) >= t_min; the first failure cuts the pixel until the next
//   boundary of `chunk` entries.
// Writes acc[pixel * 24 + c] and T[pixel] of this tile.
template <class Ids>
__device__ __forceinline__ void composite_window(const float* __restrict__ G, int row_stride,
                                 int n_rows, const Ids& ids, int count,
                                 const Spans& spans, float px, float py,
                                 float alpha_min, float t_min, int chunk,
                                 float* __restrict__ acc_out,
                                 float* __restrict__ T_out) {
  __shared__ float rows[SUB][CH];
  __shared__ int srow[SUB];
  const int tid = threadIdx.x;
  const int PIX = blockDim.x;
  const float om_max = 1.f - alpha_min;

  float acc[CF];
#pragma unroll
  for (int c = 0; c < CF; ++c) acc[c] = 0.f;
  float T = 1.f;
  bool cut = false;

  for (int base = 0; base < count; base += SUB) {
    // no pixel can take another pair (T (1 - alpha) < t_min for every
    // alpha >= alpha_min): the tile is done
    if (__syncthreads_count(T * om_max >= t_min) == 0) break;
    const int n = min(SUB, count - base);
    if (tid < n) {
      const int r = window_row(ids(base + tid), spans);
      srow[tid] = r < n_rows ? r : -1;
    }
    __syncthreads();
    for (int i = tid; i < n * CH; i += PIX) {
      const int k = i / CH, c = i - k * CH;
      const int r = srow[k];
      rows[k][c] = r >= 0 ? G[(size_t)r * row_stride + c] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      if ((base + k) % chunk == 0) cut = false;
      if (cut) continue;
      const float dx = rows[k][0] - px;
      const float dy = rows[k][1] - py;
      const float power =
          -0.5f * (rows[k][2] * dx * dx + rows[k][4] * dy * dy) -
          rows[k][3] * dx * dy;
      const float alpha = fminf(0.99f, rows[k][5] * expf(power));
      if (!(power <= 0.f && alpha >= alpha_min)) continue;
      const float test = T * (1.f - alpha);
      if (test < t_min) {
        cut = true;
        continue;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < CF; ++c) acc[c] += w * rows[k][HDR + c];
      T = test;
    }
    __syncthreads();
  }

  float4* dst = reinterpret_cast<float4*>(acc_out + (size_t)tid * CF);
#pragma unroll
  for (int v = 0; v < CF / 4; ++v)
    dst[v] = make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2],
                         acc[4 * v + 3]);
  T_out[tid] = T;
}

}  // namespace sagsw
