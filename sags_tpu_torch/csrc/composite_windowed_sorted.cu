// composite_windowed_sorted: the windowed render with its depth order built
// inside the kernel (no host pair sort, no table).
//
// Replaces the Pallas TPU kernel `composite_windowed_sorted`
// (`sags_tpu/ops/pallas_windowed.py`, `_kernel_sorted`). For tile t, every
// slot s < w_blocks * 128 of the tile's window (block b = s / 128 of span j
// when dests[j] <= b < dests[j] + nblks[j]; global row
// (bases[j] + b - dests[j]) * 128 + s % 128) is valid iff
//   the row lies in its span, sstarts[j] <= row < sends[j];
//   the tile lies in the row's rect (columns 32..35: rmin_x, rmin_y, w, h);
//   the exact minimum of the row's conic quadratic over the tile's pixels is
//   at most the alpha-gate level c^2 (`ops/binning.py`: tile_qmin, cull_c2).
// A valid slot's key is (dq << 11) | s (dq: column 36), an invalid one
// 0x7FFFFFFF. The keys are sorted ascending, nv[t] counts the valid ones, and
// the first min(nv, k_tile) composite through windowed.cuh, the loop of
// composite_windowed.cu: with the same candidates in the same order the two
// kernels give the same bits. `ewa` and `prec` pick the variant of that loop
// (the in-kernel sort is never combined with windowed_bf16).
//
// Bound: arithmetic, as composite_windowed, plus per tile the key math over
// the window's slots and the sort's compare-exchanges.
// Design: one block per tile, 256 threads. The keys live in shared memory
// (2048 x 4 B); `bitonic_sort_shared` (bitonic.cuh) sorts the window width
// rounded up to a power of two. The validity test repeats `tile_qmin` and
// `cull_c2` step by step with round-to-nearest intrinsics (qmin.cuh: no fused
// multiply-add), in PyTorch's order of operations, so the kernel bins
// exactly the pairs that the host pair sort bins from the same rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"
#include "qmin.cuh"
#include "windowed.cuh"

namespace {

constexpr int SORT_MAX = 2048;  // 16 blocks of 128 slots
constexpr int IDX_BITS = 11;
constexpr int IDX_MASK = (1 << IDX_BITS) - 1;
constexpr int32_t KEY_INVALID = 0x7FFFFFFF;
constexpr int COL_RMIN_X = 32, COL_RMIN_Y = 33, COL_RECT_W = 34,
              COL_RECT_H = 35, COL_DQ = 36;

// binning.tile_qmin(...) <= binning.cull_c2(op, alpha_min)
__device__ bool alpha_live(const float* row, int tx, int ty, float T,
                           float alpha_min) {
  const float mx = row[0], my = row[1];
  const float txT = __fmul_rn((float)tx, T);
  const float tyT = __fmul_rn((float)ty, T);
  const float x0 = __fsub_rn(txT, mx);
  const float x1 = __fsub_rn(__fadd_rn(txT, T - 1.f), mx);
  const float y0 = __fsub_rn(tyT, my);
  const float y1 = __fsub_rn(__fadd_rn(tyT, T - 1.f), my);
  const float qmin = sagsq::box_qmin(row[2], row[3], row[4], x0, x1, y0, y1);
  const float c2 =
      __fadd_rn(__fmul_rn(sagsq::gate_level(row[5], alpha_min), 1.00001f), 1e-6f);
  return qmin <= c2;
}

struct SortedIds {
  const int32_t* keys;
  __device__ int operator()(int k) const {
    const int32_t key = keys[k];
    return key == KEY_INVALID ? -1 : (key & IDX_MASK);
  }
};

}  // namespace

template <int EWA, int PREC>
__global__ void __launch_bounds__(256) composite_windowed_sorted_kernel(
    const float* __restrict__ G, int row_stride, int n_rows,
    const int32_t* __restrict__ bases, const int32_t* __restrict__ dests,
    const int32_t* __restrict__ nblks, const int32_t* __restrict__ sstarts,
    const int32_t* __restrict__ sends, int n_span, int w_blocks, int n_sort,
    int k_tile, int tile, int tiles_x, int tile_offset, float alpha_min,
    float t_min, int chunk, float* __restrict__ acc_out,
    float* __restrict__ T_out, int32_t* __restrict__ nv_out) {
  __shared__ sagsw::Spans spans;
  __shared__ int span_start[sagsw::MAX_SPAN];
  __shared__ int span_end[sagsw::MAX_SPAN];
  __shared__ __align__(16) int32_t keys[SORT_MAX];  // bitonic.cuh moves 16 bytes a thread
  __shared__ int n_valid;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < n_span) {
    const int i = t * n_span + tid;
    spans.base[tid] = bases[i];
    spans.dest[tid] = dests[i];
    spans.nblk[tid] = nblks[i];
    span_start[tid] = sstarts[i];
    span_end[tid] = sends[i];
  }
  if (tid == 0) {
    spans.n = n_span;
    n_valid = 0;
  }
  __syncthreads();
  const int tg = t + tile_offset;  // global tile id (pixel coordinates)
  const int tx = tg % tiles_x, ty = tg / tiles_x;
  const float T = (float)tile;

  int mine = 0;
  for (int s = tid; s < n_sort; s += blockDim.x) {
    int32_t key = KEY_INVALID;
    const int b = s >> 7;
    if (b < w_blocks) {
      int j = 0;
      while (j < n_span && !(spans.dest[j] <= b && b < spans.dest[j] + spans.nblk[j])) ++j;
      if (j < n_span) {
        const int grow = (spans.base[j] + b - spans.dest[j]) * 128 + (s & 127);
        if (grow >= span_start[j] && grow < span_end[j] && grow < n_rows) {
          const float* row = G + (size_t)grow * row_stride;
          const int rx = (int)row[COL_RMIN_X], ry = (int)row[COL_RMIN_Y];
          const int rw = (int)row[COL_RECT_W], rh = (int)row[COL_RECT_H];
          if (rx <= tx && tx < rx + rw && ry <= ty && ty < ry + rh &&
              alpha_live(row, tx, ty, T, alpha_min)) {
            key = ((int32_t)row[COL_DQ] << IDX_BITS) | s;
            ++mine;
          }
        }
      }
    }
    keys[s] = key;
  }
  if (mine) atomicAdd(&n_valid, mine);
  bitonic_sort_shared(keys, n_sort);  // barriers before and after
  const int nv = n_valid;
  if (tid == 0) nv_out[t] = nv;

  const int PIX = blockDim.x;
  const SortedIds ids{keys};
  sagsw::composite_window<EWA, PREC, false>(
      G, row_stride, n_rows, ids, min(nv, k_tile), spans, tile, (float)(tx * tile),
      (float)(ty * tile), alpha_min, t_min, chunk, acc_out + (size_t)t * PIX * sagsw::CF,
      T_out + (size_t)t * PIX);
}

namespace {

using Kernel = void (*)(const float*, int, int, const int32_t*, const int32_t*,
                        const int32_t*, const int32_t*, const int32_t*, int, int, int,
                        int, int, int, int, float, float, int, float*, float*, int32_t*);
// [ewa][prec]
const Kernel kVariants[2][3] = {
    {composite_windowed_sorted_kernel<0, 0>, composite_windowed_sorted_kernel<0, 1>,
     composite_windowed_sorted_kernel<0, 2>},
    {composite_windowed_sorted_kernel<1, 0>, composite_windowed_sorted_kernel<1, 1>,
     composite_windowed_sorted_kernel<1, 2>}};

}  // namespace

extern "C" int sags_composite_windowed_sorted(
    const void* G, int row_stride, int n_rows, const void* bases,
    const void* dests, const void* nblks, const void* sstarts,
    const void* sends, int n_span, int num_tiles, int w_blocks, int n_sort,
    int k_tile, int tile, int tiles_x, int tile_offset, float alpha_min,
    float t_min, int chunk, int ewa, int prec, void* acc_out, void* T_out,
    void* nv_out, void* stream) {
  if (n_span < 1 || n_span > sagsw::MAX_SPAN || chunk < 1 || n_sort > SORT_MAX ||
      (n_sort & (n_sort - 1)) || w_blocks * 128 > n_sort || k_tile > SORT_MAX ||
      ewa < 0 || ewa > 1 || prec < 0 || prec > 2)
    return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    kVariants[ewa][prec]<<<num_tiles, tile * tile, 0, (cudaStream_t)stream>>>(
        (const float*)G, row_stride, n_rows, (const int32_t*)bases,
        (const int32_t*)dests, (const int32_t*)nblks, (const int32_t*)sstarts,
        (const int32_t*)sends, n_span, w_blocks, n_sort, k_tile, tile, tiles_x,
        tile_offset, alpha_min, t_min, chunk, (float*)acc_out, (float*)T_out,
        (int32_t*)nv_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_composite_windowed_sorted_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
