// composite_windowed: front-to-back compositing of each tile's depth-ordered
// work list of window-local ids (the windowed render path).
//
// Replaces the Pallas TPU kernel `composite_windowed` (`sags_tpu/ops/
// pallas_windowed.py`, `_kernel` + `_select_and_composite`). Tile t
// composites the first counts[t] entries of table_local[t, :] (-1 = empty),
// each resolved through the tile's span plan (bases, dests, nblks) to a row
// of the anchor-sorted store G_s [n_rows, row_stride]; columns 0..31 are
// mx my ca cb cc op pad pad | 24 features. Outputs acc[t, p, 0:24] and
// T[t, p]. `ewa` (0 longhand, 1 quad), `prec` (0 highest, 1 high, 2
// default) and `bf16_obj` pick the variant of windowed.cuh's loop.
//
// Bound: float32 arithmetic, as composite_fused: each (pixel, entry) the
// loop evaluates costs an expf and ~20 rounded operations, a composited one
// 24-72 more; each entry's 128-byte row (160 under bf16_obj) is read once
// per tile. Design: one block of 256 threads per 16x16 tile, and the loop
// of windowed.cuh (rows gathered a group ahead by cp.async, a per-warp strip
// cull, one barrier a group). The TPU kernel's VMEM candidate window (14
// blocks of 32x128 floats at the default budget, 229 KB; up to 40 after
// adaptation) is not reproduced: the ids resolve through the <= 8 spans and
// only the rows the work list names are read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "windowed.cuh"

namespace {

struct TableIds {
  const int32_t* row;
  __device__ int operator()(int k) const { return row[k]; }
};

}  // namespace

template <int EWA, int PREC, bool BF16OBJ>
__global__ void __launch_bounds__(sagsw::PIX, sagsw::MIN_BLOCKS)
composite_windowed_kernel(const float* __restrict__ G, int row_stride,
                          int n_rows, const int32_t* __restrict__ table_local,
                          const int32_t* __restrict__ counts,
                          const int32_t* __restrict__ bases,
                          const int32_t* __restrict__ dests,
                          const int32_t* __restrict__ nblks, int n_span, int K,
                          int tile, int tiles_x, int tile_offset,
                          float alpha_min, float t_min, int chunk,
                          float* __restrict__ acc_out,
                          float* __restrict__ T_out) {
  __shared__ sagsw::Spans spans;
  __shared__ __align__(16) float rows[2 * sagsw::SUB * sagsw::RowStride<BF16OBJ>::value];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < n_span) {
    spans.base[tid] = bases[t * n_span + tid];
    spans.dest[tid] = dests[t * n_span + tid];
    spans.nblk[tid] = nblks[t * n_span + tid];
  }
  if (tid == 0) spans.n = n_span;
  __syncthreads();
  const int tg = t + tile_offset;  // global tile id (pixel coordinates)
  const TableIds ids{table_local + (size_t)t * K};
  const int count = min(counts[t], K);
  sagsw::composite_window<EWA, PREC, BF16OBJ>(
      rows, G, row_stride, n_rows, ids, count, spans, (float)((tg % tiles_x) * tile),
      (float)((tg / tiles_x) * tile), alpha_min, t_min, chunk,
      acc_out + (size_t)t * sagsw::PIX * sagsw::CF, T_out + (size_t)t * sagsw::PIX);
}

namespace {

using Kernel = void (*)(const float*, int, int, const int32_t*, const int32_t*,
                        const int32_t*, const int32_t*, const int32_t*, int, int,
                        int, int, int, float, float, int, float*, float*);
// [ewa][prec][bf16_obj]
const Kernel kVariants[2][3][2] = {
    {{composite_windowed_kernel<0, 0, false>, composite_windowed_kernel<0, 0, true>},
     {composite_windowed_kernel<0, 1, false>, composite_windowed_kernel<0, 1, true>},
     {composite_windowed_kernel<0, 2, false>, composite_windowed_kernel<0, 2, true>}},
    {{composite_windowed_kernel<1, 0, false>, composite_windowed_kernel<1, 0, true>},
     {composite_windowed_kernel<1, 1, false>, composite_windowed_kernel<1, 1, true>},
     {composite_windowed_kernel<1, 2, false>, composite_windowed_kernel<1, 2, true>}}};

}  // namespace

extern "C" int sags_composite_windowed(
    const void* G, int row_stride, int n_rows, const void* table_local,
    const void* counts, const void* bases, const void* dests, const void* nblks,
    int n_span, int num_tiles, int K, int tile, int tiles_x, int tile_offset,
    float alpha_min, float t_min, int chunk, int ewa, int prec, int bf16_obj,
    void* acc_out, void* T_out, void* stream) {
  if (n_span < 1 || n_span > sagsw::MAX_SPAN || chunk < 1 || ewa < 0 || ewa > 1 ||
      prec < 0 || prec > 2 || bf16_obj < 0 || bf16_obj > 1 || tile != sagsw::TILE ||
      row_stride < sagsw::CH || row_stride % 4 || (reinterpret_cast<uintptr_t>(G) & 15) ||
      (bf16_obj && row_stride < sagsw::COL_OBJ_BF16 + sagsw::N_OBJ / 2))
    return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    kVariants[ewa][prec][bf16_obj]<<<num_tiles, sagsw::PIX, 0, (cudaStream_t)stream>>>(
        (const float*)G, row_stride, n_rows, (const int32_t*)table_local,
        (const int32_t*)counts, (const int32_t*)bases, (const int32_t*)dests,
        (const int32_t*)nblks, n_span, K, tile, tiles_x, tile_offset,
        alpha_min, t_min, chunk, (float*)acc_out, (float*)T_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_composite_windowed_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
