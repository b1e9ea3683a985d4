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
// A valid slot's key is (dq << 11) | s (dq: column 36). nv[t] counts the
// valid slots, and the first min(nv, k_tile) in key order composite through
// windowed.cuh, the loop of composite_windowed.cu: with the same candidates
// in the same order the two kernels give the same bits. `ewa` and `prec`
// pick the variant of that loop (the in-kernel sort is never combined with
// windowed_bf16).
//
// Bound: float32 arithmetic, as composite_windowed, plus per tile the key
// test over the window's rows (11 floats read and ~40 operations each) and
// the sort's compare-exchanges. Design: one block of 256 threads per tile,
// in three phases.
//   keys: span by span, a warp takes 32 neighbouring rows of the span's part
//     of the window (the spans are disjoint in the window: dests are the
//     running sum of nblks, `rasterize._spans`), reads the rect as one
//     16-byte load and the conic only for a row whose rect holds the tile,
//     and appends the valid keys densely to shared memory (ballot, a prefix
//     popcount and one atomicAdd a warp). The validity test repeats
//     `tile_qmin` and `cull_c2` step by step with round-to-nearest intrinsics
//     (qmin.cuh: no fused multiply-add), in PyTorch's order of operations, so
//     the kernel bins exactly the pairs that the host pair sort bins from the
//     same rows;
//   sort: `bitonic_sort_shared` (bitonic.cuh) of the nv keys padded with
//     KEY_INVALID to the next power of two, not of the whole window (at the
//     kernel cell most slots are invalid). The keys carry their slot in the
//     low bits and are unique, so the order does not depend on the order in
//     which the warps appended them;
//   composite: windowed.cuh's loop over the first min(nv, k_tile) keys.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"
#include "qmin.cuh"
#include "windowed.cuh"

// SAGSW_STOP_AFTER=1 (2) ends the kernel after the keys (the sort), writing
// nv only: the variants that time the phases.
#ifndef SAGSW_STOP_AFTER
#define SAGSW_STOP_AFTER 0
#endif

namespace {

constexpr int SORT_MAX = 2048;  // 16 blocks of 128 slots
constexpr int IDX_BITS = 11;
constexpr int IDX_MASK = (1 << IDX_BITS) - 1;
constexpr int32_t KEY_INVALID = 0x7FFFFFFF;
constexpr int COL_RMIN_X = 32, COL_DQ = 36;

// binning.tile_qmin(...) <= binning.cull_c2(op, alpha_min) for the row with
// header h = (mx, my, ca, cb), g = (cc, op)
__device__ __forceinline__ bool alpha_live(float4 h, float2 g, int tx, int ty, float T,
                                           float alpha_min) {
  const float txT = __fmul_rn((float)tx, T);
  const float tyT = __fmul_rn((float)ty, T);
  const float x0 = __fsub_rn(txT, h.x);
  const float x1 = __fsub_rn(__fadd_rn(txT, T - 1.f), h.x);
  const float y0 = __fsub_rn(tyT, h.y);
  const float y1 = __fsub_rn(__fadd_rn(tyT, T - 1.f), h.y);
  const float qmin = sagsq::box_qmin(h.z, h.w, g.x, x0, x1, y0, y1);
  const float c2 =
      __fadd_rn(__fmul_rn(sagsq::gate_level(g.y, alpha_min), 1.00001f), 1e-6f);
  return qmin <= c2;
}

struct SortedIds {  // k < nv: every key read is valid
  const int32_t* keys;
  __device__ int operator()(int k) const { return keys[k] & IDX_MASK; }
};

}  // namespace

template <int EWA, int PREC>
__global__ void __launch_bounds__(sagsw::PIX, sagsw::MIN_BLOCKS) composite_windowed_sorted_kernel(
    const float* __restrict__ G, int row_stride, int n_rows,
    const int32_t* __restrict__ bases, const int32_t* __restrict__ dests,
    const int32_t* __restrict__ nblks, const int32_t* __restrict__ sstarts,
    const int32_t* __restrict__ sends, int n_span, int w_blocks, int k_tile, int tile,
    int tiles_x, int tile_offset, float alpha_min, float t_min, int chunk,
    float* __restrict__ acc_out, float* __restrict__ T_out, int32_t* __restrict__ nv_out) {
  __shared__ sagsw::Spans spans;
  __shared__ int span_start[sagsw::MAX_SPAN];
  __shared__ int span_end[sagsw::MAX_SPAN];
  __shared__ __align__(16) int32_t keys[SORT_MAX];  // bitonic.cuh moves 16 bytes a thread
  __shared__ __align__(16) float rows[2 * sagsw::SUB * sagsw::RowStride<false>::value];
  __shared__ int n_valid;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
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

  for (int j = 0; j < n_span; ++j) {
    // the rows of span j inside the window: blocks dest .. dest + nb - 1
    const int nb = min(spans.nblk[j], w_blocks - spans.dest[j]);
    const int row0 = spans.base[j] * 128;
    const int lo = max(span_start[j], row0);
    const int hi = min(min(span_end[j], n_rows), row0 + max(nb, 0) * 128);
    const int slot_of_row = spans.dest[j] * 128 - row0;
    for (int r0 = lo + warp * 32; r0 < hi; r0 += blockDim.x) {  // warp-uniform
      const int grow = r0 + lane;
      bool ok = false;
      int32_t key = KEY_INVALID;
      if (grow < hi) {
        const float* row = G + (size_t)grow * row_stride;
        const float4 rect = *reinterpret_cast<const float4*>(row + COL_RMIN_X);
        const int rx = (int)rect.x, ry = (int)rect.y, rw = (int)rect.z, rh = (int)rect.w;
        if (rx <= tx && tx < rx + rw && ry <= ty && ty < ry + rh) {  // the conic only here
          const float4 h = *reinterpret_cast<const float4*>(row);
          const float2 g = *reinterpret_cast<const float2*>(row + 4);
          ok = alpha_live(h, g, tx, ty, T, alpha_min);
          if (ok) key = ((int32_t)row[COL_DQ] << IDX_BITS) | (grow + slot_of_row);
        }
      }
      const unsigned vote = __ballot_sync(sagsw::FULL, ok);
      int at = 0;
      if (lane == 0 && vote) at = atomicAdd(&n_valid, __popc(vote));
      at = __shfl_sync(sagsw::FULL, at, 0);
      if (ok) keys[at + __popc(vote & ((1u << lane) - 1u))] = key;
    }
  }
  __syncthreads();
  const int nv = n_valid;
  int n = 1;  // the valid keys, padded to a power of two
  while (n < nv) n <<= 1;
  for (int i = nv + tid; i < n; i += blockDim.x) keys[i] = KEY_INVALID;
  if (tid == 0) nv_out[t] = nv;
  if (SAGSW_STOP_AFTER == 1) return;
  bitonic_sort_shared(keys, n);  // barriers before and after
  if (SAGSW_STOP_AFTER == 2) return;

  const SortedIds ids{keys};
  sagsw::composite_window<EWA, PREC, false>(
      rows, G, row_stride, n_rows, ids, min(nv, k_tile), spans, (float)(tx * tile),
      (float)(ty * tile), alpha_min, t_min, chunk, acc_out + (size_t)t * sagsw::PIX * sagsw::CF,
      T_out + (size_t)t * sagsw::PIX);
}

namespace {

using Kernel = void (*)(const float*, int, int, const int32_t*, const int32_t*,
                        const int32_t*, const int32_t*, const int32_t*, int, int, int,
                        int, int, int, float, float, int, float*, float*, int32_t*);
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
      ewa < 0 || ewa > 1 || prec < 0 || prec > 2 || tile != sagsw::TILE ||
      row_stride < COL_DQ + 1 || row_stride % 4 || (reinterpret_cast<uintptr_t>(G) & 15))
    return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    kVariants[ewa][prec]<<<num_tiles, sagsw::PIX, 0, (cudaStream_t)stream>>>(
        (const float*)G, row_stride, n_rows, (const int32_t*)bases,
        (const int32_t*)dests, (const int32_t*)nblks, (const int32_t*)sstarts,
        (const int32_t*)sends, n_span, w_blocks, k_tile, tile, tiles_x,
        tile_offset, alpha_min, t_min, chunk, (float*)acc_out, (float*)T_out,
        (int32_t*)nv_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_composite_windowed_sorted_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
