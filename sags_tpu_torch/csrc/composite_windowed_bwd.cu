// composite_windowed_bwd: per-pair gradients of composite_windowed.
//
// Replaces the Pallas TPU kernel `composite_windowed_bwd` (`sags_tpu/ops/
// pallas_windowed.py`, `_bwd_kernel`). Entry k of tile t's window-local work
// list table_local[t, :] (-1 = empty) resolves through the tile's span plan
// to a row of the anchor-sorted store G_s, as in composite_windowed.cu. For
// every entry it writes dGt[t, :, k]: the gradients of the row's first 32
// columns (mx, my, ca, cb, cc, op in rows 0-5, zeros in rows 6-7, the 24
// feature rows in 8-31), summed over the tile's 256 pixels, in table order.
//
// Transmittance in log space, as the TPU kernel (`pallas_windowed.py:
// 405-427`): inside a chunk of `chunk` entries,
//   T_exc_k = T_entry exp(sum over gated j < k of log1p(-alpha_j)),
//   m_k = gate_k and T_exc_k (1 - alpha_k) >= t_min,
// and the next chunk enters at T_entry exp(sum over m of log1p(-alpha)).
// The per-entry gradient and its reduction are composite_fused_bwd.cu's
// (pair_grads.cuh). Empty and window-dropped entries read zero rows: opacity
// 0 fails the alpha gate. The exponent is the forward's (windowed.cuh
// `ewa_power`), so the two gate every entry alike.
//
// Bound: arithmetic and the per-pair reduction, as composite_fused_bwd: each
// (pixel, entry) costs three exps and a log1p (the group is recomputed
// forward, then walked in reverse), ~190 flops, and a 30-value reduction over
// the tile's 256 pixels.
// Design: composite_fused_bwd.cu's, on the windowed work list. One block per
// tile, one thread per pixel. The forward sweep records, per 32-entry group,
// the log-space prefix at the group's start, and per chunk the entry T, in
// shared memory; the reverse sweep recomputes each group forward from that
// record and walks it backwards with the suffix sums in registers. Each
// entry's 30 per-pixel values are reduced with warp shuffles, then across the
// 8 warps through shared memory in a fixed order, and written once: no
// atomics, so dGt is bitwise reproducible. Groups past the point where no
// pixel of the tile can take another pair contribute exactly zero and are
// only zero-filled. No VMEM window: rows are gathered from G_s by id.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_grads.cuh"
#include "windowed.cuh"

namespace {
constexpr int SUB = sagsw::SUB;  // entries per group (one bit each in a uint32)
constexpr int CH = sagsb::CH;
constexpr int CF = sagsb::CF;
constexpr int NR = sagsb::NR;
}  // namespace

__global__ void __launch_bounds__(256) composite_windowed_bwd_kernel(
    const float* __restrict__ G, int row_stride, int n_rows,
    const int32_t* __restrict__ table_local, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ bases, const int32_t* __restrict__ dests,
    const int32_t* __restrict__ nblks, int n_span, int K, int tile, int tiles_x,
    int tile_offset, float alpha_min, float t_min, int chunk,
    const float* __restrict__ d_acc, const float* __restrict__ d_T,
    const float* __restrict__ T_final, float* __restrict__ dGt) {
  extern __shared__ float smem[];
  __shared__ sagsw::Spans spans;
  __shared__ int srow[SUB];
  const int PIX = blockDim.x;
  const int NW = PIX / 32;
  const int n_groups_max = (K + SUB - 1) / SUB;
  float* rows = smem;                       // [SUB][CH]
  float* texc = rows + SUB * CH;            // [SUB][PIX] exclusive T per entry
  float* red = texc + SUB * PIX;            // [SUB][NW][NR] warp partial sums
  float* gcum = red + SUB * NW * NR;        // [K/SUB][PIX] log prefix at group start
  float* tent = gcum + n_groups_max * PIX;  // [K/chunk][PIX] chunk-entry T

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid < n_span) {
    spans.base[tid] = bases[t * n_span + tid];
    spans.dest[tid] = dests[t * n_span + tid];
    spans.nblk[tid] = nblks[t * n_span + tid];
  }
  if (tid == 0) spans.n = n_span;
  __syncthreads();
  const int tg = t + tile_offset;  // global tile id (pixel coordinates)
  const float px = (float)((tg % tiles_x) * tile + tid % tile);
  const float py = (float)((tg / tiles_x) * tile + tid / tile);
  const int count = min(counts[t], K);
  const float om_max = 1.f - alpha_min;
  const int32_t* ids = table_local + (size_t)t * K;
  float* out = dGt + (size_t)t * CH * K;

  // rows of entries base .. base + n - 1 into shared memory (zeros if empty)
  auto stage = [&](int base, int n) {
    if (tid < n) {
      const int r = sagsw::window_row(ids[base + tid], spans);
      srow[tid] = r < n_rows ? r : -1;
    }
    __syncthreads();
    for (int i = tid; i < n * CH; i += PIX) {
      const int k = i / CH, c = i - k * CH;
      const int r = srow[k];
      rows[k * CH + c] = r >= 0 ? G[(size_t)r * row_stride + c] : 0.f;
    }
    __syncthreads();
  };

  // ---- forward sweep: chunk-entry T and per-group log prefixes ----
  float Tent = 1.f, cum = 0.f, msum = 0.f;
  int n_groups = 0;
  for (int base = 0; base < count; base += SUB, ++n_groups) {
    if (base % chunk == 0) {
      if (base > 0) Tent = Tent * expf(msum);
      cum = 0.f;
      msum = 0.f;
      tent[(base / chunk) * PIX + tid] = Tent;
    }
    // no pixel can pass T (1 - alpha) >= t_min again: the tile is done
    if (__syncthreads_count(Tent * expf(msum) * om_max >= t_min) == 0) break;
    const int n = min(SUB, count - base);
    stage(base, n);
    gcum[n_groups * PIX + tid] = cum;
    for (int k = 0; k < n; ++k) {
      const float* r = rows + k * CH;
      const float power = sagsw::ewa_power(r, r[0] - px, r[1] - py);
      const float alpha = fminf(0.99f, r[5] * expf(power));
      if (!(power <= 0.f && alpha >= alpha_min)) continue;
      const float lom = log1pf(-alpha);
      if (Tent * expf(cum) * (1.f - alpha) >= t_min) msum += lom;
      cum += lom;
    }
  }

  // entries past the last live group have exactly zero gradient
  const int k_live = min(count, n_groups * SUB);
  for (int i = tid; i < CH * K; i += PIX) {
    const int k = i % K;
    if (k >= k_live) out[i] = 0.f;
  }

  float dacc[CF];
  {
    const float4* src =
        reinterpret_cast<const float4*>(d_acc + ((size_t)t * PIX + tid) * CF);
#pragma unroll
    for (int v = 0; v < CF / 4; ++v) {
      const float4 q = src[v];
      dacc[4 * v] = q.x;
      dacc[4 * v + 1] = q.y;
      dacc[4 * v + 2] = q.z;
      dacc[4 * v + 3] = q.w;
    }
  }
  float carry = T_final[(size_t)t * PIX + tid] * d_T[(size_t)t * PIX + tid];
  float B = 0.f;  // sum of w s over later entries of the current chunk

  // ---- reverse sweep, one group at a time ----
  for (int gi = n_groups - 1; gi >= 0; --gi) {
    const int base = gi * SUB;
    const int n = min(SUB, count - base);
    __syncthreads();  // previous group's rows/red fully consumed
    stage(base, n);

    // recompute the group forward from its recorded log prefix
    const float Tc = tent[(base / chunk) * PIX + tid];
    float c_log = gcum[gi * PIX + tid];
    unsigned gbits = 0u, mbits = 0u;
    for (int k = 0; k < n; ++k) {
      const float* r = rows + k * CH;
      const float Te = Tc * expf(c_log);
      texc[k * PIX + tid] = Te;
      const float power = sagsw::ewa_power(r, r[0] - px, r[1] - py);
      const float alpha = fminf(0.99f, r[5] * expf(power));
      if (!(power <= 0.f && alpha >= alpha_min)) continue;
      gbits |= 1u << k;
      if (Te * (1.f - alpha) >= t_min) mbits |= 1u << k;
      c_log += log1pf(-alpha);
    }

    for (int k = n - 1; k >= 0; --k) {
      const float* r = rows + k * CH;
      const bool gate = (gbits >> k) & 1u;
      float v[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) v[q] = 0.f;
      if (gate) {
        const float dx = r[0] - px, dy = r[1] - py;
        sagsb::entry_grads(r, dx, dy, r[5] * expf(sagsw::ewa_power(r, dx, dy)),
                           (mbits >> k) & 1u, texc[k * PIX + tid], dacc, carry, B, v);
      }
      if ((base + k) % chunk == 0) {  // leaving the chunk backwards
        carry += B;
        B = 0.f;
      }
      sagsb::warp_sums(v, gate, red + (k * NW + warp) * NR, lane);
    }
    __syncthreads();
    sagsb::write_entry_sums(red, out, K, base, n, NW);
  }
}

extern "C" size_t sags_composite_windowed_bwd_smem(int K, int pix, int chunk) {
  const int nw = pix / 32;
  const int groups = (K + SUB - 1) / SUB;
  const int chunks = (K + chunk - 1) / chunk;
  return sizeof(float) * ((size_t)SUB * CH + (size_t)SUB * pix + (size_t)SUB * nw * NR +
                          (size_t)groups * pix + (size_t)chunks * pix);
}

extern "C" int sags_composite_windowed_bwd(
    const void* G, int row_stride, int n_rows, const void* table_local,
    const void* counts, const void* bases, const void* dests, const void* nblks,
    int n_span, int num_tiles, int K, int tile, int tiles_x, int tile_offset,
    float alpha_min, float t_min, int chunk, const void* d_acc, const void* d_T,
    const void* T_final, void* dGt, void* stream) {
  // a group of SUB entries never straddles a chunk boundary
  if (n_span < 1 || n_span > sagsw::MAX_SPAN || chunk < SUB || chunk % SUB ||
      K % SUB)
    return (int)cudaErrorInvalidValue;
  const int pix = tile * tile;
  const size_t smem = sags_composite_windowed_bwd_smem(K, pix, chunk);
  cudaError_t err = cudaFuncSetAttribute(composite_windowed_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (num_tiles > 0) {
    composite_windowed_bwd_kernel<<<num_tiles, pix, smem, (cudaStream_t)stream>>>(
        (const float*)G, row_stride, n_rows, (const int32_t*)table_local,
        (const int32_t*)counts, (const int32_t*)bases, (const int32_t*)dests,
        (const int32_t*)nblks, n_span, K, tile, tiles_x, tile_offset, alpha_min,
        t_min, chunk, (const float*)d_acc, (const float*)d_T,
        (const float*)T_final, (float*)dGt);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_composite_windowed_bwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
