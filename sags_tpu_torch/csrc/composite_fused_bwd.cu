// composite_fused_bwd: per-pair gradients of composite_fused.
//
// Replaces the Pallas TPU kernel `composite_fused_bwd` (`sags_tpu/ops/
// pallas_composite.py`, `_bwd_kernel` + `_prefix_hs`). For every pair (t, k)
// it writes dGt[t, :, k]: the gradients of the pair's packed row (mx, my, ca,
// cb, cc, op in rows 0-5, zeros in rows 6-7, the 24 feature rows in 8-31),
// summed over the tile's 256 pixels, by the formula of pair_grads.cuh.
//
// Bound: arithmetic and the per-pair reduction. Each (pixel, pair) costs two
// exps (the chunk is recomputed forward, then walked in reverse), ~150 flops,
// and a 30-value reduction over the tile's 256 pixels.
// Design: one block per tile, one thread per pixel. A forward sweep records
// the transmittance at the start of every 32-pair group in shared memory;
// the reverse sweep recomputes each group's transmittances forward from that
// record (no division by 1 - alpha, which loses precision as alpha nears
// 0.99) and then walks the group backwards with the suffix sums in registers.
// Each pair's 30 per-pixel values are reduced with warp shuffles, then across
// the 8 warps through shared memory in a fixed order, and written once: no
// atomics, so dGt is bitwise reproducible. Groups past the point where every
// pixel of the tile is done contribute exactly zero and are only zero-filled.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_grads.cuh"

namespace {
constexpr int SUB = 32;  // pairs per group (one bit each in a uint32 mask)
constexpr int CH = sagsb::CH;
constexpr int CF = sagsb::CF;
constexpr int NR = sagsb::NR;
}  // namespace

__global__ void __launch_bounds__(256)
composite_bwd_kernel(const float* __restrict__ G,
                     const int32_t* __restrict__ table,
                     const int32_t* __restrict__ counts, int K, int tile,
                     int tiles_x, int tile_offset, float alpha_min,
                     float t_min, int chunk, const float* __restrict__ d_acc,
                     const float* __restrict__ d_T,
                     const float* __restrict__ T_final,
                     float* __restrict__ dGt) {
  extern __shared__ float smem[];
  const int PIX = blockDim.x;
  const int NW = PIX / 32;
  float* rows = smem;                   // [SUB][CH]
  float* texc = rows + SUB * CH;        // [SUB][PIX] exclusive T per pair
  float* red = texc + SUB * PIX;        // [SUB][NW][NR] warp partial sums
  float* tsub = red + SUB * NW * NR;    // [K/SUB][PIX] group-entry T (<0: cut)

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tg = t + tile_offset;
  const float px = (float)((tg % tiles_x) * tile + tid % tile);
  const float py = (float)((tg / tiles_x) * tile + tid / tile);
  const int count = min(counts[t], K);
  const float om_max = 1.f - alpha_min;
  float* out = dGt + (size_t)t * CH * K;

  // ---- forward sweep: group-entry transmittances ----
  float T = 1.f;
  bool cut = false;
  int n_groups = 0;
  for (int base = 0; base < count; base += SUB, ++n_groups) {
    if (__syncthreads_count(T * om_max >= t_min) == 0) break;
    const int n = min(SUB, count - base);
    for (int i = tid; i < n * CH; i += PIX) {
      const int k = i / CH, c = i - k * CH;
      const int g = table[(size_t)t * K + base + k];
      rows[k * CH + c] = g >= 0 ? G[(size_t)g * CH + c] : 0.f;
    }
    __syncthreads();
    tsub[n_groups * PIX + tid] = cut ? -T : T;
    for (int k = 0; k < n; ++k) {
      if ((base + k) % chunk == 0) cut = false;
      if (cut) continue;
      const float* r = rows + k * CH;
      const float dx = r[0] - px, dy = r[1] - py;
      const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
      const float alpha = fminf(0.99f, r[5] * expf(power));
      if (!(power <= 0.f && alpha >= alpha_min)) continue;
      const float test = T * (1.f - alpha);
      if (test < t_min) {
        cut = true;
        continue;
      }
      T = test;
    }
  }

  // pairs past the last live group have exactly zero gradient
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
  float B = 0.f;  // sum of w s over later pairs of the current chunk

  // ---- reverse sweep, one group at a time ----
  for (int gi = n_groups - 1; gi >= 0; --gi) {
    const int base = gi * SUB;
    const int n = min(SUB, count - base);
    __syncthreads();  // previous group's rows/red fully consumed
    for (int i = tid; i < n * CH; i += PIX) {
      const int k = i / CH, c = i - k * CH;
      const int g = table[(size_t)t * K + base + k];
      rows[k * CH + c] = g >= 0 ? G[(size_t)g * CH + c] : 0.f;
    }
    __syncthreads();

    // recompute the group forward from its recorded entry transmittance
    const float Tv = tsub[gi * PIX + tid];
    bool gcut = Tv < 0.f;
    float Tr = fabsf(Tv);
    unsigned gbits = 0u, mbits = 0u;
    for (int k = 0; k < n; ++k) {
      if ((base + k) % chunk == 0) gcut = false;
      texc[k * PIX + tid] = Tr;
      const float* r = rows + k * CH;
      const float dx = r[0] - px, dy = r[1] - py;
      const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
      const float alpha = fminf(0.99f, r[5] * expf(power));
      if (!(power <= 0.f && alpha >= alpha_min)) continue;
      gbits |= 1u << k;
      if (gcut) continue;
      const float test = Tr * (1.f - alpha);
      if (test < t_min) {
        gcut = true;
        continue;
      }
      mbits |= 1u << k;
      Tr = test;
    }

    for (int k = n - 1; k >= 0; --k) {
      const float* r = rows + k * CH;
      const bool gate = (gbits >> k) & 1u;
      float v[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) v[q] = 0.f;
      if (gate) {
        const float dx = r[0] - px, dy = r[1] - py;
        const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
        sagsb::entry_grads(r, dx, dy, r[5] * expf(power), (mbits >> k) & 1u,
                           texc[k * PIX + tid], dacc, carry, B, v);
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

extern "C" size_t sags_composite_fused_bwd_smem(int K, int pix) {
  const int nw = pix / 32;
  const int groups = (K + SUB - 1) / SUB;
  return sizeof(float) * ((size_t)SUB * CH + (size_t)SUB * pix +
                          (size_t)SUB * nw * NR + (size_t)groups * pix);
}

extern "C" int sags_composite_fused_bwd(
    const void* G, const void* table, const void* counts, int num_tiles,
    int K, int tile, int tiles_x, int tile_offset, float alpha_min,
    float t_min, int chunk, const void* d_acc, const void* d_T,
    const void* T_final, void* dGt, void* stream) {
  const int pix = tile * tile;
  const size_t smem = sags_composite_fused_bwd_smem(K, pix);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, pix, smem, (cudaStream_t)stream>>>(
        (const float*)G, (const int32_t*)table, (const int32_t*)counts, K,
        tile, tiles_x, tile_offset, alpha_min, t_min, chunk,
        (const float*)d_acc, (const float*)d_T, (const float*)T_final,
        (float*)dGt);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_composite_fused_bwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
