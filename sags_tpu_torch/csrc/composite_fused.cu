// composite_fused: front-to-back alpha compositing per 16x16 tile.
//
// Replaces the Pallas TPU kernel `composite_fused` (`sags_tpu/ops/
// pallas_composite.py`, `_kernel`). For tile t and each pixel p of it, the
// tile's pairs k < counts[t] (Gaussian ids in table[t, :], depth order) are
// composited with the TPU kernel's gates:
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy,  alpha = min(0.99, op e^power)
//   gated iff power <= 0 and alpha >= alpha_min
//   a gated pair contributes w = alpha T and T *= (1 - alpha) only while
//   T (1 - alpha) >= t_min; once that fails, the rest of the chunk of
//   `chunk` pairs is cut for that pixel (the TPU kernel's exclusive-product
//   + min trick, `pallas_composite.py:84-106`, and the XLA scan of
//   `rasterize._composite_core_xla` cut at the same place; the next chunk
//   starts again from the carried T).
// Outputs acc[t, p, 0:24] (the 24 feature rows 8..31 of each packed row,
// weighted) and T[t, p].
//
// Bound: arithmetic. Each (pixel, pair) costs an exp and ~50 flops, while
// each pair's 128-byte row is read once per tile.
// Design: one block per tile, one thread per pixel; T and the 24 sums live in
// registers. The block gathers each group of 32 rows G[table[t, k]] straight
// into shared memory (the [NT, 32, K] gather of the TPU path is never written
// to device memory) and every thread reads them as broadcasts. A block-wide
// `__syncthreads_count` ends the tile once no pixel can accept another pair
// (T (1 - alpha_min) < t_min), and the loop never runs past counts[t].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int SUB = 32;  // pairs staged in shared memory per round
constexpr int CH = 32;   // packed row width: 8 header + 24 feature floats
constexpr int HDR = 8;
constexpr int CF = CH - HDR;
}  // namespace

__global__ void __launch_bounds__(256)
composite_fwd_kernel(const float* __restrict__ G,
                     const int32_t* __restrict__ table,
                     const int32_t* __restrict__ counts, int K, int tile,
                     int tiles_x, int tile_offset, float alpha_min,
                     float t_min, int chunk, float* __restrict__ acc_out,
                     float* __restrict__ T_out) {
  __shared__ float rows[SUB][CH];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int PIX = blockDim.x;
  const int tg = t + tile_offset;  // global tile id (pixel coordinates)
  const float px = (float)((tg % tiles_x) * tile + tid % tile);
  const float py = (float)((tg / tiles_x) * tile + tid / tile);
  const int count = min(counts[t], K);
  const float om_max = 1.f - alpha_min;

  float acc[CF];
#pragma unroll
  for (int c = 0; c < CF; ++c) acc[c] = 0.f;
  float T = 1.f;
  bool cut = false;  // this chunk's cut reached for this pixel

  for (int base = 0; base < count; base += SUB) {
    // no pixel can pass T (1 - alpha) >= t_min again: the tile is done
    if (__syncthreads_count(T * om_max >= t_min) == 0) break;
    const int n = min(SUB, count - base);
    for (int i = tid; i < n * CH; i += PIX) {
      const int k = i / CH, c = i - k * CH;
      const int g = table[(size_t)t * K + base + k];
      rows[k][c] = g >= 0 ? G[(size_t)g * CH + c] : 0.f;
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

  float4* dst = reinterpret_cast<float4*>(acc_out + ((size_t)t * PIX + tid) * CF);
#pragma unroll
  for (int v = 0; v < CF / 4; ++v)
    dst[v] = make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
  T_out[(size_t)t * PIX + tid] = T;
}

extern "C" int sags_composite_fused(const void* G, const void* table,
                                    const void* counts, int num_tiles, int K,
                                    int tile, int tiles_x, int tile_offset,
                                    float alpha_min, float t_min, int chunk,
                                    void* acc_out, void* T_out, void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, tile * tile, 0, (cudaStream_t)stream>>>(
        (const float*)G, (const int32_t*)table, (const int32_t*)counts, K,
        tile, tiles_x, tile_offset, alpha_min, t_min, chunk,
        (float*)acc_out, (float*)T_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_composite_fused_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
