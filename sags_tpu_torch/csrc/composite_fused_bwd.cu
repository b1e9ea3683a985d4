// composite_fused_bwd: per-pair gradients of composite_fused.
//
// Replaces the Pallas TPU kernel `composite_fused_bwd` (`sags_tpu/ops/
// pallas_composite.py`, `_bwd_kernel` + `_prefix_hs`). For every pair (t, k)
// it writes dGt[t, :, k]: the gradients of the pair's packed row (mx, my, ca,
// cb, cc, op in rows 0-5, zeros in rows 6-7, the 24 feature rows in 8-31),
// summed over the tile's 256 pixels. Per pixel, with s_k = sum_c f_kc dAcc_c,
// w_k = m_k alpha_k T_k and om_k = 1 - alpha_k:
//   da_k = m_k T_k s_k - (gate_k / om_k) B_k - (m_k / om_k) carry
// where B_k is the sum of w_j s_j over later pairs j of the same chunk and
// carry the sum over later chunks plus T_final dT — the TPU kernel's formula
// (`pallas_composite.py:266-276`, `gate` versus `m` kept as there), chained
// through alpha = min(0.99, op e^power) with the clip mask raw >= 0.99 and
// the max(op, 1e-12) guard.
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

namespace {
constexpr int SUB = 32;  // pairs per group (one bit each in a uint32 mask)
constexpr int CH = 32;
constexpr int HDR = 8;
constexpr int CF = CH - HDR;
constexpr int NR = 6 + CF;  // reduced values per pair
constexpr unsigned FULL = 0xffffffffu;
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
      const bool m = (mbits >> k) & 1u;
      float v[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) v[q] = 0.f;
      if (gate) {
        const float dx = r[0] - px, dy = r[1] - py;
        const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
        const float raw = r[5] * expf(power);
        const float alpha = fminf(0.99f, raw);
        const float om = 1.f - alpha;
        const float Te = texc[k * PIX + tid];
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < CF; ++c) s += r[HDR + c] * dacc[c];
        const float w = m ? alpha * Te : 0.f;
        float da = -B / om;
        if (m) da += Te * s - carry / om;
        B += w * s;
        if (raw < 0.99f) {  // ∂alpha/∂power = alpha, ∂alpha/∂op = alpha / op
          const float dpow = da * alpha;
          v[0] = dpow * (-(r[2] * dx + r[3] * dy));
          v[1] = dpow * (-(r[4] * dy + r[3] * dx));
          v[2] = dpow * (-0.5f * dx * dx);
          v[3] = dpow * (-dx * dy);
          v[4] = dpow * (-0.5f * dy * dy);
          v[5] = da * alpha / fmaxf(r[5], 1e-12f);
        }
#pragma unroll
        for (int c = 0; c < CF; ++c) v[6 + c] = w * dacc[c];
      }
      if ((base + k) % chunk == 0) {  // leaving the chunk backwards
        carry += B;
        B = 0.f;
      }
      float* dst = red + (k * NW + warp) * NR;
      if (__any_sync(FULL, gate)) {
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          float x = v[q];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(FULL, x, off);
          if (lane == 0) dst[q] = x;
        }
      } else if (lane < NR) {
        dst[lane] = 0.f;
      }
    }
    __syncthreads();

    // fixed-order sum of the warp partials; coalesced along k
    for (int i = tid; i < CH * n; i += PIX) {
      const int row = i / n, k = i - row * n;
      float x = 0.f;
      if (row < 6 || row >= HDR) {
        const int q = row < 6 ? row : 6 + (row - HDR);
        for (int w = 0; w < NW; ++w) x += red[(k * NW + w) * NR + q];
      }
      out[(size_t)row * K + base + k] = x;
    }
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
