// composite_fused_bwd: per-pair gradients of composite_fused.
//
// Replaces the Pallas TPU kernel `composite_fused_bwd` (`sags_tpu/ops/
// pallas_composite.py`, `_bwd_kernel` + `_prefix_hs`). For every pair (t, k)
// it writes dGt[t, :, k]: the gradients of the pair's packed row (mx, my, ca,
// cb, cc, op in rows 0-5, zeros in rows 6-7, the 24 feature rows in 8-31),
// summed over the tile's 256 pixels, by the formula of pair_grads.cuh.
//
// Bound: float32 arithmetic. Each (pixel, pair) costs two exps (a forward
// sweep, then each group recomputed forward and walked in reverse) and about
// 120 instructions; the sums over the tile's 256 pixels, 30 per pair, would
// cost more than all of that as shuffle trees (150 shuffles per pixel and
// pair) and cost next to nothing on the tensor cores.
// Design: one block per tile, one thread per pixel. A forward sweep records
// the transmittance at the start of every 32-pair group in shared memory;
// the reverse sweep recomputes each group's transmittances forward from that
// record (no division by 1 - alpha, which loses precision as alpha nears
// 0.99), keeping T_exc and raw = op e^power per (pair, pixel) in shared
// memory, then walks the group backwards with the suffix sums in registers
// and leaves two factors per (pair, pixel) in their place: w = m alpha T_exc
// and dpow = da alpha. Each warp multiplies its 32 pixels' factors with
// [dAcc | Phi] (pair_grads.cuh: mma.sync, TF32 split in two, float32
// accuracy), the eight partial products are summed in a fixed order and each
// pair's gradients written once: no atomics, so dGt is bitwise reproducible.
// Groups past the point where every pixel of the tile is done contribute
// exactly zero and are only zero-filled. At capacity 1024 a block takes
// 101 KB of shared memory: two blocks an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_grads.cuh"

namespace {
constexpr int SUB = sagsb::SUB;  // pairs per group (one bit each in a uint32 mask)
constexpr int CH = sagsb::CH;
constexpr int CF = sagsb::CF;
constexpr int PIX = sagsb::PIX;
constexpr int LDW = sagsb::LDW;
}  // namespace

__global__ void __launch_bounds__(PIX, 2)
composite_bwd_kernel(const float* __restrict__ G,
                     const int32_t* __restrict__ table,
                     const int32_t* __restrict__ counts, int K, int tiles_x,
                     int tile_offset, float alpha_min, float t_min, int chunk,
                     const float* __restrict__ d_acc,
                     const float* __restrict__ d_T,
                     const float* __restrict__ T_final,
                     float* __restrict__ dGt) {
  extern __shared__ __align__(16) float smem[];
  constexpr int tile = sagsb::TILE;
  float* rows = smem;             // [SUB][CH]
  float* W = rows + SUB * CH;     // [SUB][LDW] T_exc, then w, then the warps' sums
  float* D = W + SUB * LDW;       // [SUB][LDW] raw, then dpow
  float* tsub = D + SUB * LDW;    // [K/SUB][PIX] group-entry T (<0: cut)

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tg = t + tile_offset;
  const float px = (float)((tg % tiles_x) * tile + tid % tile);
  const float py = (float)((tg / tiles_x) * tile + tid / tile);
  // the tile's centre: the moments' origin (pair_grads.cuh `phi`)
  const float cx = (float)((tg % tiles_x) * tile) + 0.5f * (tile - 1);
  const float cy = (float)((tg / tiles_x) * tile) + 0.5f * (tile - 1);
  const int count = min(counts[t], K);
  const float om_max = 1.f - alpha_min;
  float* out = dGt + (size_t)t * CH * K;

  // The rows of pairs base .. base + SUB - 1 (zeros past the tile's count and
  // for id -1: opacity 0 fails the alpha gate) are fetched into registers a
  // group ahead, four values a thread, and put into shared memory when the
  // group before is done with it: the gather's latency hides behind a group.
  float nxt[SUB * CH / PIX];
  auto fetch = [&](int base) {
#pragma unroll
    for (int j = 0; j < SUB * CH / PIX; ++j) {
      const int k = warp + j * (PIX / CH);
      const int g = base + k < count ? table[(size_t)t * K + base + k] : -1;
      nxt[j] = g >= 0 ? G[(size_t)g * CH + lane] : 0.f;
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int j = 0; j < SUB * CH / PIX; ++j) rows[(warp + j * (PIX / CH)) * CH + lane] = nxt[j];
    __syncthreads();
  };
  // raw = op e^power of row r at this pixel; gate = it passes the alpha test
  auto raw_of = [&](const float* r, bool& gate) {
    const float4 a = *reinterpret_cast<const float4*>(r);
    const float2 b = *reinterpret_cast<const float2*>(r + 4);
    const float dx = a.x - px, dy = a.y - py;
    const float power = -0.5f * (a.z * dx * dx + b.x * dy * dy) - a.w * dx * dy;
    const float raw = b.y * expf(power);
    gate = power <= 0.f && fminf(0.99f, raw) >= alpha_min;
    return raw;
  };

  // ---- forward sweep: group-entry transmittances ----
  // The loops below take all SUB rows of a group, without a branch, so that
  // the exps of neighbouring pairs overlap; `rem` is (base + k) % chunk.
  float T = 1.f;
  bool cut = false;
  int n_groups = 0;
  int rem = 0;
  fetch(0);
  for (int base = 0; base < count; base += SUB, ++n_groups) {
    if (__syncthreads_count(T * om_max >= t_min) == 0) break;
    put();
    fetch(base + SUB);
    tsub[n_groups * PIX + tid] = cut ? -T : T;
#pragma unroll 4
    for (int k = 0; k < SUB; ++k) {
      cut = cut && rem != 0;
      rem = rem + 1 == chunk ? 0 : rem + 1;
      bool gate;
      const float alpha = fminf(0.99f, raw_of(rows + k * CH, gate));
      const float test = T * (1.f - alpha);
      const bool live = gate && !cut;
      cut = cut || (live && test < t_min);
      T = live && test >= t_min ? test : T;
    }
  }

  // pairs past the last live group have exactly zero gradient
  const int k_live = min(count, n_groups * SUB);
  for (int i = tid; i < CH * K; i += PIX) {
    const int k = i % K;
    if (k >= k_live) out[i] = 0.f;
  }

  const float* dacc_tile = d_acc + (size_t)t * PIX * CF;
  float dacc[CF];
  {
    const float4* src = reinterpret_cast<const float4*>(dacc_tile + tid * CF);
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
  const sagsb::PhiFrags phis = sagsb::phi_frags(warp * 32, lane);
  if (n_groups > 0) fetch((n_groups - 1) * SUB);
  for (int gi = n_groups - 1; gi >= 0; --gi) {
    const int base = gi * SUB;
    const int n = min(SUB, count - base);
    __syncthreads();  // previous group's rows and sums fully consumed
    put();
    if (gi > 0) fetch(base - SUB);

    // recompute the group forward from its recorded entry transmittance
    const float Tv = tsub[gi * PIX + tid];
    bool gcut = Tv < 0.f;
    float Tr = fabsf(Tv);
    unsigned gbits = 0u, mbits = 0u;
    rem = base % chunk;
#pragma unroll 4
    for (int k = 0; k < SUB; ++k) {
      gcut = gcut && rem != 0;
      rem = rem + 1 == chunk ? 0 : rem + 1;
      bool gate;
      const float raw = raw_of(rows + k * CH, gate);
      W[k * LDW + tid] = Tr;
      D[k * LDW + tid] = raw;
      const float test = Tr * (1.f - fminf(0.99f, raw));
      const bool live = gate && !gcut;
      const bool m = live && test >= t_min;
      gcut = gcut || (live && !m);
      gbits |= (unsigned)gate << k;
      mbits |= (unsigned)m << k;
      Tr = m ? test : Tr;
    }

    // walk it backwards: the two factors of every (pair, pixel). A pair that
    // no pixel of the warp gates costs the warp two stores.
    const unsigned any = __reduce_or_sync(sagsb::FULL, gbits);
    rem = (base + SUB - 1) % chunk;
#pragma unroll 4
    for (int k = SUB - 1; k >= 0; --k) {
      float w = 0.f, dpow = 0.f;
      if ((any >> k) & 1u) {
        const float raw = D[k * LDW + tid];
        const float alpha = fminf(0.99f, raw);
        const bool gate = (gbits >> k) & 1u;
        float wk, Bk = B;
        const float da = sagsb::entry_da(rows + k * CH, alpha, (mbits >> k) & 1u,
                                         W[k * LDW + tid], dacc, carry, Bk, wk);
        if (gate) {
          B = Bk;
          w = wk;
          if (raw < 0.99f) dpow = da * alpha;  // dalpha/dpower = alpha
        }
      }
      if (rem == 0) {  // leaving the chunk backwards
        carry += B;
        B = 0.f;
      }
      rem = rem == 0 ? chunk - 1 : rem - 1;
      W[k * LDW + tid] = w;
      D[k * LDW + tid] = dpow;
    }

    sagsb::warp_products(W, D, dacc_tile, phis, warp * 32, lane);
    __syncthreads();
    sagsb::write_group_sums(W, rows, out, K, base, n, cx, cy);
  }
}

extern "C" size_t sags_composite_fused_bwd_smem(int K, int pix) {
  const int groups = (K + SUB - 1) / SUB;
  return sizeof(float) * ((size_t)SUB * CH + 2 * (size_t)SUB * (pix + LDW - PIX) +
                          (size_t)groups * pix);
}

extern "C" int sags_composite_fused_bwd(
    const void* G, const void* table, const void* counts, int num_tiles,
    int K, int tile, int tiles_x, int tile_offset, float alpha_min,
    float t_min, int chunk, const void* d_acc, const void* d_T,
    const void* T_final, void* dGt, void* stream) {
  if (tile != sagsb::TILE) return (int)cudaErrorInvalidValue;
  const int pix = tile * tile;
  const size_t smem = sags_composite_fused_bwd_smem(K, pix);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, pix, smem, (cudaStream_t)stream>>>(
        (const float*)G, (const int32_t*)table, (const int32_t*)counts, K,
        tiles_x, tile_offset, alpha_min, t_min, chunk,
        (const float*)d_acc, (const float*)d_T, (const float*)T_final,
        (float*)dGt);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_composite_fused_bwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
