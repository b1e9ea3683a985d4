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
// registers. The rows G[table[t, k]] of a group of 32 pairs go straight into
// shared memory (the [NT, 32, K] gather of the TPU path is never written to
// device memory) by one 16-byte `cp.async` a thread, zero-filled for id -1
// and past the tile's count, into the buffer the group before does not read:
// the copy of group g + 1 is in flight while group g is composited, with one
// barrier a group. A warp covers a strip of 16 x 2 pixels, and most splats
// reach one or two of a tile's eight strips: lane l tests pair l of the group
// against the warp's strip (the least value of the conic quadratic over the
// strip's pixel centres against the alpha gate's level, qmin.cuh, with a
// margin that covers this kernel's own rounding, so only pairs that no pixel
// of the strip gates are dropped; `ops/composite.py:strip_live` is the plain
// version), `__ballot_sync` makes the 32 answers a mask, and the warp walks
// the set bits only, reading a pair's row as broadcast 16-byte loads. The
// loop body keeps its branches: a pair that no pixel of the warp gates then
// skips the 24 sums, which a branch-free body unrolled by four does not (it
// was slower by half). `cut` matters at gated pairs only, all of which are
// in the mask, so it is reset when the walk crosses a chunk's start. A warp
// whose pixels are all done (T (1 - alpha_min) < t_min) skips the group; a
// block-wide `__syncthreads_count` ends the tile once that holds for every
// pixel, and the loop never runs past counts[t]. Every pixel's arithmetic is
// the plain loop's: culling changes no bit of acc or T.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qmin.cuh"

namespace {
constexpr int SUB = 32;  // pairs staged in shared memory per round
constexpr int CH = 32;   // packed row width: 8 header + 24 feature floats
constexpr int HDR = 8;
constexpr int CF = CH - HDR;
constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int STRIP_ROWS = 32 / TILE;  // pixel rows a warp covers
constexpr unsigned FULL = 0xffffffffu;
// the strip cull's margin on the gate level: relative to the magnitude of
// the quadratic's terms over the strip (float32 rounding of `power` here and
// of the minimum there is some 20 ulp of it), and absolute (expf, logf)
constexpr float CULL_REL = 1e-5f;
constexpr float CULL_ABS = 1e-4f;

// 16 bytes from device to shared memory, asynchronously; with bytes = 0 the
// 16 bytes are zero-filled and src is not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Can a pixel centre of the strip [bx, bx + 15] x [sy, sy + 1] pass the alpha
// gate of row r? False only when the conic is convex along the edges and its
// least value over the strip exceeds the gate's level by the margin; a NaN
// anywhere keeps the pair. `composite.strip_live` takes the same float32
// operations in the same order.
__device__ __forceinline__ bool strip_keeps(const float* r, float bx, float sy,
                                            float alpha_min) {
  const float4 h = *reinterpret_cast<const float4*>(r);
  const float2 g = *reinterpret_cast<const float2*>(r + 4);
  const float a = h.z, b = h.w, c = g.x;
  const float x0 = __fsub_rn(bx, h.x), x1 = __fsub_rn(bx + (float)(TILE - 1), h.x);
  const float y0 = __fsub_rn(sy, h.y), y1 = __fsub_rn(sy + (float)(STRIP_ROWS - 1), h.y);
  const float qmin = sagsq::box_qmin(a, b, c, x0, x1, y0, y1);
  const float X = sagsq::nan_max(fabsf(x0), fabsf(x1));
  const float Y = sagsq::nan_max(fabsf(y0), fabsf(y1));
  const float mag = sagsq::quad(fabsf(a), fabsf(b), fabsf(c), X, Y);
  const float level = sagsq::gate_level(g.y, alpha_min);
  const float bound = __fadd_rn(
      level, __fadd_rn(__fmul_rn(CULL_REL, __fadd_rn(mag, level)), CULL_ABS));
  const bool drop = a > 0.f && c > 0.f && qmin > bound;
  return !drop;
}
}  // namespace

__global__ void __launch_bounds__(PIX)
composite_fwd_kernel(const float* __restrict__ G,
                     const int32_t* __restrict__ table,
                     const int32_t* __restrict__ counts, int K, int tiles_x,
                     int tile_offset, float alpha_min, float t_min, int chunk,
                     float* __restrict__ acc_out, float* __restrict__ T_out) {
  __shared__ __align__(16) float rows[2][SUB][CH];  // two buffers of a group's rows
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tg = t + tile_offset;  // global tile id (pixel coordinates)
  const float bx = (float)((tg % tiles_x) * TILE);
  const float by = (float)((tg / tiles_x) * TILE);
  const float px = bx + (float)(tid % TILE);
  const float py = by + (float)(tid / TILE);
  const float sy = by + (float)(warp * STRIP_ROWS);  // the warp's strip
  const int count = min(counts[t], K);
  const float om_max = 1.f - alpha_min;
  const int32_t* ids = table + (size_t)t * K;

  // thread tid copies 16 bytes of row tid / 8 of a group; a row's id is read
  // a group before its copy starts
  const int ck = tid >> 3, cc = (tid & 7) * 4;
  auto id_of = [&](int base) { return base + ck < count ? ids[base + ck] : -1; };
  auto copy_row = [&](int buf, int id) {
    cp_async16(&rows[buf][ck][cc], G + (size_t)max(id, 0) * CH + cc, id >= 0 ? 16 : 0);
    cp_async_commit();
  };
  int id_next = id_of(0);
  copy_row(0, id_next);
  id_next = id_of(SUB);

  float acc[CF];
#pragma unroll
  for (int c = 0; c < CF; ++c) acc[c] = 0.f;
  float T = 1.f;
  bool cut = false;  // this chunk's cut reached for this pixel

  for (int base = 0, buf = 0; base < count; base += SUB, buf ^= 1) {
    cp_async_wait_all();
    // no pixel can pass T (1 - alpha) >= t_min again: the tile is done. The
    // barrier also publishes this group's rows and frees the other buffer.
    if (__syncthreads_count(T * om_max >= t_min) == 0) break;
    if (base + SUB < count) copy_row(buf ^ 1, id_next);
    id_next = id_of(base + 2 * SUB);

    // bit k: pair base + k starts a chunk; pair base + k may reach the strip
    unsigned starts = __ballot_sync(FULL, (base + lane) % chunk == 0);
    const int n = count - base;
    unsigned mask = n >= SUB ? FULL : (1u << n) - 1u;
    mask &= __ballot_sync(FULL, strip_keeps(rows[buf][lane], bx, sy, alpha_min));
    if (!__any_sync(FULL, T * om_max >= t_min)) mask = 0u;  // the strip is done
    while (mask) {
      const int k = __ffs(mask) - 1;
      mask &= mask - 1u;
      if (starts) {  // a chunk starts at or before pair k: its cut is new
        const unsigned upto = (2u << k) - 1u;
        cut = cut && !(starts & upto);
        starts &= ~upto;
      }
      if (cut) continue;
      const float4* r = reinterpret_cast<const float4*>(rows[buf][k]);
      const float4 h = r[0];
      const float2 g = *reinterpret_cast<const float2*>(rows[buf][k] + 4);
      const float dx = h.x - px;
      const float dy = h.y - py;
      const float power = -0.5f * (h.z * dx * dx + g.x * dy * dy) - h.w * dx * dy;
      const float alpha = fminf(0.99f, g.y * expf(power));
      if (!(power <= 0.f && alpha >= alpha_min)) continue;
      const float test = T * (1.f - alpha);
      if (test < t_min) {
        cut = true;
        continue;
      }
      const float w = alpha * T;
#pragma unroll
      for (int v = 0; v < CF / 4; ++v) {
        const float4 f = r[HDR / 4 + v];
        acc[4 * v] += w * f.x;
        acc[4 * v + 1] += w * f.y;
        acc[4 * v + 2] += w * f.z;
        acc[4 * v + 3] += w * f.w;
      }
      T = test;
    }
    if (starts) cut = false;  // a chunk started after the last pair walked
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
  if (tile != TILE || chunk < 1) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
        (const float*)G, (const int32_t*)table, (const int32_t*)counts, K,
        tiles_x, tile_offset, alpha_min, t_min, chunk, (float*)acc_out,
        (float*)T_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_composite_fused_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
