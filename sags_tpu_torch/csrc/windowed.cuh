// windowed.cuh: the compositing loop shared by composite_windowed.cu (work
// list from the host pair sort) and composite_windowed_sorted.cu (work list
// sorted in the kernel), so both render a tile with the same arithmetic, and
// the window-row lookup that composite_windowed_bwd.cu uses too.
//
// A tile's work list holds window-local ids. Span j of the tile numbers the
// rows of the 128-row blocks bases[j] .. bases[j] + nblks[j] - 1 of the
// anchor-sorted store G_s from dests[j] * 128 on, so id i with
// dests[j] * 128 <= i < (dests[j] + nblks[j]) * 128 is global row
// bases[j] * 128 + i - dests[j] * 128. The TPU kernels copy those blocks into
// a VMEM window first (up to 40 blocks of 32 x 128 floats, beyond a Hopper
// block's 227 KB of shared memory); here each id is resolved through the
// <= R spans and its row is gathered straight from G_s.
//
// Bound: float32 arithmetic. A (pixel, entry) that is evaluated costs an
// expf and some 20 rounded operations for the gate, and 24 to 72 more for
// the feature sums where it is composited; each entry's row is read once per
// tile. What the loop does about it (the design of composite_fused.cu, with
// the windowed arithmetic):
//   - rows are gathered by 16-byte cp.async into the one of two shared
//     buffers that the group before does not read, a group of 32 entries
//     ahead, zero-filled for an empty slot, a row outside every span and
//     past the tile's count; ids are loaded two groups ahead and resolved
//     through the spans one group ahead; one barrier a group;
//   - a warp covers a strip of 16 x 2 pixels, and most splats reach one or
//     two of a tile's eight strips: lane l tests entry l against the warp's
//     strip (`strip_keeps`, the least value of the conic over the strip
//     against the gate's level with a margin that covers the loop's own
//     rounding in either EWA form, and the opacity against alpha_min),
//     `__ballot_sync` makes a mask of the group, and the warp walks the set
//     bits only, reading a row as 16-byte broadcasts. Culling changes no bit
//     of acc or T: a dropped entry is one that no pixel of the strip gates;
//   - 64 registers a thread, four blocks an SM;
//   - under ewa_impl="quad" lane l also computes entry l's six monomial
//     coefficients in registers, and the walk takes them by __shfl_sync.
// Every operation of the gate, T and the feature sums is rounded as the
// plain version (`ops/windowed.py:_composite_rows_plain`) rounds it:
// __fmul_rn / __fadd_rn where a fused multiply-add would change a bit, so
// the kernels are held bitwise against it in every option.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "qmin.cuh"

namespace sagsw {

constexpr int SUB = 32;  // work-list entries a group (one bit each in a mask)
constexpr int CH = 32;   // columns composited: 8 header + 24 feature floats
constexpr int HDR = 8;
constexpr int CF = CH - HDR;
constexpr int MAX_SPAN = 8;
// windowed_bf16: the 16 obj channels (feature columns 11..26) are read as
// bf16 pairs packed into float32 columns 40..47 (lo = channel 2c, hi = 2c+1)
constexpr int OBJ0 = HDR + 3, N_OBJ = 16, COL_OBJ_BF16 = 40;
constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int STRIP_ROWS = 32 / TILE;  // pixel rows a warp covers
constexpr unsigned FULL = 0xffffffffu;
// the forward kernels' resident blocks an SM: __launch_bounds__ caps a thread
// at 64 registers
constexpr int MIN_BLOCKS = 4;
// the strip cull's margin on the gate level: relative to the magnitude of the
// exponent's terms (float32 rounding of `power` in the loop and of the
// minimum in the test is some 20 ulp of it), and absolute (expf, logf)
constexpr float CULL_REL = 1e-5f;
constexpr float CULL_ABS = 1e-4f;

// EWA alpha evaluation (`RasterizeConfig.ewa_impl`) and feature precision
// (`feature_precision`) of the TPU kernel's `_select_and_composite` and
// `_feat_dot` (`pallas_windowed.py:72-95,226-262`).
enum Ewa { EWA_LONGHAND = 0, EWA_QUAD = 1 };
enum Prec { PREC_HIGHEST = 0, PREC_HIGH = 1, PREC_DEFAULT = 2 };

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

// float32 -> bfloat16 -> float32, round to nearest even (PyTorch's and XLA's
// conversion; NaN becomes the canonical quiet NaN)
__device__ __forceinline__ float bf16_round(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __uint_as_float(0x7fc00000u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// The longhand EWA exponent -0.5 (ca dx^2 + cc dy^2) - cb dx dy of row r,
// one rounded operation at a time in PyTorch's order (no fused multiply-add),
// so the plain version (`_composite_rows_plain`) computes the same bits.
__device__ __forceinline__ float ewa_power(float ca, float cb, float cc, float dx, float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx), __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(cb, dx), dy));
}
__device__ __forceinline__ float ewa_power(const float* r, float dx, float dy) {
  return ewa_power(r[2], r[3], r[4], dx, dy);
}

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
// gate of the row with header (mx, my, a, b, c, op)? False only when the
// conic is convex along the edges and its least value over the strip exceeds
// the gate's level by the margin; a NaN anywhere keeps the entry. The margin
// is relative to the magnitude of the terms the loop's exponent sums: over
// the strip for the longhand form; under "quad", of the six monomials about
// the tile origin (bx, by), whose terms grow with the distance of the centre
// from the tile and cancel to the exponent: the sum of their magnitudes is at
// most 0.5 (|a| X^2 + 2 |b| X Y + |c| Y^2) with X = |mx - bx| + 15 and
// Y = |my - by| + 15. An entry whose opacity is below alpha_min is dropped
// too (alpha <= op in either form): among them the empty slots of a work
// list whose window was cut, which read zero rows. `windowed.strip_live`
// takes the same float32 operations in the same order.
template <int EWA>
__device__ __forceinline__ bool strip_keeps(float4 h, float2 g, float bx, float by, float sy,
                                            float alpha_min) {
  const float a = h.z, b = h.w, c = g.x;
  const float x0 = __fsub_rn(bx, h.x), x1 = __fsub_rn(bx + (float)(TILE - 1), h.x);
  const float y0 = __fsub_rn(sy, h.y), y1 = __fsub_rn(sy + (float)(STRIP_ROWS - 1), h.y);
  const float qmin = sagsq::box_qmin(a, b, c, x0, x1, y0, y1);
  float X, Y;
  if (EWA == EWA_QUAD) {
    X = __fadd_rn(fabsf(__fsub_rn(h.x, bx)), (float)(TILE - 1));
    Y = __fadd_rn(fabsf(__fsub_rn(h.y, by)), (float)(TILE - 1));
  } else {
    X = sagsq::nan_max(fabsf(x0), fabsf(x1));
    Y = sagsq::nan_max(fabsf(y0), fabsf(y1));
  }
  const float mag = sagsq::quad(fabsf(a), fabsf(b), fabsf(c), X, Y);
  const float level = sagsq::gate_level(g.y, alpha_min);
  const float bound = __fadd_rn(
      level, __fadd_rn(__fmul_rn(CULL_REL, __fadd_rn(mag, level)), CULL_ABS));
  const bool drop = (a > 0.f && c > 0.f && qmin > bound) ||
                    g.y < alpha_min;  // alpha <= op: never gated
  return !drop;
}

// Composite the first `count` entries of a tile's work list, `ids(k)` giving
// the k-th window-local id, with 256 threads: one a pixel (bx + u, by + v),
// tid = 16 v + u. The gates are the TPU kernel's (`pallas_windowed.py:
// 264-326`):
//   longhand: power = ewa_power, alpha = min(0.99, op e^power);
//   quad: the same quadratic expanded around the tile origin into six
//         monomials of the tile-local (u, v) (coefficients per row, in float32,
//         one rounded operation at a time), alpha = min(0.99, op
//         e^min(power, 0)), and power in (0, 0.01] counts as 0;
//   gated iff power <= 0 and alpha >= alpha_min (an empty slot reads a zero
//   row: opacity 0 fails the gate);
//   a gated entry adds w = alpha T and sets T *= (1 - alpha) while
//   T (1 - alpha) >= t_min; the first failure cuts the pixel until the next
//   boundary of `chunk` entries.
// Feature sums: PREC_HIGHEST w f in float32; PREC_DEFAULT bf16(w) bf16(f);
// PREC_HIGH the bf16x2 split wh fh + wh fl + wl fh (lo lo dropped); with
// BF16OBJ the obj channels take bf16(w) times their packed bf16 values. The
// products of bf16 values are exact in float32; sums are float32, one entry
// at a time in work-list order, and w f is rounded before it is added, so
// the plain version's per-entry sum gives the same bits in every tier.
// `rows` is shared memory of 2 * SUB * RowStride<BF16OBJ> floats, 16-byte
// aligned; G and row_stride (a multiple of 4 floats) 16-byte aligned rows.
// Writes acc[pixel * 24 + c] and T[pixel] of this tile.
template <bool BF16OBJ>
struct RowStride {
  // columns 0..31, under BF16OBJ the packed columns 40..47 at 32..39; padded
  // so that lane l's header read in the strip test is free of bank conflicts
  static constexpr int value = BF16OBJ ? 44 : 36;
};

template <int EWA, int PREC, bool BF16OBJ, class Ids>
__device__ __forceinline__ void composite_window(float* __restrict__ rows,
                                                 const float* __restrict__ G, int row_stride,
                                                 int n_rows, const Ids& ids, int count,
                                                 const Spans& spans, float bx, float by,
                                                 float alpha_min, float t_min, int chunk,
                                                 float* __restrict__ acc_out,
                                                 float* __restrict__ T_out) {
  constexpr int RS = RowStride<BF16OBJ>::value;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float u = (float)(tid % TILE), v = (float)(tid / TILE);
  const float px = bx + u, py = by + v;
  const float uu = __fmul_rn(u, u), uv = __fmul_rn(u, v), vv = __fmul_rn(v, v);
  const float sy = by + (float)(warp * STRIP_ROWS);  // the warp's strip
  const float om_max = 1.f - alpha_min;

  // thread tid copies 16 bytes (columns cc .. cc + 3) of entry ck of a group,
  // and under BF16OBJ the threads with cc < 8 the packed columns 40 + cc ..;
  // an entry's id is loaded two groups ahead and resolved one group ahead
  const int ck = tid >> 3, cc = (tid & 7) * 4;
  auto lid_of = [&](int base) { return base + ck < count ? ids(base + ck) : -1; };
  auto copy_row = [&](int buf, int lid) {
    int r = window_row(lid, spans);
    r = r < n_rows ? r : -1;
    const float* src = G + (size_t)max(r, 0) * row_stride;
    float* dst = rows + (buf * SUB + ck) * RS;
    cp_async16(dst + cc, src + cc, r >= 0 ? 16 : 0);
    if (BF16OBJ && cc < 8) cp_async16(dst + CH + cc, src + COL_OBJ_BF16 + cc, r >= 0 ? 16 : 0);
    cp_async_commit();
  };
  copy_row(0, lid_of(0));
  int lid_next = lid_of(SUB);

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
    if (base + SUB < count) copy_row(buf ^ 1, lid_next);
    lid_next = lid_of(base + 2 * SUB);

    const float* grp = rows + buf * SUB * RS;
    // lane l: entry base + l's strip test and, under quad, its coefficients
    const float4 hl = *reinterpret_cast<const float4*>(grp + lane * RS);
    const float2 gl = *reinterpret_cast<const float2*>(grp + lane * RS + 4);
    float cf0 = 0.f, cf1 = 0.f, cf2 = 0.f, cf3 = 0.f, cf4 = 0.f, cf5 = 0.f;
    if (EWA == EWA_QUAD) {  // the six monomial coefficients of entry base + lane
      const float A = hl.z, Bq = hl.w, C = gl.x;
      const float mx = __fsub_rn(hl.x, bx), my = __fsub_rn(hl.y, by);
      const float q = __fadd_rn(__fmul_rn(__fmul_rn(A, mx), mx), __fmul_rn(__fmul_rn(C, my), my));
      cf0 = __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(Bq, mx), my));
      cf1 = __fadd_rn(__fmul_rn(A, mx), __fmul_rn(Bq, my));
      cf2 = __fadd_rn(__fmul_rn(C, my), __fmul_rn(Bq, mx));
      cf3 = __fmul_rn(-0.5f, A);
      cf4 = -Bq;
      cf5 = __fmul_rn(-0.5f, C);
    }
    // bit k: entry base + k starts a chunk; entry base + k may reach the strip
    unsigned starts = __ballot_sync(FULL, (base + lane) % chunk == 0);
    const int n = count - base;
    unsigned mask = n >= SUB ? FULL : (1u << n) - 1u;
    mask &= __ballot_sync(FULL, strip_keeps<EWA>(hl, gl, bx, by, sy, alpha_min));
    if (!__any_sync(FULL, T * om_max >= t_min)) mask = 0u;  // the strip is done
    while (mask) {
      const int k = __ffs(mask) - 1;
      mask &= mask - 1u;
      if (starts) {  // a chunk starts at or before entry k: its cut is new
        const unsigned upto = (2u << k) - 1u;
        cut = cut && !(starts & upto);
        starts &= ~upto;
      }
      float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f, c4 = 0.f, c5 = 0.f;
      if (EWA == EWA_QUAD) {  // every lane, before the divergent `cut` branch
        c0 = __shfl_sync(FULL, cf0, k);
        c1 = __shfl_sync(FULL, cf1, k);
        c2 = __shfl_sync(FULL, cf2, k);
        c3 = __shfl_sync(FULL, cf3, k);
        c4 = __shfl_sync(FULL, cf4, k);
        c5 = __shfl_sync(FULL, cf5, k);
      }
      if (cut) continue;
      const float* r = grp + k * RS;
      const float4 h = *reinterpret_cast<const float4*>(r);
      const float2 g = *reinterpret_cast<const float2*>(r + 4);
      float power, alpha;
      if (EWA == EWA_QUAD) {
        float p = __fadd_rn(c0, __fmul_rn(c1, u));
        p = __fadd_rn(p, __fmul_rn(c2, v));
        p = __fadd_rn(p, __fmul_rn(c3, uu));
        p = __fadd_rn(p, __fmul_rn(c4, uv));
        p = __fadd_rn(p, __fmul_rn(c5, vv));
        alpha = fminf(0.99f, g.y * expf(fminf(p, 0.f)));
        power = p <= 0.01f ? fminf(p, 0.f) : p;
      } else {
        power = ewa_power(h.z, h.w, g.x, h.x - px, h.y - py);
        alpha = fminf(0.99f, g.y * expf(power));
      }
      if (!(power <= 0.f && alpha >= alpha_min)) continue;
      const float test = T * (1.f - alpha);
      if (test < t_min) {
        cut = true;
        continue;
      }
      const float w = alpha * T;
      float f[CF];
#pragma unroll
      for (int q4 = 0; q4 < CF / 4; ++q4) {
        const float4 x = reinterpret_cast<const float4*>(r + HDR)[q4];
        f[4 * q4] = x.x, f[4 * q4 + 1] = x.y, f[4 * q4 + 2] = x.z, f[4 * q4 + 3] = x.w;
      }
      if (PREC == PREC_HIGHEST && !BF16OBJ) {
#pragma unroll
        for (int c = 0; c < CF; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, f[c]));
      } else {
        if (BF16OBJ) {  // the obj channels from their packed bf16 columns
          const float4 p0 = *reinterpret_cast<const float4*>(r + CH);
          const float4 p1 = *reinterpret_cast<const float4*>(r + CH + 4);
          const float pk[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int o = 0; o < N_OBJ; ++o) {
            const unsigned bits = __float_as_uint(pk[o / 2]);
            f[OBJ0 - HDR + o] = __uint_as_float((o & 1 ? bits >> 16 : bits & 0xffffu) << 16);
          }
        }
        const float wh = bf16_round(w);
        const float wl = bf16_round(w - wh);
#pragma unroll
        for (int c = 0; c < CF; ++c) {
          if (BF16OBJ && c >= OBJ0 - HDR && c < OBJ0 - HDR + N_OBJ) {
            acc[c] += wh * f[c];  // f is already a bf16 value
          } else if (PREC == PREC_DEFAULT) {
            acc[c] += wh * bf16_round(f[c]);
          } else if (PREC == PREC_HIGH) {
            const float fh = bf16_round(f[c]);
            const float fl = bf16_round(f[c] - fh);
            acc[c] += wh * fh + wh * fl + wl * fh;
          } else {
            acc[c] = __fadd_rn(acc[c], __fmul_rn(w, f[c]));
          }
        }
      }
      T = test;
    }
    if (starts) cut = false;  // a chunk started after the last entry walked
  }

  float4* dst = reinterpret_cast<float4*>(acc_out + (size_t)tid * CF);
#pragma unroll
  for (int q4 = 0; q4 < CF / 4; ++q4)
    dst[q4] = make_float4(acc[4 * q4], acc[4 * q4 + 1], acc[4 * q4 + 2], acc[4 * q4 + 3]);
  T_out[tid] = T;
}

}  // namespace sagsw
