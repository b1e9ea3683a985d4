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
// a VMEM window first; here each id is resolved through the <= R spans and
// its row is gathered straight from G_s.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sagsw {

constexpr int SUB = 32;  // work-list entries staged in shared memory per round
constexpr int CH = 32;   // columns composited: 8 header + 24 feature floats
constexpr int HDR = 8;
constexpr int CF = CH - HDR;
constexpr int MAX_SPAN = 8;
// windowed_bf16: the 16 obj channels (feature columns 11..26) are read as
// bf16 pairs packed into float32 columns 40..47 (lo = channel 2c, hi = 2c+1)
constexpr int OBJ0 = HDR + 3, N_OBJ = 16, COL_OBJ_BF16 = 40;

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
__device__ __forceinline__ float ewa_power(const float* r, float dx, float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(r[2], dx), dx),
                            __fmul_rn(__fmul_rn(r[4], dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(r[3], dx), dy));
}

// Composite the first `count` entries of a tile's work list, `ids(k)` giving
// the k-th window-local id. One thread per pixel (px, py) = (bx + u, by + v);
// the block is the tile (tile x tile pixels). The gates are the TPU kernel's
// (`pallas_windowed.py:264-326`):
//   longhand: power = ewa_power, alpha = min(0.99, op e^power);
//   quad: the same quadratic expanded around the tile origin into six
//         monomials of the tile-local (u, v) (coefficients per row, in float32,
//         one rounded operation at a time), alpha = min(0.99, op
//         e^min(power, 0)), and power in (0, 0.01] counts as 0;
//   gated iff power <= 0 and alpha >= alpha_min (an empty slot reads a zero
//   row: opacity 0 fails the gate);
//   a gated pair adds w = alpha T and sets T *= (1 - alpha) while
//   T (1 - alpha) >= t_min; the first failure cuts the pixel until the next
//   boundary of `chunk` entries.
// Feature sums: PREC_HIGHEST w f in float32; PREC_DEFAULT bf16(w) bf16(f);
// PREC_HIGH the bf16x2 split wh fh + wh fl + wl fh (lo lo dropped); with
// BF16OBJ the obj channels take bf16(w) times their packed bf16 values. The
// products of bf16 values are exact in float32; sums are float32, one pair
// at a time in work-list order, and w f is rounded before it is added, so
// the plain version's per-pair sum gives the same bits in every tier.
// Writes acc[pixel * 24 + c] and T[pixel] of this tile.
template <int EWA, int PREC, bool BF16OBJ, class Ids>
__device__ __forceinline__ void composite_window(const float* __restrict__ G, int row_stride,
                                 int n_rows, const Ids& ids, int count,
                                 const Spans& spans, int tile, float bx, float by,
                                 float alpha_min, float t_min, int chunk,
                                 float* __restrict__ acc_out,
                                 float* __restrict__ T_out) {
  __shared__ float rows[SUB][CH];
  __shared__ float coef[EWA == EWA_QUAD ? SUB : 1][6];
  __shared__ int srow[SUB];
  const int tid = threadIdx.x;
  const int PIX = blockDim.x;
  const float u = (float)(tid % tile), v = (float)(tid / tile);
  const float px = bx + u, py = by + v;
  const float uu = __fmul_rn(u, u), uv = __fmul_rn(u, v), vv = __fmul_rn(v, v);
  const float om_max = 1.f - alpha_min;

  float acc[CF];
#pragma unroll
  for (int c = 0; c < CF; ++c) acc[c] = 0.f;
  float T = 1.f;
  bool cut = false;

  for (int base = 0; base < count; base += SUB) {
    // no pixel can take another pair (T (1 - alpha) < t_min for every
    // alpha >= alpha_min): the tile is done
    if (__syncthreads_count(T * om_max >= t_min) == 0) break;
    const int n = min(SUB, count - base);
    if (tid < n) {
      const int r = window_row(ids(base + tid), spans);
      srow[tid] = r < n_rows ? r : -1;
    }
    __syncthreads();
    for (int i = tid; i < n * CH; i += PIX) {
      const int k = i / CH, c = i - k * CH;
      const int r = srow[k];
      float x = 0.f;
      if (r >= 0) {
        if (BF16OBJ && c >= OBJ0 && c < OBJ0 + N_OBJ) {
          const unsigned bits = __float_as_uint(
              G[(size_t)r * row_stride + COL_OBJ_BF16 + (c - OBJ0) / 2]);
          x = __uint_as_float(((c - OBJ0) & 1 ? bits >> 16 : bits & 0xffffu) << 16);
        } else {
          x = G[(size_t)r * row_stride + c];
        }
      }
      rows[k][c] = x;
    }
    __syncthreads();
    if (EWA == EWA_QUAD) {
      if (tid < n) {  // the six monomial coefficients of row tid
        const float A = rows[tid][2], Bq = rows[tid][3], C = rows[tid][4];
        const float mx = __fsub_rn(rows[tid][0], bx), my = __fsub_rn(rows[tid][1], by);
        const float q = __fadd_rn(__fmul_rn(__fmul_rn(A, mx), mx),
                                  __fmul_rn(__fmul_rn(C, my), my));
        coef[tid][0] = __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(Bq, mx), my));
        coef[tid][1] = __fadd_rn(__fmul_rn(A, mx), __fmul_rn(Bq, my));
        coef[tid][2] = __fadd_rn(__fmul_rn(C, my), __fmul_rn(Bq, mx));
        coef[tid][3] = __fmul_rn(-0.5f, A);
        coef[tid][4] = -Bq;
        coef[tid][5] = __fmul_rn(-0.5f, C);
      }
      __syncthreads();
    }
    for (int k = 0; k < n; ++k) {
      if ((base + k) % chunk == 0) cut = false;
      if (cut) continue;
      float power, alpha;
      if (EWA == EWA_QUAD) {
        const float* cf = coef[EWA == EWA_QUAD ? k : 0];
        float p = __fadd_rn(cf[0], __fmul_rn(cf[1], u));
        p = __fadd_rn(p, __fmul_rn(cf[2], v));
        p = __fadd_rn(p, __fmul_rn(cf[3], uu));
        p = __fadd_rn(p, __fmul_rn(cf[4], uv));
        p = __fadd_rn(p, __fmul_rn(cf[5], vv));
        alpha = fminf(0.99f, rows[k][5] * expf(fminf(p, 0.f)));
        power = p <= 0.01f ? fminf(p, 0.f) : p;
      } else {
        power = ewa_power(rows[k], rows[k][0] - px, rows[k][1] - py);
        alpha = fminf(0.99f, rows[k][5] * expf(power));
      }
      if (!(power <= 0.f && alpha >= alpha_min)) continue;
      const float test = T * (1.f - alpha);
      if (test < t_min) {
        cut = true;
        continue;
      }
      const float w = alpha * T;
      if (PREC == PREC_HIGHEST && !BF16OBJ) {
#pragma unroll
        for (int c = 0; c < CF; ++c)
          acc[c] = __fadd_rn(acc[c], __fmul_rn(w, rows[k][HDR + c]));
      } else {
        const float wh = bf16_round(w);
        const float wl = bf16_round(w - wh);
#pragma unroll
        for (int c = 0; c < CF; ++c) {
          const float f = rows[k][HDR + c];
          if (BF16OBJ && c >= 3 && c < 3 + N_OBJ) {
            acc[c] += wh * f;  // f is already a bf16 value
          } else if (PREC == PREC_DEFAULT) {
            acc[c] += wh * bf16_round(f);
          } else if (PREC == PREC_HIGH) {
            const float fh = bf16_round(f);
            const float fl = bf16_round(f - fh);
            acc[c] += wh * fh + wh * fl + wl * fh;
          } else {
            acc[c] = __fadd_rn(acc[c], __fmul_rn(w, f));
          }
        }
      }
      T = test;
    }
    __syncthreads();
  }

  float4* dst = reinterpret_cast<float4*>(acc_out + (size_t)tid * CF);
#pragma unroll
  for (int v4 = 0; v4 < CF / 4; ++v4)
    dst[v4] = make_float4(acc[4 * v4], acc[4 * v4 + 1], acc[4 * v4 + 2],
                          acc[4 * v4 + 3]);
  T_out[tid] = T;
}

}  // namespace sagsw
