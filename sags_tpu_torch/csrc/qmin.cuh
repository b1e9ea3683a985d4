// qmin.cuh: the least value of a conic quadratic over a box of pixel centres,
// shared by composite_windowed_sorted.cu (the tile cull of the in-kernel sort)
// and composite_fused.cu (the per-warp strip cull). Every step is one rounded
// float32 operation in the order `ops/binning.py:box_qmin` takes them in
// PyTorch (no fused multiply-add), so kernel and plain version give the same
// bits.

#pragma once

#include <cuda_runtime.h>

namespace sagsq {

// torch.minimum / torch.maximum / torch.clamp(min=) propagate NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float clamp_min(float x, float m) {
  return x != x ? x : fmaxf(x, m);
}

// a x^2 + 2 b x y + c y^2, left to right as PyTorch evaluates it
__device__ __forceinline__ float quad(float a, float b, float c, float x, float y) {
  const float t1 = __fmul_rn(__fmul_rn(a, x), x);
  const float t2 = __fmul_rn(__fmul_rn(__fmul_rn(2.f, b), x), y);
  const float t3 = __fmul_rn(__fmul_rn(c, y), y);
  return __fadd_rn(__fadd_rn(t1, t2), t3);
}

// Minimum of a x^2 + 2 b x y + c y^2 over [x0, x1] x [y0, y1] (offsets from
// the conic's centre): zero when the centre lies inside, else the least of
// the four edges' minima (`binning.box_qmin`).
__device__ __forceinline__ float box_qmin(float a, float b, float c, float x0, float x1,
                                          float y0, float y1) {
  const bool inside = (x0 <= 0.f) && (0.f <= x1) && (y0 <= 0.f) && (0.f <= y1);
  const float a_s = clamp_min(a, 1e-12f);
  const float c_s = clamp_min(c, 1e-12f);
  const float nb = -b;
  float q = nan_max(__fdiv_rn(__fmul_rn(nb, x0), c_s), y0);
  const float qx0 = quad(a, b, c, x0, nan_min(q, y1));
  q = nan_max(__fdiv_rn(__fmul_rn(nb, x1), c_s), y0);
  const float qx1 = quad(a, b, c, x1, nan_min(q, y1));
  q = nan_max(__fdiv_rn(__fmul_rn(nb, y0), a_s), x0);
  const float qy0 = quad(a, b, c, nan_min(q, x1), y0);
  q = nan_max(__fdiv_rn(__fmul_rn(nb, y1), a_s), x0);
  const float qy1 = quad(a, b, c, nan_min(q, x1), y1);
  const float qmin = nan_min(nan_min(qx0, qx1), nan_min(qy0, qy1));
  return inside ? 0.f : qmin;
}

// The alpha gate's level in conic-q units, before any margin:
// max(2 ln(op / alpha_min), 0); q above it means alpha < alpha_min.
__device__ __forceinline__ float gate_level(float op, float alpha_min) {
  const float lg = logf(clamp_min(__fdiv_rn(op, alpha_min), 1e-12f));
  return clamp_min(__fmul_rn(2.f, lg), 0.f);
}

}  // namespace sagsq
