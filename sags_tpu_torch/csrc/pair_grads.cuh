// pair_grads.cuh: the reverse sweep's per-entry gradient and its fixed-order
// reduction over a tile's pixels, shared by composite_fused_bwd.cu (classic
// table) and composite_windowed_bwd.cu (windowed work list), which differ
// only in how they find an entry's row and keep the transmittance.
//
// Per pixel, with s_k = sum_c f_kc dAcc_c, w_k = m_k alpha_k T_k and
// om_k = 1 - alpha_k:
//   da_k = m_k T_k s_k - (gate_k / om_k) B_k - (m_k / om_k) carry
// where B_k is the sum of w_j s_j over later entries of the same chunk and
// carry the sum over later chunks plus T_final dT: the TPU kernels' formula
// (`pallas_composite.py:266-276`, `gate` versus `m` kept as there), chained
// through alpha = min(0.99, op e^power) with the clip mask raw >= 0.99 and
// the max(op, 1e-12) guard.

#pragma once

#include <cuda_runtime.h>

namespace sagsb {

constexpr int CH = 32;  // row columns: 8 header + 24 features
constexpr int HDR = 8;
constexpr int CF = CH - HDR;
constexpr int NR = 6 + CF;  // reduced values per entry: mx, my, ca, cb, cc, op, features
constexpr unsigned FULL = 0xffffffffu;

// One gated entry's per-pixel gradient values v[NR] (v is zero-filled by the
// caller): row r, offsets dx, dy, raw = op e^power, m = it composited, Te its
// exclusive transmittance; B (this chunk's later w s) takes on w s.
__device__ __forceinline__ void entry_grads(const float* r, float dx, float dy, float raw,
                                            bool m, float Te, const float* dacc,
                                            float carry, float& B, float* v) {
  const float alpha = fminf(0.99f, raw);
  const float om = 1.f - alpha;
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

// The warp's sums of v into dst[0 .. NR-1] by a shuffle tree (zeros, without
// the tree, when no lane of the warp is gated).
__device__ __forceinline__ void warp_sums(const float* v, bool gate, float* dst, int lane) {
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

// Entries base .. base + n - 1 of the tile: the fixed-order sum over the nw
// warps' partials red[(k * nw + warp) * NR + q], written to out[row * K + base
// + k] (rows 6-7 zero), coalesced along k. No atomics: bitwise reproducible.
__device__ __forceinline__ void write_entry_sums(const float* red, float* out, int K,
                                                 int base, int n, int nw) {
  for (int i = threadIdx.x; i < CH * n; i += blockDim.x) {
    const int row = i / n, k = i - row * n;
    float x = 0.f;
    if (row < 6 || row >= HDR) {
      const int q = row < 6 ? row : 6 + (row - HDR);
      for (int w = 0; w < nw; ++w) x += red[(k * nw + w) * NR + q];
    }
    out[(size_t)row * K + base + k] = x;
  }
}

}  // namespace sagsb
