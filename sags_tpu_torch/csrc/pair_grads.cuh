// pair_grads.cuh: the reverse sweep's per-entry gradient and its fixed-order
// reduction over a tile's pixels, shared by composite_fused_bwd.cu (classic
// table) and composite_windowed_bwd.cu (windowed work list), which differ
// in how they find an entry's row and keep the transmittance, and in how they
// sum over the pixels: the windowed kernel by shuffle trees (`entry_grads`,
// `warp_sums`, `write_entry_sums`), the classic one as a matrix product on
// the tensor cores (`warp_products`, `write_group_sums`).
//
// Per pixel, with s_k = sum_c f_kc dAcc_c, w_k = m_k alpha_k T_k and
// om_k = 1 - alpha_k:
//   da_k = m_k T_k s_k - (gate_k / om_k) B_k - (m_k / om_k) carry
// where B_k is the sum of w_j s_j over later entries of the same chunk and
// carry the sum over later chunks plus T_final dT: the TPU kernels' formula
// (`pallas_composite.py:266-276`, `gate` versus `m` kept as there), chained
// through alpha = min(0.99, op e^power) with the clip mask raw >= 0.99 and
// the max(op, 1e-12) guard.
//
// The matrix form. With dpow_k = da_k alpha_k where raw_k < 0.99, the sums
// over a tile's 256 pixels p are two products, as in the TPU kernel's body
// (`pallas_composite.py:261-265, 292-296`):
//   dfeat[k][c] = sum_p w[k][p] dAcc[p][c]           (24 columns)
//   S[k][i]     = sum_p dpow[k][p] Phi[p][i]         (6 moments)
// Phi = {1, u, v, u^2, u v, v^2}, (u, v) the pixel's offset from the tile's
// centre (half-integers up to 7.5: exact in TF32). The geometry gradients
// follow per entry from the moments and the entry's centre relative to the
// same point (`write_group_sums`). The products run as mma.sync m16n8k8 in
// TF32 with w, dpow and dAcc split into a high and a low part (three
// products, two where Phi is exact): float32 accuracy, in an order the
// instruction sequence fixes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sagsb {

constexpr int CH = 32;  // row columns: 8 header + 24 features
constexpr int HDR = 8;
constexpr int CF = CH - HDR;
constexpr int NR = 6 + CF;  // reduced values per entry: mx, my, ca, cb, cc, op, features
constexpr unsigned FULL = 0xffffffffu;

// One gated entry at one pixel: returns da = dL/dalpha. Row r, alpha, m = it
// composited, Te its exclusive transmittance; w is its weight m alpha Te, and
// B (this chunk's later w s) takes on w s.
__device__ __forceinline__ float entry_da(const float* r, float alpha, bool m, float Te,
                                          const float* dacc, float carry, float& B,
                                          float& w) {
  const float om = 1.f - alpha;
  const float4* f = reinterpret_cast<const float4*>(r + HDR);  // rows are 128-byte aligned
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CF / 4; ++c) {
    const float4 q = f[c];
    s += q.x * dacc[4 * c];
    s += q.y * dacc[4 * c + 1];
    s += q.z * dacc[4 * c + 2];
    s += q.w * dacc[4 * c + 3];
  }
  w = m ? alpha * Te : 0.f;
  const float da = (m ? Te * s : 0.f) - (m ? B + carry : B) / om;
  B += w * s;
  return da;
}

// One gated entry's per-pixel gradient values v[NR] (v is zero-filled by the
// caller): row r, offsets dx, dy, raw = op e^power, m = it composited, Te its
// exclusive transmittance; B (this chunk's later w s) takes on w s.
__device__ __forceinline__ void entry_grads(const float* r, float dx, float dy, float raw,
                                            bool m, float Te, const float* dacc,
                                            float carry, float& B, float* v) {
  const float alpha = fminf(0.99f, raw);
  float w;
  const float da = entry_da(r, alpha, m, Te, dacc, carry, B, w);
  if (raw < 0.99f) {  // dalpha/dpower = alpha, dalpha/dop = alpha / op
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

// ---- the sums over a tile's pixels as a matrix product ----

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int NWARP = PIX / 32;
constexpr int SUB = 32;       // entries per group: two m16 tiles
constexpr int LDW = PIX + 4;  // row stride of a [SUB][PIX] factor array: the
                              // mma fragment loads hit 32 different banks
constexpr int MOM = CF;       // first moment column of a group's 32 sums

__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}

// c[16 x 8] += a[16 x 8] b[8 x 8]. Lane l = 4 g + q holds a = {(g, q),
// (g + 8, q), (g, q + 4), (g + 8, q + 4)}, b = {(q, g), (q + 4, g)} and
// c = {(g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1)}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Column i of Phi at pixel p of the tile (columns 6 and 7 pad the n8 tile),
// without a branch: a product of two of {0, 1, u, v}.
__device__ __forceinline__ float phi(int p, int i) {
  const float u = (float)(p % TILE) - 0.5f * (TILE - 1);
  const float v = (float)(p / TILE) - 0.5f * (TILE - 1);
  const float a = i == 0 ? 1.f : (i == 1 || i == 3 || i == 4) ? u : (i == 2 || i == 5) ? v : 0.f;
  const float b = i == 3 ? u : (i == 4 || i == 5) ? v : 1.f;
  return a * b;
}

// A lane's share of Phi as mma B fragments for the warp's pixels p0 ..
// p0 + 31, one k8 step each: the same for every group of the tile.
struct PhiFrags {
  uint32_t b[4][2];
};

__device__ __forceinline__ PhiFrags phi_frags(int p0, int lane) {
  PhiFrags f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f.b[ks][h] = __float_as_uint(phi(p0 + ks * 8 + (lane & 3) + 4 * h, lane >> 2));
  return f;
}

// One warp's share of a group's sums, over its 32 pixels p0 .. p0 + 31:
//   C[k][c]       = sum_p W[k][p] dAcc[p][c],  c < CF
//   C[k][MOM + i] = sum_p D[k][p] Phi[p][i]
// for the group's SUB entries k. W and D are [SUB][LDW] in shared memory,
// written for these pixels by this warp's own lanes; dacc_tile is the tile's
// d_acc [PIX][CF] in device memory. C goes, transposed, over the warp's own
// columns of W: W[c * LDW + p0 + k]. Whole warp, converged. Neighbouring mma
// write different accumulators, so none waits for the one before it.
__device__ __forceinline__ void warp_products(float* W, const float* D,
                                              const float* __restrict__ dacc_tile,
                                              const PhiFrags& phis, int p0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  float c[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[mt][nt][i] = 0.f;
  __syncwarp();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int p = p0 + ks * 8 + q;  // this lane's pixels of the k8 step: p, p + 4
    uint32_t bh[3][2], bl[3][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
        split_tf32(__ldg(dacc_tile + (p + 4 * h) * CF + nt * 8 + g), bh[nt][h], bl[nt][h]);
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int at = (mt * 16 + g) * LDW + p;
      split_tf32(W[at], ah[mt][0], al[mt][0]);
      split_tf32(W[at + 8 * LDW], ah[mt][1], al[mt][1]);
      split_tf32(W[at + 4], ah[mt][2], al[mt][2]);
      split_tf32(W[at + 8 * LDW + 4], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) mma_tf32(c[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) mma_tf32(c[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) mma_tf32(c[mt][nt], ah[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int at = (mt * 16 + g) * LDW + p;
      split_tf32(D[at], ah[mt][0], al[mt][0]);
      split_tf32(D[at + 8 * LDW], ah[mt][1], al[mt][1]);
      split_tf32(D[at + 4], ah[mt][2], al[mt][2]);
      split_tf32(D[at + 8 * LDW + 4], ah[mt][3], al[mt][3]);
    }
    mma_tf32(c[0][3], al[0], phis.b[ks]);
    mma_tf32(c[1][3], al[1], phis.b[ks]);
    mma_tf32(c[0][3], ah[0], phis.b[ks]);
    mma_tf32(c[1][3], ah[1], phis.b[ks]);
  }
  __syncwarp();  // every lane has read its share of W
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        W[(nt * 8 + 2 * q + (i & 1)) * LDW + p0 + mt * 16 + g + 8 * (i >> 1)] = c[mt][nt][i];
}

// Column c of entry k of the group: the warps' partial sums in a fixed order.
__device__ __forceinline__ float group_sum(const float* W, int c, int k) {
  float x = 0.f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) x += W[c * LDW + w * 32 + k];
  return x;
}

// Entries base .. base + n - 1 of the tile, after every warp's
// `warp_products` and a barrier: out[row * K + base + k], coalesced along k.
// Feature rows are the summed columns; the geometry rows follow from the six
// moments S and the entry's centre (mxc, myc) relative to the tile's centre
// (cx, cy), since dx = mxc - u and dy = myc - v:
//   sum dpow dx = mxc S0 - Su,   sum dpow dx^2 = mxc (mxc S0 - 2 Su) + Suu,
//   sum dpow dx dy = mxc (myc S0 - Sv) - myc Su + Suv,   dop = S0 / max(op, 1e-12).
// Rows 6-7 are zero. No atomics: bitwise reproducible.
__device__ __forceinline__ void write_group_sums(const float* W, const float* rows,
                                                 float* out, int K, int base, int n, float cx,
                                                 float cy) {
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  if (k >= n) return;
#pragma unroll
  for (int it = 0; it < CF / NWARP; ++it) {
    const int c = it * NWARP + warp;
    out[(size_t)(HDR + c) * K + base + k] = group_sum(W, c, k);
  }
  float x = 0.f;
  if (warp < 6) {
    const float* r = rows + k * CH;
    const float mxc = r[0] - cx, myc = r[1] - cy;
    const float S0 = group_sum(W, MOM, k);
    const float Su = group_sum(W, MOM + 1, k), Sv = group_sum(W, MOM + 2, k);
    const float sx = mxc * S0 - Su, sy = myc * S0 - Sv;
    switch (warp) {
      case 0: x = -(r[2] * sx + r[3] * sy); break;
      case 1: x = -(r[4] * sy + r[3] * sx); break;
      case 2: x = -0.5f * (mxc * (mxc * S0 - 2.f * Su) + group_sum(W, MOM + 3, k)); break;
      case 3: x = -(mxc * sy - myc * Su + group_sum(W, MOM + 4, k)); break;
      case 4: x = -0.5f * (myc * (myc * S0 - 2.f * Sv) + group_sum(W, MOM + 5, k)); break;
      default: x = S0 / fmaxf(r[5], 1e-12f); break;
    }
  }
  out[(size_t)warp * K + base + k] = x;
}

}  // namespace sagsb
