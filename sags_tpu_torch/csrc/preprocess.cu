// preprocess: the rasterizer's per-Gaussian projection, forward and backward.
//
// Replaces no TPU kernel: the JAX package leaves `preprocess` to XLA, which
// fuses its [P] columns into a few passes. In the port it was one PyTorch op
// a scalar expression (`ops/rasterize.py:preprocess`, which stays the plain
// version): ~365 launches forward and ~540 in autograd's backward at SH
// degree 0, each a pass over every slot of the map's capacity.
//
// Forward (`sags_preprocess`), one thread a slot: the view transform, the
// pixel centre, Sigma3D = R diag((s m)^2) R^T from the normalised quaternion,
// the view-space covariance, the EWA Jacobian with its 1.3 tan(fov) clamp,
// the +low_pass conic, the 3-sigma radius, the alpha-gate level rcull2, the
// tile rectangle (tight or by radius) and the SH degree-0 colour. Every
// expression is written in the plain version's order, one rounded float32
// operation each, and the library is built with -fmad=false, so the outputs
// are the plain version's on the card bit for bit: the binning's integers
// after it (pairs, overflows, peaks) do not move. The quaternion's norm sums
// its squares as PyTorch's CUDA reduction does, (x^2 + z^2) + (y^2 + w^2)
// (PyTorch 2.11's on an H100 agrees on each of 2^20 random quaternions, where
// the other two pairings miss ~15%); a division by a Python scalar is a
// product with the scalar's reciprocal taken in double and rounded to float32,
// as PyTorch does it on the card, and the host computes that reciprocal
// (an IEEE float32 quotient differs from it in ~75% of the slots at alpha_min
// = 1/255). The outputs go to one [18, P] float32 buffer, a contiguous row a
// field: mx my depth ca cb cc czx cyz rcull2, the colour as [P, 3] in rows
// 9-11, radius rmin_x rmin_y rmax_x rmax_y as int32 in rows 12-16, and row
// 17's bytes: valid [P], then clamped [P, 3].
//
// Backward (`sags_preprocess_bwd`): autograd's chain rule through the same
// expressions, recomputed from the inputs a slot at a time (nothing saved but
// the inputs), with its choices at every branch: torch.clamp passes the
// gradient on [lo, hi], ends included; the where on |depth| < 1e-6 and on
// det != 0 cut it; the colour clamp at 0 passes it where raw >= 0; the
// quaternion's norm passes it where norm >= 1e-12. It reads the gradients of
// mx my depth ca cb cc czx cyz and the colour (each a pointer and a stride;
// null reads zero) and writes those of means3d, scales, quats, the SH
// degree-0 coefficients and mean2d_offset (null: not written). radius,
// the rectangle, valid, clamped and rcull2 take no gradient.
//
// Bound: device memory. The forward reads ~65 bytes a slot (means, scales,
// quaternion, opacity, SH-0, the active flag, the offset) and writes 72; the
// backward reads the same inputs and 44 bytes of gradients and writes 52:
// ~1.3 GB for both at 2^22 slots, 0.39 ms at 3.35 TB/s. The ~900 PyTorch
// ops moved some 36 GB. The camera's two 4x4 matrices are read on the device
// through their pointers into shared memory once a block: no host read.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGrads = 11;  // mx my depth ca cb cc czx cyz color r g b

// The call's scalars, each rounded to float32 as PyTorch rounds a Python
// number it multiplies, adds, compares or clamps by.
struct Consts {
  float width, height, fx, fy, lim_x, lim_y, near, low_pass, scale_mod;
  float inv_alpha_min;  // float32(1 / alpha_min): `op / alpha_min`
  float tile, inv_tile;  // `/ tile`, likewise
  float c0;
};

struct Grads {
  const float* p[kGrads];
  long long stride[kGrads];
};

// torch.clamp passes NaN through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float ndc2pix(float v, float size) {
  return ((v + 1.0f) * size - 1.0f) * 0.5f;
}

// The differentiable part of the projection, in the plain version's order.
// cam: the world-view matrix V (0..15) and the full projection M (16..31),
// row-major.
struct Terms {
  float tvx, tvy, depth, hx, hy, inv_w, mean_x, mean_y;
  float n, nc, q[4], r[9], sm[3], v[3];
  float C00, C01, C02, C11, C12, C22;
  float safe_z, rx, ry, txc, tyc, inv_z, j00, j02, j11, j12;
  float cxx, cyy, cxy, czx, cyz, det, inv_det;
  bool det_ok;
};

__device__ __forceinline__ void terms(const float* cam, const Consts& k, float x, float y,
                                      float z, const float* s, const float* qin, Terms& t) {
  const float* V = cam;
  const float* M = cam + 16;
  t.tvx = V[0] * x + V[1] * y + V[2] * z + V[3];
  t.tvy = V[4] * x + V[5] * y + V[6] * z + V[7];
  t.depth = V[8] * x + V[9] * y + V[10] * z + V[11];
  t.hx = M[0] * x + M[1] * y + M[2] * z + M[3];
  t.hy = M[4] * x + M[5] * y + M[6] * z + M[7];
  const float hw = M[12] * x + M[13] * y + M[14] * z + M[15];
  t.inv_w = 1.0f / (hw + 1e-7f);
  t.mean_x = ndc2pix(t.hx * t.inv_w, k.width);
  t.mean_y = ndc2pix(t.hy * t.inv_w, k.height);

  // quat_normalize: q / clamp(vector_norm(q), min=1e-12)
  t.n = sqrtf((qin[0] * qin[0] + qin[2] * qin[2]) + (qin[1] * qin[1] + qin[3] * qin[3]));
  t.nc = clamp_min(t.n, 1e-12f);
  for (int i = 0; i < 4; ++i) t.q[i] = qin[i] / t.nc;
  const float qx = t.q[0], qy = t.q[1], qz = t.q[2], qw = t.q[3];
  float* r = t.r;
  r[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  r[1] = 2.0f * (qx * qy - qw * qz);
  r[2] = 2.0f * (qx * qz + qw * qy);
  r[3] = 2.0f * (qx * qy + qw * qz);
  r[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  r[5] = 2.0f * (qy * qz - qw * qx);
  r[6] = 2.0f * (qx * qz - qw * qy);
  r[7] = 2.0f * (qy * qz + qw * qx);
  r[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
  for (int i = 0; i < 3; ++i) {
    t.sm[i] = s[i] * k.scale_mod;
    t.v[i] = t.sm[i] * t.sm[i];
  }
  const float* v = t.v;
  float S[3][3];
  S[0][0] = r[0] * r[0] * v[0] + r[1] * r[1] * v[1] + r[2] * r[2] * v[2];
  S[0][1] = r[0] * r[3] * v[0] + r[1] * r[4] * v[1] + r[2] * r[5] * v[2];
  S[0][2] = r[0] * r[6] * v[0] + r[1] * r[7] * v[1] + r[2] * r[8] * v[2];
  S[1][1] = r[3] * r[3] * v[0] + r[4] * r[4] * v[1] + r[5] * r[5] * v[2];
  S[1][2] = r[3] * r[6] * v[0] + r[4] * r[7] * v[1] + r[5] * r[8] * v[2];
  S[2][2] = r[6] * r[6] * v[0] + r[7] * r[7] * v[1] + r[8] * r[8] * v[2];
  S[1][0] = S[0][1];
  S[2][0] = S[0][2];
  S[2][1] = S[1][2];
  // A = Rv S and C = A Rv^T, each entry Python's sum(): 0 + a + b + c
  float A[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      A[i][j] = 0.0f + V[4 * i] * S[0][j] + V[4 * i + 1] * S[1][j] + V[4 * i + 2] * S[2][j];
  auto centry = [&](int i, int j) {
    return 0.0f + A[i][0] * V[4 * j] + A[i][1] * V[4 * j + 1] + A[i][2] * V[4 * j + 2];
  };
  t.C00 = centry(0, 0);
  t.C01 = centry(0, 1);
  t.C02 = centry(0, 2);
  t.C11 = centry(1, 1);
  t.C12 = centry(1, 2);
  t.C22 = centry(2, 2);

  t.safe_z = fabsf(t.depth) < 1e-6f ? 1e-6f : t.depth;
  t.rx = t.tvx / t.safe_z;
  t.ry = t.tvy / t.safe_z;
  t.txc = clamp2(t.rx, -k.lim_x, k.lim_x) * t.depth;
  t.tyc = clamp2(t.ry, -k.lim_y, k.lim_y) * t.depth;
  t.inv_z = 1.0f / t.safe_z;
  t.j00 = k.fx * t.inv_z;
  t.j02 = -k.fx * t.txc * t.inv_z * t.inv_z;
  t.j11 = k.fy * t.inv_z;
  t.j12 = -k.fy * t.tyc * t.inv_z * t.inv_z;
  const float j00 = t.j00, j02 = t.j02, j11 = t.j11, j12 = t.j12;
  t.cxx = j00 * j00 * t.C00 + 2.0f * j00 * j02 * t.C02 + j02 * j02 * t.C22 + k.low_pass;
  t.cyy = j11 * j11 * t.C11 + 2.0f * j11 * j12 * t.C12 + j12 * j12 * t.C22 + k.low_pass;
  t.cxy = j00 * (j11 * t.C01 + j12 * t.C02) + j02 * (j11 * t.C12 + j12 * t.C22);
  t.czx = j00 * t.C02 + j02 * t.C22;
  t.cyz = j11 * t.C12 + j12 * t.C22;
  t.det = t.cxx * t.cyy - t.cxy * t.cxy;
  t.det_ok = t.det != 0.0f;
  t.inv_det = 1.0f / (t.det_ok ? t.det : 1.0f);
}

__device__ __forceinline__ void load_cam(float* cam, const float* view, const float* proj) {
  if (threadIdx.x < 32)
    cam[threadIdx.x] = threadIdx.x < 16 ? view[threadIdx.x] : proj[threadIdx.x - 16];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
preprocess_kernel(const float* __restrict__ means, const float* __restrict__ scales,
                  const float* __restrict__ quats, const float* __restrict__ opac,
                  const float* __restrict__ shs, int sh_stride,
                  const uint8_t* __restrict__ active, const float* __restrict__ offset,
                  const float* __restrict__ view, const float* __restrict__ proj, Consts k,
                  int P, int tiles_x, int tiles_y, int tight, float* __restrict__ out) {
  __shared__ float cam[32];
  load_cam(cam, view, proj);
  const size_t Pz = (size_t)P;
  int32_t* iout = reinterpret_cast<int32_t*>(out + 12 * Pz);
  uint8_t* bout = reinterpret_cast<uint8_t*>(out + 17 * Pz);
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < P; g += gridDim.x * kThreads) {
    Terms t;
    terms(cam, k, means[3 * g], means[3 * g + 1], means[3 * g + 2], scales + 3 * g,
          quats + 4 * g, t);
    float mean_x = t.mean_x, mean_y = t.mean_y;
    if (offset) {
      mean_x = mean_x + offset[2 * g];
      mean_y = mean_y + offset[2 * g + 1];
    }
    const float mid = 0.5f * (t.cxx + t.cyy);
    const float lam = mid + sqrtf(clamp_min(mid * mid - t.det, 0.1f));
    const float radius = ceilf(3.0f * sqrtf(clamp_min(lam, 0.0f)));
    float rcull2 = 2.0f * lam * logf(clamp_min(opac[g] * k.inv_alpha_min, 1e-12f));
    rcull2 = clamp_min(rcull2, 0.0f);
    const float tx = (float)tiles_x, ty = (float)tiles_y;
    int rmin_x, rmin_y, rmax_x, rmax_y;
    if (tight) {
      const float c2 = rcull2 / clamp_min(lam, 1e-12f);
      const float w_x = sqrtf(c2 * clamp_min(t.cxx, 0.0f));
      const float w_y = sqrtf(c2 * clamp_min(t.cyy, 0.0f));
      rmin_x = (int)clamp2(floorf((mean_x - w_x) * k.inv_tile), 0.0f, tx);
      rmin_y = (int)clamp2(floorf((mean_y - w_y) * k.inv_tile), 0.0f, ty);
      rmax_x = (int)clamp2(floorf((mean_x + w_x) * k.inv_tile) + 1.0f, 0.0f, tx);
      rmax_y = (int)clamp2(floorf((mean_y + w_y) * k.inv_tile) + 1.0f, 0.0f, ty);
    } else {
      rmin_x = (int)clamp2(floorf((mean_x - radius) * k.inv_tile), 0.0f, tx);
      rmin_y = (int)clamp2(floorf((mean_y - radius) * k.inv_tile), 0.0f, ty);
      rmax_x = (int)clamp2(floorf((mean_x + radius + k.tile - 1.0f) * k.inv_tile), 0.0f, tx);
      rmax_y = (int)clamp2(floorf((mean_y + radius + k.tile - 1.0f) * k.inv_tile), 0.0f, ty);
    }
    const int touched = (rmax_x - rmin_x) * (rmax_y - rmin_y);
    const bool valid = t.depth > k.near && t.det_ok && touched > 0 && (!active || active[g]);

    out[g] = mean_x;
    out[Pz + g] = mean_y;
    out[2 * Pz + g] = t.depth;
    out[3 * Pz + g] = t.cyy * t.inv_det;
    out[4 * Pz + g] = -t.cxy * t.inv_det;
    out[5 * Pz + g] = t.cxx * t.inv_det;
    out[6 * Pz + g] = t.czx;
    out[7 * Pz + g] = t.cyz;
    out[8 * Pz + g] = rcull2;
    iout[g] = valid ? (int)radius : 0;
    iout[Pz + g] = rmin_x;
    iout[2 * Pz + g] = rmin_y;
    iout[3 * Pz + g] = rmax_x;
    iout[4 * Pz + g] = rmax_y;
    bout[g] = valid;
    for (int c = 0; c < 3; ++c) {
      bool clamped = false;
      if (shs) {
        const float raw = k.c0 * shs[(size_t)g * 3 * sh_stride + c * sh_stride] + 0.5f;
        clamped = raw < 0.0f;
        out[9 * Pz + 3 * (size_t)g + c] = clamp_min(raw, 0.0f);
      }
      bout[Pz + 3 * (size_t)g + c] = clamped;
    }
  }
}

__device__ __forceinline__ float grad_at(const Grads& gr, int f, int g) {
  return gr.p[f] ? gr.p[f][(long long)g * gr.stride[f]] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
preprocess_bwd_kernel(const float* __restrict__ means, const float* __restrict__ scales,
                      const float* __restrict__ quats, const float* __restrict__ shs,
                      int sh_stride, const float* __restrict__ view,
                      const float* __restrict__ proj, Consts k, int P, Grads gr,
                      float* __restrict__ d_means, float* __restrict__ d_scales,
                      float* __restrict__ d_quats, float* __restrict__ d_shs,
                      float* __restrict__ d_offset) {
  __shared__ float cam[32];
  load_cam(cam, view, proj);
  const float* V = cam;
  const float* M = cam + 16;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < P; g += gridDim.x * kThreads) {
    const float g_mx = grad_at(gr, 0, g), g_my = grad_at(gr, 1, g);
    if (d_offset) {
      d_offset[2 * g] = g_mx;
      d_offset[2 * g + 1] = g_my;
    }
    if (d_shs) {
      for (int c = 0; c < 3; ++c) {
        const size_t at = (size_t)g * 3 * sh_stride + c * sh_stride;
        const float raw = k.c0 * shs[at] + 0.5f;
        d_shs[at] = raw >= 0.0f ? k.c0 * grad_at(gr, 8 + c, g) : 0.0f;
      }
    }
    if (!d_means && !d_scales && !d_quats) continue;
    Terms t;
    const float x = means[3 * g], y = means[3 * g + 1], z = means[3 * g + 2];
    const float* qin = quats + 4 * g;
    terms(cam, k, x, y, z, scales + 3 * g, qin, t);

    // ca = cyy / det, cb = -cxy / det, cc = cxx / det (det cut where it is 0)
    const float g_ca = grad_at(gr, 3, g), g_cb = grad_at(gr, 4, g), g_cc = grad_at(gr, 5, g);
    const float g_czx = grad_at(gr, 6, g), g_cyz = grad_at(gr, 7, g);
    float g_cxx = g_cc * t.inv_det, g_cyy = g_ca * t.inv_det, g_cxy = -g_cb * t.inv_det;
    if (t.det_ok) {
      const float g_inv = g_ca * t.cyy - g_cb * t.cxy + g_cc * t.cxx;
      const float g_det = -g_inv * t.inv_det * t.inv_det;
      g_cxx += g_det * t.cyy;
      g_cyy += g_det * t.cxx;
      g_cxy -= 2.0f * t.cxy * g_det;
    }
    // the 2D covariance and the two conic-to-depth rows from J and C
    const float j00 = t.j00, j02 = t.j02, j11 = t.j11, j12 = t.j12;
    const float g_j00 = g_cxx * 2.0f * (j00 * t.C00 + j02 * t.C02)
                        + g_cxy * (j11 * t.C01 + j12 * t.C02) + g_czx * t.C02;
    const float g_j02 = g_cxx * 2.0f * (j00 * t.C02 + j02 * t.C22)
                        + g_cxy * (j11 * t.C12 + j12 * t.C22) + g_czx * t.C22;
    const float g_j11 = g_cyy * 2.0f * (j11 * t.C11 + j12 * t.C12)
                        + g_cxy * (j00 * t.C01 + j02 * t.C12) + g_cyz * t.C12;
    const float g_j12 = g_cyy * 2.0f * (j11 * t.C12 + j12 * t.C22)
                        + g_cxy * (j00 * t.C02 + j02 * t.C22) + g_cyz * t.C22;
    const float gC00 = g_cxx * j00 * j00;
    const float gC01 = g_cxy * j00 * j11;
    const float gC02 = g_cxx * 2.0f * j00 * j02 + g_cxy * j00 * j12 + g_czx * j00;
    const float gC11 = g_cyy * j11 * j11;
    const float gC12 = g_cyy * 2.0f * j11 * j12 + g_cxy * j02 * j11 + g_cyz * j11;
    const float gC22 = g_cxx * j02 * j02 + g_cyy * j12 * j12 + g_cxy * j02 * j12
                       + g_czx * j02 + g_cyz * j12;

    // J from tvx, tvy, depth through the clamp and safe_z
    const float iz2 = t.inv_z * t.inv_z;
    const float g_inv_z = k.fx * g_j00 + k.fy * g_j11
                          - 2.0f * k.fx * t.txc * t.inv_z * g_j02
                          - 2.0f * k.fy * t.tyc * t.inv_z * g_j12;
    const float g_txc = -k.fx * iz2 * g_j02, g_tyc = -k.fy * iz2 * g_j12;
    const float g_rx = (t.rx >= -k.lim_x && t.rx <= k.lim_x) ? g_txc * t.depth : 0.0f;
    const float g_ry = (t.ry >= -k.lim_y && t.ry <= k.lim_y) ? g_tyc * t.depth : 0.0f;
    const float g_tvx = g_rx / t.safe_z, g_tvy = g_ry / t.safe_z;
    float g_depth = grad_at(gr, 2, g) + g_txc * clamp2(t.rx, -k.lim_x, k.lim_x)
                    + g_tyc * clamp2(t.ry, -k.lim_y, k.lim_y);
    if (!(fabsf(t.depth) < 1e-6f))
      g_depth += -(g_rx * t.tvx + g_ry * t.tvy) / (t.safe_z * t.safe_z) - g_inv_z * iz2;

    if (d_means) {
      // the pixel centre: ((h / w + 1) size - 1) / 2
      const float g_u = g_mx * 0.5f * k.width, g_v = g_my * 0.5f * k.height;
      const float g_hx = g_u * t.inv_w, g_hy = g_v * t.inv_w;
      const float g_hw = -(g_u * t.hx + g_v * t.hy) * t.inv_w * t.inv_w;
      for (int i = 0; i < 3; ++i)
        d_means[3 * g + i] = V[i] * g_tvx + V[4 + i] * g_tvy + V[8 + i] * g_depth
                             + M[i] * g_hx + M[4 + i] * g_hy + M[12 + i] * g_hw;
    }
    if (!d_scales && !d_quats) continue;

    // C = Rv S Rv^T: the symmetric gradient G of S is Rv^T Gc Rv, Gc with its
    // off-diagonal entries halved (C01, C02, C12 stand for both of their pairs)
    const float Gc[3][3] = {{gC00, 0.5f * gC01, 0.5f * gC02},
                            {0.5f * gC01, gC11, 0.5f * gC12},
                            {0.5f * gC02, 0.5f * gC12, gC22}};
    float T[3][3], G[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        T[i][j] = Gc[i][0] * V[j] + Gc[i][1] * V[4 + j] + Gc[i][2] * V[8 + j];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        G[i][j] = V[i] * T[0][j] + V[4 + i] * T[1][j] + V[8 + i] * T[2][j];
    // S = R diag(v) R^T: dR = 2 G R diag(v), dv_k = (R^T G R)_kk
    const float* r = t.r;
    float gr_[9], gv[3];
    for (int kk = 0; kk < 3; ++kk) {
      float acc = 0.0f;
      for (int i = 0; i < 3; ++i) {
        const float GR = G[i][0] * r[kk] + G[i][1] * r[3 + kk] + G[i][2] * r[6 + kk];
        gr_[3 * i + kk] = 2.0f * t.v[kk] * GR;
        acc += r[3 * i + kk] * GR;
      }
      gv[kk] = acc;
    }
    if (d_scales)
      for (int i = 0; i < 3; ++i)
        d_scales[3 * g + i] = gv[i] * 2.0f * t.sm[i] * k.scale_mod;
    if (!d_quats) continue;
    // R from the normalised quaternion (x, y, z, w)
    const float qx = t.q[0], qy = t.q[1], qz = t.q[2], qw = t.q[3];
    const float* d = gr_;
    float gq[4];
    gq[0] = 2.0f * qy * (d[1] + d[3]) + 2.0f * qz * (d[2] + d[6])
            + 2.0f * qw * (d[7] - d[5]) - 4.0f * qx * (d[4] + d[8]);
    gq[1] = 2.0f * qx * (d[1] + d[3]) + 2.0f * qw * (d[2] - d[6])
            + 2.0f * qz * (d[5] + d[7]) - 4.0f * qy * (d[0] + d[8]);
    gq[2] = 2.0f * qw * (d[3] - d[1]) + 2.0f * qx * (d[2] + d[6])
            + 2.0f * qy * (d[5] + d[7]) - 4.0f * qz * (d[0] + d[4]);
    gq[3] = 2.0f * qz * (d[3] - d[1]) + 2.0f * qy * (d[2] - d[6])
            + 2.0f * qx * (d[7] - d[5]);
    // q = qin / max(|qin|, 1e-12): the norm passes where |qin| >= 1e-12
    float g_nc = 0.0f;
    for (int i = 0; i < 4; ++i) g_nc -= gq[i] * qin[i];
    g_nc = g_nc / (t.nc * t.nc);
    const float g_n = (t.n >= 1e-12f && t.n != 0.0f) ? g_nc / t.n : 0.0f;
    for (int i = 0; i < 4; ++i) d_quats[4 * g + i] = gq[i] / t.nc + g_n * qin[i];
  }
}

}  // namespace

// consts: 13 host floats in `Consts`' order. out: float32 [18 * P], written
// in full for every slot but rows 9-11 (the colour) without `shs`.
extern "C" int sags_preprocess(const void* means, const void* scales, const void* quats,
                               const void* opac, const void* shs, const void* active,
                               const void* offset, const void* view, const void* proj,
                               const float* consts, int P, int sh_stride, int tiles_x,
                               int tiles_y, int tight, void* out, void* stream) {
  if (P < 0 || sh_stride < 1) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  Consts k;
  memcpy(&k, consts, sizeof(Consts));
  const int grid = sagsg::grid_for<preprocess_kernel>(kThreads, P);
  preprocess_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)means, (const float*)scales, (const float*)quats, (const float*)opac,
      (const float*)shs, sh_stride, (const uint8_t*)active, (const float*)offset,
      (const float*)view, (const float*)proj, k, P, tiles_x, tiles_y, tight, (float*)out);
  return (int)cudaGetLastError();
}

// grads: 11 host pointers (mx my depth ca cb cc czx cyz, the colour's r g b;
// null reads zero) and strides: each's element stride between slots.
extern "C" int sags_preprocess_bwd(const void* means, const void* scales, const void* quats,
                                   const void* shs, const void* view, const void* proj,
                                   const float* consts, const void* const* grads,
                                   const long long* strides, int P, int sh_stride,
                                   void* d_means, void* d_scales, void* d_quats,
                                   void* d_shs, void* d_offset, void* stream) {
  if (P < 0 || sh_stride < 1 || (d_shs && !shs)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  Consts k;
  memcpy(&k, consts, sizeof(Consts));
  Grads gr;
  for (int f = 0; f < kGrads; ++f) {
    gr.p[f] = (const float*)grads[f];
    gr.stride[f] = strides[f];
  }
  const int grid = sagsg::grid_for<preprocess_bwd_kernel>(kThreads, P);
  preprocess_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)means, (const float*)scales, (const float*)quats, (const float*)shs,
      sh_stride, (const float*)view, (const float*)proj, k, P, gr, (float*)d_means,
      (float*)d_scales, (float*)d_quats, (float*)d_shs, (float*)d_offset);
  return (int)cudaGetLastError();
}

extern "C" const char* sags_preprocess_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* sags_preprocess_bwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
