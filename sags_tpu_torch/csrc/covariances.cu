// covariances: GICP's per-point surfel covariances in one launch: each
// point's k nearest points, their gated mean and covariance, its closed-form
// eigendecomposition, the quaternion of its eigenvectors and the
// regularised covariance.
//
// Replaces no TPU kernel: the JAX package leaves `estimate_covariances` to
// XLA (`sags_tpu/ops/gicp.py:83`), which fuses its columns into a few
// passes. In the port it was one PyTorch op a scalar expression
// (`ops/gicp.py:estimate_covariances_plain`, which stays the plain version):
// at 4,096 points ~290 launches (the chunked kNN's matmuls and top-k, the
// gathers, `sym_eig3`'s columns, `rotmat_to_quat`), each a few microseconds
// on the card and tens of microseconds of the host's time. The fused
// front-end calls it twice a frame.
//
// What it computes, as the plain version does (`fast_gicp_impl.hpp:380-479`,
// the gates and divisor of the JAX package):
//   - the neighbourhood: each point's k nearest points, itself included, by
//     the float32 formula of `ops/knn.py`, |q|^2 + |p|^2 - 2 q.p (the squared
//     norms summed as PyTorch's CUDA reduction sums a last axis of 3,
//     (x^2 + z^2) + y^2; the dot product as cuBLAS's chain of fused
//     multiply-adds), masked points moved to 1e10, the k smallest by the
//     unclamped value, ties to the lower index; each distance clamped at 0;
//   - reliable: d^2 < knn_max_distance and both masks; where fewer than 3
//     are, every neighbour in both masks; the mean over the reliable
//     neighbours (summed in PyTorch's order for a middle axis: four
//     accumulators, entry r into r % 4, then ((a0 + a1) + a2) + a3), the
//     covariance sum_r d_r d_r^T over them (a fused multiply-add chain, as
//     `bmm`) times float32(1/k): divided by k, not by the reliable count;
//   - `sym_eig3`'s trigonometric eigenvalues with its isotropic branch, its
//     eigenvectors from the rows' cross products with their fallbacks, then
//     `rotmat_to_quat`'s Shepperd selection and normalisation; scales the
//     square roots of the eigenvalues clamped at 0, divided by
//     max(2 z^1.5, 1) where `z_values` are given;
//   - the regularisation: none, frobenius (norm(inv(A)) A with A = C +
//     1e-3 I, what inverting the normalised inverse gives: the plain version
//     inverts twice in float32, here the norm is taken in float64), plane,
//     min_eig, normalized_min_eig, normalized_ellipse (1e-9 on every axis
//     where the middle eigenvalue is 0), then U diag(vals) U^T;
//   - masked points: the identity covariance; their quaternion (0, 0, 0, 1)
//     and zero scales come out of the same path (no reliable neighbour).
// Each expression is written in the plain version's order and the library is
// built with -fmad=false, so each operation rounds as PyTorch's elementwise
// ops round it; a division by a Python number is a product with its float32
// reciprocal, as PyTorch does it on the card.
//
// Bound: the neighbourhood pass, N^2 distances of 9 float32 operations (at
// the stream's 4,096 points 0.15 GFLOP, 2.3 us at the card's float32 rate;
// the inputs and outputs ~0.4 MB). The rest is ~1,000 operations a point.
//
// Design: one launch, a warp a point, a block of 512 threads owns 16 points
// (256 blocks at 4,096 points: enough to fill 132 SMs, two blocks to an SM).
// The points stream through shared memory in stages of 4,096 (64 KB; masked
// ones replaced and |p|^2 computed once a stage; a cloud of one stage is
// staged once for both passes). A sorted top-k in each of 8 threads a point
// (`gicp_align.cu`'s shape) took 118 registers for k up to 32 and ran at
// about twice this design's time on an H100 at the stream's shape, so the
// selection takes two passes of 9 operations a distance instead: pass 1
// keeps each lane's one or two smallest distances and takes the k-th
// smallest of the warp's 32 or 64 by k rounds of a warp minimum, a bound on
// the point's k-th distance (they are distances of distinct points); pass 2
// collects the points within the bound (~k of them) into shared memory by a
// ballot and ranks them there by (distance, index). More than 64 within the
// bound (exact ties of many points, as duplicates give) take k rounds of a
// warp minimum over every point instead. Then lane r gathers neighbour r, the
// gates are two ballots, and the sums visit the neighbours in order through
// shuffles; lane 0 forms the eigenpairs, the quaternion and the regularised
// covariance in registers and writes the three outputs. Nothing is allocated
// and the host reads nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;  // points a block owns, a warp each
constexpr int kStage = 4096;  // points staged in shared memory at once (64 KB)
constexpr int kCap = 64;      // candidates a point ranks in shared memory
constexpr int kMaxK = 32;     // the largest k the kernel takes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 2147483647;  // the index of an empty slot

// `GICPConfig.regularization`, in the wrapper's order
enum Reg { kRegNone = 0, kFrobenius, kPlane, kMinEig, kNormalizedMinEig, kNormalizedEllipse };

struct Args {
  const float* points;   // [N, 3]
  const uint8_t* mask;   // [N]
  const float* z;        // [N] or null
  int n, k, reg;
  float gate;   // knn_max_distance, compared with the squared distance
  float inv_k;  // float32(1 / k)
  float* covs;    // [N, 3, 3]
  float* quats;   // [N, 4] xyzw
  float* scales;  // [N, 3]
};

// torch.clamp passes NaN through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// torch.sum over a last axis of 3 on the card: two lanes, (x0 + x2) + x1
__device__ __forceinline__ float sum3(float a, float b, float c) { return (a + c) + b; }

// torch.linalg.cross on the card: each component a fused multiply-add,
// a_j b_l - a_l b_j as fma(a_j, b_l, -(a_l b_j))
__device__ __forceinline__ void cross(const float* a, const float* b, float* c) {
  c[0] = fmaf(a[1], b[2], -(a[2] * b[1]));
  c[1] = fmaf(a[2], b[0], -(a[0] * b[2]));
  c[2] = fmaf(a[0], b[1], -(a[1] * b[0]));
}

__device__ __forceinline__ float sqnorm3(const float* v) {
  return sum3(v[0] * v[0], v[1] * v[1], v[2] * v[2]);
}

// `sym_eig3`'s `evec`: the cross product of two rows of A - lam I with the
// largest norm, normalised, or `fallback` (axis `fb`) where it vanishes
__device__ void evec(const float A[3][3], float lam, int fb, float* v) {
  float r[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r[i][j] = i == j ? A[i][j] - lam : A[i][j];
  float c01[3], c02[3], c12[3];
  cross(r[0], r[1], c01);
  cross(r[0], r[2], c02);
  cross(r[1], r[2], c12);
  const float n01 = sqnorm3(c01), n02 = sqnorm3(c02), n12 = sqnorm3(c12);
  const bool b01 = n01 >= n02 && n01 >= n12, b02 = n02 >= n12;
  float best[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) best[i] = b01 ? c01[i] : (b02 ? c02[i] : c12[i]);
  const float nrm = sqrtf(sqnorm3(best));
  const bool ok = nrm > 1e-20f;
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = ok ? best[i] / nrm : (i == fb ? 1.0f : 0.0f);
}

// `sym_eig3`: eigenvalues descending, eigenvectors as U's columns (det +1)
__device__ void sym_eig3(const float A[3][3], float* ev, float U[3][3]) {
  const float a00 = A[0][0], a01 = A[0][1], a02 = A[0][2];
  const float a11 = A[1][1], a12 = A[1][2], a22 = A[2][2];
  const float third = (float)(1.0 / 3.0), sixth = (float)(1.0 / 6.0);
  const float q = (a00 + a11 + a22) * third;
  const float p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  const float p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0f * p1;
  const float p = sqrtf(clamp_min(p2, 0.0f) * sixth);
  const float scale = clamp_min(fabsf(q), 1.0f);
  const bool iso = p <= 1e-7f * scale;
  const float ps = iso ? 1.0f : p;
  const float detB = (b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02) +
                      a02 * (a01 * a12 - b11 * a02)) /
                     (ps * ps * ps);
  const float r = clamp2(detB * 0.5f, -1.0f, 1.0f);
  const float phi = acosf(r) * third;
  const float e1 = q + 2.0f * p * cosf(phi);
  const float e3 = q + 2.0f * p * cosf(phi + (float)(2.0 * M_PI / 3.0));
  const float e2 = 3.0f * q - e1 - e3;

  float v3[3], v1[3];
  evec(A, e3, 2, v3);
  evec(A, e1, 0, v1);
  const float dot = sum3(v1[0] * v3[0], v1[1] * v3[1], v1[2] * v3[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) v1[i] = v1[i] - dot * v3[i];
  const float n1 = sqrtf(sqnorm3(v1));
  const float ex[3] = {1.0f, 0.0f, 0.0f}, ey[3] = {0.0f, 1.0f, 0.0f};
  float alt[3], alt2[3];
  cross(v3, ex, alt);
  cross(v3, ey, alt2);
  const float alt_n = sqrtf(sqnorm3(alt)), alt2_n = sqrtf(sqnorm3(alt2));
  const float alt_c = clamp_min(alt_n, 1e-30f), alt2_c = clamp_min(alt2_n, 1e-30f);
  const float n1_c = clamp_min(n1, 1e-30f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float a = alt_n > 0.1f ? alt[i] / alt_c : alt2[i] / alt2_c;
    v1[i] = n1 > 1e-10f ? v1[i] / n1_c : a;
  }
  float v2[3];
  cross(v3, v1, v2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    U[i][0] = iso ? (i == 0 ? 1.0f : 0.0f) : v1[i];
    U[i][1] = iso ? (i == 1 ? 1.0f : 0.0f) : v2[i];
    U[i][2] = iso ? (i == 2 ? 1.0f : 0.0f) : v3[i];
  }
  ev[0] = iso ? q : e1;
  ev[1] = iso ? q : e2;
  ev[2] = iso ? q : e3;
}

// `rotmat_to_quat` (xyzw): Shepperd's four candidates, selected as
// `torch.where` selects them, then normalised
__device__ void rotmat_to_quat(const float m[3][3], float* out) {
  const float tr = m[0][0] + m[1][1] + m[2][2];
  const float s0 = sqrtf(clamp_min(tr + 1.0f, 1e-12f)) * 2.0f;
  const float s1 = sqrtf(clamp_min(1.0f + m[0][0] - m[1][1] - m[2][2], 1e-12f)) * 2.0f;
  const float s2 = sqrtf(clamp_min(1.0f + m[1][1] - m[0][0] - m[2][2], 1e-12f)) * 2.0f;
  const float s3 = sqrtf(clamp_min(1.0f + m[2][2] - m[0][0] - m[1][1], 1e-12f)) * 2.0f;
  float q[4];
  if (tr > 0.0f) {
    q[0] = (m[2][1] - m[1][2]) / s0;
    q[1] = (m[0][2] - m[2][0]) / s0;
    q[2] = (m[1][0] - m[0][1]) / s0;
    q[3] = 0.25f * s0;
  } else if (m[0][0] > m[1][1] && m[0][0] > m[2][2]) {
    q[0] = 0.25f * s1;
    q[1] = (m[0][1] + m[1][0]) / s1;
    q[2] = (m[0][2] + m[2][0]) / s1;
    q[3] = (m[2][1] - m[1][2]) / s1;
  } else if (m[1][1] > m[2][2]) {
    q[0] = (m[0][1] + m[1][0]) / s2;
    q[1] = 0.25f * s2;
    q[2] = (m[1][2] + m[2][1]) / s2;
    q[3] = (m[0][2] - m[2][0]) / s2;
  } else {
    q[0] = (m[0][2] + m[2][0]) / s3;
    q[1] = (m[1][2] + m[2][1]) / s3;
    q[2] = 0.25f * s3;
    q[3] = (m[1][0] - m[0][1]) / s3;
  }
  // vector_norm's reduction over 4: (x^2 + z^2) + (y^2 + w^2)
  const float n = clamp_min(sqrtf((q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3])),
                            1e-12f);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = q[i] / n;
}

// norm(inv(A)) A in float64: the plain version's inv(inv(A) / norm)
__device__ void frobenius(const float A[3][3], float out[3][3]) {
  double a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) a[i][j] = (double)A[i][j];
  const double c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  const double c01 = a[0][2] * a[2][1] - a[0][1] * a[2][2];
  const double c02 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
  const double c10 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
  const double c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0];
  const double c12 = a[0][2] * a[1][0] - a[0][0] * a[1][2];
  const double c20 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  const double c21 = a[0][1] * a[2][0] - a[0][0] * a[2][1];
  const double c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0];
  const double det = a[0][0] * c00 + a[0][1] * c10 + a[0][2] * c20;
  const double ss = c00 * c00 + c01 * c01 + c02 * c02 + c10 * c10 + c11 * c11 + c12 * c12 +
                    c20 * c20 + c21 * c21 + c22 * c22;
  const double norm = sqrt(ss) / fabs(det);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i][j] = (float)(norm * a[i][j]);
}

// |q|^2 + |p|^2 - 2 q.p as `ops/knn.py` computes it on the card; the
// doubling is exact, so the subtraction is one fused multiply-add
__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float qq, float4 p) {
  return fmaf(-2.0f, fmaf(qz, p.z, fmaf(qy, p.y, qx * p.x)), qq + p.w);
}

// Point j as the neighbourhood pass sees it: masked at 1e10, |p|^2 in w.
__device__ __forceinline__ float4 far_point(const Args& a, int j) {
  float x = 1e10f, y = 1e10f, z = 1e10f;
  if (a.mask[j]) {
    x = a.points[3 * j];
    y = a.points[3 * j + 1];
    z = a.points[3 * j + 2];
  }
  return make_float4(x, y, z, sum3(x * x, y * y, z * z));
}

// Stages points [t0, t0 + cnt) in shared memory.
__device__ __forceinline__ void stage(const Args& a, int t0, int cnt, float4* tile) {
  __syncthreads();  // the previous stage is consumed
  for (int s = threadIdx.x; s < cnt; s += kThreads) tile[s] = far_point(a, t0 + s);
  __syncthreads();
}

// (d, j) before (e, l): the smaller distance, then the lower index
__device__ __forceinline__ bool before(float d, int j, float e, int l) {
  return d < e || (d == e && j < l);
}

// The warp's smallest (d, j), on every lane.
__device__ __forceinline__ void warp_min(float& d, int& j) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(kFull, d, o);
    const int oj = __shfl_xor_sync(kFull, j, o);
    if (before(od, oj, d, j)) {
      d = od;
      j = oj;
    }
  }
}

// The point's surfel from its k neighbours (nd, ni: ascending), on every
// lane of its warp: lane r < k gathers neighbour r, the gates are two
// ballots, the sums visit the neighbours in order through shuffles; then
// lane 0 takes the eigenpairs, quaternion, scales and regularised
// covariance and writes row i of the outputs.
__device__ void surfel(const Args& a, int i, int lane, const float* nd, const int* ni) {
  const int k = a.k;
  // the gates: reliable within the distance and both masks; every
  // neighbour in both masks where fewer than 3 are reliable
  const bool mi_ok = a.mask[i] != 0;
  float p[3] = {0.0f, 0.0f, 0.0f};
  bool v = false, near = false;
  if (lane < k) {
    const int j = ni[lane];
    v = mi_ok && j < a.n && a.mask[j];
    near = clamp_min(nd[lane], 0.0f) < a.gate;
    if (v) {
#pragma unroll
      for (int c = 0; c < 3; ++c) p[c] = a.points[3 * (size_t)j + c];
    }
  }
  const uint32_t valid = __ballot_sync(kFull, v);
  uint32_t rel = __ballot_sync(kFull, v && near);
  if (__popc(rel) < 3) rel = valid;
  const float n_rel = (float)max(__popc(rel), 1);
  float acc[3][4];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[c][u] = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {  // unrolled: acc's index is known
    if (r < k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float x = __shfl_sync(kFull, p[c], r);
        if (rel >> r & 1u) acc[c][r & 3] = acc[c][r & 3] + x;
      }
    }
  }
  float d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mean = (((acc[c][0] + acc[c][1]) + acc[c][2]) + acc[c][3]) / n_rel;
    d[c] = rel >> lane & 1u ? p[c] - mean : 0.0f;
  }
  float C[3][3];
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int w = 0; w < 3; ++w) C[u][w] = 0.0f;
  for (int r = 0; r < k; ++r) {
    float dr[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) dr[c] = __shfl_sync(kFull, d[c], r);
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int w = 0; w < 3; ++w) C[u][w] = fmaf(dr[u], dr[w], C[u][w]);
  }
  if (lane != 0) return;
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int w = 0; w < 3; ++w) C[u][w] = C[u][w] * a.inv_k;

  float ev[3], U[3][3], q[4];
  sym_eig3(C, ev, U);
  rotmat_to_quat(U, q);
  float sv[3], sc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sv[c] = clamp_min(ev[c], 0.0f);
    sc[c] = sqrtf(sv[c]);
  }
  if (a.z) {
    const float zc = clamp_min(powf(a.z[i], 1.5f) * 2.0f, 1.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) sc[c] = sc[c] / zc;
  }

  float out[3][3];
  if (a.reg == kRegNone) {
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v) out[u][v] = C[u][v];
  } else if (a.reg == kFrobenius) {
    float A[3][3];
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v) A[u][v] = u == v ? C[u][v] + 1e-3f : C[u][v] + 0.0f;
    frobenius(A, out);
  } else {
    float vals[3];
    if (a.reg == kPlane) {
      vals[0] = vals[1] = 1.0f;
      vals[2] = 1e-3f;
    } else if (a.reg == kMinEig) {
#pragma unroll
      for (int c = 0; c < 3; ++c) vals[c] = clamp_min(sv[c], 1e-3f);
    } else if (a.reg == kNormalizedMinEig) {
      const float top = clamp_min(sv[0], 1e-30f);
#pragma unroll
      for (int c = 0; c < 3; ++c) vals[c] = clamp_min(sv[c] / top, 1e-3f);
    } else {  // normalized_ellipse
      const float mid = sv[1];
#pragma unroll
      for (int c = 0; c < 3; ++c) vals[c] = mid == 0.0f ? 1e-9f : clamp_min(sv[c] / mid, 1e-3f);
    }
    // einsum("nij,nj,nkj->nik") on the card (opt_einsum's path): vals into
    // the second U, then the product of the first with it, a fused
    // multiply-add chain over j
    float t[3][3];
#pragma unroll
    for (int v = 0; v < 3; ++v)
#pragma unroll
      for (int j = 0; j < 3; ++j) t[v][j] = U[v][j] * vals[j];
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v)
        out[u][v] = fmaf(U[u][2], t[v][2], fmaf(U[u][1], t[v][1], U[u][0] * t[v][0]));
  }
  float* co = a.covs + 9 * (size_t)i;
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int v = 0; v < 3; ++v) co[3 * u + v] = mi_ok ? out[u][v] : (u == v ? 1.0f : 0.0f);
#pragma unroll
  for (int c = 0; c < 4; ++c) a.quats[4 * (size_t)i + c] = q[c];
#pragma unroll
  for (int c = 0; c < 3; ++c) a.scales[3 * (size_t)i + c] = sc[c];
}

// One warp a point. Pass 1 bounds its k-th smallest distance: each lane's
// M smallest (M = 1 for k <= 16, 2 for k <= 32), then the k-th smallest of
// the warp's 32 M, an upper bound since they are distances of k distinct
// points. Pass 2 collects the points within the bound (~k of them) into
// shared memory, ranked there by (distance, index); past kCap of them
// (exact ties of many points) k rounds of a warp minimum over every point
// take their place.
template <int M>
__global__ void __launch_bounds__(kThreads, 2) covariances_kernel(const Args a) {
  extern __shared__ float4 tile[];
  __shared__ float cd[kWarps][kCap], sd[kWarps][kMaxK];
  __shared__ int ci[kWarps][kCap], si[kWarps][kMaxK];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + w;
  const bool has = i < a.n;
  const int k = a.k, staged = min(a.n, kStage);
  float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (has) q = far_point(a, i);

  float m[M];
#pragma unroll
  for (int u = 0; u < M; ++u) m[u] = INFINITY;
  for (int t0 = 0; t0 < a.n; t0 += kStage) {
    const int cnt = min(kStage, a.n - t0);
    stage(a, t0, cnt, tile);
    if (!has) continue;
    for (int s = lane; s < cnt; s += 32) {
      const float d = sq_dist(q.x, q.y, q.z, q.w, tile[s]);
      if (M == 1) {
        m[0] = fminf(m[0], d);  // a NaN distance is passed over
      } else {
        const float dn = fminf(d, INFINITY);
#pragma unroll
        for (int u = M - 1; u > 0; --u) m[u] = fminf(m[u], fmaxf(m[u - 1], dn));
        m[0] = fminf(m[0], dn);
      }
    }
  }
  float bound = INFINITY;
  for (int r = 0; r < k; ++r) {  // pop the warp's smallest head, lowest lane first
    float mn = m[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
    const unsigned at = __ballot_sync(kFull, m[0] == mn);
    if (at && lane == __ffs(at) - 1) {
#pragma unroll
      for (int u = 0; u + 1 < M; ++u) m[u] = m[u + 1];
      m[M - 1] = INFINITY;
    }
    bound = mn;
  }

  int n_cand = 0;  // the same on every lane
  const unsigned below = (1u << lane) - 1u;
  for (int t0 = 0; t0 < a.n; t0 += kStage) {
    const int cnt = min(kStage, a.n - t0);
    if (a.n > staged) stage(a, t0, cnt, tile);  // a single stage stays
    if (!has) continue;
    for (int s0 = 0; s0 < cnt; s0 += 32) {
      const int s = s0 + lane;
      const float d = s < cnt ? sq_dist(q.x, q.y, q.z, q.w, tile[s]) : INFINITY;
      const bool hit = s < cnt && d <= bound;
      const unsigned hits = __ballot_sync(kFull, hit);
      if (hits) {
        const int pos = n_cand + __popc(hits & below);
        if (hit && pos < kCap) {
          cd[w][pos] = d;
          ci[w][pos] = t0 + s;
        }
        n_cand += __popc(hits);
      }
    }
  }
  if (!has) return;
  __syncwarp();
  for (int r = lane; r < k; r += 32) {
    sd[w][r] = INFINITY;
    si[w][r] = kNone;
  }
  __syncwarp();
  if (n_cand <= kCap) {
    for (int e = lane; e < n_cand; e += 32) {  // each candidate's rank
      const float d = cd[w][e];
      const int j = ci[w][e];
      int rank = 0;
      for (int f = 0; f < n_cand; ++f) rank += before(cd[w][f], ci[w][f], d, j);
      if (rank < k) {
        sd[w][rank] = d;
        si[w][rank] = j;
      }
    }
  } else {
    float pd = -INFINITY;
    int pj = -1;
    for (int r = 0; r < k; ++r) {
      float bd = INFINITY;
      int bj = kNone;
      for (int j = lane; j < a.n; j += 32) {
        const float d = sq_dist(q.x, q.y, q.z, q.w, far_point(a, j));
        if (before(pd, pj, d, j) && before(d, j, bd, bj)) {
          bd = d;
          bj = j;
        }
      }
      warp_min(bd, bj);
      if (lane == 0) {
        sd[w][r] = bd;
        si[w][r] = bj;
      }
      pd = bd;
      pj = bj;
    }
  }
  __syncwarp();
  surfel(a, i, lane, sd[w], si[w]);
}

template <int M>
int launch(const Args& a, int grid, size_t smem, cudaStream_t stream) {
  // the staged points take more than the default 48 KB
  const cudaError_t err = cudaFuncSetAttribute(
      covariances_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  covariances_kernel<M><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest k `sags_covariances` takes.
extern "C" int sags_covariances_max_k() { return kMaxK; }

// Outputs: covs float32 [n, 3, 3], quats float32 [n, 4] (xyzw), scales
// float32 [n, 3]. z: float32 [n] or null. reg: `Reg`. 1 <= k <= min(n, 32).
extern "C" int sags_covariances(const void* points, const void* mask, const void* z, int n,
                                int k, int reg, float gate, float inv_k, void* covs,
                                void* quats, void* scales, void* stream) {
  if (n < 0 || k < 1 || k > kMaxK || (n > 0 && k > n) || reg < kRegNone ||
      reg > kNormalizedEllipse)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Args a;
  a.points = (const float*)points;
  a.mask = (const uint8_t*)mask;
  a.z = (const float*)z;
  a.n = n;
  a.k = k;
  a.reg = reg;
  a.gate = gate;
  a.inv_k = inv_k;
  a.covs = (float*)covs;
  a.quats = (float*)quats;
  a.scales = (float*)scales;
  const int grid = (n + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float4) * (size_t)min(n, kStage);
  if (k <= 16) return launch<1>(a, grid, smem, (cudaStream_t)stream);
  return launch<2>(a, grid, smem, (cudaStream_t)stream);
}

extern "C" const char* sags_covariances_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
