// gicp_align: GICP's whole Levenberg-Marquardt (or Gauss-Newton) align in
// one cooperative launch: every linearization and every LM trial on the
// card, with no read by the host.
//
// Replaces no TPU kernel: the JAX package leaves the loop to XLA
// (`sags_tpu/ops/gicp.py:648-760`, three `lax.while_loop`s). In the port the
// loop was Python (`ops/gicp.py:lsq_align` over `make_gicp_linearizer`, which
// stays the plain version): each trial and each outer iteration read their
// flags on the host, and each linearization relaunched the kNN chunks, the
// top-k, the gather, `robust_inv3` and the einsums.
//
// What it computes, as `lsq_align` does (`lsq_registration_impl.hpp:53-173`):
//   - a linearization at T: each source point s moved to p = R s + t, its
//     nearest target by the float32 formula of `ops/knn.py`,
//     |p|^2 + |q|^2 - 2 p.q, masked targets at 1e10, ties to the lower
//     index; it counts (w = 1) where the source mask, the gate d^2 < gate2
//     and the target's mask hold; its weight M = (C_B + R C_A R^T)^-1, the
//     adjugate over the determinant where |det| > 1e-20 and elsewhere the
//     symmetric pseudo-inverse (eigenvalues of magnitude 1e-12 or less
//     left out; the eigenpairs by cyclic Jacobi rotations where
//     `robust_inv3` takes them from `eigh`: an exactly singular matrix's
//     zero eigenvalue reads 0 here, up to ~1e-7 in float32 `eigh`);
//     H = sum w J^T M J,
//     b = sum w J^T M r, e = sum w r^T M r with r = mean_B - p and
//     J = [skew(p) | -I];
//   - Gauss-Newton: T <- exp(d) T with H d = -b, until the step is below the
//     epsilons or `max_iterations`;
//   - Levenberg-Marquardt: lambda starts at `lm_init_lambda_factor` times
//     H's largest absolute diagonal entry; each trial solves
//     (H + lambda I) d = -b, evaluates e at exp(d) T with the linearization's
//     correspondences and weights, rho = (e0 - e) / d.(lambda d - b); it
//     accepts at rho >= 0 (lambda *= max(1/3, 1 - (2 rho - 1)^3)), else
//     lambda *= nu, nu *= 2, and stops early when the rejected step is
//     already below the epsilons; an outer iteration with no accepted or
//     early trial fails; it converges when its last step is below the
//     epsilons. A singular system gives a non-finite step (the 6x6 LU with
//     partial pivoting divides by its zero pivot, as `solve_ex` does), which
//     no trial accepts: a pair with no correspondence keeps its initial
//     guess.
// Outputs: T [16], H [36] (the last linearization's) and e (its error) in
// `out`, the outer iterations and the trials in `out_i`, and the converged
// flag.
//
// Bound: the latency of its grid-wide barriers, one a linearization and one
// a trial. The rest is small: the nearest-neighbour pass at the stream's
// shape (4096 x 4096) is 16.8M distance evaluations, ~0.15 GFLOP, a few
// microseconds at the card's float32 rate; every input is read once a pass
// (~0.4 MB). As separate ops with a host read a trial, the stream's aligns
// left an H100 idle ~48 ms a frame. At the stream's shape (6 linearizations
// and 6 trials) this kernel takes 0.178 ms on an H100 80GB HBM3 at 700 W,
// against 47 ms for `lsq_align` on the same card: its barriers take 1.1 us
// each, and the rest is the nearest-neighbour passes (~25 us each, ten
// times their operation bound) and thread 0's LM step.
//
// Design: one launch of a grid that is co-resident by construction
// (`cudaLaunchCooperativeKernel`, blocks an SM from the occupancy query),
// no larger than the source points need. A block owns 32 source points at a
// time, 8 threads to a point: the targets stream through shared memory in
// tiles of 1024 (masked ones replaced and |q|^2 computed once a tile), each
// thread scans every 8th target of the tile, and the 8 meet by a warp
// shuffle (smaller distance, then lower index). The point's first thread
// forms the weight and its 28 contributions (H's upper triangle row by row,
// b, e) and keeps (w, mean_B, M) in a scratch row that only it reads again,
// in the trials. A block sums its points' contributions in float64 in a
// fixed order (a shuffle tree, then the warps in order) into its row of a
// partials buffer, and a grid barrier follows. Every block then sums all
// rows in the same fixed order, so every block holds the same H, b and e,
// bit for bit, and runs the same scalar LM logic (one thread; the state in
// shared memory) with no broadcast. A trial is one more pass over each
// block's own points (e only) and one more barrier. The partials are double
// buffered: a block writes one buffer while others may still read the
// other, and it can reach the buffer it read only after every block has
// passed the barrier that follows their reads. Every sum has a fixed order,
// so an align is bitwise repeatable on a given card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;  // threads that split one source point's targets
constexpr int kGroups = kThreads / kLanes;  // source points a block holds at once
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;  // targets staged in shared memory at once
constexpr int kSums = 28;    // H's upper triangle (21, row by row), b (6), e
constexpr int kCorr = 13;    // w, mean_B (3), M row-major (9)
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* src;         // [N, 3]
  const uint8_t* src_mask;  // [N]
  const float* src_cov;     // [N, 3, 3]
  const float* tgt;         // [M, 3]
  const uint8_t* tgt_mask;  // [M]
  const float* tgt_cov;     // [M, 3, 3]
  const float* init_T;      // [4, 4]
  int n_src, n_tgt;
  float gate2;  // the correspondence distance threshold, squared
  int max_iterations, lm_max_iterations, gauss_newton;
  float lm_init_lambda_factor, rot_eps, trans_eps;
  float* corr;       // [N, kCorr] scratch
  double* partials;  // [2, gridDim.x, kSums] scratch
  float* out;        // T [16], H [36], e
  int32_t* out_i;    // outer iterations, trials
  uint8_t* converged;
};

// The optimizer's state, one copy a block in shared memory, written by the
// block's thread 0 alone, between barriers.
struct State {
  float T[16], xi[16], dl[16], d[6];
  float H[36], b[6];
  float y0, e, lam, nu;
  int i, n_lm, converged, failed, success, stop;
};

// float32 operations rounded one at a time, as PyTorch's elementwise ops
// round them (no contraction into fused multiply-adds)
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// torch.clamp(x, min=m): NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float m) { return x < m ? m : x; }

// p = R s + t of the row-major 4x4 T (`source @ R.T + t`)
__device__ __forceinline__ void transform(const float* T, float x, float y, float z,
                                          float* p) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    p[r] = add(fmaf(T[4 * r + 2], z, fmaf(T[4 * r + 1], y, mul(T[4 * r], x))), T[4 * r + 3]);
}

// The symmetric pseudo-inverse of the 3x3 A (its lower triangle): cyclic
// Jacobi rotations in float64 to the eigenpairs, then sum over the
// eigenvalues of magnitude above 1e-12 (as float32) of v v^T / lambda.
__device__ void pinv3(const float* A, float* out) {
  double a[3][3], v[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[r][c] = (double)(r >= c ? A[3 * r + c] : A[3 * c + r]);
      v[r][c] = r == c ? 1.0 : 0.0;
    }
  for (int sweep = 0; sweep < 16; ++sweep) {
    const double off = a[0][1] * a[0][1] + a[0][2] * a[0][2] + a[1][2] * a[1][2];
    if (!(off > 0.0)) break;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int p = k == 2 ? 1 : 0, q = k == 0 ? 1 : 2;
      const double apq = a[p][q];
      if (apq == 0.0) continue;
      const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
      const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
      const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
#pragma unroll
      for (int r = 0; r < 3; ++r) {  // A <- A G (columns p, q)
        const double arp = a[r][p], arq = a[r][q];
        a[r][p] = c * arp - s * arq;
        a[r][q] = s * arp + c * arq;
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) {  // A <- G^T A (rows p, q)
        const double apr = a[p][r], aqr = a[q][r];
        a[p][r] = c * apr - s * aqr;
        a[q][r] = s * apr + c * aqr;
      }
      a[p][q] = a[q][p] = 0.0;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const double vrp = v[r][p], vrq = v[r][q];
        v[r][p] = c * vrp - s * vrq;
        v[r][q] = s * vrp + c * vrq;
      }
    }
  }
  double inv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float lam = (float)a[j][j];
    inv[j] = fabsf(lam) > 1e-12f ? 1.0 / (double)lam : 0.0;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[3 * r + c] = (float)(v[r][0] * inv[0] * v[c][0] + v[r][1] * inv[1] * v[c][1] +
                               v[r][2] * inv[2] * v[c][2]);
}

// `robust_inv3`: the adjugate over the determinant where |det| > 1e-20,
// the pseudo-inverse elsewhere
__device__ void robust_inv3(const float* A, float* M) {
  const float a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5], g = A[6],
              h = A[7], i = A[8];
  const float c11 = sub(mul(e, i), mul(f, h)), c12 = sub(mul(c, h), mul(b, i)),
              c13 = sub(mul(b, f), mul(c, e));
  const float c21 = sub(mul(f, g), mul(d, i)), c22 = sub(mul(a, i), mul(c, g)),
              c23 = sub(mul(c, d), mul(a, f));
  const float c31 = sub(mul(d, h), mul(e, g)), c32 = sub(mul(b, g), mul(a, h)),
              c33 = sub(mul(a, e), mul(b, d));
  const float det = add(add(mul(a, c11), mul(b, c21)), mul(c, c31));
  if (!(fabsf(det) > 1e-20f)) {
    pinv3(A, M);
    return;
  }
  const float r = __fdiv_rn(1.0f, det);
  const float adj[9] = {c11, c12, c13, c21, c22, c23, c31, c32, c33};
#pragma unroll
  for (int k = 0; k < 9; ++k) M[k] = mul(adj[k], r);
}

// (H + lam I) d = rhs by LU with partial pivoting, float32. A zero pivot
// divides by zero, so a singular system gives a non-finite d.
__device__ void solve6(const float* H, float lam, const float* rhs, float* d) {
  float A[36], x[6];
  for (int k = 0; k < 36; ++k) A[k] = H[k];
  for (int k = 0; k < 6; ++k) {
    A[7 * k] = add(A[7 * k], lam);
    x[k] = rhs[k];
  }
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[7 * k]);
    for (int r = k + 1; r < 6; ++r) {
      const float v = fabsf(A[6 * r + k]);
      if (v > best) {
        best = v;
        p = r;
      }
    }
    if (p != k) {
      for (int c = 0; c < 6; ++c) {
        const float t = A[6 * k + c];
        A[6 * k + c] = A[6 * p + c];
        A[6 * p + c] = t;
      }
      const float t = x[k];
      x[k] = x[p];
      x[p] = t;
    }
    for (int r = k + 1; r < 6; ++r) {
      const float f = __fdiv_rn(A[6 * r + k], A[7 * k]);
      for (int c = k + 1; c < 6; ++c) A[6 * r + c] = fmaf(-f, A[6 * k + c], A[6 * r + c]);
      x[r] = fmaf(-f, x[k], x[r]);
    }
  }
  for (int k = 5; k >= 0; --k) {
    float s = x[k];
    for (int c = k + 1; c < 6; ++c) s = fmaf(-A[6 * k + c], d[c], s);
    d[k] = __fdiv_rn(s, A[7 * k]);
  }
}

// se3(so3_exp(d[:3]), d[3:]) as a row-major 4x4 (`core/transforms.so3_exp`:
// the half-angle quaternion, its series below theta^2 = 1e-8, normalized)
__device__ void delta_of(const float* d, float* D) {
  const float w0 = d[0], w1 = d[1], w2 = d[2];
  const float th2 = add(add(mul(w0, w0), mul(w1, w1)), mul(w2, w2));
  const float th = sqrtf(clamp_min(th2, 1e-12f));
  const bool small = th2 < 1e-8f;
  const float imag = small ? add(sub(0.5f, mul(1.0f / 48.0f, th2)),
                                 mul(mul(1.0f / 3840.0f, th2), th2))
                           : __fdiv_rn(sinf(mul(0.5f, th)), th);
  const float real = small ? add(sub(1.0f, mul(1.0f / 8.0f, th2)),
                                 mul(mul(1.0f / 384.0f, th2), th2))
                           : cosf(mul(0.5f, th));
  float x = mul(imag, w0), y = mul(imag, w1), z = mul(imag, w2), w = real;
  const float n = clamp_min(sqrtf(add(add(add(mul(x, x), mul(y, y)), mul(z, z)), mul(w, w))),
                            1e-12f);
  x = __fdiv_rn(x, n);
  y = __fdiv_rn(y, n);
  z = __fdiv_rn(z, n);
  w = __fdiv_rn(w, n);
  D[0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  D[1] = mul(2.0f, sub(mul(x, y), mul(w, z)));
  D[2] = mul(2.0f, add(mul(x, z), mul(w, y)));
  D[4] = mul(2.0f, add(mul(x, y), mul(w, z)));
  D[5] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
  D[6] = mul(2.0f, sub(mul(y, z), mul(w, x)));
  D[8] = mul(2.0f, sub(mul(x, z), mul(w, y)));
  D[9] = mul(2.0f, add(mul(y, z), mul(w, x)));
  D[10] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
  D[3] = d[3];
  D[7] = d[4];
  D[11] = d[5];
  D[12] = D[13] = D[14] = 0.0f;
  D[15] = 1.0f;
}

// C = A B of row-major 4x4s
__device__ void matmul4(const float* A, const float* B, float* C) {
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c)
      C[4 * r + c] = fmaf(A[4 * r + 3], B[12 + c],
                          fmaf(A[4 * r + 2], B[8 + c],
                               fmaf(A[4 * r + 1], B[4 + c], mul(A[4 * r], B[c]))));
}

// `_is_converged`: max |R - I| / rot_eps and max |t| / trans_eps both
// below 1 (a NaN anywhere: not converged, as torch.max propagates it)
__device__ bool is_converged(const float* D, float rot_eps, float trans_eps) {
  bool ok = true;
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c)
      ok = ok && __fdiv_rn(fabsf(sub(D[4 * r + c], r == c ? 1.0f : 0.0f)), rot_eps) < 1.0f;
    ok = ok && __fdiv_rn(fabsf(D[4 * r + 3]), trans_eps) < 1.0f;
  }
  return ok;
}

// Adds each thread's `v` (non-zero only on a point's first thread: lanes 0,
// 8, 16 and 24 of a warp) into the block's `acc`, in a fixed order.
template <int NV>
__device__ __forceinline__ void block_add(const double (&v)[NV], double (*red)[kSums],
                                          double* acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    double x = v[k];
    x += __shfl_xor_sync(kFull, x, 16);
    x += __shfl_xor_sync(kFull, x, 8);
    if (lane == 0) red[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    double s = acc[threadIdx.x];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    acc[threadIdx.x] = s;
  }
  __syncthreads();
}

// Every block's row of `partials[buf]` summed in a fixed order into `sums`
// (the first `nv` values); the same bits in every block.
__device__ void grid_sum(const double* partials, int buf, int nv, double* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double* p = partials + (size_t)buf * gridDim.x * kSums;
  for (int v = warp; v < nv; v += kWarps) {
    double s = 0.0;
    for (int b = lane; b < (int)gridDim.x; b += 32) s += __ldcg(p + (size_t)b * kSums + v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) sums[v] = s;
  }
  __syncthreads();
}

// The linearization at T: each point's correspondence and weight into
// `corr`, the block's sums of H, b and e into `acc`.
__device__ void linearize(const Args& a, const float* T, float4* tile, double (*red)[kSums],
                          double* acc) {
  const int g = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  if (threadIdx.x < kSums) acc[threadIdx.x] = 0.0;
  for (int base = blockIdx.x * kGroups; base < a.n_src; base += gridDim.x * kGroups) {
    const int i = base + g;
    const bool has = i < a.n_src;
    float p[3] = {0.0f, 0.0f, 0.0f};
    if (has) transform(T, a.src[3 * i], a.src[3 * i + 1], a.src[3 * i + 2], p);
    const float qq = add(add(mul(p[0], p[0]), mul(p[1], p[1])), mul(p[2], p[2]));
    float best = INFINITY;
    int bi = a.n_tgt;  // none yet
    for (int t0 = 0; t0 < a.n_tgt; t0 += kTile) {
      const int cnt = min(kTile, a.n_tgt - t0);
      __syncthreads();  // the previous tile is consumed
      for (int k = threadIdx.x; k < cnt; k += kThreads) {
        const int j = t0 + k;
        float x = 1e10f, y = 1e10f, z = 1e10f;
        if (a.tgt_mask[j]) {
          x = a.tgt[3 * j];
          y = a.tgt[3 * j + 1];
          z = a.tgt[3 * j + 2];
        }
        tile[k] = make_float4(x, y, z, add(add(mul(x, x), mul(y, y)), mul(z, z)));
      }
      __syncthreads();
      if (has) {
        int k = lane;
        for (; k + 3 * kLanes < cnt; k += 4 * kLanes) {
          float dd[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 q = tile[k + u * kLanes];
            const float dot = fmaf(p[2], q.z, fmaf(p[1], q.y, mul(p[0], q.x)));
            dd[u] = sub(add(qq, q.w), mul(2.0f, dot));
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (dd[u] < best) {
              best = dd[u];
              bi = t0 + k + u * kLanes;
            }
        }
        for (; k < cnt; k += kLanes) {
          const float4 q = tile[k];
          const float dot = fmaf(p[2], q.z, fmaf(p[1], q.y, mul(p[0], q.x)));
          const float dd = sub(add(qq, q.w), mul(2.0f, dot));
          if (dd < best) {
            best = dd;
            bi = t0 + k;
          }
        }
      }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (ob < best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    double v[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] = 0.0;
    if (has && lane == 0) {
      const bool found = bi < a.n_tgt;
      const int j = found ? bi : 0;
      const bool ok = found && a.src_mask[i] && clamp_min(best, 0.0f) < a.gate2 &&
                      a.tgt_mask[j];
      float* row = a.corr + (size_t)kCorr * i;
      row[0] = ok ? 1.0f : 0.0f;
      if (found) {
        const float mb[3] = {a.tgt[3 * j], a.tgt[3 * j + 1], a.tgt[3 * j + 2]};
        // R C_A R^T, then + C_B, then its (pseudo-)inverse
        const float* C = a.src_cov + 9 * (size_t)i;
        float RC[9], S[9], M[9];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            RC[3 * r + c] = fmaf(T[4 * r + 2], C[6 + c],
                                 fmaf(T[4 * r + 1], C[3 + c], mul(T[4 * r], C[c])));
        const float* CB = a.tgt_cov + 9 * (size_t)j;
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            S[3 * r + c] = add(CB[3 * r + c],
                               fmaf(RC[3 * r + 2], T[4 * c + 2],
                                    fmaf(RC[3 * r + 1], T[4 * c + 1],
                                         mul(RC[3 * r], T[4 * c]))));
        robust_inv3(S, M);
        row[1] = mb[0];
        row[2] = mb[1];
        row[3] = mb[2];
#pragma unroll
        for (int k = 0; k < 9; ++k) row[4 + k] = M[k];
        if (ok) {
          const float r3[3] = {sub(mb[0], p[0]), sub(mb[1], p[1]), sub(mb[2], p[2])};
          // J = [skew(p) | -I], MJ = M J
          const float J[3][6] = {{0.0f, -p[2], p[1], -1.0f, 0.0f, 0.0f},
                                 {p[2], 0.0f, -p[0], 0.0f, -1.0f, 0.0f},
                                 {-p[1], p[0], 0.0f, 0.0f, 0.0f, -1.0f}};
          float MJ[3][6];
#pragma unroll
          for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int c = 0; c < 6; ++c)
              MJ[r][c] = fmaf(M[3 * r + 2], J[2][c], fmaf(M[3 * r + 1], J[1][c],
                                                          mul(M[3 * r], J[0][c])));
          int n = 0;
#pragma unroll
          for (int r = 0; r < 6; ++r)
#pragma unroll
            for (int c = r; c < 6; ++c)
              v[n++] = (double)fmaf(J[2][r], MJ[2][c], fmaf(J[1][r], MJ[1][c],
                                                           mul(J[0][r], MJ[0][c])));
#pragma unroll
          for (int c = 0; c < 6; ++c)
            v[21 + c] = (double)fmaf(MJ[2][c], r3[2], fmaf(MJ[1][c], r3[1],
                                                          mul(MJ[0][c], r3[0])));
          float e = 0.0f;
#pragma unroll
          for (int r = 0; r < 3; ++r)
            e = fmaf(r3[r], fmaf(M[3 * r + 2], r3[2], fmaf(M[3 * r + 1], r3[1],
                                                           mul(M[3 * r], r3[0]))), e);
          v[27] = (double)e;
        }
      }
    }
    block_add<kSums>(v, red, acc);
  }
}

// The error at T with the last linearization's correspondences and weights
// (each point's first thread reads the row it wrote), into `acc[0]`.
__device__ void error_at(const Args& a, const float* T, double (*red)[kSums], double* acc) {
  const int g = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  if (threadIdx.x == 0) acc[0] = 0.0;
  for (int base = blockIdx.x * kGroups; base < a.n_src; base += gridDim.x * kGroups) {
    const int i = base + g;
    double v[1] = {0.0};
    if (i < a.n_src && lane == 0) {
      const float* row = a.corr + (size_t)kCorr * i;
      if (row[0] != 0.0f) {
        float p[3];
        transform(T, a.src[3 * i], a.src[3 * i + 1], a.src[3 * i + 2], p);
        const float r3[3] = {sub(row[1], p[0]), sub(row[2], p[1]), sub(row[3], p[2])};
        const float* M = row + 4;
        float e = 0.0f;
#pragma unroll
        for (int r = 0; r < 3; ++r)
          e = fmaf(r3[r], fmaf(M[3 * r + 2], r3[2], fmaf(M[3 * r + 1], r3[1],
                                                         mul(M[3 * r], r3[0]))), e);
        v[0] = (double)e;
      }
    }
    block_add<1>(v, red, acc);
  }
}

__device__ void write_partials(const Args& a, int buf, int nv, const double* acc) {
  if (threadIdx.x < nv)
    a.partials[((size_t)buf * gridDim.x + blockIdx.x) * kSums + threadIdx.x] = acc[threadIdx.x];
}

// thread 0: H, b and e of the linearization just summed
__device__ void take_linearization(State& st, const double* sums) {
  int n = 0;
  for (int r = 0; r < 6; ++r)
    for (int c = r; c < 6; ++c) {
      const float h = (float)sums[n++];
      st.H[6 * r + c] = h;
      st.H[6 * c + r] = h;
    }
  for (int c = 0; c < 6; ++c) st.b[c] = (float)sums[21 + c];
  st.y0 = (float)sums[27];
  st.e = st.y0;
}

__global__ void __launch_bounds__(kThreads) gicp_align_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float4 tile[kTile];
  __shared__ double red[kWarps][kSums];
  __shared__ double acc[kSums];
  __shared__ double sums[kSums];
  __shared__ State st;
  int buf = 0;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 16; ++k) st.T[k] = a.init_T[k];
    for (int k = 0; k < 36; ++k) st.H[k] = k % 7 == 0 ? 1.0f : 0.0f;
    st.e = INFINITY;
    st.lam = -1.0f;
    st.i = st.n_lm = st.converged = st.failed = 0;
  }
  __syncthreads();
  for (;;) {
    const bool go = st.i < a.max_iterations && !st.converged && !st.failed;
    __syncthreads();  // every thread has read the flags before thread 0 writes
    if (!go) break;
    linearize(a, st.T, tile, red, acc);
    write_partials(a, buf, kSums, acc);
    grid.sync();
    grid_sum(a.partials, buf, kSums, sums);
    buf ^= 1;
    if (threadIdx.x == 0) {
      take_linearization(st, sums);
      if (a.gauss_newton) {
        float nb[6];
        for (int c = 0; c < 6; ++c) nb[c] = -st.b[c];
        solve6(st.H, 0.0f, nb, st.d);
        delta_of(st.d, st.dl);
        matmul4(st.dl, st.T, st.xi);
        for (int k = 0; k < 16; ++k) st.T[k] = st.xi[k];
        st.converged = is_converged(st.dl, a.rot_eps, a.trans_eps);
        st.i += 1;
      } else {
        if (st.lam < 0.0f) {
          float m = 0.0f;  // torch.max: a NaN diagonal gives NaN
          for (int k = 0; k < 6; ++k) {
            const float h = fabsf(st.H[7 * k]);
            m = (h > m || isnan(h)) ? h : m;
          }
          st.lam = mul(a.lm_init_lambda_factor, m);
        }
        st.nu = 2.0f;
        for (int k = 0; k < 16; ++k) st.dl[k] = k % 5 == 0 ? 1.0f : 0.0f;
        st.success = 0;
      }
    }
    __syncthreads();
    if (a.gauss_newton) continue;
    for (int trial = 0; trial < a.lm_max_iterations; ++trial) {
      if (threadIdx.x == 0) {
        float nb[6];
        for (int c = 0; c < 6; ++c) nb[c] = -st.b[c];
        solve6(st.H, st.lam, nb, st.d);
        delta_of(st.d, st.dl);
        matmul4(st.dl, st.T, st.xi);
        st.stop = 0;
      }
      __syncthreads();
      error_at(a, st.xi, red, acc);
      write_partials(a, buf, 1, acc);
      grid.sync();
      grid_sum(a.partials, buf, 1, sums);
      buf ^= 1;
      if (threadIdx.x == 0) {
        const float yi = (float)sums[0];
        float den = 0.0f;
        for (int c = 0; c < 6; ++c) den = fmaf(st.d[c], sub(mul(st.lam, st.d[c]), st.b[c]), den);
        const float rho = __fdiv_rn(sub(st.y0, yi), den);
        st.n_lm += 1;
        if (rho >= 0.0f) {
          const float u = sub(mul(2.0f, rho), 1.0f);
          st.lam = mul(st.lam, clamp_min(sub(1.0f, mul(mul(u, u), u)), 1.0f / 3.0f));
          for (int k = 0; k < 16; ++k) st.T[k] = st.xi[k];
          st.success = 1;
          st.stop = 1;
        } else {
          st.lam = mul(st.nu, st.lam);
          st.nu = mul(2.0f, st.nu);
          if (is_converged(st.dl, a.rot_eps, a.trans_eps)) {
            st.success = 1;
            st.stop = 1;
          }
        }
      }
      __syncthreads();
      const bool stop = st.stop;
      __syncthreads();
      if (stop) break;
    }
    if (threadIdx.x == 0) {
      st.failed = !st.success;
      st.converged = is_converged(st.dl, a.rot_eps, a.trans_eps);
      st.i += 1;
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int k = 0; k < 16; ++k) a.out[k] = st.T[k];
    for (int k = 0; k < 36; ++k) a.out[16 + k] = st.H[k];
    a.out[52] = st.e;
    a.out_i[0] = st.i;
    a.out_i[1] = st.n_lm;
    a.converged[0] = st.converged ? 1 : 0;
  }
}

__global__ void grid_sync_probe_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < syncs; ++k) grid.sync();
}

// Blocks of the align's grid for `n_src` source points: no more than stay
// co-resident (the occupancy query, taken once, times the SM count), nor
// than the points need.
int grid_for(int n_src) {
  static int cap = 0;
  if (cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gicp_align_kernel, kThreads, 0);
    cap = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const int need = (n_src + kGroups - 1) / kGroups;
  return need < 1 ? 1 : (need < cap ? need : cap);
}

}  // namespace

// The grid `sags_gicp_align` launches for `n_src` source points: the wrapper
// sizes the partials buffer, 2 * grid * 28 float64, from it.
extern "C" int sags_gicp_align_grid(int n_src) { return grid_for(n_src); }

// Scratch: corr float32 [n_src, 13], partials float64 [2, grid, 28]. Outputs:
// out float32 [53] (T, H, e), out_i int32 [2] (iterations, trials),
// converged uint8 [1].
extern "C" int sags_gicp_align(const void* src, const void* src_mask, const void* src_cov,
                               const void* tgt, const void* tgt_mask, const void* tgt_cov,
                               const void* init_T, int n_src, int n_tgt, float gate2,
                               int max_iterations, int lm_max_iterations, int gauss_newton,
                               float lm_init_lambda_factor, float rot_eps, float trans_eps,
                               void* corr, void* partials, void* out, void* out_i,
                               void* converged, void* stream) {
  if (n_src < 0 || n_tgt < 0 || max_iterations < 0 || lm_max_iterations < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  Args a;
  a.src = (const float*)src;
  a.src_mask = (const uint8_t*)src_mask;
  a.src_cov = (const float*)src_cov;
  a.tgt = (const float*)tgt;
  a.tgt_mask = (const uint8_t*)tgt_mask;
  a.tgt_cov = (const float*)tgt_cov;
  a.init_T = (const float*)init_T;
  a.n_src = n_src;
  a.n_tgt = n_tgt;
  a.gate2 = gate2;
  a.max_iterations = max_iterations;
  a.lm_max_iterations = lm_max_iterations;
  a.gauss_newton = gauss_newton;
  a.lm_init_lambda_factor = lm_init_lambda_factor;
  a.rot_eps = rot_eps;
  a.trans_eps = trans_eps;
  a.corr = (float*)corr;
  a.partials = (double*)partials;
  a.out = (float*)out;
  a.out_i = (int32_t*)out_i;
  a.converged = (uint8_t*)converged;
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)gicp_align_kernel,
                                                dim3(grid_for(n_src)), dim3(kThreads), args,
                                                0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `syncs` grid-wide barriers and nothing else, on the align's grid for
// `n_src` points: the latency that bounds the align (`chip_smoke.py`).
extern "C" int sags_gicp_grid_sync_probe(int n_src, int syncs, void* stream) {
  void* args[] = {&syncs};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)grid_sync_probe_kernel,
                                                dim3(grid_for(n_src)), dim3(kThreads), args,
                                                0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* sags_gicp_align_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
