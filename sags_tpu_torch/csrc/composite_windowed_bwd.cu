// composite_windowed_bwd: per-pair gradients of composite_windowed.
//
// Replaces the Pallas TPU kernel `composite_windowed_bwd` (`sags_tpu/ops/
// pallas_windowed.py`, `_bwd_kernel`). Entry k of tile t's window-local work
// list table_local[t, :] (-1 = empty) resolves through the tile's span plan
// to a row of the anchor-sorted store G_s, as in composite_windowed.cu. For
// every entry it writes dGt[t, :, k]: the gradients of the row's first 32
// columns (mx, my, ca, cb, cc, op in rows 0-5, zeros in rows 6-7, the 24
// feature rows in 8-31), summed over the tile's 256 pixels, in table order.
//
// Transmittance in log space, as the TPU kernel (`pallas_windowed.py:
// 405-427`): inside a chunk of `chunk` entries,
//   T_exc_k = T_entry exp(sum over gated j < k of log1p(-alpha_j)),
//   m_k = gate_k and T_exc_k (1 - alpha_k) >= t_min,
// and the next chunk enters at T_entry exp(sum over m of log1p(-alpha)).
// The per-entry gradient and its reduction are composite_fused_bwd.cu's
// (pair_grads.cuh). Empty and window-dropped entries read zero rows: opacity
// 0 fails the alpha gate. The exponent is the forward's (windowed.cuh
// `ewa_power`), so the two gate every entry alike.
//
// Bound: float32 arithmetic. Each (pixel, entry) costs three exps and two
// log1p (a forward sweep; then each group recomputed forward and walked in
// reverse) and about 150 instructions; the 30 sums over the tile's 256 pixels
// run on the tensor cores and cost next to nothing.
// Design: composite_fused_bwd.cu's, on the windowed work list. One block per
// tile, one thread per pixel. The forward sweep records, per 32-entry group,
// the log-space prefix at the group's start, and per chunk the entry T, in
// shared memory; the reverse sweep recomputes each group forward from that
// record, keeping T_exc and raw = op e^power per (entry, pixel) in shared
// memory, walks it backwards with the suffix sums in registers
// (pair_grads.cuh `walk_group`) and leaves w = m alpha T_exc and dpow =
// da alpha in their place. Each warp multiplies its 32 pixels' factors with
// [dAcc | Phi] (`warp_products`: mma.sync, TF32 split in two, float32
// accuracy), the eight partial products are summed in a fixed order and each
// entry's gradients written once (`write_group_sums`): no atomics, so dGt is
// bitwise reproducible. The sweeps take all 32 rows of a group without a
// data-dependent branch (rows past the tile's count and empty slots are zero
// rows), and the next group's ids are resolved through the spans and its
// rows fetched into registers while the current group is worked on. Groups
// past the point where no pixel of the tile can take another pair contribute
// exactly zero and are only zero-filled. No VMEM window: rows are gathered
// from G_s by id. At capacity 1024 and chunk 512 a block takes 105 KB of
// shared memory: two blocks an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_grads.cuh"
#include "windowed.cuh"

namespace {
constexpr int SUB = sagsb::SUB;  // entries per group (one bit each in a uint32 mask)
constexpr int CH = sagsb::CH;
constexpr int CF = sagsb::CF;
constexpr int PIX = sagsb::PIX;
constexpr int LDW = sagsb::LDW;
static_assert(SUB == sagsw::SUB && CH == sagsw::CH, "one group and row width");
}  // namespace

__global__ void __launch_bounds__(PIX, 2) composite_windowed_bwd_kernel(
    const float* __restrict__ G, int row_stride, int n_rows,
    const int32_t* __restrict__ table_local, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ bases, const int32_t* __restrict__ dests,
    const int32_t* __restrict__ nblks, int n_span, int K, int tiles_x,
    int tile_offset, float alpha_min, float t_min, int chunk,
    const float* __restrict__ d_acc, const float* __restrict__ d_T,
    const float* __restrict__ T_final, float* __restrict__ dGt) {
  extern __shared__ __align__(16) float smem[];
  __shared__ sagsw::Spans spans;
  constexpr int tile = sagsb::TILE;
  const int n_groups_max = K / SUB;
  float* rows = smem;                       // [SUB][CH]
  float* W = rows + SUB * CH;               // [SUB][LDW] T_exc, then w, then the warps' sums
  float* D = W + SUB * LDW;                 // [SUB][LDW] raw, then dpow
  float* gcum = D + SUB * LDW;              // [K/SUB][PIX] log prefix at group start
  float* tent = gcum + n_groups_max * PIX;  // [K/chunk][PIX] chunk-entry T

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid < n_span) {
    spans.base[tid] = bases[t * n_span + tid];
    spans.dest[tid] = dests[t * n_span + tid];
    spans.nblk[tid] = nblks[t * n_span + tid];
  }
  if (tid == 0) spans.n = n_span;
  __syncthreads();
  const int tg = t + tile_offset;  // global tile id (pixel coordinates)
  const float px = (float)((tg % tiles_x) * tile + tid % tile);
  const float py = (float)((tg / tiles_x) * tile + tid / tile);
  // the tile's centre: the moments' origin (pair_grads.cuh `phi`)
  const float cx = (float)((tg % tiles_x) * tile) + 0.5f * (tile - 1);
  const float cy = (float)((tg / tiles_x) * tile) + 0.5f * (tile - 1);
  const int count = min(counts[t], K);
  const float om_max = 1.f - alpha_min;
  const int32_t* ids = table_local + (size_t)t * K;
  float* out = dGt + (size_t)t * CH * K;

  // The rows of entries base .. base + SUB - 1 (zeros past the tile's count,
  // for id -1 and for an id in no span: opacity 0 fails the alpha gate) are
  // fetched into registers a group ahead, four values a thread, and put into
  // shared memory when the group before is done with it; their ids are read
  // a group before that, so neither load is waited for where it starts.
  // A warp resolves the ids of its four rows itself, every lane alike.
  constexpr int NF = SUB * CH / PIX;
  int nid[NF];
  float nxt[NF];
  auto load_ids = [&](int base) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int k = base + warp + j * (PIX / CH);
      nid[j] = base >= 0 && k < count ? ids[k] : -1;
    }
  };
  // the rows of the ids held in `nid`, then the ids of the group at next_base
  auto fetch = [&](int next_base) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      int r = sagsw::window_row(nid[j], spans);
      if (r >= n_rows) r = -1;
      nxt[j] = r >= 0 ? G[(size_t)r * row_stride + lane] : 0.f;
    }
    load_ids(next_base);
  };
  auto put = [&]() {
#pragma unroll
    for (int j = 0; j < NF; ++j) rows[(warp + j * (PIX / CH)) * CH + lane] = nxt[j];
    __syncthreads();
  };
  // raw = op e^power of row r at this pixel, the exponent the forward's
  // (windowed.cuh `ewa_power`); gate = it passes the alpha test
  auto raw_of = [&](const float* r, bool& gate) {
    const float power = sagsw::ewa_power(r, r[0] - px, r[1] - py);
    const float raw = r[5] * expf(power);
    gate = power <= 0.f && fminf(0.99f, raw) >= alpha_min;
    return raw;
  };

  // ---- forward sweep: chunk-entry T and per-group log prefixes ----
  // A group never straddles a chunk boundary (chunk is a multiple of SUB).
  float Tent = 1.f, cum = 0.f, msum = 0.f;
  int n_groups = 0;
  load_ids(0);
  fetch(SUB);
  for (int base = 0, rem = 0, ci = 0; base < count; base += SUB, ++n_groups) {
    if (rem == 0) {  // entering a chunk
      Tent = Tent * expf(msum);
      cum = 0.f;
      msum = 0.f;
      tent[ci * PIX + tid] = Tent;
      ++ci;
    }
    rem = rem + SUB == chunk ? 0 : rem + SUB;
    // no pixel can pass T (1 - alpha) >= t_min again: the tile is done
    if (__syncthreads_count(Tent * expf(msum) * om_max >= t_min) == 0) break;
    put();
    fetch(base + 2 * SUB);
    gcum[n_groups * PIX + tid] = cum;
#pragma unroll 4
    for (int k = 0; k < SUB; ++k) {
      bool gate;
      const float alpha = fminf(0.99f, raw_of(rows + k * CH, gate));
      const float lom = log1pf(gate ? -alpha : 0.f);
      const bool m = gate && Tent * expf(cum) * (1.f - alpha) >= t_min;
      msum += m ? lom : 0.f;
      cum += lom;
    }
  }

  // entries past the last live group have exactly zero gradient
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
  float B = 0.f;  // sum of w s over later entries of the current chunk

  // ---- reverse sweep, one group at a time ----
  const sagsb::PhiFrags phis = sagsb::phi_frags(warp * 32, lane);
  load_ids((n_groups - 1) * SUB);
  fetch((n_groups - 2) * SUB);
  for (int gi = n_groups - 1; gi >= 0; --gi) {
    const int base = gi * SUB;
    const int n = min(SUB, count - base);
    __syncthreads();  // previous group's rows and sums fully consumed
    put();
    fetch(base - 2 * SUB);

    // recompute the group forward from its recorded log prefix
    const float Tc = tent[(base / chunk) * PIX + tid];
    float c_log = gcum[gi * PIX + tid];
    unsigned gbits = 0u, mbits = 0u;
#pragma unroll 4
    for (int k = 0; k < SUB; ++k) {
      bool gate;
      const float raw = raw_of(rows + k * CH, gate);
      const float alpha = fminf(0.99f, raw);
      const float Te = Tc * expf(c_log);
      W[k * LDW + tid] = Te;
      D[k * LDW + tid] = raw;
      gbits |= (unsigned)gate << k;
      mbits |= (unsigned)(gate && Te * (1.f - alpha) >= t_min) << k;
      c_log += log1pf(gate ? -alpha : 0.f);
    }

    // walk it backwards: the two factors of every (entry, pixel)
    sagsb::walk_group(rows, W, D, gbits, mbits, dacc, chunk, (base + SUB - 1) % chunk, carry,
                      B, tid);

    sagsb::warp_products(W, D, dacc_tile, phis, warp * 32, lane);
    __syncthreads();
    sagsb::write_group_sums(W, rows, out, K, base, n, cx, cy);
  }
}

extern "C" size_t sags_composite_windowed_bwd_smem(int K, int chunk) {
  const int groups = (K + SUB - 1) / SUB;
  const int chunks = (K + chunk - 1) / chunk;
  return sizeof(float) * ((size_t)SUB * CH + 2 * (size_t)SUB * LDW + (size_t)groups * PIX +
                          (size_t)chunks * PIX);
}

extern "C" int sags_composite_windowed_bwd(
    const void* G, int row_stride, int n_rows, const void* table_local,
    const void* counts, const void* bases, const void* dests, const void* nblks,
    int n_span, int num_tiles, int K, int tile, int tiles_x, int tile_offset,
    float alpha_min, float t_min, int chunk, const void* d_acc, const void* d_T,
    const void* T_final, void* dGt, void* stream) {
  // a group of SUB entries never straddles a chunk boundary
  if (tile != sagsb::TILE || n_span < 1 || n_span > sagsw::MAX_SPAN || chunk < SUB ||
      chunk % SUB || K % SUB)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sags_composite_windowed_bwd_smem(K, chunk);
  cudaError_t err = cudaFuncSetAttribute(composite_windowed_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (num_tiles > 0) {
    composite_windowed_bwd_kernel<<<num_tiles, PIX, smem, (cudaStream_t)stream>>>(
        (const float*)G, row_stride, n_rows, (const int32_t*)table_local,
        (const int32_t*)counts, (const int32_t*)bases, (const int32_t*)dests,
        (const int32_t*)nblks, n_span, K, tiles_x, tile_offset, alpha_min,
        t_min, chunk, (const float*)d_acc, (const float*)d_T,
        (const float*)T_final, (float*)dGt);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sags_composite_windowed_bwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
